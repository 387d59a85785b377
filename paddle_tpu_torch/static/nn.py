"""Layer functions of static mode (``paddle_tpu/static/nn.py``): each
creates its parameters with :func:`graph.create_parameter` (so the
startup Program re-initializes them) and records the port's functionals.
Parameters go to ``device`` (default cuda; ``"cpu"`` for the plain
versions).  ``fc``'s weight is [size, in], PyTorch's layout, so an
``fc`` with an activation is the ``linear`` -> activation pair that
``fuse_linear_act`` fuses.
"""
from __future__ import annotations

import math

from ..nn import functional as F
from .graph import create_parameter


def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
       activation=None, name=None, device=None):
    """``activation(flatten(x) @ w.T + b)``: the dims of x from
    ``num_flatten_dims`` on are flattened into the input width.
    ``weight_attr``: an initializer for :func:`create_parameter` (a
    function or a value); ``bias_attr=False``: no bias."""
    in_dim = math.prod(int(d) for d in x.shape[num_flatten_dims:])
    w = create_parameter([size, in_dim], x.dtype, initializer=weight_attr,
                         name=f"{name}.w" if name else None, device=device)
    b = None
    if bias_attr is not False:
        b = create_parameter([size], x.dtype, is_bias=True,
                             initializer=bias_attr,
                             name=f"{name}.b" if name else None,
                             device=device)
    if x.dim() > num_flatten_dims + 1:
        # flattened at run time: the Program keeps its batch size free
        x = x.flatten(num_flatten_dims)
    out = F.linear(x, w, b)
    return getattr(F, activation)(out) if activation else out


def embedding(input, size, padding_idx=None, param_attr=None,
              dtype="float32", device=None):
    w = create_parameter(list(size), dtype, initializer=param_attr,
                         device=device)
    return F.embedding(input, w, padding_idx)


def layer_norm(input, begin_norm_axis=1, epsilon=1e-5, device=None):
    shape = [int(d) for d in input.shape[begin_norm_axis:]]
    w = create_parameter(shape, input.dtype, initializer=lambda t: t.fill_(1),
                         device=device)
    b = create_parameter(shape, input.dtype, is_bias=True, device=device)
    return F.layer_norm(input, shape, w, b, epsilon)


def dropout(x, dropout_prob=0.5, is_test=False, generator=None,
            dropout_implementation="downgrade_in_infer"):
    """The JAX package's ``static.nn.dropout``: by default kept elements
    are not scaled in training (``downgrade_in_infer``), and with
    ``upscale_in_train`` they are scaled by 1 / (1 - p)."""
    mode = "upscale_in_train" if dropout_implementation == \
        "upscale_in_train" else "downscale_in_infer"
    return F.dropout(x, dropout_prob, not is_test, generator, mode)
