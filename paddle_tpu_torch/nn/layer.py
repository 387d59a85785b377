"""The layers BERT needs (``paddle_tpu/nn/layer/common.py`` and
``norm.py``) as ``torch.nn.Module``s.

``Linear`` keeps PyTorch's [out, in] weight and calls
``functional.linear(x, self.weight, self.bias)``, so the static
recorder sees one ``linear`` op whose inputs are the parameters
themselves; ``convert.bert_from_jax`` transposes the JAX package's
[in, out] weights.  Every layer takes ``device`` (default cuda, through
``device.resolve_device``; ``"cpu"`` for the plain versions) and
``dtype``, and an ``init``: the ``torch.Generator`` from which weights
are drawn (normal, std ``init_std``; biases zero, norms one), ``None``
for PyTorch's default generator, or :data:`EMPTY` to leave them
uninitialized for a loader to fill.
"""
from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from . import functional as F

EMPTY = "empty"


def _weight(shape, device, dtype, init, std):
    w = torch.empty(shape, device=device, dtype=dtype)
    if isinstance(init, str):
        if init != EMPTY:
            raise ValueError(f"init must be a torch.Generator, None or "
                             f"{EMPTY!r}, not {init!r}")
    else:
        w.normal_(0.0, std, generator=init)
    return nn.Parameter(w)


class Linear(nn.Module):
    """``x @ weight.T + bias``, weight [out_features, in_features]."""

    def __init__(self, in_features, out_features, *, device=None,
                 dtype=torch.float32, init=None, init_std=0.02):
        super().__init__()
        device = resolve_device(device)
        self.in_features, self.out_features = in_features, out_features
        self.weight = _weight((out_features, in_features), device, dtype,
                              init, init_std)
        self.bias = nn.Parameter(torch.zeros(out_features, device=device,
                                             dtype=dtype))

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Module):
    def __init__(self, num_embeddings, embedding_dim, *, device=None,
                 dtype=torch.float32, init=None, init_std=0.02):
        super().__init__()
        device = resolve_device(device)
        self.weight = _weight((num_embeddings, embedding_dim), device, dtype,
                              init, init_std)

    def forward(self, x):
        return F.embedding(x, self.weight)


class LayerNorm(nn.Module):
    def __init__(self, normalized_shape, epsilon=1e-5, *, device=None,
                 dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape,
                                              device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(self.normalized_shape,
                                             device=device, dtype=dtype))

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.epsilon)


class Dropout(nn.Module):
    """Dropout with probability ``p`` in training mode, its mask drawn
    from ``generator`` (``None``: PyTorch's default generator)."""

    def __init__(self, p=0.5, generator=None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)
