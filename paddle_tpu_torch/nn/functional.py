"""Functionals of the port's layers (``paddle_tpu/nn/functional``): the
ones BERT and the static-graph passes need, in plain PyTorch.

Each public function here is one op to the static-graph recorder
(``static.graph``): :func:`op` routes it through
``torch.overrides.handle_torch_function``, so while static mode is on
the recorder sees ``linear``, ``gelu``, ``dropout``... by name, as the
JAX package's ``dispatch.apply`` names its ops.  Exact and tanh gelu
are two ops, ``gelu`` and ``gelu_tanh``, as in the JAX package
(``nn/functional/activation.py:32-36``): ``fuse_linear_act`` fuses only
the first.  Outside static mode the call goes straight to its body.

Weights keep PyTorch's layout: ``linear`` takes w [out, in].  Dropout
draws its mask from an explicit ``torch.Generator`` (the JAX package's
``jax.random`` keys give other bits, so tests compare the two at p = 0
and check the mask's statistics on their own).
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F
from torch.overrides import handle_torch_function, has_torch_function


def op(name):
    """Make the decorated function one op named ``name`` to a torch
    function mode (the static recorder): with a mode active, or a
    tensor argument that overrides ``__torch_function__``, the call goes
    there; otherwise straight to the function."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            tensors = tuple(a for a in (*args, *kwargs.values())
                            if isinstance(a, torch.Tensor))
            if has_torch_function(tensors):
                return handle_torch_function(wrapper, tensors, *args,
                                             **kwargs)
            return fn(*args, **kwargs)

        wrapper.__name__ = wrapper.__qualname__ = name
        return wrapper
    return deco


@op("linear")
def linear(x, weight, bias=None):
    """``x @ weight.T + bias``; weight [out, in]."""
    return F.linear(x, weight, bias)


@op("relu")
def relu(x):
    return torch.relu(x)


@op("gelu")
def _gelu_exact(x):
    return F.gelu(x)


@op("gelu_tanh")
def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


def gelu(x, approximate=False):
    """Exact (erf) gelu, or the tanh approximation: two ops."""
    return gelu_tanh(x) if approximate else _gelu_exact(x)


@op("silu")
def silu(x):
    return F.silu(x)


@op("swish")
def swish(x):
    return F.silu(x)


@op("tanh")
def tanh(x):
    return torch.tanh(x)


@op("layer_norm")
def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    return F.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


@op("embedding")
def embedding(x, weight, padding_idx=None):
    """Rows of ``weight`` at the indices ``x``; rows at ``padding_idx``
    are zero, as the JAX package's ``jnp.where`` makes them."""
    out = F.embedding(x, weight)
    if padding_idx is not None:
        out = out.masked_fill((x == padding_idx)[..., None], 0.0)
    return out


def dropout(x, p=0.5, training=True, generator=None,
            mode="upscale_in_train"):
    """Dropout: each element kept with probability 1 - p (a uniform draw
    from ``generator`` below 1 - p), scaled by 1 / (1 - p) in mode
    ``upscale_in_train`` and left as it is in ``downscale_in_infer``.
    ``p == 0`` or ``training=False`` is the identity (no op), in both
    modes, as in the JAX package."""
    if not training or p == 0.0:
        return x
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"unsupported dropout mode {mode!r}")
    return _dropout(x, p, generator,
                    1.0 / (1.0 - p) if mode == "upscale_in_train" else 1.0)


@op("dropout")
def _dropout(x, p, generator, scale):
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        < 1.0 - p
    return torch.where(keep, x * scale,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    if reduction == "none":
        return out
    raise ValueError(f"unknown reduction {reduction!r}")


@op("cross_entropy")
def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """The JAX ``cross_entropy`` with every argument, computed in f32
    (the JAX function computes in the logits' dtype: the same numbers
    for f32 logits).  Hard labels (``label`` [...] or with a size-1
    ``axis``) are class indices, those equal to ``ignore_index`` left
    out; ``label_smoothing`` mixes in the mean negative log-probability
    over the classes; ``weight`` [C] scales each label's loss, and
    ``"mean"`` then divides by the summed weights of the labels kept,
    else by their count (at least 1).  Soft labels are distributions
    over ``axis`` (smoothed toward uniform), and ``"mean"`` is the plain
    mean.  ``use_softmax=False`` takes probabilities (their log, clipped
    to [1e-15, 1])."""
    x = input.float()
    axis = axis % x.ndim
    logp = torch.log_softmax(x, dim=axis) if use_softmax \
        else torch.log(x.clamp(1e-15, 1.0))
    if soft_label:
        soft = label.float()
        if label_smoothing > 0.0:
            soft = soft * (1 - label_smoothing) \
                + label_smoothing / x.shape[axis]
        return _reduce(-(soft * logp).sum(axis), reduction)
    if label.ndim == logp.ndim:
        label = label.squeeze(axis)
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    nll = -torch.gather(logp, axis, safe.unsqueeze(axis)).squeeze(axis)
    loss = torch.where(valid, nll, torch.zeros_like(nll))
    if label_smoothing > 0.0:
        smooth = -logp.mean(axis)
        loss = (1 - label_smoothing) * loss + label_smoothing * torch.where(
            valid, smooth, torch.zeros_like(smooth))
    w = None
    if weight is not None:
        w = torch.where(valid, weight.float()[safe], torch.zeros_like(loss))
        loss = loss * w
    if reduction == "mean":
        denom = w.sum() if w is not None \
            else valid.sum().clamp_min(1).float()
        return loss.sum() / denom
    return _reduce(loss, reduction)


@op("nll_loss")
def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """The JAX ``nll_loss``: log-probabilities ``input`` [N, C, ...],
    class indices ``label`` [N, ...]; ``weight`` [C] scales each label's
    loss and ``"mean"`` divides by the weights of the labels kept (else
    by their count, at least 1)."""
    valid = label != ignore_index
    safe = torch.where(valid, label, torch.zeros_like(label)).long()
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    wsum = None
    if weight is not None:
        w = weight[safe]
        loss = loss * w
        wsum = torch.where(valid, w, torch.zeros_like(w)).sum()
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        denom = wsum if wsum is not None \
            else valid.sum().clamp_min(1).to(loss.dtype)
        return loss.sum() / denom
    return _reduce(loss, reduction)


@op("mse_loss")
def mse_loss(input, label, reduction="mean"):
    return _reduce((input - label).square(), reduction)


@op("l1_loss")
def l1_loss(input, label, reduction="mean"):
    return _reduce((input - label).abs(), reduction)


@op("scaled_dot_product_attention")
def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 training=True, generator=None):
    """Attention in the [B, T, H, D] layout, as plain products: scores
    ``q k^T / sqrt(D)`` plus the additive mask, a softmax in
    f32 rounded to q's dtype, dropout on the probabilities, then the
    product with v.  The JAX package's ``_sdpa_reference`` without its
    flash path (BERT's mask and dropout keep it off the kernel there
    too); unlike it, ``dropout_p`` is applied (it ignores it)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))   # [B, H, T, D]
    logits = torch.matmul(qt, kt.transpose(-1, -2)) * scale
    if attn_mask is not None:
        logits = logits + attn_mask
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    if training and dropout_p > 0.0:
        probs = dropout(probs, dropout_p, True, generator)
    return torch.matmul(probs, vt).transpose(1, 2)
