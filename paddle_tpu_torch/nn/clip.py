"""Gradient clipping, the port of ``paddle_tpu/nn/clip.py``.

``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``
take ``[(param, grad)]`` pairs and return new pairs, leaving ``p.grad``
alone, as an optimizer's ``grad_clip`` calls them.  A pair whose grad is
None, or whose parameter does not require grad (the JAX package's
``trainable`` False), passes through untouched.  ``clip_grad_norm_``
and ``clip_grad_value_`` write ``p.grad`` in place.

The norms and scales round where the JAX rules round:
- each gradient is raised to f32 for its squared sum; the sums are
  added one tensor at a time (no concatenated copy: at Llama-3-8B width
  an f32 copy of the embedding's gradient alone is 2.1 GB), then the
  square root;
- the scale ``min(clip_norm / max(norm, 1e-12), 1)`` is an f32 scalar,
  and a gradient times it is formed in f32 and rounded once to the
  gradient's dtype.  A bf16 tensor times a 0-d f32 tensor stays bf16 in
  PyTorch's type promotion (two roundings), so the gradient is raised
  to f32 explicitly;
- ``clip_grad_norm_`` with ``norm_type`` inf takes the largest absolute
  entry in the gradients' own dtype (their common dtype when they
  differ) and forms its scale in that dtype, as the JAX function does;
  each gradient times the scale is formed in the wider of the two
  dtypes and rounded once to the gradient's.

Every reduction and product here is a plain PyTorch op: the JAX rules
are XLA, with no Pallas kernel.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "clip_grad_norm_", "clip_grad_value_"]


def _skipped(p, g) -> bool:
    return g is None or not p.requires_grad


def _scaled(g, scale):
    """``g * scale`` formed in f32 and rounded once to g's dtype."""
    return (g.float() * scale).to(g.dtype)


def _sq_sum(g):
    return g.float().square().sum()


def _min_ratio(limit, norm, floor):
    """``min(limit / max(norm, floor), 1)`` in norm's dtype.  The limit
    is a tensor: a Python number over a tensor is its reciprocal times
    the number in PyTorch, two roundings, where the JAX rule divides."""
    den = torch.clamp(norm, min=floor)
    return torch.clamp(torch.full_like(den, limit) / den, max=1.0)


class ClipGradBase:
    def __call__(self, params_grads):
        return self._clip(params_grads)


class ClipGradByValue(ClipGradBase):
    """Each gradient clamped to ``[min, max]`` (``min`` defaults to
    ``-max``), in its own dtype."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = -max if min is None else min

    @torch.no_grad()
    def _clip(self, params_grads):
        return [(p, g) if _skipped(p, g) else
                (p, torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    """Each gradient scaled by ``min(clip_norm / max(||g||, 1e-12), 1)``
    of its own f32 L2 norm."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    @torch.no_grad()
    def _clip(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skipped(p, g):
                out.append((p, g))
                continue
            norm = _sq_sum(g).sqrt()
            scale = _min_ratio(self.clip_norm, norm, 1e-12)
            out.append((p, _scaled(g, scale)))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Every gradient scaled by ``min(clip_norm / max(G, 1e-12), 1)``,
    G the f32 L2 norm of all of them together.  ``group_name`` and
    ``auto_skip_clip`` are taken for the Paddle signature, as in the JAX
    class, and change nothing.  ``last_global_norm`` keeps the 0-d f32
    norm of the last call (None before one, or when no gradient was
    clipped), for a caller to log."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = clip_norm
        self.last_global_norm = None

    def _global_norm(self, params_grads):
        total = None
        for p, g in params_grads:
            if _skipped(p, g):
                continue
            s = _sq_sum(g)
            total = s if total is None else total + s
        return None if total is None else total.sqrt()

    @torch.no_grad()
    def _clip(self, params_grads):
        params_grads = list(params_grads)
        global_norm = self._global_norm(params_grads)
        self.last_global_norm = global_norm
        if global_norm is None:
            return params_grads
        scale = _min_ratio(self.clip_norm, global_norm, 1e-12)
        return [(p, g) if _skipped(p, g) else (p, _scaled(g, scale))
                for p, g in params_grads]


@torch.no_grad()
def clip_grad_norm_(parameters, max_norm, norm_type=2.0,
                    error_if_nonfinite=False):
    """Scale every ``p.grad`` in place by ``min(max_norm / max(total,
    1e-6), 1)``; returns the total norm (0-d).  For a finite
    ``norm_type`` the total is ``(sum |g|^norm_type)^(1/norm_type)`` in
    f32; for inf, the largest ``|g|``.  ``error_if_nonfinite`` is taken
    for the signature and changes nothing, as in the JAX function."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    parameters = list(parameters)
    grads = [p.grad for p in parameters if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        total = torch.stack([g.abs().max() for g in grads]).max()
    else:
        acc = None
        for g in grads:
            s = g.float().abs().pow(norm_type).sum()
            acc = s if acc is None else acc + s
        total = acc.pow(1.0 / norm_type)
    scale = _min_ratio(max_norm, total, 1e-6)
    for p in parameters:
        if p.grad is not None:
            wide = torch.promote_types(p.grad.dtype, scale.dtype)
            p.grad.copy_(p.grad.to(wide) * scale)
    return total


@torch.no_grad()
def clip_grad_value_(parameters, clip_value):
    """Clamp every ``p.grad`` to ``[-clip_value, clip_value]`` in place."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad.clamp_(-clip_value, clip_value)
