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

A parameter laid out on a mesh (``distributed.sharding.Placement``)
holds its part of the gradient: the squared sums (or, for
``norm_type`` inf, the largest entries) of the parameters split over
the same axes are added, then summed (max-reduced) over the group of
those axes, so each part counts once and a replicated parameter, whose
every rank holds the same gradient, counts once too.  Every rank of the
mesh computes the same norm.  A pipeline stage's parameters
(``distributed.PipelineParallel`` marks them) hold only their stage's
part of the model: the stage's total, reduced over its own axes first,
is then summed (max-reduced) over the pipeline group, a weight that
several stages share (``SharedLayerDesc``) counted on the first of them
alone, so every stage clips by the norm of the whole model.
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


def _over_shards(params, values, reduce_op="sum"):
    """The sum (or max) of per-parameter ``values`` over the whole of
    every parameter: values grouped by the mesh axes their parameter is
    split over, each group's total reduced over those axes' ranks, in
    one order on every rank; a pipeline stage's total then reduced over
    the pipeline group (the module docstring)."""
    from ..distributed import collective
    from ..distributed.sharding import placement_of

    groups = {}
    stages = None
    for p, v in zip(params, values):
        # (the pipeline group, whether this stage counts the weight)
        pipeline = getattr(p, "_pipeline_norm", None)
        if pipeline is not None:
            stages = pipeline[0]
            if not pipeline[1]:
                continue
        pl = placement_of(p)
        key = () if pl is None or pl.replicated else pl.axes
        groups.setdefault(key, (pl, []))[1].append(v)
    total = None
    for key in sorted(groups):          # one order on every rank
        pl, vals = groups[key]
        acc = vals[0]
        for v in vals[1:]:
            acc = torch.maximum(acc, v) if reduce_op == "max" else acc + v
        if key:
            op = collective.ReduceOp.MAX if reduce_op == "max" \
                else collective.ReduceOp.SUM
            acc = collective.all_reduce(acc.clone(), op,
                                        pl.mesh.group(*key))
        total = acc if total is None else (
            torch.maximum(total, acc) if reduce_op == "max" else total + acc)
    if stages is not None:
        if total is None:
            total = torch.zeros_like(values[0])
        op = collective.ReduceOp.MAX if reduce_op == "max" \
            else collective.ReduceOp.SUM
        total = collective.all_reduce(total.clone(), op, stages)
    return total


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
        pairs = [(p, g) for p, g in params_grads if not _skipped(p, g)]
        if not pairs:
            return None
        return _over_shards([p for p, _ in pairs],
                            [_sq_sum(g) for _, g in pairs]).sqrt()

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
    with_grad = [p for p in parameters if p.grad is not None]
    grads = [p.grad for p in with_grad]
    if not grads:
        return torch.zeros(())
    if norm_type == float("inf"):
        dtype = grads[0].dtype
        for g in grads[1:]:
            dtype = torch.promote_types(dtype, g.dtype)
        total = _over_shards(with_grad, [g.abs().max().to(dtype)
                                         for g in grads], "max")
    else:
        total = _over_shards(with_grad, [g.float().abs().pow(norm_type)
                                         .sum() for g in grads])
        total = total.pow(1.0 / norm_type)
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
