"""Fleet's meta-optimizers (the port of
``paddle_tpu/distributed/fleet/meta_optimizers.py``): optimizer
wrappers that ``fleet.distributed_optimizer`` applies from the
strategy's ``dgc``, ``gradient_merge`` and ``localsgd`` flags.

- :class:`LocalSGDOptimizer`: ``k_steps`` local steps, then the
  parameters averaged over the data-parallel ranks (``begin_step``
  delays the first average: before it every step syncs).  The
  reference runs one controller, where the parameters are replicated
  and the average is the identity, so its local SGD is plain data
  parallelism.  The port runs one process a rank, so it is true local
  SGD: ``distributed_optimizer`` makes the step skip the gradients'
  mean over the data ranks, each rank updates from its own batches, and
  a sync averages the parameters (``collective.mean_rounded_once``).
- :class:`DGCMomentum`: deep gradient compression (momentum correction,
  top-k of the running sum ``v``, the emitted coordinates cleared in
  ``u`` and ``v``, ``rampup_begin_step`` steps of plain momentum first,
  weight decay folded into the gradient).  It sees the gradient the
  step sees, the data ranks' mean, as the reference's does, so it saves
  no communication.  A parameter laid out on a mesh holds its part: the
  threshold is the k-th largest ``|v|`` of the whole parameter (each
  rank's own top k gathered over the parameter's group).
- :class:`GradientMergeOptimizer`: ``k_steps`` gradients summed (and
  with ``avg`` divided by k) before one update of the inner optimizer;
  the sums start again from zero, and the inner optimizer's step count
  counts real updates only.  This is the reference's eager path; its
  traced blend (a ``jnp.where`` over a step that always runs) is JAX's
  own and has no counterpart here.  Under fleet the inner step averages
  over the data ranks, so the mean runs on the apply step alone, over
  the merged sum.

The update rules are plain PyTorch, as the reference's are XLA.
"""
from __future__ import annotations

import numpy as np
import torch

from ...optimizer.optimizer import Momentum, Optimizer, _s

__all__ = ["DGCMomentum", "GradientMergeOptimizer", "LocalSGDOptimizer",
           "dgc_momentum_correction", "dgc_sparsify"]


def _base(opt):
    """The innermost ``Optimizer`` under any wrappers."""
    while not isinstance(opt, Optimizer) and hasattr(opt, "_inner"):
        opt = opt._inner
    return opt


class _Wrapper:
    """Attribute reads fall through to the wrapped optimizer."""

    def __getattr__(self, name):
        if name.startswith("_inner") or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self._inner, name)

    def clear_grad(self, set_to_zero=False):
        self._inner.clear_grad(set_to_zero)

    clear_gradients = clear_grad


class LocalSGDOptimizer(_Wrapper):
    """Steps ``inner``; every ``k_steps`` steps from ``begin_step`` (and
    at every step before it) averages the parameters over ``group``
    (the data-parallel ranks; None or a group of one: no average)."""

    def __init__(self, inner_optimizer, k_steps: int = 1,
                 begin_step: int = 1, group=None):
        self._inner = inner_optimizer
        self.k_steps = max(1, int(k_steps))
        self.begin_step = max(1, int(begin_step))
        self._group = group
        self._step_count = 0

    def step(self):
        self._inner.step()
        self._step_count += 1
        if self._step_count < self.begin_step:
            sync = True
        else:
            sync = (self._step_count - self.begin_step) % self.k_steps == 0
        if sync:
            self._average_parameters()

    @torch.no_grad()
    def _average_parameters(self):
        from .. import collective

        g = self._group
        if g is None or g.nranks == 1:
            return
        for p in _base(self._inner)._parameter_list:
            collective.mean_rounded_once(p.data, g)


def dgc_sparsify(g, err, k):
    """Top-k magnitude selection with error feedback: ``(sparse,
    residual)`` of ``g + err`` in f32, the k largest entries kept (ties
    at the threshold kept too)."""
    corrected = g.float() + err
    flat = corrected.abs().reshape(-1)
    if k >= flat.numel():
        return corrected, torch.zeros_like(corrected)
    thresh = torch.topk(flat, k).values[-1]
    sparse = torch.where(corrected.abs() >= thresh, corrected,
                         torch.zeros_like(corrected))
    return sparse, corrected - sparse


def _kth_largest(a, k, group):
    """The k-th largest entry of the whole of ``a`` (a 1-d tensor), each
    rank of ``group`` holding an equal part: each rank's own top
    ``min(k, part)`` gathered, then the k-th largest of those (each of
    the whole's top k is among its own rank's)."""
    from .. import collective

    local = torch.topk(a, min(k, a.numel())).values
    if group is not None and group.nranks > 1:
        local = torch.cat(collective.all_gather(None, local.contiguous(),
                                                group=group))
    return torch.topk(local, k).values[-1]


def dgc_momentum_correction(g, u, v, mu, k, group=None, size=None):
    """DGC with momentum correction (Lin et al. 2018, section 3.2): ``u =
    mu * u + g`` (one fused multiply-add, as XLA compiles the reference's
    jitted rule), ``v = v + u``; the entries of ``v`` at or above the
    k-th largest ``|v|`` are emitted and cleared in ``u`` and ``v``.
    ``u`` and ``v`` are updated in place; returns the emitted (dense,
    mostly zero) f32 tensor.  ``group`` and ``size``: ``g`` is a part of
    a parameter of ``size`` entries split over ``group``."""
    gf = g.float()
    torch.add(gf, u, alpha=_s(mu), out=u)
    v.add_(u)
    size = v.numel() if size is None else size
    if k >= size:
        sparse = v.clone()
        u.zero_()
        v.zero_()
        return sparse
    mag = v.abs()
    mask = mag >= _kth_largest(mag.reshape(-1), k, group)
    zero = torch.zeros_like(v)
    sparse = torch.where(mask, v, zero)
    u.copy_(torch.where(mask, zero, u))
    v.copy_(torch.where(mask, zero, v))
    return sparse


class DGCMomentum(Momentum):
    """Momentum with deep gradient compression (the reference's
    ``DGCMomentum``).  For the first ``rampup_begin_step`` steps it is
    ``Momentum``; then each parameter's gradient (plus ``weight_decay``
    times the parameter, in f32) goes through
    :func:`dgc_momentum_correction` with ``k = max(1, int(size * (1 -
    sparsity)))`` of the whole parameter's size, and the emitted tensor
    is applied as a plain SGD step (``p - lr * sparse`` in f32, rounded
    once to the parameter's dtype).  ``sparsity`` 0 or 1 leaves it
    ``Momentum``."""

    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 sparsity=0.999, rampup_begin_step=0, weight_decay=None,
                 grad_clip=None, name=None, **kwargs):
        super().__init__(learning_rate, momentum, parameters,
                         weight_decay=weight_decay, grad_clip=grad_clip,
                         name=name, **kwargs)
        self.sparsity = float(sparsity)
        self.rampup_begin_step = int(rampup_begin_step)
        self._dgc_step = 0

    def step(self):
        self._dgc_step += 1       # optimizer steps, not parameter updates
        super().step()

    def _update_param(self, p, g, lr):
        if not (self._dgc_step > self.rampup_begin_step
                and 0.0 < self.sparsity < 1.0):
            return super()._update_param(p, g, lr)
        u = self._add_accumulator("dgc_u", p, dtype=torch.float32)
        v = self._add_accumulator("dgc_v", p, dtype=torch.float32)
        if self._weight_decay:
            g = g.float() + p.float() * _s(self._weight_decay)
        pl = getattr(p, "placement", None)
        split = pl is not None and not pl.replicated
        size = int(np.prod(pl.full_shape)) if split else p.numel()
        group = pl.mesh.group(*pl.axes) if split else None
        k = max(1, int(size * (1.0 - self.sparsity)))
        sparse = dgc_momentum_correction(g, u, v, self._momentum, k, group,
                                         size)
        p.copy_(p.float() - sparse * _s(lr))


class GradientMergeOptimizer(_Wrapper):
    """``k_steps``-step gradient accumulation before one real update of
    ``inner`` (the module docstring).  A parameter with a gradient in
    any of the k microsteps gets its merged gradient on the apply step,
    whether or not it has one there; after the first apply every merged
    parameter keeps an entry (zero-filled, not dropped), so it takes an
    update (a zero gradient) at every later apply, as in the
    reference."""

    def __init__(self, inner_optimizer, k_steps: int = 2, avg: bool = True):
        self._inner = inner_optimizer
        self.k_steps = max(1, int(k_steps))
        self.avg = avg
        self._merged = {}          # id(param) -> the running sum
        self._calls = 0

    @torch.no_grad()
    def step(self):
        inner = self._inner
        if self.k_steps == 1:
            return inner.step()
        params = _base(inner)._parameter_list
        for p in params:
            if p.grad is not None:
                acc = self._merged.get(id(p))
                self._merged[id(p)] = p.grad.clone() if acc is None \
                    else acc.add_(p.grad)
        self._calls += 1
        if self._calls % self.k_steps:
            return None
        denom = float(self.k_steps) if self.avg else 1.0
        for p in params:
            acc = self._merged.get(id(p))
            if acc is not None:
                p.grad = acc / denom if denom != 1.0 else acc.clone()
        out = inner.step()
        for acc in self._merged.values():
            acc.zero_()
        return out
