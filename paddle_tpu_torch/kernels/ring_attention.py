"""Ring attention: exact attention over a sequence split across the
ranks of an ``sp`` group (the port of
``paddle_tpu/kernels/ring_attention.py``).

Each rank holds q, k and v of its own T/sp positions (the port's SPMD
idiom: a rank's tensors are its part, not global arrays).  Step i of the
ring, on rank r, holds the k/v block of rank ``src = (r - i) % sp`` and
rotates it one hop to rank r + 1 afterwards
(``distributed.collective.ring_exchange``; gloo stages it through
pinned host memory).  Only the [B, T/sp, KVH, D] block travels: the
kernels take KVH dividing H, so grouped-query attention stays native.

- :func:`ring_attention` (:class:`_RingAttention`) runs the flash
  kernels once per held block (``kernels.flash_attention``'s forward
  with the LSE): the diagonal block (``src == r``) causal with Tq = Tk,
  earlier blocks (``src < r``) not causal, later ones skipped and not
  launched (causal); each block's output is written in f32
  (``out_f32``) and merged by the LSEs in f32, then rounded once.  The
  backward recomputes nothing of the forward: for each held block the
  dQ and dK/dV kernels with the GLOBAL LSE and ``delta = rowsum(dO *
  O)`` of the merged, rounded output, dQ summed in f32 on the rank, the
  dK/dV f32 accumulators travelling around the ring with their block
  and reaching its owner after sp hops.  CPU tensors run the same loop
  over the flash kernels' plain versions, so the CPU tests hold this
  loop, its merge and its backward against the JAX ring.
- Without an ``sp`` group of more than one rank, it is the dense
  attention (``flash_attention_bthd``), as the JAX function falls back
  when the mesh has no ``sp`` axis.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import _bwd, _delta, _fwd, flash_attention_bthd

__all__ = ["ring_attention"]


def _group_of(mesh, axis_name, group):
    """The ``sp`` group: ``group``, else ``mesh``'s (or the active
    mesh's) ``axis_name`` group; None without one of more than one
    rank."""
    if group is None:
        from ..distributed.mesh import _active_mesh

        mesh = mesh or _active_mesh()
        if mesh is None or axis_name not in mesh.shape:
            return None
        group = mesh.group(axis_name)
    return group if group.nranks > 1 else None


def _merge(o, lse, oi, li):
    """Two attention results over disjoint key sets, each normalized
    over its own keys with its LSE, as one: f32 [B, H, Tq, D] and
    [B, H, Tq]."""
    if o is None:
        return oi, li
    new = torch.logaddexp(lse, li)
    return (o * torch.exp(lse - new)[..., None]
            + oi * torch.exp(li - new)[..., None]), new


def _held_blocks(group, causal):
    """``(step, diag)`` of each step of the ring on this rank, which
    holds the block of rank ``src``: ``diag`` whether that block takes
    the causal mask (the diagonal); None for a block wholly above the
    diagonal (skipped)."""
    n, rank = group.nranks, group.rank
    for i in range(n):
        src = (rank - i) % n
        diag = causal and src == rank
        yield i, None if causal and src > rank else diag


def _ring_forward(q, k, v, group, causal, scale):
    """(out [B, T, H, D] in q's dtype, the f32 LSE [B, H, T]) of this
    rank's queries over every rank's keys (module docstring)."""
    from ..distributed.collective import ring_exchange

    qh = q.transpose(1, 2)
    kc, vc = k, v
    o = lse = None
    for i, diag in _held_blocks(group, causal):
        if diag is not None:
            oi, li = _fwd(qh, kc.transpose(1, 2), vc.transpose(1, 2), diag,
                          scale, True, out_f32=True)
            o, lse = _merge(o, lse, oi, li)
        if i < group.nranks - 1:
            kc, vc = ring_exchange([kc, vc], group)
    return o.to(q.dtype).transpose(1, 2), lse


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        out, lse = _ring_forward(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        from ..distributed.collective import ring_exchange

        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        qh, doh = q.transpose(1, 2), do.transpose(1, 2)
        delta = _delta(out.transpose(1, 2), doh)
        dq = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        dkc = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dvc = torch.zeros_like(dkc)
        for i, diag in _held_blocks(group, ctx.causal):
            if diag is not None:
                dqi, dki, dvi = _bwd(qh, kc.transpose(1, 2),
                                     vc.transpose(1, 2), doh, lse, delta,
                                     diag, ctx.scale, out_f32=True)
                dq += dqi
                dkc += dki.transpose(1, 2)
                dvc += dvi.transpose(1, 2)
            # the accumulators go with their block; after the last step
            # one more hop brings each home
            if i < group.nranks - 1:
                kc, vc, dkc, dvc = ring_exchange([kc, vc, dkc, dvc], group)
            else:
                dkc, dvc = ring_exchange([dkc, dvc], group)
        return (dq.to(q.dtype).transpose(1, 2), dkc.to(k.dtype),
                dvc.to(v.dtype), None, None, None)


def ring_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                   scale=None, batch_axis=None, group=None):
    """Exact attention of this rank's q [B, T/sp, H, D] over the keys of
    every rank of the ``sp`` group, k/v [B, T/sp, KVH, D] (KVH dividing
    H); returns this rank's [B, T/sp, H, D].  The group is ``group``, or
    ``mesh``'s (default the active mesh's) ``axis_name`` group; without
    one of more than one rank, dense attention.  ``batch_axis`` is the
    JAX signature's: a rank's tensors already hold its batch rows.
    Differentiable in q, k and v (module docstring)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = _group_of(mesh, axis_name, group)
    if group is None:
        return flash_attention_bthd(q, k, v, causal, scale)
    if k.shape[2] == 0 or q.shape[2] % k.shape[2] or v.shape != k.shape:
        raise ValueError(f"ring_attention: q {tuple(q.shape)} does not fit "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _RingAttention.apply(q, k, v, group, causal, scale)
    return _ring_forward(q, k, v, group, causal, scale)[0]
