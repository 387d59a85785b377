"""A sequence split over the ranks of an ``sp`` group: the model side of
sequence and context parallelism (``LlamaConfig.sequence_parallel``,
``LlamaConfig.context_parallel``).

The JAX package keeps one global [B, T, ...] array and lets
``shard_map`` split it; the port runs one process a rank, so a rank
holds only its T/sp positions, ``rank * T/sp`` onwards
(:class:`SequenceShards`), from the embedding to the loss:

- RoPE rotates the rank's positions (``SequenceShards.offset``);
- attention sees every earlier key through ring or Ulysses attention
  (``kernels.ring_attention``, ``kernels.ulysses_attention``), or,
  with ``sequence_parallel`` alone, through k and v gathered over the
  group (:func:`gathered_kv_attention`: the rank's queries against the
  first ``(rank + 1) * T/sp`` keys, causal with Tq < Tk, bottom-right
  aligned; dK/dV go back by a reduce-scatter);
- the next-token loss pairs a rank's last position with the first label
  of the next rank (:func:`next_token_pairs`) and divides by the count
  of predicted tokens over the whole sequence, so a rank's loss is its
  share of the global mean and the shares (and their gradients) SUM
  over the group.

:func:`sequence_shards` is None, and the model dense, when the active
mesh has no ``sp`` axis of more than one rank or the config asks for
neither option; a mesh with ``sp`` and a model with neither stays
replicated over ``sp``, as in the JAX package.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import collective
from .mesh import sequence_group

__all__ = ["SequenceShards", "gathered_kv_attention", "next_token_pairs",
           "sequence_part", "sequence_shards", "uses_sequence_parallel"]


def uses_sequence_parallel(config) -> bool:
    """Whether ``config`` splits its sequence over an ``sp`` axis when
    the mesh has one (either option set)."""
    return bool(getattr(config, "context_parallel", "")
                or getattr(config, "sequence_parallel", False))


class SequenceShards:
    """This rank's part of a sequence split evenly over ``group``:
    ``local`` positions from ``offset = rank * local`` of ``total``."""

    def __init__(self, group: "collective.Group", local: int):
        self.group = group
        self.n = group.nranks
        self.rank = group.rank
        self.local = int(local)
        self.offset = self.rank * self.local
        self.total = self.n * self.local

    @property
    def last(self) -> bool:
        return self.rank == self.n - 1

    def next_labels(self, labels):
        """The first label [B, 1] of the next rank's part (every rank
        takes part in the gather), None on the last rank: its last
        position predicts nothing."""
        parts = collective.all_gather(None, labels[:, :1].contiguous(),
                                      group=self.group)
        return None if self.last else parts[self.rank + 1]


def sequence_shards(config, local: int, mesh=None
                    ) -> Optional[SequenceShards]:
    """The split of a sequence whose rank part is ``local`` positions
    long, for a model of ``config`` on ``mesh`` (default the active
    one), or None where the model runs dense (module docstring)."""
    if not uses_sequence_parallel(config):
        return None
    group = sequence_group(mesh)
    if group is None or group.nranks == 1:
        return None
    return SequenceShards(group, local)


def sequence_part(t, group, dim: int = 1):
    """This rank's part of ``t`` along ``dim`` (the sequence of a [B, T,
    ...] leaf), split evenly over ``group``; raises if it does not
    divide."""
    n = group.nranks
    if t.shape[dim] % n:
        raise ValueError(f"a sequence of {t.shape[dim]} positions does not "
                         f"split over {n} sp ranks")
    size = t.shape[dim] // n
    return t.narrow(dim, group.rank * size, size)


def next_token_pairs(x, labels, seq: Optional[SequenceShards] = None):
    """``(rows, next_labels, count)`` of the next-token loss: the rows of
    x [B, T, ...] that predict a token, the label each predicts, and the
    count of predicted tokens over the whole sequence, by which the
    summed loss is divided.  Dense: ``x[:, :-1]`` against ``labels[:,
    1:]``, B (T - 1) of them.  On a rank of ``seq``: every position, the
    last against the next rank's first label; the last rank's last
    position predicts nothing; the count is B (total - 1)."""
    B = labels.shape[0]
    if seq is None:
        return x[:, :-1], labels[:, 1:], B * (labels.shape[1] - 1)
    count = B * (seq.total - 1)
    nxt = seq.next_labels(labels)
    if nxt is None:
        return x[:, :-1], labels[:, 1:], count
    return x, torch.cat([labels[:, 1:], nxt], dim=1), count


def _gather(t, seq: SequenceShards):
    """Every rank's part of t [B, T/sp, ...] along dim 1, in order."""
    return torch.cat(collective.all_gather(None, t.contiguous(),
                                           group=seq.group), dim=1)


class _GatheredKV(torch.autograd.Function):
    """Causal attention of this rank's queries over k and v gathered
    from every rank of the group, of which the first ``(rank + 1) *
    local`` keys are visible: the flash kernels with Tq < Tk (the mask
    bottom-right aligned, so query t sees the keys up to its global
    position ``offset + t``).  The backward writes dK and dV in f32 over
    the visible keys, zeros past them, and reduce-scatters the sum to
    each key's rank, rounded once to k's dtype."""

    @staticmethod
    def forward(ctx, q, k, v, seq, scale):
        from ..kernels import flash_attention as fa

        vis = seq.offset + seq.local
        kv = _gather(k, seq)[:, :vis].contiguous()
        vv = _gather(v, seq)[:, :vis].contiguous()
        qh, kh, vh = (t.transpose(1, 2) for t in (q, kv, vv))
        o, lse = fa._fwd(qh, kh, vh, True, scale, with_lse=True)
        ctx.save_for_backward(qh, kh, vh, o, lse)
        ctx.seq, ctx.scale = seq, scale
        ctx.kdtype = k.dtype
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, do):
        from ..kernels import flash_attention as fa

        qh, kh, vh, o, lse = ctx.saved_tensors
        seq = ctx.seq
        doh = do.transpose(1, 2)
        dq, dk, dv = fa._bwd(qh, kh, vh, doh, lse, fa._delta(o, doh), True,
                             ctx.scale, out_f32=True)
        out = []
        for d in (dk, dv):
            B, KVH, vis, D = d.shape
            full = d.new_zeros((B, seq.total, KVH, D))
            full[:, :vis] = d.transpose(1, 2)
            part = full.new_empty((B, seq.local, KVH, D))
            collective.reduce_scatter(
                part, [p.contiguous() for p in full.split(seq.local, 1)],
                group=seq.group)
            out.append(part.to(ctx.kdtype))
        return dq.to(qh.dtype).transpose(1, 2), out[0], out[1], None, None


def gathered_kv_attention(q, k, v, seq: SequenceShards, scale=None):
    """Causal attention of q [B, T/sp, H, D] (this rank's positions) over
    every earlier key of the sequence, k/v [B, T/sp, KVH, D] gathered
    over ``seq.group`` (:class:`_GatheredKV`); without grad, the forward
    kernel alone over the gathered keys."""
    from ..kernels.flash_attention import flash_attention_bthd

    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _GatheredKV.apply(q, k, v, seq, scale)
    vis = seq.offset + seq.local
    return flash_attention_bthd(q, _gather(k, seq)[:, :vis],
                                _gather(v, seq)[:, :vis], True, scale)
