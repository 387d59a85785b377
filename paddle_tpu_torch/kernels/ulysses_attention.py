"""Ulysses (DeepSpeed-Ulysses) sequence parallelism by all-to-all (the
port of ``paddle_tpu/kernels/ulysses_attention.py``).

A rank holds q, k and v of its T/sp positions with all of its heads
([B, T/sp, H, D]).  One all-to-all over the ``sp`` group turns each into
the whole sequence of 1/sp of the heads ([B, T, H/sp, D]: the heads
split into sp contiguous groups, group j to rank j, so a rank's query
heads read the kv heads of their own group), attention runs on those
(:func:`_plain_attention`: the flash kernels on the card, the f32
reference on the CPU), and the inverse all-to-all gives the rank its
positions back with every head.  Each all-to-all is an autograd
Function whose backward is the inverse all-to-all
(``distributed.collective.alltoall_single``; gloo runs it on CUDA
tensors without staging).

With tensor parallelism the rank's tensors already hold its tp part of
the heads (``head_axis``, the JAX signature's): the all-to-all runs
over the ``sp`` group with those.  When the local kv heads do not
divide by sp (the tiny config's 2 kv heads at sp = 4), it is ring
attention (``kernels.ring_attention``), as in the JAX function.
Without an ``sp`` group of more than one rank it is
:func:`_plain_attention` of the whole sequence.
"""
from __future__ import annotations

import math

import torch

from .flash_attention import flash_attention_bthd
from .ring_attention import _group_of, ring_attention

__all__ = ["ulysses_attention"]


def _plain_attention(q, k, v, causal, scale):
    """q [B, T, H, D] over k/v [B, T, KVH, D] (the whole sequence, local
    heads; KVH divides H): the flash kernels for CUDA tensors; for CPU
    ones the JAX function's f32 reference (causal top-left, as Tq =
    Tk), its output in q's dtype."""
    if q.is_cuda:
        return flash_attention_bthd(q, k, v, causal, scale)
    rep = q.shape[2] // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        tq, tk = s.shape[-2], s.shape[-1]
        mask = torch.ones((tq, tk), dtype=torch.bool,
                          device=s.device).tril()
        s = torch.where(mask, s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p, v.float()).to(q.dtype)


def _seq_to_heads(x, group):
    """[B, T/n, H, D] -> [B, T, H/n, D]: head group j of this rank's
    positions to rank j, every rank's positions of this rank's head
    group back, in sequence order."""
    n = group.nranks
    B, T, H, D = x.shape
    parts = x.reshape(B, T, n, H // n, D).permute(2, 0, 1, 3, 4)
    from ..distributed.collective import alltoall_single

    got = alltoall_single(parts.contiguous(), group=group)
    return got.permute(1, 0, 2, 3, 4).reshape(B, n * T, H // n, D)


def _heads_to_seq(x, group):
    """The inverse of :func:`_seq_to_heads`: [B, T, H/n, D] -> [B, T/n,
    H, D]."""
    n = group.nranks
    B, T, Hn, D = x.shape
    parts = x.reshape(B, n, T // n, Hn, D).permute(1, 0, 2, 3, 4)
    from ..distributed.collective import alltoall_single

    got = alltoall_single(parts.contiguous(), group=group)
    return got.permute(1, 2, 0, 3, 4).reshape(B, T // n, n * Hn, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g, ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _heads_to_seq(x, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g, ctx.group), None


def ulysses_attention(q, k, v, mesh=None, axis_name="sp", causal=False,
                      scale=None, batch_axis=None, head_axis=None,
                      group=None):
    """Exact attention of this rank's q [B, T/sp, H, D] over the keys of
    every rank of the ``sp`` group, k/v [B, T/sp, KVH, D]; returns this
    rank's [B, T/sp, H, D] (module docstring).  The group is ``group``,
    or ``mesh``'s (default the active mesh's) ``axis_name`` group.
    ``batch_axis`` and ``head_axis`` are the JAX signature's: a rank's
    tensors already hold its batch rows and its tp heads.
    Differentiable in q, k and v."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = _group_of(mesh, axis_name, group)
    if group is None:
        return _plain_attention(q, k, v, causal, scale)
    if k.shape[2] % group.nranks:
        return ring_attention(q, k, v, causal=causal, scale=scale,
                              group=group)
    qh, kh, vh = (_SeqToHeads.apply(t, group) for t in (q, k, v))
    return _HeadsToSeq.apply(_plain_attention(qh, kh, vh, causal, scale),
                             group)
