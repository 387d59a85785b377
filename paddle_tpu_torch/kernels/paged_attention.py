"""Fused paged-attention decode: CUDA kernel + plain PyTorch version.

Replaces ``paddle_tpu/kernels/paged_attention.py`` ``_decode_kernel``
(the ``pallas_call`` in ``_pallas_partials``) and its
``_combine_splits`` merge; the kernels are ``csrc/paged_attention.cu``,
whose header says what bounds them on the H100 and how the split-K grid
became parallel blocks.

One decode step per sequence of the bucket: the new token's k is
rotated (RoPE at ``positions[b]``) and k/v are scattered into the block
pools by plain PyTorch ops, then :func:`paged_decode_attention` attends
q (rotated and scaled by 1/sqrt(D) inside the kernel) over each
sequence's pages through the block table, masking ``k_pos <=
positions[b]``.  GQA head ``h = kvh * rep + r``.

Unlike the JAX function, which returns new pools, the scatter here
updates the pools IN PLACE (``index_copy_``); :func:`fused_paged_decode`
returns them anyway, so its signature matches the reference's.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

KERNEL = "paged_decode"
LIB = "paged_attention"   # csrc/paged_attention.cu
NEG_INF = -1e30
SMEM_LIMIT = 48 * 1024     # the kernel uses default (non-opt-in) smem


def _rotate_half(x, c, s):
    """Rotate-half RoPE; c/s broadcast against x's last dim (halves)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _scatter_token(pool, new, block_table, positions):
    """Write one token per sequence into its pool slot, in place — the
    reference's index math and column clamp."""
    nb, bs = pool.shape[0], pool.shape[1]
    nbs = block_table.shape[1]
    rows = torch.arange(block_table.shape[0], device=pool.device)
    col = torch.clamp(positions // bs, max=nbs - 1)
    idx = block_table[rows, col].long() * bs + positions % bs
    pool.view(nb * bs, pool.shape[2], pool.shape[3]).index_copy_(
        0, idx, new.to(pool.dtype))
    return pool


def _split_candidates(nbs):
    return [s for s in (1, 2, 4, 8, 16) if s <= nbs and nbs % s == 0]


def _default_splits(nbs):
    """~4-way split-K once the table is deep enough, else fewer (the
    reference's static heuristic)."""
    best = 1
    for s in _split_candidates(nbs):
        if s <= max(1, nbs // 2) and s <= 4:
            best = s
    return best


def _plain_partials(q_rot, k_pool, v_pool, block_table, positions,
                    num_splits):
    """The reference's split-K partials (``_xla_partials``): contiguous
    page ranges per split, full masked softmax per split."""
    B = q_rot.shape[0]
    bs = k_pool.shape[1]
    nbs = block_table.shape[1]
    Lp = (nbs // num_splits) * bs
    bt = block_table.long()
    kb = k_pool[bt].float()                              # [B,nbs,bs,KVH,D]
    vb = v_pool[bt].float()
    kb = kb.reshape(B, num_splits, Lp, kb.shape[3], kb.shape[4])
    vb = vb.reshape(B, num_splits, Lp, vb.shape[3], vb.shape[4])
    scores = torch.einsum("bkrd,bslkd->bskrl", q_rot, kb)
    k_pos = torch.arange(nbs * bs, device=q_rot.device).reshape(
        num_splits, Lp)
    valid = k_pos[None, :, None, None, :] <= \
        positions[:, None, None, None, None]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1)                                  # [B,S,KVH,rep]
    pexp = torch.exp(scores - m[..., None])
    l = pexp.sum(-1)
    acc = torch.einsum("bskrl,bslkd->bskrd", pexp, vb)
    return acc, m, l


def _combine_splits(acc, m, l):
    """Log-sum-exp merge of the per-split partials."""
    m_g = m.amax(1)                                      # [B,KVH,rep]
    w = torch.exp(m - m_g[:, None])                      # [B,S,KVH,rep]
    l_g = (w * l).sum(1)
    out = (w[..., None] * acc).sum(1)
    return out / torch.clamp(l_g, min=1e-30)[..., None]  # [B,KVH,rep,D]


def paged_decode_attention_plain(q, c, s, k_pool, v_pool, block_table,
                                 positions, num_splits):
    B, H, D = q.shape
    KVH = k_pool.shape[2]
    rep = H // KVH
    q_g = q.reshape(B, KVH, rep, D)
    q_rot = _rotate_half(q_g.float(), c[:, None, None, :],
                         s[:, None, None, :]) * (1.0 / math.sqrt(D))
    acc, m, l = _plain_partials(q_rot, k_pool, v_pool, block_table,
                                positions, num_splits)
    return _combine_splits(acc, m, l).reshape(B, H, D).to(q.dtype)


def paged_decode_attention(q, c, s, k_pool, v_pool, block_table, positions,
                           num_splits):
    """Attention of one UNROTATED query token per sequence over the
    paged pools (which already hold the token's k/v).

    q: [B, H, D]; c/s: [B, D/2] RoPE rows at ``positions``; pools
    [nb, bs, KVH, D]; block_table [B, nbs] int32; positions [B] int32.
    Returns [B, H, D] in q's dtype.  CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, c, s, k_pool, v_pool,
                                            block_table, positions,
                                            num_splits)
    B, H, D = q.shape
    nb, bs, KVH, Dk = k_pool.shape
    nbs = block_table.shape[1]
    rep = H // KVH
    if (Dk != D or H % KVH or D % 2 or v_pool.shape != k_pool.shape
            or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype
            or block_table.dtype != torch.int32
            or positions.dtype != torch.int32 or nbs % num_splits):
        raise ValueError("paged_decode_attention: operands do not fit "
                         f"q {tuple(q.shape)} {q.dtype}, pool "
                         f"{tuple(k_pool.shape)} {k_pool.dtype}")
    fn = _build.bind(LIB, "paged_decode",
                     [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    smem = _build.bind(LIB, "paged_decode_smem_bytes",
                       [ctypes.c_int] * 3)(rep, D, bs)
    if smem > SMEM_LIMIT:
        raise ValueError(f"paged_decode_attention: rep={rep}, D={D}, "
                         f"block_size={bs} needs {smem} B of shared memory")
    q = q.contiguous()
    c, s = c.float().contiguous(), s.float().contiguous()
    _build.require_cuda(KERNEL, q, c, s, k_pool, v_pool, block_table,
                        positions)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, num_splits, H, D), **f32)
    m = torch.empty((B, num_splits, H), **f32)
    l = torch.empty((B, num_splits, H), **f32)
    out = torch.empty_like(q)
    p = _build.ptr
    _build.check(fn(p(q), p(c), p(s), p(k_pool), p(v_pool), p(block_table),
                    p(positions), p(acc), p(m), p(l), p(out), B, KVH, rep, D,
                    bs, nbs, num_splits, 1.0 / math.sqrt(D),
                    _build.dtype_code(q), _build.stream_ptr(q)), KERNEL)
    _build.launches.add(KERNEL)
    return out


def fused_paged_decode(q, k_new, v_new, k_pool, v_pool, block_table,
                       positions, cos, sin, *, num_splits=None):
    """One fused decode step of paged attention.

    q: [B, 1, H, D] UNROTATED queries; k_new/v_new: [B, 1, KVH, D]
    unrotated new-token key/value; k_pool/v_pool: [nb, bs, KVH, D];
    block_table: [B, nbs] int32; positions: [B] int32 write frontiers;
    cos/sin: [max_pos, D/2] RoPE tables.  Rotates k_new, scatters k/v
    into the pools in place, then attends.  Returns (attn_out
    [B, 1, H, D], k_pool, v_pool)."""
    B, T, H, D = q.shape
    if T != 1:
        raise ValueError(f"fused_paged_decode is single-token (T == 1), "
                         f"got T == {T}")
    nbs = block_table.shape[1]
    if num_splits is None or nbs % num_splits:
        num_splits = _default_splits(nbs)
    pos = positions.long()
    c, s = cos[pos], sin[pos]                            # [B, half]
    k_rot = _rotate_half(k_new[:, 0].float(), c[:, None, :],
                         s[:, None, :]).to(k_new.dtype)
    _scatter_token(k_pool, k_rot, block_table, pos)
    _scatter_token(v_pool, v_new[:, 0], block_table, pos)
    out = paged_decode_attention(q[:, 0], c, s, k_pool, v_pool, block_table,
                                 positions, num_splits)
    return out.reshape(B, 1, H, D), k_pool, v_pool
