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

Quantized pools (``kv_cache_dtype`` ``"int8"``/``"fp8"``, the
reference's ``kv_dtype`` variant of ``_decode_kernel``) hold int8 codes
with a [nb, bs] f32 scale per side: the new token is quantized as it is
written (``kv_quant.quantize_scatter``, one launch for k and v) and the
kernel dequantizes each row in registers.  Each scheme counts its own
launches (``paged_decode_int8``, ``paged_decode_fp8``).

Which CUDA kernel runs follows q's type.  bf16 q takes
``paged_decode_hopper``, one launch whose blocks split each sequence's
live keys into chunks of ``CHUNK_KEYS`` (:func:`decode_plan` sizes the
grid and the scratch) and whose last block per (sequence, kv head)
merges their shares; it reads bf16 or f32 cos/sin as given, and
refuses operands outside its shapes (:func:`hopper_path`).  f32, which
only the tests serve, takes ``paged_decode_partials`` with
``num_splits`` splits and a combine kernel.  Both agree with the plain
version up to the order of f32 sums (and the Hopper kernel's exp2).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, kv_quant

KERNEL = "paged_decode"
LIB = "paged_attention"   # csrc/paged_attention.cu
NEG_INF = -1e30
SMEM_LIMIT = 48 * 1024     # paged_decode_partials: default smem
CHUNK_KEYS = 64            # csrc/paged_attention.cu PF_CHUNK
HOPPER_REPS = (1, 2, 4, 8)
HOPPER_DIMS = (64, 128)
BLOCKS_PER_SM = 3          # csrc/paged_attention.cu PF_MIN_BLOCKS
MAX_SPLITS = 64            # csrc/paged_attention.cu PF_MAX_SPLITS


def _rotate_half(x, c, s):
    """Rotate-half RoPE; c/s broadcast against x's last dim (halves)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _token_rows(block_table, positions, bs):
    """Flat pool row of each sequence's token at ``positions`` [B] (int64):
    the reference's index math and column clamp."""
    nbs = block_table.shape[1]
    rows = torch.arange(block_table.shape[0], device=block_table.device)
    col = torch.clamp(positions // bs, max=nbs - 1)
    return block_table[rows, col].long() * bs + positions % bs


def _scatter_token(pool, new, block_table, positions):
    """Write one token per sequence into its pool slot, in place."""
    nb, bs = pool.shape[0], pool.shape[1]
    idx = _token_rows(block_table, positions, bs)
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


def decode_plan(B, KVH, nbs, bs, sm_count):
    """Splits of ``paged_decode_hopper``: how many blocks share one
    (sequence, kv head)'s live keys.  Enough for BLOCKS_PER_SM blocks a
    SM, as many as its registers let reside at once, so that the live
    blocks run in one wave when every sequence is long; no more than a
    full table has chunks of CHUNK_KEYS, nor MAX_SPLITS (the last
    block's merge keeps a weight of each in shared memory).  The
    kernel's own partition follows each sequence's frontier (block s
    takes the s-th run of ceil(chunks / S) chunks), so the scratch of
    [B, S, H, D] partials is an upper bound known
    without a host sync."""
    max_chunks = -(-nbs * bs // CHUNK_KEYS)
    want = -(-BLOCKS_PER_SM * sm_count // max(1, B * KVH))
    return max(1, min(max_chunks, want, MAX_SPLITS))


def hopper_path(q, k_pool, v_pool, rep):
    """Whether these operands go to ``paged_decode_hopper``: True for bf16
    q, False for f32 (the general kernel).  bf16 operands it does not
    take raise ValueError: rep and D it is not built for, a block size
    that is not a power of two (its row index is a shift and a mask),
    pools not 16-byte aligned (its row loads)."""
    if q.dtype != torch.bfloat16:
        return False
    bs = k_pool.shape[1]
    if not (rep in HOPPER_REPS and q.shape[-1] in HOPPER_DIMS and bs > 0
            and bs & (bs - 1) == 0 and k_pool.data_ptr() % 16 == 0
            and v_pool.data_ptr() % 16 == 0):
        raise ValueError(
            f"paged_decode_attention: the bf16 kernel takes rep in "
            f"{HOPPER_REPS}, D in {HOPPER_DIMS}, a power-of-two block size "
            f"and 16-byte aligned pools; got rep={rep}, D={q.shape[-1]}, "
            f"block_size={bs}")
    return True


def _plain_partials(q_rot, k_pool, v_pool, block_table, positions,
                    num_splits, k_scale=None, v_scale=None,
                    kv_cache_dtype=None):
    """The reference's split-K partials (``_xla_partials``): contiguous
    page ranges per split, full masked softmax per split."""
    B = q_rot.shape[0]
    bs = k_pool.shape[1]
    nbs = block_table.shape[1]
    Lp = (nbs // num_splits) * bs
    bt = block_table.long()
    kb = kv_quant.gather_pages(k_pool, k_scale, bt, kv_cache_dtype)
    vb = kv_quant.gather_pages(v_pool, v_scale, bt, kv_cache_dtype)
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
                                 positions, num_splits, k_scale=None,
                                 v_scale=None, kv_cache_dtype=None):
    B, H, D = q.shape
    KVH = k_pool.shape[2]
    rep = H // KVH
    q_g = q.reshape(B, KVH, rep, D)
    q_rot = _rotate_half(q_g.float(), c[:, None, None, :],
                         s[:, None, None, :]) * (1.0 / math.sqrt(D))
    acc, m, l = _plain_partials(q_rot, k_pool, v_pool, block_table,
                                positions, num_splits, k_scale, v_scale,
                                kv_cache_dtype)
    return _combine_splits(acc, m, l).reshape(B, H, D).to(q.dtype)


def paged_decode_attention(q, c, s, k_pool, v_pool, block_table, positions,
                           num_splits, k_scale=None, v_scale=None,
                           kv_cache_dtype=None):
    """Attention of one UNROTATED query token per sequence over the
    paged pools (which already hold the token's k/v).

    q: [B, H, D]; c/s: [B, D/2] RoPE rows at ``positions``; pools
    [nb, bs, KVH, D] in q's dtype, or int8 codes of ``kv_cache_dtype``
    with their [nb, bs] f32 ``k_scale``/``v_scale``; block_table [B, nbs]
    int32; positions [B] int32.  Returns [B, H, D] in q's dtype.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, c, s, k_pool, v_pool,
                                            block_table, positions,
                                            num_splits, k_scale, v_scale,
                                            kv_cache_dtype)
    B, H, D = q.shape
    nb, bs, KVH, Dk = k_pool.shape
    nbs = block_table.shape[1]
    rep = H // KVH
    if (Dk != D or H % KVH or D % 2
            or not kv_quant.pools_fit(q.dtype, k_pool, v_pool, k_scale,
                                      v_scale, kv_cache_dtype)
            or block_table.dtype != torch.int32
            or positions.dtype != torch.int32 or nbs % num_splits):
        raise ValueError("paged_decode_attention: operands do not fit "
                         f"q {tuple(q.shape)} {q.dtype}, pool "
                         f"{tuple(k_pool.shape)} {k_pool.dtype}")
    fn = _build.bind(LIB, "paged_decode",
                     [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7
                     + [ctypes.c_float] + [ctypes.c_int] * 3
                     + [ctypes.c_void_p])
    hopper = hopper_path(q, k_pool, v_pool, rep)
    if hopper:
        splits = decode_plan(B, KVH, nbs, bs, _build.sm_count(q.device))
    else:
        splits = num_splits
        smem = _build.bind(LIB, "paged_decode_smem_bytes",
                           [ctypes.c_int] * 3)(rep, D, bs)
        if smem > SMEM_LIMIT:
            raise ValueError(f"paged_decode_attention: rep={rep}, D={D}, "
                             f"block_size={bs} needs {smem} B of shared "
                             "memory")
    name = kv_quant.counter_name(KERNEL, kv_cache_dtype)
    q = q.contiguous()
    if not (hopper and c.dtype == s.dtype == torch.bfloat16):
        c, s = c.float(), s.float()
    c, s = c.contiguous(), s.contiguous()
    scales = () if kv_cache_dtype is None else (k_scale, v_scale)
    _build.require_cuda(name, q, c, s, k_pool, v_pool, block_table,
                        positions, *scales)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, splits, H, D), **f32)
    m = torch.empty((B, splits, H), **f32)
    l = torch.empty((B, splits, H), **f32)
    out = torch.empty_like(q)
    p = _build.ptr
    ks, vs = (p(t) for t in scales) if scales else (None, None)
    tickets = p(_tickets(q.device, B * KVH)) if hopper else None
    _build.check(fn(p(q), p(c), p(s), p(k_pool), p(v_pool), ks, vs,
                    p(block_table), p(positions), p(acc), p(m), p(l),
                    tickets, p(out), B, KVH, rep, D, bs, nbs, splits,
                    1.0 / math.sqrt(D), _build.dtype_code(q),
                    _build.dtype_code(c),
                    kv_quant.KV_DTYPE_CODES[kv_cache_dtype],
                    _build.stream_ptr(q)), name)
    _build.launches.add(name)
    return out


def fused_paged_decode(q, k_new, v_new, k_pool, v_pool, block_table,
                       positions, cos, sin, *, num_splits=None,
                       k_scale=None, v_scale=None, kv_cache_dtype=None):
    """One fused decode step of paged attention.

    q: [B, 1, H, D] UNROTATED queries; k_new/v_new: [B, 1, KVH, D]
    unrotated new-token key/value; k_pool/v_pool: [nb, bs, KVH, D];
    block_table: [B, nbs] int32; positions: [B] int32 write frontiers;
    cos/sin: [max_pos, D/2] RoPE tables.  Rotates k_new (in f32, rounded
    to its dtype), scatters k/v into the pools in place, then attends.
    Returns (attn_out [B, 1, H, D], k_pool, v_pool).

    With ``kv_cache_dtype`` the pools hold int8 codes and
    ``k_scale``/``v_scale`` their [nb, bs] f32 row scales: the token is
    quantized at write (pools and scales updated in place) and the
    return grows to (attn_out, k_pool, v_pool, k_scale, v_scale)."""
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
    if kv_cache_dtype is None:
        _scatter_token(k_pool, k_rot, block_table, pos)
        _scatter_token(v_pool, v_new[:, 0], block_table, pos)
    else:
        kv_quant.quantize_scatter(
            k_pool, v_pool, k_scale, v_scale, k_rot, v_new[:, 0],
            _token_rows(block_table, pos, k_pool.shape[1]), kv_cache_dtype)
    out = paged_decode_attention(q[:, 0], c, s, k_pool, v_pool, block_table,
                                 positions, num_splits, k_scale, v_scale,
                                 kv_cache_dtype)
    out = out.reshape(B, 1, H, D)
    if kv_cache_dtype is None:
        return out, k_pool, v_pool
    return out, k_pool, v_pool, k_scale, v_scale


_ticket_buffers: dict = {}


def _tickets(device, n):
    """The int32 tickets of ``paged_decode_hopper``, one per (sequence, kv
    head), at least ``n``, one buffer per device and stream.  Zero when
    made; each launch leaves them at zero again (the last block of a
    (sequence, kv head) resets its own), so the launches of one stream,
    which run one after another, share them; launches on two streams at
    once would mix their tickets, hence a buffer each."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _ticket_buffers.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _ticket_buffers[key] = buf
    return buf
