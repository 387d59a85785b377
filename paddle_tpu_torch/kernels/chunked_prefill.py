"""Chunked-prefill attention over the paged pool: CUDA kernel + plain
PyTorch version.

Replaces ``paddle_tpu/kernels/chunked_prefill.py`` ``_chunk_kernel``
(the ``pallas_call`` in ``_pallas_chunked``); the kernel is
``csrc/chunked_prefill.cu``, whose header says what bounds it on the
H100 and how its blocks split the rep*T query rows.  The kernel is
chosen from the operands before the launch (:func:`wgmma_width`): bf16
at any head_dim that is a multiple of 8 up to 256 (any rep, chunk
length, batch and block size) over bf16 or code pools, with q, the pools
and the scales 16-byte aligned, runs the wgmma kernel on its instance of
64, 128 or 256 columns (the columns past head_dim zeros, which costs W /
D of the true products: 1.33x at Phi-3's 96, 1.6x at 80; the instances
are bound by their products on the H100, the 256-column one also by its
shared memory, which takes its keys 32 at a time), whose producer loads
bf16 pages of 8, 16, 32 or a multiple of 64 keys as TMA boxes and copies
every other page size by cp.async (:func:`copy_producer`); every other
shape up to head_dim 256 (head_dims not a multiple of 8, such as 20 or
100), bf16 or f32, the general CUDA-core instance, counted as
``chunked_prefill_general`` for bf16 (f32 keeps ``chunked_prefill``).
head_dim above 256 raises before any launch.  There is no fallback: a
wgmma instance whose tensor maps or launch fail raises.

The caller has rotated q and k (``apply_rope``) and scattered the
chunk's k/v into the pools; padded chunk positions went to the garbage
block 0 and their output rows are discarded by the caller.  Query t of
sequence b sits at ``positions[b] + t`` and sees keys ``k_pos <=
positions[b] + t``.  GQA head ``h = kvh * rep + r``.

Quantized pools (``kv_cache_dtype`` ``"int8"``/``"fp8"``, the
reference's ``kv_dtype`` variant of ``_chunk_kernel``) hold int8 codes
with [nb, bs] f32 row scales, which the caller filled with
``kv_quant.kv_write``; the kernels dequantize as they stage the
pages (f32), or decode the codes to bf16 exactly and apply the scales
per key (bf16; see the source).  Each scheme counts its own launches
(``chunked_prefill_int8``, ``chunked_prefill_fp8``).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, kv_quant

KERNEL = "chunked_prefill"
GENERAL = "chunked_prefill_general"   # bf16 on the general instance
NEG_INF = -1e30
MAX_HEAD_DIM = 256         # csrc/chunked_prefill.cu CP_MAXD
WGMMA_WIDTHS = (64, 128, 256)  # the bf16 wgmma kernel's instances
SMEM_LIMIT = 227 * 1024    # the general instance: a block's opt-in smem
TMA_PAGE_ROWS = 64         # csrc/chunked_prefill.cu CW_PAGE_ROWS


def tma_block_size_ok(bs):
    """csrc/chunked_prefill.cu ``cw_block_size_ok``: the bf16 pages the
    wgmma kernel loads as TMA boxes, those of a multiple of 64 rows or of
    8 to 64 rows that divide 64 (a box is 1024-byte aligned in the
    128-byte swizzle only from 8 rows up), so that a key tile (64 keys,
    32 at 256 columns) is whole boxes of one page's rows."""
    return bs % TMA_PAGE_ROWS == 0 or (bs >= 8 and TMA_PAGE_ROWS % bs == 0)


def copy_producer(bs, kv_cache_dtype=None):
    """Whether the wgmma kernel's producer copies a bf16 pool's rows by
    cp.async into the ring (pages that are not whole TMA boxes: below 8
    rows, or neither a divisor nor a multiple of 64, such as 12); code
    pools take their own producer at any block size."""
    return kv_cache_dtype is None and not tma_block_size_ok(bs)


def wgmma_width(q, k_pool, v_pool, scales=()):
    """The columns of the bf16 wgmma instance these operands go to, or
    None where the general instance takes them: bf16 q at a head_dim D
    that is a multiple of 8, on the instance of 64 (D <= 64), 128 or 256
    columns, over bf16 or code pools of any block size, with q, the pools
    and the scales 16-byte aligned (its 16-byte loads and TMA copies).
    Raises for head_dim above 256, which no kernel takes."""
    D = q.shape[-1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"chunked_attention: head_dim {D} has no kernel "
                         f"(at most {MAX_HEAD_DIM})")
    if not (q.dtype == torch.bfloat16 and D % 8 == 0
            and k_pool.shape[1] > 0
            and all(t.data_ptr() % 16 == 0
                    for t in (q, k_pool, v_pool, *scales))):
        return None
    return next(w for w in WGMMA_WIDTHS if D <= w)


def instance(q, k_pool, v_pool, scales=(), kv_cache_dtype=None):
    """The kernel instance these operands launch, as the launch counter
    tallies it beside the kernel's name: ``w{W}_tma``, ``w{W}_copy`` or
    ``w{W}_codes{16|8}`` for the wgmma kernel of W columns by its
    producer (code pools copy 8 codes at a time where head_dim % 16 ==
    8), ``maxd128`` or ``maxd256`` for the general one."""
    W = wgmma_width(q, k_pool, v_pool, scales)
    D = q.shape[-1]
    if W is None:
        return f"maxd{128 if D <= 128 else MAX_HEAD_DIM}"
    if kv_cache_dtype is not None:
        return f"w{W}_codes{8 if D % 16 else 16}"
    return f"w{W}_{'copy' if copy_producer(k_pool.shape[1]) else 'tma'}"


def chunked_attention_plain(q, k_pool, v_pool, block_table, positions,
                            k_scale=None, v_scale=None, kv_cache_dtype=None,
                            scale=None):
    """The reference's grouped-query chunk attention (``_xla_chunked``
    and its caller's grouping), in f32 with a full masked softmax.
    ``scale`` defaults to 1/sqrt(head_dim)."""
    B, T, H, D = q.shape
    KVH = k_pool.shape[2]
    rep = H // KVH
    RT = rep * T
    bs = k_pool.shape[1]
    L = block_table.shape[1] * bs
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    q_g = q.reshape(B, T, KVH, rep, D).permute(0, 2, 3, 1, 4) \
        .reshape(B, KVH, RT, D).float() * scale
    bt = block_table.long()
    kb = kv_quant.gather_pages(k_pool, k_scale, bt, kv_cache_dtype) \
        .reshape(B, L, KVH, D)
    vb = kv_quant.gather_pages(v_pool, v_scale, bt, kv_cache_dtype) \
        .reshape(B, L, KVH, D)
    scores = torch.einsum("bkrd,blkd->bkrl", q_g, kb)
    k_pos = torch.arange(L, device=q.device)
    q_pos = positions[:, None] + torch.arange(RT, device=q.device) % T
    valid = k_pos[None, None, None, :] <= q_pos[:, None, :, None]
    scores = torch.where(valid, scores, NEG_INF)
    m = scores.amax(-1, keepdim=True)
    pexp = torch.exp(scores - m)
    l = pexp.sum(-1, keepdim=True)
    acc = torch.einsum("bkrl,blkd->bkrd", pexp, vb)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, KVH, rep, T, D).permute(0, 3, 1, 2, 4) \
        .reshape(B, T, H, D).to(q.dtype)


def chunked_attention(q, k_pool, v_pool, block_table, positions,
                      k_scale=None, v_scale=None, kv_cache_dtype=None):
    """Paged attention for one prefill chunk.

    q: [B, T, H, D] ROTATED queries; k_pool/v_pool [nb, bs, KVH, D]
    already holding the chunk's k/v, in q's dtype or as int8 codes of
    ``kv_cache_dtype`` with their [nb, bs] f32 ``k_scale``/``v_scale``;
    block_table [B, nbs] int32; positions [B] int32 chunk-start
    frontiers.  Returns [B, T, H, D] in q's dtype.  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        return chunked_attention_plain(q, k_pool, v_pool, block_table,
                                       positions, k_scale, v_scale,
                                       kv_cache_dtype)
    q = q.contiguous()
    B, T, H, D = q.shape
    nb, bs, KVH, Dk = k_pool.shape
    nbs = block_table.shape[1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"chunked_attention: head_dim {D} has no kernel "
                         f"(at most {MAX_HEAD_DIM})")
    if (Dk != D or H % KVH
            or not kv_quant.pools_fit(q.dtype, k_pool, v_pool, k_scale,
                                      v_scale, kv_cache_dtype)
            or block_table.dtype != torch.int32
            or positions.dtype != torch.int32):
        raise ValueError("chunked_attention: operands do not fit "
                         f"q {tuple(q.shape)} {q.dtype}, pool "
                         f"{tuple(k_pool.shape)} {k_pool.dtype}")
    scales = () if kv_cache_dtype is None else (k_scale, v_scale)
    wgmma = wgmma_width(q, k_pool, v_pool, scales) is not None
    copy = wgmma and copy_producer(bs, kv_cache_dtype)
    if not wgmma:
        smem = _build.bind(KERNEL, "chunked_prefill_smem_bytes",
                           [ctypes.c_int] * 2)(D, bs)
        if smem > SMEM_LIMIT:
            raise ValueError(f"chunked_attention: D={D}, block_size={bs} "
                             f"needs {smem} B of shared memory")
    fn = _build.bind(KERNEL, "chunked_prefill",
                     [ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                     + [ctypes.c_float] + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    general = not wgmma and q.dtype == torch.bfloat16
    name = kv_quant.counter_name(GENERAL if general else KERNEL,
                                 kv_cache_dtype)
    _build.require_cuda(name, q, k_pool, v_pool, block_table, positions,
                        *scales)
    out = torch.empty_like(q)
    p = _build.ptr
    ks, vs = (p(t) for t in scales) if scales else (None, None)
    _build.check(fn(p(q), p(k_pool), p(v_pool), ks, vs, p(block_table),
                    p(positions), p(out), B, T, KVH, H // KVH, D, bs, nb,
                    nbs, 1.0 / math.sqrt(D), _build.dtype_code(q),
                    kv_quant.KV_DTYPE_CODES[kv_cache_dtype], int(wgmma),
                    int(copy), _build.stream_ptr(q)), name)
    _build.launches.add(name, instance(q, k_pool, v_pool, scales,
                                       kv_cache_dtype))
    return out
