"""Chunked-prefill attention over the paged pool: CUDA kernel + plain
PyTorch version.

Replaces ``paddle_tpu/kernels/chunked_prefill.py`` ``_chunk_kernel``
(the ``pallas_call`` in ``_pallas_chunked``); the kernel is
``csrc/chunked_prefill.cu``, whose header says what bounds it on the
H100 and how its blocks split the rep*T query rows: bf16 runs on the
tensor cores (head_dim 64 or 128), f32 on the CUDA cores.

The caller has rotated q and k (``apply_rope``) and scattered the
chunk's k/v into the pools; padded chunk positions went to the garbage
block 0 and their output rows are discarded by the caller.  Query t of
sequence b sits at ``positions[b] + t`` and sees keys ``k_pos <=
positions[b] + t``.  GQA head ``h = kvh * rep + r``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

KERNEL = "chunked_prefill"
NEG_INF = -1e30
MAX_HEAD_DIM = 128         # csrc/chunked_prefill.cu CP_MAXD (f32 kernel)
COL_PARTS = 4              # csrc/chunked_prefill.cu CP_PARTS (f32 kernel)
BF16_HEAD_DIMS = (64, 128)  # the bf16 tensor-core kernel's instances
SMEM_LIMIT = 48 * 1024


def chunked_attention_plain(q, k_pool, v_pool, block_table, positions):
    """The reference's grouped-query chunk attention (``_xla_chunked``
    and its caller's grouping), in f32 with a full masked softmax."""
    B, T, H, D = q.shape
    KVH = k_pool.shape[2]
    rep = H // KVH
    RT = rep * T
    bs = k_pool.shape[1]
    L = block_table.shape[1] * bs
    q_g = q.reshape(B, T, KVH, rep, D).permute(0, 2, 3, 1, 4) \
        .reshape(B, KVH, RT, D).float() * (1.0 / math.sqrt(D))
    bt = block_table.long()
    kb = k_pool[bt].float().reshape(B, L, KVH, D)
    vb = v_pool[bt].float().reshape(B, L, KVH, D)
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


def chunked_attention(q, k_pool, v_pool, block_table, positions):
    """Paged attention for one prefill chunk.

    q: [B, T, H, D] ROTATED queries; k_pool/v_pool [nb, bs, KVH, D]
    already holding the chunk's k/v; block_table [B, nbs] int32;
    positions [B] int32 chunk-start frontiers.  Returns [B, T, H, D] in
    q's dtype.  CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if q.device.type == "cpu":
        return chunked_attention_plain(q, k_pool, v_pool, block_table,
                                       positions)
    B, T, H, D = q.shape
    nb, bs, KVH, Dk = k_pool.shape
    nbs = block_table.shape[1]
    head_dim_ok = (D in BF16_HEAD_DIMS if q.dtype == torch.bfloat16
                   else D <= MAX_HEAD_DIM and D % COL_PARTS == 0)
    if (Dk != D or H % KVH or not head_dim_ok
            or v_pool.shape != k_pool.shape or k_pool.dtype != q.dtype
            or v_pool.dtype != q.dtype or block_table.dtype != torch.int32
            or positions.dtype != torch.int32):
        raise ValueError("chunked_attention: operands do not fit "
                         f"q {tuple(q.shape)} {q.dtype}, pool "
                         f"{tuple(k_pool.shape)} {k_pool.dtype}")
    if q.dtype == torch.float32:
        smem = _build.bind(KERNEL, "chunked_prefill_smem_bytes",
                           [ctypes.c_int] * 2)(D, bs)
        if smem > SMEM_LIMIT:
            raise ValueError(f"chunked_attention: D={D}, block_size={bs} "
                             f"needs {smem} B of shared memory")
    fn = _build.bind(KERNEL, "chunked_prefill",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    q = q.contiguous()
    _build.require_cuda(KERNEL, q, k_pool, v_pool, block_table, positions)
    out = torch.empty_like(q)
    p = _build.ptr
    _build.check(fn(p(q), p(k_pool), p(v_pool), p(block_table), p(positions),
                    p(out), B, T, KVH, H // KVH, D, bs, nbs,
                    1.0 / math.sqrt(D), _build.dtype_code(q),
                    _build.stream_ptr(q)), KERNEL)
    _build.launches.add(KERNEL)
    return out
