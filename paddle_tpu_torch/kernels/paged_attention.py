"""Fused paged-attention decode: CUDA kernel + plain PyTorch version.

Replaces ``paddle_tpu/kernels/paged_attention.py`` ``_decode_kernel``
(the ``pallas_call`` in ``_pallas_partials``) and its
``_combine_splits`` merge; the kernels are ``csrc/paged_attention.cu``,
whose header says what bounds them on the H100 and how the split-K grid
became parallel blocks.

One decode step per sequence of the bucket: the new token's k is
rotated (RoPE at ``positions[b]``) and k/v are written into the block
pools by one launch (``kv_quant.kv_write``), then
:func:`paged_decode_attention` attends
q (rotated and scaled by 1/sqrt(D) inside the kernel) over each
sequence's pages through the block table, masking ``k_pos <=
positions[b]``.  GQA head ``h = kvh * rep + r``.

Unlike the JAX function, which returns new pools, the write here
updates the pools IN PLACE; :func:`fused_paged_decode` returns them
anyway, so its signature matches the reference's.

Quantized pools (``kv_cache_dtype`` ``"int8"``/``"fp8"``, the
reference's ``kv_dtype`` variant of ``_decode_kernel``) hold int8 codes
with a [nb, bs] f32 scale per side: the new token is quantized as it is
written (the same ``kv_quant.kv_write`` launch) and the
kernel dequantizes each row in registers.  Each scheme counts its own
launches (``paged_decode_int8``, ``paged_decode_fp8``).

Which CUDA kernel runs is chosen from the operands before the launch
(:func:`hopper_path`).  bf16 q at a head_dim D that is a multiple of 8
up to 256 over 16-byte aligned pools, any GQA rep and block size, takes
``paged_decode_hopper``, one launch whose blocks split each sequence's
live keys into chunks of ``CHUNK_KEYS`` (:func:`decode_plan` sizes the
grid and the scratch) and whose last block per (sequence, kv head,
sub-group) merges their shares; it reads bf16 or f32 cos/sin as given.
A key row is spread over W / 8 lanes (:func:`hopper_width`: W = 64, 128
or 256, the smallest that holds D, so that the lanes' shuffle trees are
powers of two): D = 64 and 128 run on instances of D columns, every
other D on the padded instance of W columns, which takes D at run time
and whose lanes past D load nothing (Phi-3-mini's 96 on 128 columns
costs 4 idle lanes of 16 a key in issue slots, no bytes); its launches
are tallied by instance (:func:`instance`).  Its instance holds 1, 2 or
4 q heads a block (:func:`hopper_group`: rep 3 runs padded to 4, rep 7
as sub-groups of 4 and 3 heads), and a block size that is not a power
of two finds its pages by a multiplier (:func:`div_magic`).  Every other
shape (bf16 head_dims that are not a multiple of 8, unaligned pools, or
f32, which only the tests serve) takes the general instance
``paged_decode_partials`` with the splits of :func:`general_plan` and a
combine kernel: any rep, block size and head_dim whose staging fits a
block's shared memory, in f32 inside and one rounding at the store.  A
bf16 call that takes it counts as ``paged_decode_general``
(``_int8``/``_fp8`` over code pools).  There is no fallback: a launch
that fails raises.  Both agree with the plain version up to the order of
f32 sums (and the Hopper kernel's exp2).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build, kv_quant
from .rope import rotate_half

KERNEL = "paged_decode"
GENERAL = "paged_decode_general"   # bf16 on the general instance
LIB = "paged_attention"   # csrc/paged_attention.cu
NEG_INF = -1e30
SMEM_LIMIT = 227 * 1024    # paged_decode_partials: a block's opt-in smem
CHUNK_KEYS = 64            # csrc/paged_attention.cu PF_CHUNK
HOPPER_REPS = (1, 2, 4)      # q heads a block of paged_decode_hopper
HOPPER_WIDTHS = (64, 128, 256)  # its columns a key row (W / 8 lanes)
EXACT_WIDTHS = (64, 128)     # the widths built for D == W at compile time
BLOCKS_PER_SM = 3          # csrc/paged_attention.cu PF_MIN_BLOCKS
# blocks a SM the splits of a padded instance over bf16 pools aim at: its
# time at Phi-3-mini's, Phi-2's and Gemma-7B's heads fell by a fifth from
# 3 to about 10 (the longest sequences' shares end together;
# tools/decode_splits.py, PERF.md)
PADDED_BF16_BLOCKS_PER_SM = 10
MAX_SPLITS = 64            # csrc/paged_attention.cu PF_MAX_SPLITS


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


def hopper_group(rep):
    """(REP, groups) of ``paged_decode_hopper`` for a GQA rep: a kv
    head's rep q heads run as ``groups`` = ceil(rep / 4) sub-groups of
    ceil(rep / groups) heads, each in the smallest instance of
    HOPPER_REPS that holds it; the padded rows load no q and write
    nothing (rep 3 runs in REP 4, 7 as blocks of 4 and 3 heads, 16 as
    four blocks of 4, each reading its kv head's keys).  More heads a
    block need more registers than 3 blocks a SM leave (an instance of
    8 spilled and was slower than two of 4: ``csrc/paged_attention.cu``)."""
    groups = -(-rep // HOPPER_REPS[-1])
    per = -(-rep // groups)
    return next(r for r in HOPPER_REPS if r >= per), groups


def div_magic(bs):
    """(magic, shift) that find a key's page ``n // bs`` on the card as
    ``(umulhi(n, magic) + n) >> shift`` for every n < 2^31 (the round-up
    multiplier of Granlund and Montgomery; the sum stays below 2^32);
    magic 0 for a power of two, which the kernel's POW2 instances
    shift."""
    shift = (bs - 1).bit_length()
    if bs & (bs - 1) == 0:
        return 0, shift
    return ((1 << 32) * ((1 << shift) - bs)) // bs + 1, shift


def decode_plan(B, KVH, nbs, bs, sm_count, groups=1,
                blocks_per_sm=BLOCKS_PER_SM):
    """Splits of ``paged_decode_hopper``: how many blocks share one
    (sequence, kv head, sub-group)'s live keys (``groups`` sub-groups a
    kv head, :func:`hopper_group`).  Enough for ``blocks_per_sm`` blocks
    a SM: by default BLOCKS_PER_SM, as many as its registers let reside
    at once, so that the live blocks run in one wave when every sequence
    is long (a padded instance over bf16 pools aims at
    PADDED_BF16_BLOCKS_PER_SM, several waves of shorter shares); no more
    than a
    full table has chunks of CHUNK_KEYS, nor MAX_SPLITS (the last
    block's merge keeps a weight of each in shared memory).  The
    kernel's own partition follows each sequence's frontier (block s
    takes the s-th run of ceil(chunks / S) chunks), so the scratch of
    [B, S, H, D] partials is an upper bound known
    without a host sync."""
    max_chunks = -(-nbs * bs // CHUNK_KEYS)
    want = -(-blocks_per_sm * sm_count // max(1, B * KVH * groups))
    return max(1, min(max_chunks, want, MAX_SPLITS))


def blocks_per_sm(q, kv_cache_dtype=None):
    """The blocks a SM :func:`decode_plan` aims at for a Hopper launch:
    PADDED_BF16_BLOCKS_PER_SM on a padded instance over bf16 pools, else
    BLOCKS_PER_SM."""
    padded = instance(q, True).endswith("_pad")
    return PADDED_BF16_BLOCKS_PER_SM if padded and kv_cache_dtype is None \
        else BLOCKS_PER_SM


def general_plan(B, KVH, nbs, sm_count):
    """Splits of the general instance: it deals the pages of a sequence
    round-robin over them (page p to split p % S), so any S takes any
    table; enough for two blocks a SM, no more than the table has pages
    or MAX_SPLITS.  ``num_splits``, which the plain version takes, does
    not shape it: the two agree up to the order of f32 sums."""
    want = -(-2 * sm_count // max(1, B * KVH))
    return max(1, min(nbs, want, MAX_SPLITS))


def hopper_path(q, k_pool, v_pool, rep):
    """Whether these operands go to ``paged_decode_hopper``: bf16 q at a
    head_dim that is a multiple of 8 up to 256, any rep and block size,
    and pools 16-byte aligned (its row loads).  Every other shape takes
    the general instance."""
    D = q.shape[-1]
    return (q.dtype == torch.bfloat16 and rep >= 1 and D % 8 == 0
            and 0 < D <= HOPPER_WIDTHS[-1] and k_pool.shape[1] > 0
            and k_pool.data_ptr() % 16 == 0 and v_pool.data_ptr() % 16 == 0)


def hopper_width(D):
    """The columns W of the ``paged_decode_hopper`` instance of head_dim
    D: the smallest of HOPPER_WIDTHS that holds it."""
    return next(w for w in HOPPER_WIDTHS if D <= w)


def instance(q, hopper):
    """The kernel instance a call launches, as the launch counter tallies
    it beside the kernel's name: ``w64`` or ``w128`` for the Hopper
    kernel's instances of D = 64 and 128 columns, ``w64_pad``,
    ``w128_pad`` or ``w256_pad`` for its padded ones (D at run time), None
    for the general instance."""
    if not hopper:
        return None
    D = q.shape[-1]
    W = hopper_width(D)
    return f"w{W}" if D == W and W in EXACT_WIDTHS else f"w{W}_pad"


def counter_name(q, hopper, kv_cache_dtype):
    """The launch counter of a call: ``paged_decode`` for the Hopper
    kernel and for f32, ``paged_decode_general`` for bf16 on the general
    instance, each with the scheme's suffix over code pools."""
    general = not hopper and q.dtype == torch.bfloat16
    return kv_quant.counter_name(GENERAL if general else KERNEL,
                                 kv_cache_dtype)


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
                                 v_scale=None, kv_cache_dtype=None,
                                 scale=None):
    """The reference's decode (``_xla_partials`` and the combine) in f32.
    ``scale`` defaults to 1/sqrt(head_dim)."""
    B, H, D = q.shape
    KVH = k_pool.shape[2]
    rep = H // KVH
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    q_g = q.reshape(B, KVH, rep, D)
    q_rot = rotate_half(q_g.float(), c[:, None, None, :],
                         s[:, None, None, :]) * scale
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
                     + [ctypes.c_float] + [ctypes.c_int] * 6
                     + [ctypes.c_uint, ctypes.c_int, ctypes.c_void_p])
    hopper = hopper_path(q, k_pool, v_pool, rep)
    width = hopper_width(D) if hopper else 0
    REP, groups = hopper_group(rep) if hopper else (0, 1)
    magic, shift = div_magic(bs) if hopper else (0, 0)
    if hopper:
        splits = decode_plan(B, KVH, nbs, bs, _build.sm_count(q.device),
                             groups, blocks_per_sm(q, kv_cache_dtype))
    else:
        splits = general_plan(B, KVH, nbs, _build.sm_count(q.device))
        smem = _build.bind(LIB, "paged_decode_smem_bytes",
                           [ctypes.c_int] * 3)(rep, D, bs)
        if smem > SMEM_LIMIT:
            raise ValueError(f"paged_decode_attention: rep={rep}, D={D}, "
                             f"block_size={bs} needs {smem} B of shared "
                             "memory")
    name = counter_name(q, hopper, kv_cache_dtype)
    q = q.contiguous()
    if c.dtype not in (torch.float32, torch.bfloat16):
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
    tickets = p(_tickets(q.device, B * KVH * groups)) if hopper else None
    _build.check(fn(p(q), p(c), p(s), p(k_pool), p(v_pool), ks, vs,
                    p(block_table), p(positions), p(acc), p(m), p(l),
                    tickets, p(out), B, KVH, rep, D, bs, nbs, splits,
                    1.0 / math.sqrt(D), _build.dtype_code(q),
                    _build.dtype_code(c),
                    kv_quant.KV_DTYPE_CODES[kv_cache_dtype], width, REP,
                    groups, magic, shift, _build.stream_ptr(q)), name)
    _build.launches.add(name, instance(q, hopper))
    return out


def fused_paged_decode(q, k_new, v_new, k_pool, v_pool, block_table,
                       positions, cos, sin, *, num_splits=None,
                       k_scale=None, v_scale=None, kv_cache_dtype=None):
    """One fused decode step of paged attention.

    q: [B, 1, H, D] UNROTATED queries; k_new/v_new: [B, 1, KVH, D]
    unrotated new-token key/value; k_pool/v_pool: [nb, bs, KVH, D];
    block_table: [B, nbs] int32; positions: [B] int32 write frontiers;
    cos/sin: [max_pos, D/2] RoPE tables.  Rotates k_new (in f32, rounded
    to its dtype) and writes k/v into the pools in place
    (``kv_quant.kv_write``, one launch on the card), then attends.
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
    kv_quant.kv_write(k_pool, v_pool, k_new, v_new, block_table, positions,
                      c=c, s=s, k_scale=k_scale, v_scale=v_scale,
                      scheme=kv_cache_dtype)
    out = paged_decode_attention(q[:, 0], c, s, k_pool, v_pool, block_table,
                                 positions, num_splits, k_scale, v_scale,
                                 kv_cache_dtype)
    out = out.reshape(B, 1, H, D)
    if kv_cache_dtype is None:
        return out, k_pool, v_pool
    return out, k_pool, v_pool, k_scale, v_scale


_ticket_buffers: dict = {}
# every buffer a (device, stream) outgrew: a CUDA graph captured while it
# was current still counts its tickets there, so none is ever freed
_outgrown_tickets: list = []


def _tickets(device, n):
    """The int32 tickets of ``paged_decode_hopper``, one per (sequence, kv
    head, sub-group), at least ``n``, one buffer per device and stream.
    Zero when made; each launch leaves them at zero again (the last
    block of a (sequence, kv head, sub-group) resets its own), so the
    launches of one stream, which run one after another, share them;
    launches on two streams at once would mix their tickets, hence a
    buffer each.  A CUDA graph bakes in the buffer of the stream it was
    captured on (``jit.GraphStep``'s capture stream): its warmup makes
    or grows the buffer there before capture, so no allocation is
    recorded into the graph, and graphs replay one after another, as
    launches of one stream do.  A buffer that a later, larger ``n``
    outgrows is kept for the graphs that hold it."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _ticket_buffers.get(key)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _outgrown_tickets.append(buf)
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=device)
        _ticket_buffers[key] = buf
    return buf
