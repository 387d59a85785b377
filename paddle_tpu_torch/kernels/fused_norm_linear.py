"""RMSNorm folded into the prologue of the projections that follow it:
CUDA kernels + plain PyTorch version.

Replaces ``paddle_tpu/kernels/fused_norm_linear.py`` ``_kernel`` (the
``pallas_call`` in ``_norm_linear_pallas``); the kernels are
``csrc/fused_norm_linear.cu``, whose header says what bounds each on the
H100.  The math contract is the reference's, cast points included:

    normed = ((x.f32 * rs).to(x.dtype) * nw)        # stays x.dtype
    out    = act(normed.f32 @ w.f32).to(x.dtype)    # f32 accumulation

``rs = rms_scale(x, eps)`` is computed once per activation and shared by
every projection of it (q/k/v, gate/up): the [M, 1] row scale is the
only intermediate, the normalized [M, K] activation never exists.

The kernels share one wrapper and are counted by the rows they take:
``fused_norm_linear_skinny`` for M <= 8 rows (a decode step's bucket)
and ``fused_norm_linear_tiled`` above (a prefill chunk).  The kernels
take N a multiple of 16 bytes' worth of elements and, for bf16 above 8
rows (whose x tiles TMA loads), K a multiple of 8 (every Llama width
is).

:func:`fused_norm_linear_group` takes every weight that shares one
activation and row scale (q/k/v, gate/up; at most ``MAX_GROUP``): in
bf16 one launch covers all of them, the skinny kernel at most 8 rows
(a thread block cluster per column strip, split along K by
:func:`skinny_plan`), the tiled one above, so the narrow k and v fill
the card together with q.  A bf16 single call is a group of one, so
each output of a group equals its single call bit for bit.  f32 is one
:func:`fused_norm_linear` a weight (the skinny f32 kernel split along K
by :func:`skinny_splits`).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

ACTIVATIONS = ("none", "silu")
SKINNY_MAX_ROWS = 8       # csrc/fused_norm_linear.cu SK_MR
MAX_GROUP = 3             # csrc/fused_norm_linear.cu WG_MAX_W
SKINNY_MIN_ROWS_PER_SPLIT = 64
SKINNY_ROWS_PER_RANK = 1024  # bf16 skinny: k rows of w a rank takes
SKINNY_MAX_SPLIT = 8        # csrc/fused_norm_linear.cu SKM_MAX_SPLIT
SKINNY_BK = 64              # csrc/fused_norm_linear.cu SKM_BK
SKINNY_STAGES = 4           # csrc/fused_norm_linear.cu SKM_STAGES
SMEM_OPT_IN = 227 * 1024    # the H100's dynamic shared memory a block


def rms_scale(x, eps):
    """Per-row RMSNorm scale in f32, ``rsqrt(mean(x^2) + eps)``, [..., 1]."""
    var = x.float().square().mean(-1, keepdim=True)
    return torch.rsqrt(var + eps)


def fused_norm_linear_plain(x2d, rs, nw, w, activation="none"):
    normed = (x2d.float() * rs).to(x2d.dtype) * nw
    z = normed.float() @ w.float()
    if activation == "silu":
        z = F.silu(z)
    return z.to(x2d.dtype)


def kernel_name(rows: int) -> str:
    return ("fused_norm_linear_skinny" if rows <= SKINNY_MAX_ROWS
            else "fused_norm_linear_tiled")


def skinny_plan(K):
    """(splits, rows) of the bf16 skinny kernel: the K split (the blocks
    of one cluster, at most SKINNY_MAX_SPLIT) and the k rows of w each
    rank takes, a multiple of SKINNY_BK.  It depends on K alone, so a
    weight's output does not depend on the group it is launched in.  At
    Llama's K = 4096: 4 ranks of 1024 rows (128 KB of a 64-column strip
    each)."""
    splits = min(SKINNY_MAX_SPLIT, max(1, -(-K // SKINNY_ROWS_PER_RANK)))
    rows = -(-K // splits)
    return splits, -(-rows // SKINNY_BK) * SKINNY_BK


def skinny_smem_bytes(rows):
    """Dynamic shared memory of a bf16 skinny block (skm_smem in the
    source): the ring's 8 KB stages, x's 8 rows of ``rows`` (+ 8) bf16,
    the 64 x 8 f32 partial tile, the barriers, 1 KB for alignment."""
    return 1024 + SKINNY_STAGES * 8192 + SKINNY_MAX_ROWS * (rows + 8) * 2 \
        + 64 * SKINNY_MAX_ROWS * 4 + 2 * SKINNY_STAGES * 8


def skinny_splits(N, K, elem_bytes, sm_count):
    """How many ways the f32 skinny kernel splits K over the grid: doubled
    until the column strips times the splits give two blocks per SM,
    keeping at least 64 rows of w per block."""
    strips = -(-N // (32 * (16 // elem_bytes)))
    splits = 1
    while (strips * splits < 2 * sm_count
           and K // (2 * splits) >= SKINNY_MIN_ROWS_PER_SPLIT):
        splits *= 2
    return splits


def _checked(x, row_scale, norm_weight, w):
    """x as [M, K] and rs as [M, 1], contiguous, after the checks every
    CUDA call makes."""
    K, N = x.shape[-1], w.shape[1]
    x2d = x.reshape(-1, K)
    rs = row_scale.reshape(-1, 1)
    if not (w.dtype == norm_weight.dtype == x.dtype
            and rs.dtype == torch.float32 and w.shape[0] == K
            and norm_weight.shape == (K,) and rs.shape[0] == x2d.shape[0]):
        raise ValueError("fused_norm_linear: operands do not fit "
                         f"x {tuple(x.shape)} {x.dtype}")
    x2d, rs = x2d.contiguous(), rs.contiguous()
    _build.require_cuda("fused_norm_linear", x2d, rs, norm_weight, w)
    vec = 16 // x.element_size()
    tensor_cores = (x2d.shape[0] > SKINNY_MAX_ROWS
                    and x.dtype == torch.bfloat16)
    if (N % vec or (tensor_cores and K % 8)
            or any(t.data_ptr() % 16 for t in (x2d, norm_weight, w))):
        raise ValueError(f"fused_norm_linear: the kernels load 16 bytes at "
                         f"a time; N={N} (and K={K} for bf16 rows > "
                         f"{SKINNY_MAX_ROWS}) must be multiples of {vec} "
                         f"and the operands 16-byte aligned")
    return x2d, rs


def fused_norm_linear(x, row_scale, norm_weight, w, activation="none"):
    """``act(((x * row_scale).to(x.dtype) * norm_weight) @ w)``.

    x: [..., K]; row_scale: [..., 1] f32 from :func:`rms_scale`;
    norm_weight: [K]; w: [K, N] (Paddle's [in, out] layout).  Returns
    [..., N] in x's dtype.  CPU tensors take the plain version; CUDA
    tensors launch a kernel."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}")
    lead, K = x.shape[:-1], x.shape[-1]
    N = w.shape[1]
    if x.device.type == "cpu":
        return fused_norm_linear_plain(x.reshape(-1, K),
                                       row_scale.reshape(-1, 1), norm_weight,
                                       w, activation).reshape(*lead, N)
    if x.dtype == torch.bfloat16:
        return fused_norm_linear_group(x, row_scale, norm_weight, [w],
                                       [activation])[0]
    x2d, rs = _checked(x, row_scale, norm_weight, w)
    M = x2d.shape[0]
    name = kernel_name(M)
    splits = 1
    if name.endswith("skinny"):
        splits = skinny_splits(N, K, x.element_size(), _build.sm_count(x.device))
    part = torch.empty((splits, M, N) if splits > 1 else (0,),
                       dtype=torch.float32, device=x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    fn = _build.bind("fused_norm_linear", "fused_norm_linear",
                     [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                     + [ctypes.c_void_p])
    p = _build.ptr
    _build.check(fn(p(x2d), p(rs), p(norm_weight), p(w), p(out), p(part), M,
                    N, K, splits, int(activation == "silu"),
                    _build.dtype_code(x), _build.stream_ptr(x)),
                 "fused_norm_linear")
    _build.launches.add(name)
    return out.reshape(*lead, N)


def fused_norm_linear_group(x, row_scale, norm_weight, ws, activations):
    """``[fused_norm_linear(x, row_scale, norm_weight, w, act) for w, act
    in zip(ws, activations)]`` for 1 to ``MAX_GROUP`` weights, each output
    equal to its single call.  In bf16 on the card one launch covers them
    all, counted once as ``fused_norm_linear_skinny`` (at most
    ``SKINNY_MAX_ROWS`` rows) or ``fused_norm_linear_tiled``."""
    if not (0 < len(ws) <= MAX_GROUP and len(ws) == len(activations)
            and all(a in ACTIVATIONS for a in activations)):
        raise ValueError(f"fused_norm_linear_group: {len(ws)} weights "
                         f"(1 to {MAX_GROUP}) and activations "
                         f"{activations}")
    lead, K = x.shape[:-1], x.shape[-1]
    M = x.numel() // K if K else 0
    if x.device.type == "cpu" or x.dtype != torch.bfloat16:
        return [fused_norm_linear(x, row_scale, norm_weight, w, a)
                for w, a in zip(ws, activations)]
    for w in ws:
        x2d, rs = _checked(x, row_scale, norm_weight, w)
    name = kernel_name(M)
    splits, rows = skinny_plan(K) if name.endswith("skinny") else (1, 0)
    if rows and skinny_smem_bytes(rows) > SMEM_OPT_IN:
        raise ValueError(f"fused_norm_linear_group: K={K} needs "
                         f"{skinny_smem_bytes(rows)} B of shared memory a "
                         f"block at {M} rows")
    outs = [torch.empty((M, w.shape[1]), dtype=x.dtype, device=x.device)
            for w in ws]
    # the C entry takes MAX_GROUP slots; the unused ones repeat weight 0
    idx = list(range(len(ws))) + [0] * (MAX_GROUP - len(ws))
    silu = sum(1 << i for i, a in enumerate(activations) if a == "silu")
    fn = _build.bind("fused_norm_linear", "fused_norm_linear_group",
                     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                     + [ctypes.c_void_p])
    p = _build.ptr
    _build.check(fn(p(x2d), p(rs), p(norm_weight), *[p(ws[i]) for i in idx],
                    *[p(outs[i]) for i in idx],
                    *[ws[i].shape[1] for i in idx], silu, len(ws), M, K,
                    splits, rows, _build.stream_ptr(x)),
                 "fused_norm_linear_group")
    _build.launches.add(name)
    return [o.reshape(*lead, o.shape[1]) for o in outs]
