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

Two kernels share one wrapper: ``skinny`` for M <= 8 rows (a decode
step's bucket) and ``tiled`` above (a prefill chunk); each counts its
own launches.  Both load 16 bytes at a time, so the kernels take N a
multiple of 16 bytes' worth of elements and, for bf16 ``tiled`` (whose
tiles TMA loads), K a multiple of 8 (every Llama width is).

:func:`fused_norm_linear_group` takes every weight that shares one
activation and row scale (q/k/v, gate/up; at most ``MAX_GROUP``): in
bf16 above 8 rows it launches the tiled kernel once for all of them, so
the narrow k and v fill the card together with q; elsewhere it is one
:func:`fused_norm_linear` a weight.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

ACTIVATIONS = ("none", "silu")
SKINNY_MAX_ROWS = 8       # csrc/fused_norm_linear.cu SK_MR
MAX_GROUP = 3             # csrc/fused_norm_linear.cu WG_MAX_W
SKINNY_MIN_ROWS_PER_SPLIT = 64


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


def skinny_splits(N, K, elem_bytes, sm_count):
    """How many ways the skinny kernel splits K over the grid: doubled
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
    x2d, rs = _checked(x, row_scale, norm_weight, w)
    M = x2d.shape[0]
    name = kernel_name(M)
    splits = 1
    if name.endswith("skinny"):
        splits = skinny_splits(N, K, x.element_size(), _sm_count(x.device))
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
    equal to its single call.  In bf16 on the card above
    ``SKINNY_MAX_ROWS`` rows, one launch of the tiled kernel covers them
    all (counted once as ``fused_norm_linear_tiled``)."""
    if not (0 < len(ws) <= MAX_GROUP and len(ws) == len(activations)
            and all(a in ACTIVATIONS for a in activations)):
        raise ValueError(f"fused_norm_linear_group: {len(ws)} weights "
                         f"(1 to {MAX_GROUP}) and activations "
                         f"{activations}")
    lead, K = x.shape[:-1], x.shape[-1]
    M = x.numel() // K if K else 0
    if (x.device.type == "cpu" or x.dtype != torch.bfloat16
            or M <= SKINNY_MAX_ROWS):
        return [fused_norm_linear(x, row_scale, norm_weight, w, a)
                for w, a in zip(ws, activations)]
    for w in ws:
        x2d, rs = _checked(x, row_scale, norm_weight, w)
    outs = [torch.empty((M, w.shape[1]), dtype=x.dtype, device=x.device)
            for w in ws]
    # the C entry takes MAX_GROUP slots; the unused ones repeat weight 0
    idx = list(range(len(ws))) + [0] * (MAX_GROUP - len(ws))
    silu = sum(1 << i for i, a in enumerate(activations) if a == "silu")
    fn = _build.bind("fused_norm_linear", "fused_norm_linear_group",
                     [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                     + [ctypes.c_void_p])
    p = _build.ptr
    _build.check(fn(p(x2d), p(rs), p(norm_weight), *[p(ws[i]) for i in idx],
                    *[p(outs[i]) for i in idx],
                    *[ws[i].shape[1] for i in idx], silu, len(ws), M, K,
                    _build.stream_ptr(x)), "fused_norm_linear_group")
    _build.launches.add("fused_norm_linear_tiled")
    return [o.reshape(*lead, o.shape[1]) for o in outs]


@functools.lru_cache(maxsize=None)
def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count
