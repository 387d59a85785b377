"""Rotate-half RoPE at a scalar position offset: CUDA kernel + plain
PyTorch version, with a backward that is the same kernel at the negated
angle.

Replaces ``paddle_tpu/kernels/rope.py`` ``_rope_kernel`` (the
``pallas_call`` in ``_rope_fwd``; its ``custom_vjp`` backward runs the
kernel with ``-sin``); the kernel is ``csrc/rope.cu``, whose header says
what bounds it on the H100.

Cast points follow ``_rope_kernel``: x and the tables are raised to f32,
the rotation is computed there, and the result is rounded once to
x's dtype.  (``models.llama.apply_rope``, the serving path's per-sequence
rotation, mirrors the XLA formula instead, which rounds at every
operation in the model's dtype.)
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "rope"


def rotate_half(x, c, s):
    """Rotate-half RoPE; c/s broadcast against x's last dim (halves)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def rope_plain(x, cos, sin):
    """x [B, T, H, D]; cos/sin [T, D/2], already at the offset."""
    return rotate_half(x.float(), cos.float()[None, :, None, :],
                       sin.float()[None, :, None, :]).to(x.dtype)


def _rope(x, cos, sin, sign):
    """The rotation by ``sign`` times the angle: the plain version for a
    CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return rope_plain(x, cos, sin if sign > 0 else -sin)
    B, T, H, D = x.shape
    if (D % 2 or cos.shape != (T, D // 2) or sin.shape != cos.shape
            or cos.dtype != x.dtype or sin.dtype != x.dtype):
        raise ValueError(f"rope: tables {tuple(cos.shape)} {cos.dtype} do "
                         f"not fit x {tuple(x.shape)} {x.dtype}")
    x = x.contiguous()
    _build.require_cuda(KERNEL, x, cos, sin)
    out = torch.empty_like(x)
    fn = _build.bind(KERNEL, "rope", [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 4
                     + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    p = _build.ptr
    _build.check(fn(p(x), p(cos), p(sin), p(out), B, T, H, D, float(sign),
                    _build.dtype_code(x), _build.stream_ptr(x)), KERNEL)
    _build.launches.add(KERNEL)
    return out


class _Rope(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rope(x, cos, sin, 1.0)

    @staticmethod
    def backward(ctx, g):
        cos, sin = ctx.saved_tensors
        # the inverse rotation: the transpose of an orthogonal one
        return _rope(g, cos, sin, -1.0), None, None


def fused_rope(x, cos, sin, position_offset=0):
    """RoPE of x [B, T, H, D] with the rows ``position_offset`` ..
    ``position_offset + T - 1`` of the tables cos/sin [max_T, D/2].
    Differentiable in x; CPU tensors take the plain version, CUDA tensors
    launch the kernel (forward and backward)."""
    T = x.shape[1]
    if position_offset < 0 or position_offset + T > cos.shape[0]:
        raise ValueError(f"rope: positions {position_offset}.."
                         f"{position_offset + T - 1} are past the table "
                         f"({cos.shape[0]} rows)")
    c = cos[position_offset:position_offset + T]
    s = sin[position_offset:position_offset + T]
    if torch.is_grad_enabled() and x.requires_grad:
        return _Rope.apply(x, c, s)
    return _rope(x, c, s, 1.0)
