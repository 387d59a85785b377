"""RMSNorm over the last axis: CUDA kernel + plain PyTorch version, and
its backward in plain PyTorch.

Replaces ``paddle_tpu/kernels/rms_norm.py`` ``_kernel`` (the
``pallas_call`` in ``_rms_fwd_impl``); the kernel is
``csrc/rms_norm.cu``, whose header says what bounds it on the H100.
The JAX backward is XLA (``_rms_vjp_bwd``: the vjp of ``_rms_ref``), so
here it is :func:`rms_norm_bwd_plain`, the same vjp written out, on
both devices.

Cast points follow ``LlamaRMSNorm`` of the JAX package (and
``fused_norm_linear``): the normalized row is rounded to ``x.dtype``
before the weight multiply.  The TPU kernel multiplies by the weight in
f32 and rounds once, which can differ by one bf16 ulp.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "rms_norm"


def rms_norm_plain(x, weight, eps):
    var = x.float().square().mean(-1, keepdim=True)
    return (x.float() * torch.rsqrt(var + eps)).to(x.dtype) * weight


def rms_norm_bwd_plain(x, weight, eps, g):
    """``(dx, dweight)``, the vjp of :func:`rms_norm_plain` at x for the
    cotangent g, in f32 (the rounding of the normalized row passes the
    gradient straight through, as a cast's vjp does).  The weight
    gradient sums over rows in f32 and is rounded once."""
    xf = x.float()
    r = torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    normed = (xf * r).to(x.dtype).float()
    gf = g.float()
    dn = gf * weight.float()
    dx = r * dn - xf * (r ** 3) * (dn * xf).mean(-1, keepdim=True)
    dw = (gf * normed).reshape(-1, x.shape[-1]).sum(0)
    return dx.to(x.dtype), dw.to(weight.dtype)


def _forward(x, weight, eps):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, weight, eps)
    if weight.dtype != x.dtype or weight.shape != x.shape[-1:]:
        raise ValueError(f"rms_norm: weight {tuple(weight.shape)} "
                         f"{weight.dtype} does not fit x {tuple(x.shape)} "
                         f"{x.dtype}")
    x = x.contiguous()
    _build.require_cuda(KERNEL, x, weight)
    out = torch.empty_like(x)
    d = x.shape[-1]
    fn = _build.bind(KERNEL, "rms_norm", [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p])
    _build.check(fn(_build.ptr(x), _build.ptr(weight), _build.ptr(out),
                    x.numel() // d, d, eps, _build.dtype_code(x),
                    _build.stream_ptr(x)), KERNEL)
    _build.launches.add(KERNEL)
    return out


class _RmsNorm(torch.autograd.Function):
    """Saves x and the weight only; the backward recomputes the row
    scale."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        dx, dw = rms_norm_bwd_plain(x, weight, ctx.eps, g)
        return dx, dw, None


def rms_norm(x, weight, eps):
    """RMSNorm of ``x`` [..., d] with ``weight`` [d], differentiable in
    both.  CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RmsNorm.apply(x, weight, eps)
    return _forward(x, weight, eps)
