"""RMSNorm over the last axis, and the row scale it is built on: CUDA
kernel + plain PyTorch versions, and the norm's backward in plain
PyTorch.

Replaces ``paddle_tpu/kernels/rms_norm.py`` ``_kernel`` (the
``pallas_call`` in ``_rms_fwd_impl``) and the reference's XLA
``rms_scale`` (``paddle_tpu/kernels/fused_norm_linear.py``), the f32 row
scale in front of every fused_norm_linear; both are ``csrc/rms_norm.cu``
(counted as ``rms_norm`` and ``rms_scale``), whose header says what
bounds it on the H100.
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
SCALE = "rms_scale"


def rms_scale_plain(x, eps):
    """Per-row RMSNorm scale in f32, ``rsqrt(mean(x^2) + eps)``, [..., 1]."""
    var = x.float().square().mean(-1, keepdim=True)
    return torch.rsqrt(var + eps)


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


def vec_ok(d, *tensors):
    """Whether rows of ``d`` elements of these tensors take the kernel's
    16-byte loads (whole vectors a row, each tensor 16-byte aligned);
    else it loads one element at a time."""
    return (d * tensors[0].element_size() % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


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
        ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(_build.ptr(x), _build.ptr(weight), _build.ptr(out),
                    x.numel() // d if d else 0, d, eps, _build.dtype_code(x),
                    int(vec_ok(d, x, weight, out)), _build.stream_ptr(x)),
                 KERNEL)
    _build.launches.add(KERNEL)
    return out


def rms_scale(x, eps):
    """Per-row RMSNorm scale of ``x`` [..., d] in f32, ``rsqrt(mean(x^2)
    + eps)``, [..., 1]: the row scale every fused_norm_linear of x
    shares.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (one launch, counted as ``rms_scale``)."""
    if x.device.type == "cpu":
        return rms_scale_plain(x, eps)
    x = x.contiguous()
    _build.require_cuda(SCALE, x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    rs = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                     device=x.device)
    fn = _build.bind(KERNEL, "rms_scale", [ctypes.c_void_p] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(_build.ptr(x), _build.ptr(rs), rows, d, eps,
                    _build.dtype_code(x), int(vec_ok(d, x)),
                    _build.stream_ptr(x)), SCALE)
    _build.launches.add(SCALE)
    return rs


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
