"""RMSNorm over the last axis: CUDA kernel + plain PyTorch version.

Replaces ``paddle_tpu/kernels/rms_norm.py`` ``_kernel`` (the
``pallas_call`` in ``_rms_fwd_impl``); the kernel is
``csrc/rms_norm.cu``, whose header says what bounds it on the H100.

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


def rms_norm(x, weight, eps):
    """RMSNorm of ``x`` [..., d] with ``weight`` [d].  CPU tensors take
    the plain version; CUDA tensors launch the kernel."""
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
