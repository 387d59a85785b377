"""A matrix product with the bias and the activation fused into its
epilogue: CUDA kernel + plain PyTorch version, with a backward that
recomputes the pre-activation.

Replaces ``paddle_tpu/kernels/fused_linear.py`` ``_kernel`` (the
``pallas_call`` in ``_fused_linear_fwd``); the kernel is
``csrc/fused_linear.cu``, whose header says what bounds it on the H100
and what its design does about it.  A bf16 call takes one of two
instances, chosen from its shapes and addresses before the launch by
:func:`tma_ok`: the wgmma kernel fed by TMA where a tensor map can hold
x and w, the predicated mma.sync kernel everywhere else.  The
static-graph pass
``static.passes.fuse_linear_act`` rewrites a ``linear`` followed by its
activation into one call of :func:`fused_linear`.

Contract, the TPU kernel's cast points (``fused_linear.py:50-59``):

    z   = x.f32 @ w.f32.T + b.f32          # f32 accumulation
    out = act(z).to(x.dtype)               # one rounding

``w`` is [N, K], PyTorch's ``Linear`` layout (the JAX kernel takes
Paddle's [K, N]); ``act`` is one of ``ACTIVATIONS``: none, relu, exact
(erf) gelu, gelu_tanh and silu.  The backward follows ``_vjp_bwd``
(``:108-117``), which is XLA there and plain PyTorch here: it recomputes
z in f32, takes dz = g * act'(z), and returns dx = dz @ w, dw = dz.T @ x
and db = sum(dz), each in its input's dtype.  With bf16 operands its
f32 products run in TF32 on the card (``device.tf32_if_exact``): the
recomputed z is exact there (bf16 values are exact in TF32), and dx and
dw see dz rounded to TF32 (2^-11 relative) before their rounding to
bf16 (2^-9).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..device import tf32_if_exact
from . import _build

KERNEL = "fused_linear"
# codes shared with csrc/fused_linear.cu
ACTIVATIONS = {"none": 0, "relu": 1, "gelu": 2, "gelu_tanh": 3, "silu": 4}


def activate(z, activation):
    """The activation of the f32 pre-activation ``z``."""
    if activation == "relu":
        return torch.relu(z)
    if activation == "gelu":
        return F.gelu(z)
    if activation == "gelu_tanh":
        return F.gelu(z, approximate="tanh")
    if activation == "silu":
        return F.silu(z)
    return z


def _pre_activation(x2d, w, b):
    z = torch.matmul(x2d.float(), w.float().t())
    return z if b is None else z + b.float()


def fused_linear_plain(x2d, w, b, activation):
    """``act(x2d @ w.T + b)`` with the kernel's cast points; x2d [M, K],
    w [N, K], b [N] or None."""
    return activate(_pre_activation(x2d, w, b), activation).to(x2d.dtype)


def tma_ok(x2d, w):
    """True where the bf16 wgmma instance takes ``x2d`` [M, K] and ``w``
    [N, K] (dense, row-major): TMA's tensor maps of x, w and the output
    [M, N] need row strides (K and N bf16) and bases that are multiples
    of 16 bytes (the output is allocated here, aligned).  Every other
    bf16 call, and K = 0, takes the predicated instance; f32 has its own
    kernel.  Decided from the operands alone, before any launch."""
    K, N = x2d.shape[-1], w.shape[0]
    return (x2d.dtype == torch.bfloat16 and K > 0 and K % 8 == 0
            and N % 8 == 0 and x2d.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0)


def _forward(x2d, w, b, activation):
    """The plain version for a CPU tensor, the kernel for a CUDA one."""
    if x2d.device.type == "cpu":
        return fused_linear_plain(x2d, w, b, activation)
    M, K = x2d.shape
    N = w.shape[0]
    if not (w.dim() == 2 and w.shape[1] == K and w.dtype == x2d.dtype
            and (b is None or (b.shape == (N,) and b.dtype == x2d.dtype))):
        raise ValueError(f"fused_linear: w {tuple(w.shape)} {w.dtype} and "
                         f"bias do not fit x {tuple(x2d.shape)} {x2d.dtype}")
    # the kernel indexes every operand as a dense row-major array
    x2d, w = x2d.contiguous(), w.contiguous()
    b = None if b is None else b.contiguous()
    operands = (x2d, w) if b is None else (x2d, w, b)
    _build.require_cuda(KERNEL, *operands)
    code = _build.dtype_code(x2d)
    out = torch.empty((M, N), dtype=x2d.dtype, device=x2d.device)
    if M == 0 or N == 0:
        return out
    fn = _build.bind(KERNEL, "fused_linear", [ctypes.c_void_p] * 4
                     + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    p = _build.ptr
    _build.check(fn(p(x2d), p(w), None if b is None else p(b), p(out), M, N,
                    K, ACTIVATIONS[activation], code, int(tma_ok(x2d, w)),
                    _build.stream_ptr(x2d)), KERNEL)
    _build.launches.add(KERNEL)
    return out


class _FusedLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2d, w, b, activation):
        ctx.save_for_backward(x2d, w, b)
        ctx.activation = activation
        return _forward(x2d, w, b, activation)

    @staticmethod
    def backward(ctx, g):
        x2d, w, b = ctx.saved_tensors
        dx = dw = db = None
        with tf32_if_exact(x2d.dtype):
            with torch.enable_grad():
                z = _pre_activation(x2d.detach(), w.detach(),
                                    None if b is None else b.detach())
                z.requires_grad_()
                (dz,) = torch.autograd.grad(activate(z, ctx.activation), z,
                                            g.float())
            if ctx.needs_input_grad[0]:
                dx = torch.matmul(dz, w.float()).to(x2d.dtype)
            if ctx.needs_input_grad[1]:
                dw = torch.matmul(dz.t(), x2d.float()).to(w.dtype)
        if b is not None and ctx.needs_input_grad[2]:
            db = dz.sum(0).to(b.dtype)
        return dx, dw, db, None


def fused_linear(x, w, bias=None, activation="none"):
    """``activation(x @ w.T + bias)`` with the epilogue fused into the
    product.  x: [..., K]; w: [N, K]; bias: [N] or None.  Returns
    [..., N] in x's dtype; differentiable in x, w and bias.  CPU tensors
    take the plain version; CUDA tensors launch the kernel (f32 or bf16,
    any shape) or raise."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unsupported activation {activation!r}; have "
                         f"{sorted(ACTIVATIONS)}")
    lead, K = x.shape[:-1], x.shape[-1]
    x2d = x.reshape(-1, K)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w, bias)):
        out = _FusedLinear.apply(x2d, w, bias, activation)
    else:
        out = _forward(x2d, w, bias, activation)
    return out.reshape(*lead, w.shape[0])
