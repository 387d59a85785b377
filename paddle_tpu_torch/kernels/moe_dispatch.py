"""MoE token dispatch and combine (GShard capacity-padded routing): CUDA
kernels + plain PyTorch versions, each the other's backward.

Replaces ``paddle_tpu/kernels/moe_dispatch.py`` ``_dispatch_kernel`` and
``_combine_kernel`` (the ``pallas_call``s in ``_dispatch_raw`` and
``_combine_raw``); the kernels are ``csrc/moe_dispatch.cu``, whose header
says what bounds them on the H100.

- dispatch: tokens [T, M] -> [E, C, M], ``out[e, c] = sum of w[t, k] *
  tokens[t]`` over the choices (t, k) with ``eidx[t, k] = e`` and
  ``sidx[t, k] = c``; a choice with ``sidx >= C`` is dropped; slots no
  choice names are zero.
- combine: [E, C, M] -> [T, M], ``out[t] = sum over k of w[t, k] *
  expert_out[eidx[t, k], sidx[t, k]]``, dropped choices contributing 0.
Both accumulate in f32 and round once to the tokens' dtype, as the TPU
kernels do.  (The reference's XLA fallback ``_combine_xla`` multiplies
and sums in the tokens' dtype instead; in bf16 the two differ.)

The vjps are the reference's (``_moe_dispatch_bwd``, ``_moe_combine_bwd``):
the gradient of the routed rows is the other kernel, the gradient of the
weights the f32 dot of each routed row with its cotangent row, in plain
PyTorch (XLA in the reference).

Indices are int32 [T, K]; weights [T, K] f32 or the tokens' dtype.  The
kernels take any T, C and M.  Dispatch is one launch in every form
(decode, prefill chunk, training, dropping, backward): persistent blocks
that each own every G-th slot, sized by :func:`dispatch_plan`.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

LIB = "moe_dispatch"
DISPATCH = "moe_dispatch"       # launch counters
COMBINE = "moe_combine"
BLOCKS_PER_SM = 2               # csrc/moe_dispatch.cu DP_MIN_BLOCKS
MAX_SLOTS = 3000                # slots a block: 4 ints each in its 48 KB
                                # of shared memory
MIN_WRITE = 16                  # elements a block writes per choice it reads


def moe_capacity(tokens: int, experts: int, top_k: int,
                 capacity_factor: float = 1.0) -> int:
    """GShard expert capacity: ceil(capacity_factor * T * K / E), the C
    in the padded [E, C, M] dispatch buffer."""
    return max(1, -(-int(tokens * top_k * capacity_factor) // experts))


def _slots(eidx, sidx, C):
    """(flat row ``eidx * C + min(sidx, C - 1)``, kept mask ``sidx <
    C``), both [T, K]."""
    s = sidx.long()
    return eidx.long() * C + torch.clamp(s, max=C - 1), s < C


def dispatch_plain(tokens, eidx, sidx, weights, E, C):
    T, M = tokens.shape
    K = eidx.shape[1]
    rows, kept = (x.reshape(-1) for x in _slots(eidx, sidx, C))
    weighted = tokens.float().repeat_interleave(K, 0) \
        * weights.reshape(-1, 1).float()
    out = torch.zeros((E * C, M), dtype=torch.float32, device=tokens.device)
    out.index_add_(0, rows[kept], weighted[kept])
    return out.view(E, C, M).to(tokens.dtype)


def combine_plain(expert_out, eidx, sidx, weights):
    E, C, M = expert_out.shape
    rows, kept = _slots(eidx, sidx, C)
    w = weights.float() * kept
    gathered = expert_out.reshape(E * C, M)[rows].float()       # [T, K, M]
    return (gathered * w[..., None]).sum(1).to(expert_out.dtype)


def dispatch_plan(slots, n, M, sm_count):
    """(blocks, slots a block) of the dispatch kernel for ``slots`` = E*C
    rows of ``M`` elements and ``n`` = T*K choices: a power of two (the
    kernel finds a slot's block with a mask), at most BLOCKS_PER_SM a SM,
    fewer where there are fewer slots or where a block would write fewer
    than MIN_WRITE elements per choice it reads (each block re-reads all
    n), more where a block would own more than MAX_SLOTS (its shared
    memory).  Block b owns the slots b, b + blocks, ..., at least one and
    at most ``per``.  (0, 0), no launch, when there is nothing to
    write."""
    if slots <= 0 or M <= 0:
        return 0, 0
    want = min(slots, BLOCKS_PER_SM * sm_count,
               max(1, slots * M // (MIN_WRITE * max(n, 1))))
    blocks = 1 << (want.bit_length() - 1)
    while -(-slots // blocks) > MAX_SLOTS:
        blocks *= 2
    return blocks, -(-slots // blocks)


def _operands(what, T, dtype, eidx, sidx, weights):
    """Check the CUDA kernels' routing operands for T tokens of
    ``dtype``."""
    K = eidx.shape[-1]
    if eidx.shape != (T, K) or sidx.shape != (T, K) or \
            weights.shape != (T, K):
        raise ValueError(f"{what}: eidx {tuple(eidx.shape)}, sidx "
                         f"{tuple(sidx.shape)}, weights "
                         f"{tuple(weights.shape)} do not fit {T} tokens")
    if eidx.dtype != torch.int32 or sidx.dtype != torch.int32:
        raise TypeError(f"{what}: the CUDA kernel takes int32 indices, got "
                        f"{eidx.dtype} and {sidx.dtype}")
    if weights.dtype not in (torch.float32, dtype):
        raise TypeError(f"{what}: weights must be float32 or {dtype}, got "
                        f"{weights.dtype}")


def _vec(M, *tensors) -> int:
    """1 when every row is 16 bytes' worth of elements and 16-byte
    aligned, so a thread moves 16 bytes a load."""
    t = tensors[0]
    return int(M * t.element_size() % 16 == 0
               and all(x.data_ptr() % 16 == 0 for x in tensors))


def _dispatch(tokens, eidx, sidx, weights, E, C):
    """The plain version for a CPU tensor, the kernel for a CUDA one
    (weights read as given, f32 or the tokens' dtype)."""
    if tokens.device.type == "cpu":
        return dispatch_plain(tokens, eidx, sidx, weights, E, C)
    code = _build.dtype_code(tokens)
    _operands(DISPATCH, tokens.shape[0], tokens.dtype, eidx, sidx, weights)
    tokens, eidx, sidx, w = (x.contiguous()
                             for x in (tokens, eidx, sidx, weights))
    _build.require_cuda(DISPATCH, tokens, eidx, sidx, w)
    T, M = tokens.shape
    K = eidx.shape[1]
    out = torch.empty((E, C, M), dtype=tokens.dtype, device=tokens.device)
    blocks, per = dispatch_plan(E * C, T * K, M,
                                _build.sm_count(tokens.device))
    if blocks == 0:
        return out
    fn = _build.bind(LIB, "moe_dispatch", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    p = _build.ptr
    _build.check(fn(p(tokens), p(eidx), p(sidx), p(w), p(out), T, K, M, E,
                    C, code, int(w.dtype == torch.float32),
                    _vec(M, tokens, out), blocks, per,
                    _build.stream_ptr(tokens)), DISPATCH)
    _build.launches.add(DISPATCH)
    return out


def _combine(expert_out, eidx, sidx, weights):
    """The plain version for a CPU tensor, the kernel for a CUDA one
    (weights read as given, f32 or the tokens' dtype)."""
    if expert_out.device.type == "cpu":
        return combine_plain(expert_out, eidx, sidx, weights)
    code = _build.dtype_code(expert_out)
    E, C, M = expert_out.shape
    _operands(COMBINE, eidx.shape[0], expert_out.dtype, eidx, sidx, weights)
    expert_out, eidx, sidx, w = (x.contiguous() for x in
                                 (expert_out, eidx, sidx, weights))
    _build.require_cuda(COMBINE, expert_out, eidx, sidx, w)
    T, K = eidx.shape
    out = torch.empty((T, M), dtype=expert_out.dtype,
                      device=expert_out.device)
    fn = _build.bind(LIB, "moe_combine", [ctypes.c_void_p] * 5
                     + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    p = _build.ptr
    _build.check(fn(p(expert_out), p(eidx), p(sidx), p(w), p(out), T, K, M,
                    E, C, code, int(w.dtype == torch.float32),
                    _vec(M, expert_out, out),
                    _build.stream_ptr(expert_out)), COMBINE)
    _build.launches.add(COMBINE)
    return out


def _weights_grad(table, rows, eidx, sidx, C):
    """d weights [T, K] f32: the f32 dot of ``table`` [E, C, M] at each
    choice's slot with that choice's row of ``rows`` [T, M], 0 for a
    dropped choice (the reference's ``dw``)."""
    flat, kept = _slots(eidx, sidx, C)
    gathered = table.reshape(-1, table.shape[-1])[flat].float()  # [T, K, M]
    return (gathered * rows.float()[:, None, :]).sum(-1) * kept


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tokens, eidx, sidx, weights, E, C):
        ctx.save_for_backward(tokens, eidx, sidx, weights)
        ctx.C = C
        return _dispatch(tokens, eidx, sidx, weights, E, C)

    @staticmethod
    def backward(ctx, g):
        tokens, eidx, sidx, weights = ctx.saved_tensors
        dtok = dw = None
        if ctx.needs_input_grad[0]:      # a combine of g
            dtok = _combine(g, eidx, sidx, weights).to(tokens.dtype)
        if ctx.needs_input_grad[3]:
            dw = _weights_grad(g, tokens, eidx, sidx, ctx.C) \
                .to(weights.dtype)
        return dtok, None, None, dw, None, None


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, expert_out, eidx, sidx, weights):
        ctx.save_for_backward(expert_out, eidx, sidx, weights)
        return _combine(expert_out, eidx, sidx, weights)

    @staticmethod
    def backward(ctx, g):
        expert_out, eidx, sidx, weights = ctx.saved_tensors
        E, C, _ = expert_out.shape
        d_eo = dw = None
        if ctx.needs_input_grad[0]:      # a dispatch of g
            d_eo = _dispatch(g, eidx, sidx, weights, E, C) \
                .to(expert_out.dtype)
        if ctx.needs_input_grad[3]:
            dw = _weights_grad(expert_out, g, eidx, sidx, C) \
                .to(weights.dtype)
        return d_eo, None, None, dw


def _grad(*tensors):
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def moe_dispatch(tokens, eidx, sidx, weights, E, C):
    """Route ``tokens`` [T, M] to the [E, C, M] expert buffers (module
    docstring), differentiable in ``tokens`` and ``weights``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel."""
    if _grad(tokens, weights):
        return _Dispatch.apply(tokens, eidx, sidx, weights, E, C)
    return _dispatch(tokens, eidx, sidx, weights, E, C)


def moe_combine(expert_out, eidx, sidx, weights):
    """Gather ``expert_out`` [E, C, M] back per token with the gate
    ``weights`` (module docstring), differentiable in ``expert_out`` and
    ``weights``."""
    if _grad(expert_out, weights):
        return _Combine.apply(expert_out, eidx, sidx, weights)
    return _combine(expert_out, eidx, sidx, weights)
