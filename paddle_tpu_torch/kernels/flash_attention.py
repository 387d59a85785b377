"""FlashAttention forward and backward: CUDA kernels + plain PyTorch
versions, with the autograd plumbing shared by both.

Replaces ``paddle_tpu/kernels/flash_attention.py``: ``_fwd_kernel``
(launch name ``flash_attention_fwd``, a forward without grad),
``_fwd_kernel_lse`` (``flash_attention_fwd_lse``, the forward under
grad, which also writes the f32 logsumexp rows), ``_bwd_dq_kernel``
(``flash_attention_bwd_dq``) and ``_bwd_dkv_kernel``
(``flash_attention_bwd_dkv``).  The kernels are
``csrc/flash_attention.cu``, whose header says what bounds them on the
H100 and how their blocks split the work.

Semantics follow the JAX package: logits ``(q . k) * scale`` in f32,
causal masking bottom-right (query i sees key j iff j <= i + Tk - Tq),
``lse = m + log(l)``, and the FlashAttention-2 backward that recomputes
P from the LSE with ``delta = rowsum(dO * O)`` taken from the ROUNDED
output.  Causal attention with Tq > Tk is refused: it leaves query rows
with no visible key, which training never has.

Grouped-query attention is done in the kernels: query head h reads kv
head ``h // (H // KVH)`` and dK/dV sum over each kv head's group, which
is the vjp of the JAX ``jnp.repeat``.  The kernels take [B, H, T, D]
views with any strides on the first three axes, so
:func:`flash_attention_bthd` hands the model's [B, T, H, D] tensors over
as transposed views, without a copy.

Which kernel runs is chosen for each of the four from the operands
before the launch (:func:`wgmma_width`, :func:`general_route`): bf16
with strides TMA takes runs the wgmma kernels at every head_dim that is
a multiple of 8 up to 256, on the instance of 64, 128 or 256 columns
that holds it, the columns past head_dim zeros (80 and 96, as Phi-2 and
Phi-3 use, on the 128-column one, Gemma's 256 on its own); the padding
costs W / D of the true products (1.33x at 96, 1.6x at 80).  On the
H100 each instance is bound by its products; dK/dV's 256-column
instance computes S and dP once for each of its two warpgroups (1.5x
its products), since one warpgroup cannot hold 64 keys of dK and dV at
256 columns.  f32, and bf16 at head_dims that are not a multiple of 8
(the tests' 20, or 100) or other strides, take the general CUDA-core
instances, each bf16 launch of them counted under its kernel's name with
``_general`` (f32 keeps the plain names).  There is no fallback: a wgmma
instance whose tensor maps or launch fail raises.  There are no
block-size flags and no autotune: the TPU kernel's tiling knobs are not
function.  CPU tensors take the plain versions; CUDA tensors launch the
kernels or raise.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build

SOURCE = "flash_attention"
FWD = "flash_attention_fwd"
FWD_LSE = "flash_attention_fwd_lse"
BWD_DQ = "flash_attention_bwd_dq"
BWD_DKV = "flash_attention_bwd_dkv"
NEG_INF = -1e30
MAX_HEAD_DIM = 256          # csrc/flash_attention.cu F_MAXD
WGMMA_WIDTHS = (64, 128, 256)   # the bf16 wgmma kernels' instances
GENERAL = "_general"        # suffix of a bf16 launch of a general kernel


# ------------------------------------------------------------ plain versions
def _mask(Tq, Tk, device):
    """Bottom-right causal mask [Tq, Tk]: key j visible to query i iff
    j <= i + Tk - Tq."""
    return torch.ones((Tq, Tk), dtype=torch.bool, device=device).tril(Tk - Tq)


def _repeat_kv(x, rep):
    return x.repeat_interleave(rep, dim=1) if rep > 1 else x


def _logits(q, k, causal, scale):
    """f32 logits [B, H, Tq, Tk] of q [B, H, Tq, D] against k with the
    same head count, masked keys at NEG_INF."""
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if causal:
        s = torch.where(_mask(q.shape[2], k.shape[2], q.device), s, NEG_INF)
    return s


def attn_reference(q, k, v, causal, scale):
    """The JAX ``_attn_reference``: [B, H, T, D], one head count, f32
    logits, probabilities cast to q's dtype before the second product."""
    probs = torch.softmax(_logits(q, k, causal, scale), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bhsd->bhtd", probs, v)


def flash_fwd_plain(q, k, v, causal, scale):
    """``(o, lse)`` as the kernels compute them: o in q's dtype, lse f32
    [B, H, Tq].  k/v [B, KVH, Tk, D] with KVH dividing H."""
    rep = q.shape[1] // k.shape[1]
    s = _logits(q, _repeat_kv(k, rep), causal, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bhts,bhsd->bhtd", p, _repeat_kv(v, rep).float())
    return (o / l).to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _delta(o, do):
    """FlashAttention-2's delta = rowsum(dO * O), f32 [B, H, Tq], from
    the output as it was rounded."""
    return (do.float() * o.float()).sum(-1)


def _bwd_plain(q, k, v, do, lse, delta, causal, scale):
    B, H, Tq, D = q.shape
    KVH, Tk = k.shape[1], k.shape[2]
    rep = H // KVH
    kr, vr = _repeat_kv(k, rep).float(), _repeat_kv(v, rep).float()
    p = torch.exp(_logits(q, kr, causal, scale) - lse[..., None])
    dp = torch.einsum("bhtd,bhsd->bhts", do.float(), vr)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kr)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, q.float())
    dv = torch.einsum("bhts,bhtd->bhsd", p, do.float())
    if rep > 1:
        dk = dk.reshape(B, KVH, rep, Tk, D).sum(2)
        dv = dv.reshape(B, KVH, rep, Tk, D).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_plain(q, k, v, o, lse, do, causal, scale):
    """FlashAttention-2 backward ``(dq, dk, dv)``: P recomputed from the
    LSE, dS = P * (dO V^T - delta) * scale, all in f32, each gradient
    rounded once to its operand's dtype (dK/dV summed over each kv
    head's group first)."""
    return _bwd_plain(q, k, v, do, lse, _delta(o, do), causal, scale)


# ------------------------------------------------------------------ kernels
_ARGS = [ctypes.c_int] * 6 + [ctypes.c_int64] * 6 + [
    ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p]


def _kernel_view(t):
    """``t`` as a [B, H, T, D] view the kernels can index: dense in the
    [B, H, T, D] or [B, T, H, D] order and 16-byte aligned, else a
    contiguous copy."""
    if not (t.is_contiguous() or t.transpose(1, 2).is_contiguous()) \
            or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _like(t, ref):
    """``t`` with ``ref``'s strides (the kernels share one set of strides
    between q, O, dO and dQ, and one between k, v, dK and dV)."""
    return t if t.stride() == ref.stride() else torch.empty_like(ref).copy_(t)


def _strides(t):
    """The strides of a [B, H, T, D] view's first three axes as the
    kernels take them: an axis of extent 1, whose stride never matters,
    gets the view's element count (a multiple of D)."""
    return [s if n != 1 else t.numel()
            for n, s in zip(t.shape[:3], t.stride()[:3])]


def tma_strides(t):
    """:func:`_strides`, each a multiple of 16 bytes, or raise: the bf16
    forward, dQ and dK/dV load their tiles by TMA, whose tensor maps take
    no other stride."""
    st = _strides(t)
    if any(s * t.element_size() % 16 for s in st):
        raise ValueError(f"flash_attention: the bf16 kernels' tensor maps "
                         f"need strides that are multiples of 16 bytes; "
                         f"got {t.stride()[:3]} elements of "
                         f"{t.element_size()} bytes")
    return st


def wgmma_width(q, k, kernel):
    """The columns of the bf16 wgmma instance that runs ``kernel`` (FWD,
    FWD_LSE, BWD_DQ or BWD_DKV) on these [B, H, T, D] views, or None
    where the general instances do: every kernel takes a head_dim D that
    is a multiple of 8 on the instance of 64 (D <= 64), 128 or 256
    columns; f32, other head_dims and strides the tensor maps cannot
    take (:func:`tma_strides`) take the general ones.  Raises for
    head_dim above 256, which no kernel takes."""
    D = q.shape[-1]
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} has no kernel "
                         f"(at most {MAX_HEAD_DIM})")
    if kernel not in (FWD, FWD_LSE, BWD_DQ, BWD_DKV):
        raise ValueError(f"flash_attention: no kernel {kernel!r}")
    if q.dtype != torch.bfloat16 or D % 8:
        return None
    try:
        tma_strides(q), tma_strides(k)
    except ValueError:
        return None
    return next(w for w in WGMMA_WIDTHS if D <= w)


def general_route(q, k, kernel):
    """Whether the general instances run ``kernel`` on these views (see
    :func:`wgmma_width`)."""
    return wgmma_width(q, k, kernel) is None


def instance(q, k, kernel):
    """The instance of ``kernel`` these views launch, as the launch
    counter tallies it beside the kernel's name: ``w{W}`` for the wgmma
    instance of W columns, ``maxd128`` or ``maxd256`` for the general
    one (head_dim up to 128, or up to 256)."""
    W = wgmma_width(q, k, kernel)
    if W is None:
        return f"maxd{128 if q.shape[-1] <= 128 else MAX_HEAD_DIM}"
    return f"w{W}"


def _launch_name(base, q, k):
    """The counter of a launch of kernel ``base``: ``base``, or ``base``
    + ``_general`` for a bf16 launch of a general instance."""
    general = q.dtype == torch.bfloat16 and general_route(q, k, base)
    return base + GENERAL if general else base


def _common_args(q, k, causal, scale, kernel):
    B, H, Tq, D = q.shape
    KVH, Tk = k.shape[1], k.shape[2]
    return [B, H, KVH, Tq, Tk, D, *_strides(q), *_strides(k),
            int(causal), float(scale), _build.dtype_code(q),
            int(general_route(q, k, kernel)), _build.stream_ptr(q)]


def _fwd_kernel(q, k, v, causal, scale, with_lse):
    _build.require_cuda(FWD, q, k, v, contiguous=False)
    q, k = _kernel_view(q), _kernel_view(k)
    v = _like(_kernel_view(v), k)
    o = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device) \
        if with_lse else None
    fn = _build.bind(SOURCE, "flash_fwd", [ctypes.c_void_p] * 5 + _ARGS)
    p = _build.ptr
    name = FWD_LSE if with_lse else FWD
    _build.check(fn(p(q), p(k), p(v), p(o), p(lse) if with_lse else None,
                    *_common_args(q, k, causal, scale, name)), SOURCE)
    _build.launches.add(_launch_name(name, q, k), instance(q, k, name))
    return o, lse


def _bwd_operands(q, k, v, do, lse, delta):
    """The backward kernels' operands, checked and laid out for them."""
    _build.require_cuda(BWD_DQ, q, k, v, do, lse, delta, contiguous=False)
    q, k = _kernel_view(q), _kernel_view(k)
    # dO and v take q's and k's strides, which the route checked
    return (q, k, _like(_kernel_view(v), k), _like(do, q), lse.contiguous(),
            delta.contiguous())


def _dq_kernel(q, k, v, do, lse, delta, causal, scale):
    dq = torch.empty_like(q)
    fn = _build.bind(SOURCE, "flash_bwd_dq", [ctypes.c_void_p] * 7 + _ARGS)
    p = _build.ptr
    _build.check(fn(p(q), p(k), p(v), p(do), p(lse), p(delta), p(dq),
                    *_common_args(q, k, causal, scale, BWD_DQ)), SOURCE)
    _build.launches.add(_launch_name(BWD_DQ, q, k), instance(q, k, BWD_DQ))
    return dq


def _dkv_kernel(q, k, v, do, lse, delta, causal, scale):
    dk, dv = torch.empty_like(k), torch.empty_like(k)
    fn = _build.bind(SOURCE, "flash_bwd_dkv", [ctypes.c_void_p] * 8 + _ARGS)
    p = _build.ptr
    _build.check(fn(p(q), p(k), p(v), p(do), p(lse), p(delta), p(dk), p(dv),
                    *_common_args(q, k, causal, scale, BWD_DKV)), SOURCE)
    _build.launches.add(_launch_name(BWD_DKV, q, k),
                        instance(q, k, BWD_DKV))
    return dk, dv


def _bwd_kernels(q, k, v, do, lse, delta, causal, scale):
    ops = _bwd_operands(q, k, v, do, lse, delta)
    return (_dq_kernel(*ops, causal, scale),
            *_dkv_kernel(*ops, causal, scale))


def _fwd(q, k, v, causal, scale, with_lse):
    if q.device.type == "cpu":
        o, lse = flash_fwd_plain(q, k, v, causal, scale)
        return o, lse if with_lse else None
    return _fwd_kernel(q, k, v, causal, scale, with_lse)


def _bwd(q, k, v, do, lse, delta, causal, scale):
    if q.device.type == "cpu":
        return _bwd_plain(q, k, v, do, lse, delta, causal, scale)
    return _bwd_kernels(q, k, v, do, lse, delta, causal, scale)


class _FlashAttention(torch.autograd.Function):
    """Saves O (as rounded) and the f32 LSE; the backward computes delta
    and runs dQ and dK/dV."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = _fwd(q, k, v, causal, scale, with_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _bwd(q, k, v, do, lse, _delta(o, do), ctx.causal,
                          ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_bhtd(q, k, v, causal=False, scale=None):
    """Attention of q [B, H, Tq, D] over k/v [B, KVH, Tk, D] (KVH divides
    H), differentiable in all three.  ``scale`` defaults to 1/sqrt(D).
    Under grad the forward also writes the LSE for the backward; without
    grad it does not."""
    B, H, Tq, D = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != B \
            or k.shape[3] != D or k.shape[1] == 0 or H % k.shape[1] \
            or k.shape[2] == 0 or q.dtype != k.dtype or v.dtype != k.dtype:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} {q.dtype} "
                         f"does not fit k {tuple(k.shape)} {k.dtype}, v "
                         f"{tuple(v.shape)} {v.dtype}")
    if causal and Tq > k.shape[2]:
        raise ValueError(f"flash_attention: causal attention with Tq={Tq} > "
                         f"Tk={k.shape[2]} leaves query rows with no "
                         "visible key")
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _fwd(q, k, v, causal, scale, with_lse=False)[0]


def flash_attention_bthd(q, k, v, causal=False, scale=None):
    """The [B, T, H, D] layout (the model's): q [B, Tq, H, D], k/v
    [B, Tk, KVH, D], output [B, Tq, H, D] (on the card, in q's memory
    order: no transpose is copied)."""
    out = flash_attention_bhtd(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal, scale)
    return out.transpose(1, 2)
