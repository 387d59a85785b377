"""Quantized paged-KV storage: the codec, and the quantize-at-write
scatter (CUDA kernel + plain PyTorch version).

The port's own copy of ``paddle_tpu/kernels/kv_quant.py``.  The block
pools store KV as int8 CODES plus one float32 absmax scale per (block,
token) ROW, the scale reducing over the row's kv_heads x head_dim
values.  Every KV write quantizes exactly the rows it lands on, so no
earlier code is ever rescaled.  Two schemes share one int8 container:

* ``"int8"``: ``scale = absmax / 127``, ``code = round(clip(x / scale))``;
* ``"fp8"``:  ``scale = absmax / 448`` (e4m3's largest normal), the code
  is the float8_e4m3fn bit pattern of ``clip(x / scale)`` viewed as int8.

Dequantization is ``decode_codes(codes) * scale`` in float32, done by
the attention kernels as they stage a page (``paged_attention``,
``chunked_prefill``).  The order of operations is the reference's,
``absmax / qmax`` and then ``x / scale``, both true divisions, so the
codes and scales are bit-identical to the JAX package's.  A divisor is
never a Python number: PyTorch's CUDA division multiplies by the
reciprocal of a host scalar, which is not a correctly rounded division.

:func:`quantize_scatter` replaces the reference's quantize-and-scatter
writes, which are XLA code and not Pallas (``paged_attention.py``
``_scatter_token_quant`` for a decode token, ``models/llama.py``
``_scatter_q`` for a prefill chunk): one launch writes the k and the v
rows of a step's tokens, codes and scales (``csrc/kv_quant.cu``).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL = "kv_quant_scatter"
LIB = "kv_quant"          # csrc/kv_quant.cu

#: canonical scheme names (``None`` = a full-precision pool)
KV_SCHEMES = ("int8", "fp8")

_ALIASES = {
    None: None, "": None, "fp32": None, "float32": None, "auto": None,
    "int8": "int8", "i8": "int8",
    "fp8": "fp8", "fp8_e4m3": "fp8", "float8_e4m3fn": "fp8",
}

#: clip / quantization range per scheme (e4m3's largest normal is 448)
KV_QMAX = {"int8": 127.0, "fp8": 448.0}

#: numeric gauge codes (the serving_kv_cache_dtype gauge)
KV_DTYPE_CODES = {None: 0, "int8": 1, "fp8": 2}


def resolve_kv_cache_dtype(name):
    """Canonicalize a ``ServingConfig.kv_cache_dtype`` spelling to
    ``None`` / ``"int8"`` / ``"fp8"`` (ValueError on anything else)."""
    if isinstance(name, str):
        name = name.lower()
    if name in _ALIASES:
        return _ALIASES[name]
    raise ValueError(
        f"unsupported kv_cache_dtype {name!r}; expected one of "
        f"{sorted(k for k in _ALIASES if isinstance(k, str))}")


def kv_storage_dtype(scheme):
    """Pool element dtype for ``scheme``: int8 holds both schemes' codes."""
    return torch.int8 if scheme is not None else None


def kv_scale_bytes_per_block(block_size, scheme):
    """Scale-sidecar bytes of ONE (k or v) block: one f32 per token row,
    zero when unquantized."""
    return int(block_size) * 4 if scheme is not None else 0


def kv_bytes_per_element(scheme, fallback_dtype=torch.float32) -> int:
    """Bytes of one stored KV element: 1 for both quantized schemes, the
    pool dtype's width otherwise."""
    if scheme is not None:
        return 1
    return torch.empty((), dtype=fallback_dtype).element_size()


def quantize_kv(x, scheme):
    """Quantize KV rows: ``x`` [..., KVH, D] → (int8 codes of the same
    shape, f32 scales [...]), one absmax scale per leading row.  An
    all-zero row gets scale 1.0, so its dequantization stays exact."""
    qmax = KV_QMAX[scheme]
    xf = x.float()
    absmax = xf.abs().amax(dim=(-2, -1))
    scale = torch.where(absmax > 0.0, absmax / absmax.new_full((), qmax),
                        absmax.new_ones(()))
    y = xf / scale[..., None, None]
    if scheme == "int8":
        codes = torch.clamp(torch.round(y), -qmax, qmax).to(torch.int8)
    else:
        codes = torch.clamp(y, -qmax, qmax).to(torch.float8_e4m3fn) \
            .view(torch.int8)
    return codes, scale


def decode_codes(codes, scheme):
    """Codes → float32, without the scale multiply."""
    if scheme == "int8":
        return codes.float()
    return codes.view(torch.float8_e4m3fn).float()


def dequantize_kv(codes, scale, scheme):
    """``codes`` [..., KVH, D] int8 and per-row ``scale`` [...] → f32."""
    return decode_codes(codes, scheme) * scale[..., None, None]


def gather_pages(pool, scale, bt, scheme):
    """The pages ``bt`` [B, nbs] (int64) of a pool in f32, [B, nbs, bs,
    KVH, D]: a full-precision pool (``scheme`` None) cast, a quantized
    one dequantized (codes times the row's scale, the reference's XLA
    versions of the attention kernels)."""
    if scheme is None:
        return pool[bt].float()
    return decode_codes(pool[bt], scheme) * scale[bt][..., None, None]


def pools_fit(dtype, k_pool, v_pool, k_scale, v_scale, scheme):
    """Whether k/v pools (and scales) are what an attention kernel over
    ``dtype`` activations takes: pools of ``dtype`` (``scheme`` None), or
    int8 codes with [nb, bs] f32 scales."""
    if v_pool.shape != k_pool.shape:
        return False
    if scheme is None:
        return k_pool.dtype == dtype and v_pool.dtype == dtype
    return (k_pool.dtype == torch.int8 and v_pool.dtype == torch.int8
            and k_scale.shape == k_pool.shape[:2]
            and v_scale.shape == k_pool.shape[:2]
            and k_scale.dtype == torch.float32
            and v_scale.dtype == torch.float32)


def counter_name(kernel, scheme):
    """The launch counter of an attention ``kernel`` over pools of
    ``scheme``: its own name, or ``<kernel>_int8`` / ``<kernel>_fp8``."""
    return kernel if scheme is None else f"{kernel}_{scheme}"


def quantize_scatter_plain(k_pool, v_pool, k_scale, v_scale, k_new, v_new,
                           rows, scheme):
    for pool, scales, new in ((k_pool, k_scale, k_new),
                              (v_pool, v_scale, v_new)):
        codes, sc = quantize_kv(new, scheme)
        nb, bs = pool.shape[0], pool.shape[1]
        pool.view(nb * bs, pool.shape[2], pool.shape[3]).index_copy_(
            0, rows, codes)
        scales.view(nb * bs).index_copy_(0, rows, sc)


def quantize_scatter(k_pool, v_pool, k_scale, v_scale, k_new, v_new, rows,
                     scheme):
    """Quantize the rows ``k_new``/``v_new`` [N, KVH, D] (model dtype)
    and write them IN PLACE at the flat pool rows ``rows`` [N] int64
    (``block * block_size + offset``): codes into the int8 pools
    [nb, bs, KVH, D], scales into the [nb, bs] f32 sidecars.  Rows that
    several tokens share (the garbage block's row 0) get one of them.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if k_new.device.type == "cpu":
        return quantize_scatter_plain(k_pool, v_pool, k_scale, v_scale,
                                      k_new, v_new, rows, scheme)
    N, KVH, D = k_new.shape
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    if (k_pool.shape[2:] != (KVH, D) or v_pool.shape != k_pool.shape
            or v_new.shape != k_new.shape or v_new.dtype != k_new.dtype
            or k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8
            or k_scale.shape != (nb, bs) or v_scale.shape != (nb, bs)
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32
            or rows.shape != (N,) or rows.dtype != torch.int64):
        raise ValueError("quantize_scatter: operands do not fit new rows "
                         f"{tuple(k_new.shape)} {k_new.dtype}, pool "
                         f"{tuple(k_pool.shape)} {k_pool.dtype}")
    k_new, v_new = k_new.contiguous(), v_new.contiguous()
    _build.require_cuda(KERNEL, k_new, v_new, k_pool, v_pool, k_scale,
                        v_scale, rows)
    fn = _build.bind(LIB, "kv_quant_scatter",
                     [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
                     + [ctypes.c_void_p])
    p = _build.ptr
    _build.check(fn(p(k_new), p(v_new), p(rows), p(k_pool), p(v_pool),
                    p(k_scale), p(v_scale), N, KVH * D,
                    _build.dtype_code(k_new), KV_DTYPE_CODES[scheme],
                    _build.stream_ptr(k_new)), KERNEL)
    _build.launches.add(KERNEL)
