"""Paged-KV storage: the int8 / fp8 codec, and the write of a step's new
k and v rows into the pools (CUDA kernel + plain PyTorch version).

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

:func:`kv_write` replaces the reference's writes, which are XLA code and
not Pallas (``paged_attention.py`` ``fused_paged_decode``'s k rotation
and ``_scatter_token`` / ``_scatter_token_quant`` for a decode token,
``models/llama.py`` ``_scatter`` / ``_scatter_q`` for a prefill chunk):
one launch (``csrc/kv_quant.cu``) looks up every token's row, rotates a
decode step's k, and writes k and v, into pools of the model's dtype or
as codes and scales.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .rope import rotate_half

KERNEL = "kv_write"
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
            and k_scale is not None and v_scale is not None
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


def token_rows(block_table, positions, T, bs, write_mask=None):
    """Flat pool row [B * T] (int64) of token t of sequence b, at position
    ``positions[b] + t``: ``block_table[b, min(pos // bs, nbs - 1)] * bs +
    pos % bs``, the reference's index math and column clamp; a token that
    ``write_mask`` [B, T] leaves out goes to row 0, the garbage block."""
    B, nbs = block_table.shape
    pos = positions.long()[:, None] + torch.arange(T, device=positions.device)
    rows = torch.arange(B, device=positions.device)[:, None]
    col = torch.clamp(pos // bs, max=nbs - 1)
    idx = block_table[rows, col].long() * bs + pos % bs
    if write_mask is not None:
        idx = torch.where(write_mask, idx, 0)
    return idx.reshape(-1)


def kv_write_plain(k_pool, v_pool, k, v, block_table, positions, c=None,
                   s=None, write_mask=None, k_scale=None, v_scale=None,
                   scheme=None):
    B, T, KVH, D = k.shape
    if c is not None:           # k in f32, rounded once to its dtype
        k = rotate_half(k.float(), c[:, None, None, :],
                        s[:, None, None, :]).to(k.dtype)
    rows = token_rows(block_table, positions, T, k_pool.shape[1], write_mask)
    k, v = (x.reshape(B * T, KVH, D) for x in (k, v))
    if scheme is not None:
        quantize_scatter_plain(k_pool, v_pool, k_scale, v_scale, k, v, rows,
                               scheme)
        return
    for pool, new in ((k_pool, k), (v_pool, v)):
        nb, bs = pool.shape[0], pool.shape[1]
        pool.view(nb * bs, KVH, D).index_copy_(0, rows, new.to(pool.dtype))


def kv_write(k_pool, v_pool, k, v, block_table, positions, *, c=None,
             s=None, write_mask=None, k_scale=None, v_scale=None,
             scheme=None):
    """Write the new rows ``k``/``v`` [B, T, KVH, D] (model dtype) IN
    PLACE into the pools [nb, bs, KVH, D]: token t of sequence b at
    ``positions[b] + t`` through ``block_table`` [B, nbs] int32
    (:func:`token_rows`; ``positions`` [B] int32).  Two forms:

    - a decode step (T == 1): ``c``/``s`` [B, D/2] are the RoPE rows at
      ``positions`` and k comes unrotated; it is rotated in f32 and
      rounded once to its dtype before the write;
    - a prefill chunk: k comes rotated; ``write_mask`` [B, T] bool sends
      the padded tokens to row 0 of the garbage block.

    Pools of the rows' dtype take them as they are (``scheme`` None);
    int8 pools take the codes of ``scheme`` ("int8" / "fp8") and the
    [nb, bs] f32 ``k_scale``/``v_scale`` their row scales.  A row of
    the garbage block that several tokens share gets one of them whole
    (the kernel: the last).  CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    if k.device.type == "cpu":
        return kv_write_plain(k_pool, v_pool, k, v, block_table, positions,
                              c, s, write_mask, k_scale, v_scale, scheme)
    B, T, KVH, D = k.shape
    nbs = block_table.shape[1]
    rot = c is not None
    if (v.shape != k.shape or v.dtype != k.dtype or D % 2
            or k_pool.shape[2:] != (KVH, D)
            or not pools_fit(k.dtype, k_pool, v_pool, k_scale, v_scale,
                             scheme)
            or block_table.shape[0] != B or block_table.dtype != torch.int32
            or positions.shape != (B,) or positions.dtype != torch.int32
            or (s is None) == rot
            or (rot and (T != 1 or c.shape != (B, D // 2)
                         or s.shape != c.shape or s.dtype != c.dtype))
            or (write_mask is not None
                and (write_mask.shape != (B, T)
                     or write_mask.dtype != torch.bool))):
        raise ValueError("kv_write: operands do not fit new rows "
                         f"{tuple(k.shape)} {k.dtype}, pool "
                         f"{tuple(k_pool.shape)} {k_pool.dtype}")
    if B * T == 0:
        return
    ops = [x.contiguous() if x is not None else None
           for x in (k, v, c, s, write_mask)]
    scales = () if scheme is None else (k_scale, v_scale)
    _build.require_cuda(KERNEL, *(x for x in ops if x is not None), k_pool,
                        v_pool, block_table, positions, *scales)
    vec = (D // 2) % (16 // k.element_size()) == 0 and all(
        x.data_ptr() % 16 == 0 for x in (*ops[:4], k_pool, v_pool)
        if x is not None)
    fn = _build.bind(LIB, "kv_write", [ctypes.c_void_p] * 11
                     + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    p = _build.ptr

    def ptr(x):
        return None if x is None else p(x)

    _build.check(fn(*(ptr(x) for x in ops[:4]), p(block_table),
                    p(positions), ptr(ops[4]), p(k_pool), p(v_pool),
                    *(ptr(x) for x in (k_scale, v_scale)), B, T, KVH, D,
                    k_pool.shape[1], nbs, _build.dtype_code(k),
                    _build.dtype_code(c) if rot else 0,
                    KV_DTYPE_CODES[scheme], int(vec),
                    _build.stream_ptr(k)), KERNEL)
    _build.launches.add(KERNEL)
