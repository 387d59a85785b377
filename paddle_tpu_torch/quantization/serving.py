"""Weight-only int8 for serving (``ServingConfig(weight_dtype="int8")``).

The port of ``paddle_tpu/quantization/serving.py``.  The serving
model's layers hand their raw ``weight`` tensors to the fused kernels
(``fused_norm_linear``) and to plain products, so there is no per-layer
forward to swap: :func:`quantize_model_weights` quantizes every
:class:`~paddle_tpu_torch.models.llama.Linear` weight IN PLACE, lm_head
included, and keeps the model as it is otherwise:

* the per-output-channel absmax codes and f32 scales become buffers of
  the layer (``weight_int8`` [in, out] int8, ``weight_scale`` [1, out]
  f32): the artifacts a deployment keeps;
* the weight becomes their dequantization ``codes * (scale / 127)``,
  computed in f32 and stored in the model's dtype.

The JAX package stores that dequantization in f32 whatever the model's
dtype; the port keeps the model's dtype, so a bf16 model's kernels go on
reading bf16 weights.  For an f32 model the two are the same numbers.
The weights change in place, and the port's steps (their CUDA graphs
too) read the weights' memory at every call, so nothing is rebuilt.

The scale rule is the JAX package's ``_quantize_weight`` (in
``paddle_tpu/quantization/__init__.py``), shared there by QAT, PTQ and
serving: per-output-channel absmax, at least 1e-8, and
``round(w / s * 127)`` clipped to +-127, in that order.
"""
from __future__ import annotations

import logging
from typing import Optional

import torch

__all__ = ["quantize_model_weights", "resolve_weight_dtype"]

logger = logging.getLogger("paddle_tpu_torch.quantization.serving")

_WEIGHT_DTYPE_ALIASES = {
    None: None, "": None, "fp32": None, "float32": None, "auto": None,
    "int8": "int8", "i8": "int8", "w8": "int8", "weight_int8": "int8",
}


def _channel_scale(v, quant_axis):
    """Per-channel absmax scale, keepdims (broadcastable against v),
    at least 1e-8."""
    red = tuple(i for i in range(v.ndim) if i != quant_axis)
    return torch.clamp(v.abs().amax(dim=red, keepdim=True), min=1e-8)


def _quantize_weight(w, quant_axis, qmax=127.0):
    """``(w_int8, scale)`` of f32 ``w``, the scale per ``quant_axis``
    channel and broadcastable against ``w``."""
    s = _channel_scale(w, quant_axis)
    q = torch.clamp(torch.round(w / s * qmax), -qmax, qmax).to(torch.int8)
    return q, s


def resolve_weight_dtype(name: Optional[str]) -> Optional[str]:
    """Canonical weight-quantization scheme, or None for full precision."""
    key = name.lower() if isinstance(name, str) else name
    try:
        return _WEIGHT_DTYPE_ALIASES[key]
    except KeyError:
        raise ValueError(
            f"unsupported weight_dtype {name!r}; serving weight-only "
            f"quantization supports int8 (aliases: i8, w8) or "
            f"fp32/None") from None


@torch.no_grad()
def quantize_model_weights(model, weight_dtype: Optional[str] = None):
    """Quantize ``model``'s linear weights in place (absmax per output
    channel, int8).  Idempotent: the same scheme again is a no-op;
    another scheme on a quantized model raises (the original weights
    are gone).  Returns a report: ``layers`` quantized, ``fp32_bytes``
    the weights took in f32, ``quant_bytes`` the codes and scales."""
    from ..models.llama import Linear

    scheme = resolve_weight_dtype(weight_dtype)
    prior = getattr(model, "_serving_weight_dtype", None)
    if scheme is None:
        if prior is not None:
            raise ValueError(
                f"model weights already quantized to {prior}; cannot "
                "restore full precision (reload the checkpoint)")
        return {"layers": 0, "fp32_bytes": 0, "quant_bytes": 0}
    if prior is not None:
        if prior == scheme:
            return dict(model._serving_weight_quant_report)
        raise ValueError(
            f"model weights already quantized to {prior}; cannot "
            f"requantize to {scheme}")

    layers = fp32_bytes = quant_bytes = 0
    for layer in model.modules():
        if not isinstance(layer, Linear) or layer.weight.ndim != 2:
            continue
        w = layer.weight
        codes, scale = _quantize_weight(w.float(), quant_axis=1)
        layer.register_buffer("weight_int8", codes)
        layer.register_buffer("weight_scale", scale)
        # a tensor divisor: a Python one would be a reciprocal multiply
        # on the card, not the reference's division
        step = scale / scale.new_full((), 127.0)
        w.copy_(codes.float() * step)
        layers += 1
        fp32_bytes += w.numel() * 4
        quant_bytes += codes.numel() + scale.numel() * 4

    report = {"layers": layers, "fp32_bytes": fp32_bytes,
              "quant_bytes": quant_bytes}
    model._serving_weight_dtype = scheme
    model._serving_weight_quant_report = dict(report)
    logger.info("weight-only quant: %d linear layers -> %s (%.2f MiB -> "
                "%.2f MiB resident)", layers, scheme, fp32_bytes / 2**20,
                quant_bytes / 2**20)
    return report
