"""Quantization in the port: serving's weight-only int8
(:mod:`.serving`)."""
from __future__ import annotations

from .serving import quantize_model_weights, resolve_weight_dtype

__all__ = ["quantize_model_weights", "resolve_weight_dtype"]
