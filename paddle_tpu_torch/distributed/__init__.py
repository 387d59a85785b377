"""Distributed training of the port (``paddle_tpu/distributed``): so far
activation recomputation (``recompute``)."""
from .recompute import RecomputeWrapper, recompute, recompute_sequential

__all__ = ["RecomputeWrapper", "recompute", "recompute_sequential"]
