"""Device resolution for the PyTorch port (counterpart of
``paddle_tpu/core/place.py``).

Every entry point takes an explicit ``device``.  Left as ``None`` it
means the GPU: the port is written for an NVIDIA card, and running on
the CPU is something a caller asks for (``device="cpu"``, which is what
the tests do).  There is no silent fallback: asking for ``cuda`` on a
machine without one raises.
"""
from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=None) -> torch.device:
    """``device`` (``None``, a string or a ``torch.device``) as a
    ``torch.device``; ``None`` means ``cuda``.  Raises ``RuntimeError``
    for a CUDA device when no GPU is visible."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch versions "
            "of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
