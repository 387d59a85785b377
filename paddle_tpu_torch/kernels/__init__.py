"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (which runs only for CPU tensors).

- :mod:`rms_norm`           — ``csrc/rms_norm.cu``
- :mod:`fused_norm_linear`  — ``csrc/fused_norm_linear.cu``
- :mod:`paged_attention`    — ``csrc/paged_attention.cu``
- :mod:`chunked_prefill`    — ``csrc/chunked_prefill.cu``

``_build.launches`` counts each kernel's launches.
"""
from ._build import launches

__all__ = ["launches"]
