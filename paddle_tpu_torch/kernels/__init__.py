"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch version (which runs only for CPU tensors).

- :mod:`rms_norm`           — ``csrc/rms_norm.cu``, the norm and the f32
  row scale (``rms_scale``) every fused_norm_linear group takes
- :mod:`fused_norm_linear`  — ``csrc/fused_norm_linear.cu``
- :mod:`paged_attention`    — ``csrc/paged_attention.cu`` (f32, bf16,
  int8 and fp8 KV pools)
- :mod:`chunked_prefill`    — ``csrc/chunked_prefill.cu`` (the same)
- :mod:`kv_quant`           — ``csrc/kv_quant.cu``, the int8 / fp8 KV
  codec and the KV write (row lookup, a decode step's k rotation,
  quantization) into every kind of pool
- :mod:`rope`               — ``csrc/rope.cu``
- :mod:`flash_attention`    — ``csrc/flash_attention.cu``
- :mod:`moe_dispatch`       — ``csrc/moe_dispatch.cu``, MoE dispatch and
  combine, each the other's backward
- :mod:`fused_linear`       — ``csrc/fused_linear.cu``, a product with its
  bias and activation in the epilogue (the static pass
  ``fuse_linear_act`` puts it in place of linear -> activation)

``_build.launches`` counts each kernel's launches.
"""
from ._build import launches

__all__ = ["launches"]
