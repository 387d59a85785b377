"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, written for an NVIDIA H100.  The
JAX package (``paddle_tpu``) stays the reference; this package imports
``torch`` and never ``jax`` or anything of ``paddle_tpu``.  Every kernel
the JAX package wrote in Pallas for the TPU is, here, a CUDA C++ kernel
for ``sm_90a`` under ``csrc/``, built at first use
(``kernels/_build.py``); beside each one sits its plain PyTorch version,
which runs only for tensors on the CPU.

Slice 1 covers the greedy serving path: ``serving.Engine`` over
``models.llama.LlamaForCausalLM`` with the fused paged-decode and
chunked-prefill steps.

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, ServingConfig
    model = LlamaForCausalLM(LlamaConfig.tiny())          # on cuda
    eng = Engine(model, ServingConfig(max_batch_size=8))
    req = eng.submit(prompt_ids, max_new_tokens=16)
    eng.run_until_complete()
"""
from __future__ import annotations

from .device import resolve_device

__all__ = ["resolve_device"]
