"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

A second package beside the JAX one, written for an NVIDIA H100.  The
JAX package (``paddle_tpu``) stays the reference; this package imports
``torch`` and never ``jax`` or anything of ``paddle_tpu``.  Every kernel
the JAX package wrote in Pallas for the TPU is, here, a CUDA C++ kernel
for ``sm_90a`` under ``csrc/``, built at first use
(``kernels/_build.py``); beside each one sits its plain PyTorch version,
which runs only for tensors on the CPU.

It covers the greedy serving path (``serving.Engine`` over
``models.llama.LlamaForCausalLM`` with the fused paged-decode and
chunked-prefill steps, from full-precision or int8 / fp8 KV pools, with
full-precision or int8 weights), the no-cache training path, and the
static-graph frontend (``static``: record a Program, fuse linear ->
activation pairs into the ``fused_linear`` kernel, train it with
``Executor``), which BERT (``models.bert``) runs on, and the high-level
training loop (``Model``, from ``hapi``: ``prepare`` / ``fit`` /
``evaluate`` / ``predict`` with ``io``'s loaders, ``metric``, ``nn``'s
losses, callbacks and ``resilience.ResilienceCallback``'s resumable,
NaN-guarded checkpoints).

    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, ServingConfig
    model = LlamaForCausalLM(LlamaConfig.tiny())          # on cuda
    eng = Engine(model, ServingConfig(max_batch_size=8))
    req = eng.submit(prompt_ids, max_new_tokens=16)
    eng.run_until_complete()

    import paddle_tpu_torch as paddle
    model = paddle.Model(LlamaForCausalLM(LlamaConfig.tiny()))
    model.prepare(paddle.optimizer.AdamW(1e-3, parameters=model.parameters()),
                  paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    model.fit(batches, epochs=1)          # batches of (ids, next ids)
"""
from __future__ import annotations

from . import io, metric, nn, optimizer, static
from .device import resolve_device
from .framework.io import load, save
from .hapi import Model, summary
from .static import disable_static, enable_static

__all__ = ["Model", "disable_static", "enable_static", "io", "load",
           "metric", "nn", "optimizer", "resolve_device", "save", "static",
           "summary"]
