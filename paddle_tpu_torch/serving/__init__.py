"""paddle_tpu_torch.serving — continuous-batching LLM inference on the GPU.

- :mod:`engine`    — the continuous-batching :class:`Engine`
- :mod:`cache`     — :class:`BlockKVPool`, the paged cache memory manager
- :mod:`scheduler` — FCFS + fairness policy, admission control, preemption
- :mod:`metrics`   — TTFT/TPOT/queue-time counters + engine gauges

Quick start::

    from paddle_tpu_torch.serving import Engine, ServingConfig
    eng = Engine(model, ServingConfig(max_batch_size=8, block_size=16,
                                      num_blocks=128))
    req = eng.submit(prompt_ids, max_new_tokens=64, eos_token_id=2)
    eng.run_until_complete()
    tokens = req.output_ids()
    print(eng.stats())
"""
from __future__ import annotations

from .cache import BlockKVPool, PoolExhausted
from .engine import Engine, ServingConfig
from .metrics import RequestTimeline, ServingMetrics
from .scheduler import (FINISHED, PREEMPTED, PREFILLING, QUEUED, RUNNING,
                        AdmissionError, QueueFull, Request, Scheduler)

__all__ = [
    "Engine", "ServingConfig", "BlockKVPool", "PoolExhausted", "Scheduler",
    "Request", "AdmissionError", "QueueFull", "ServingMetrics",
    "RequestTimeline", "QUEUED", "PREFILLING", "RUNNING", "PREEMPTED",
    "FINISHED",
]
