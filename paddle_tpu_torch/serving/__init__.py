"""paddle_tpu_torch.serving — continuous-batching LLM inference on the GPU.

- :mod:`engine`    — the continuous-batching :class:`Engine`
- :mod:`cache`     — :class:`BlockKVPool`, the paged cache memory manager
- :mod:`scheduler` — FCFS + priority policy, admission control, preemption
- :mod:`metrics`   — TTFT/TPOT/queue-time counters + engine gauges
- :mod:`overload`  — load shedding, degradation ladder, step watchdog
- :mod:`sampling`  — seeded temperature/top-k/top-p (:class:`SamplingParams`)
- :mod:`speculative` — draft propose + batched target verify
  (:class:`SpeculativeConfig`)
- :mod:`router`    — :class:`Router`, prefix- and load-aware fleet
  placement
- :mod:`replay`    — multi-tenant trace replay through a router
- :mod:`stream`    — SSE framing over ``submit(on_token=...)``
- :mod:`endpoint`  — Predictor-shaped :class:`Endpoint` front door

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
from .endpoint import Endpoint
from .engine import Engine, ServingConfig
from .metrics import RequestTimeline, ServingMetrics
from .overload import (DEGRADED, FAILED, LADDER_LEVELS, SERVING,
                       EngineQuarantined, OverloadController)
from .replay import (Arrival, Tenant, build_trace, default_tenants,
                     replay_trace)
from .router import ROUTER_POLICIES, Router, RouterMetrics
from .sampling import SamplingParams
from .scheduler import (FINISHED, PREEMPTED, PREFILLING, QUEUED, RUNNING,
                        AdmissionError, QueueFull, Request, Scheduler)
from .speculative import SpeculativeConfig
from .stream import DONE_FRAME, sse_event, sse_stream, stream_events

__all__ = [
    "Engine", "ServingConfig", "Endpoint", "BlockKVPool", "PoolExhausted",
    "Scheduler", "Request", "AdmissionError", "QueueFull", "ServingMetrics",
    "RequestTimeline", "OverloadController", "EngineQuarantined",
    "Router", "RouterMetrics", "ROUTER_POLICIES", "Tenant", "Arrival",
    "default_tenants", "build_trace", "replay_trace", "SamplingParams",
    "SpeculativeConfig", "sse_event", "sse_stream", "stream_events", "DONE_FRAME", "LADDER_LEVELS", "SERVING", "DEGRADED",
    "FAILED", "QUEUED", "PREFILLING", "RUNNING", "PREEMPTED", "FINISHED",
]
