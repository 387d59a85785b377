"""Request-level counters and timelines for the serving engine (the
port of the parts of ``paddle_tpu/serving/metrics.py`` that
``Engine.stats()`` reports).  Times are host wall-clock
(``perf_counter_ns``) at the moments the engine learns of each event;
on a GPU the engine synchronizes when it reads a step's tokens, so a
first-token time includes the device work before it."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional


def _now_ns() -> int:
    return time.perf_counter_ns()


@dataclass
class RequestTimeline:
    submitted_ns: int = 0
    admitted_ns: int = 0          # last admission (re-set on re-admit)
    first_token_ns: int = 0
    finished_ns: int = 0
    tokens_generated: int = 0
    preemptions: int = 0
    finish_reason: Optional[str] = None

    def to_dict(self) -> dict:
        ttft = (self.first_token_ns - self.submitted_ns) / 1e9 \
            if self.first_token_ns else None
        queue_time = (self.admitted_ns - self.submitted_ns) / 1e9 \
            if self.admitted_ns else None
        # time per output token over the decode phase (the tokens after
        # the first, which prefill produced)
        tpot = None
        if self.finished_ns and self.tokens_generated > 1:
            tpot = ((self.finished_ns - self.first_token_ns) / 1e9
                    / (self.tokens_generated - 1))
        return {
            "ttft_s": ttft,
            "tpot_s": tpot,
            "queue_time_s": queue_time,
            "e2e_s": ((self.finished_ns - self.submitted_ns) / 1e9
                      if self.finished_ns else None),
            "tokens_generated": self.tokens_generated,
            "preemptions": self.preemptions,
            "finish_reason": self.finish_reason,
        }


class ServingMetrics:
    def __init__(self):
        self.submitted = 0
        self.rejected = 0
        self.completed = 0          # every retirement, any finish_reason
        self.failed = 0             # retirements with finish_reason error
        # tokens of requests that finished as asked (eos, stop, length)
        self.goodput_tokens = 0
        self.stream_active = 0      # requests with on_token in flight
        self.preempted = 0          # preemption events
        self.tokens_generated = 0
        self.decode_iterations = 0
        self.prefills = 0
        self.prefix_cache_hits = 0
        self.prefix_cache_misses = 0
        self.prefix_cache_evictions = 0
        self.prefill_chunks = 0
        self._cached_tokens_sum = 0
        self._prompt_tokens_sum = 0
        self._occupancy_sum = 0.0
        self._cache_util_sum = 0.0
        self._gauge_samples = 0
        self.last_batch_occupancy = 0.0
        self.last_cache_utilization = 0.0
        # the KV pool's storage: dtype code (0 full precision / 1 int8 /
        # 2 fp8) and the f32 scale bytes one block carries per side
        self.kv_cache_dtype_code = 0
        self.kv_quant_scale_bytes = 0
        self.requests: Dict[str, RequestTimeline] = {}

    def on_submit(self, request_id: str):
        self.submitted += 1
        self.requests[request_id] = RequestTimeline(submitted_ns=_now_ns())

    def on_kv_cache_config(self, dtype_code: int, scale_bytes: int):
        """The engine reports its pool's storage format: ``dtype_code``
        per ``kernels.kv_quant.KV_DTYPE_CODES`` and ``scale_bytes``, the
        f32 scale bytes of one block of one (k or v) side."""
        self.kv_cache_dtype_code = int(dtype_code)
        self.kv_quant_scale_bytes = int(scale_bytes)

    def on_reject(self):
        self.rejected += 1

    def on_admit(self, request_id: str):
        self.requests[request_id].admitted_ns = _now_ns()
        self.prefills += 1

    def on_first_token(self, request_id: str):
        t = self.requests[request_id]
        if t.first_token_ns == 0:
            t.first_token_ns = _now_ns()

    def on_prefix_lookup(self, cached_tokens: int, prompt_tokens: int):
        if cached_tokens > 0:
            self.prefix_cache_hits += 1
        else:
            self.prefix_cache_misses += 1
        self._cached_tokens_sum += cached_tokens
        self._prompt_tokens_sum += prompt_tokens

    def on_prefill_complete(self, chunks: int):
        self.prefill_chunks += chunks

    def on_evictions(self, n: int):
        self.prefix_cache_evictions += n

    def on_preempt(self, request_id: str):
        self.preempted += 1
        self.requests[request_id].preemptions += 1

    def on_finish(self, request_id: str, tokens: int, reason: str):
        self.completed += 1
        if reason == "error":
            self.failed += 1
        self.tokens_generated += tokens
        if reason in ("eos", "stop", "length"):
            self.goodput_tokens += tokens
        t = self.requests[request_id]
        t.finished_ns = _now_ns()
        t.tokens_generated = tokens
        t.finish_reason = reason

    def on_stream_start(self):
        self.stream_active += 1

    def on_stream_end(self):
        self.stream_active -= 1

    def on_decode_iteration(self, active: int, batch_size: int,
                            cache_utilization: float):
        self.decode_iterations += 1
        occ = active / batch_size if batch_size else 0.0
        self.last_batch_occupancy = occ
        self.last_cache_utilization = cache_utilization
        self._occupancy_sum += occ
        self._cache_util_sum += cache_utilization
        self._gauge_samples += 1

    def as_dict(self) -> dict:
        n = max(self._gauge_samples, 1)
        return {
            "counters": {
                "requests_submitted": self.submitted,
                "requests_rejected": self.rejected,
                "requests_completed": self.completed,
                "requests_failed": self.failed,
                "preemptions": self.preempted,
                "tokens_generated": self.tokens_generated,
                "decode_iterations": self.decode_iterations,
                "prefills": self.prefills,
                "prefix_cache_hits": self.prefix_cache_hits,
                "prefix_cache_misses": self.prefix_cache_misses,
                "prefix_cache_evictions": self.prefix_cache_evictions,
                "prefill_chunks": self.prefill_chunks,
                "goodput_tokens": self.goodput_tokens,
            },
            "gauges": {
                "stream_active": self.stream_active,
                "batch_occupancy": self.last_batch_occupancy,
                "batch_occupancy_avg": round(self._occupancy_sum / n, 4),
                "cache_utilization": self.last_cache_utilization,
                "cache_utilization_avg": round(
                    self._cache_util_sum / n, 4),
                "prefix_cached_token_ratio": round(
                    self._cached_tokens_sum
                    / max(self._prompt_tokens_sum, 1), 4),
                "serving_kv_cache_dtype": self.kv_cache_dtype_code,
                "kv_quant_scale_bytes": self.kv_quant_scale_bytes,
            },
            "requests": {rid: t.to_dict()
                         for rid, t in self.requests.items()},
        }
