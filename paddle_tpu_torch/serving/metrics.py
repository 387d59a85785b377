"""Request-level observability for the serving engine (the port of
``paddle_tpu/serving/metrics.py``).

Per-request timings (TTFT, TPOT, queue time, tokens generated) plus
engine-level counters and gauges (batch occupancy, cache utilization,
preemptions, and the overload controller's timeouts, sheds, watchdog
stalls, step retries, degradation level and health, and speculative
decoding's drafted and accepted tokens), exportable three ways:

- ``as_dict()`` — everything, JSON-ready (the reference's schema);
- ``export_chrome(path)`` — chrome://tracing JSON of the recorded
  request spans (queued, decode);
- the port's ``observability`` registry — every event is mirrored under
  the reference's names (``serving_*`` counters and gauges, TTFT / TPOT /
  queue / e2e histograms) whenever telemetry is enabled.

Times are host wall-clock (``perf_counter_ns``) at the moments the
engine learns of each event; on a GPU the engine reads each step's
output to the host before it records a token, so a first-token time
includes the device work before it.  The reference also mirrors each
span into a recording ``paddle_tpu.profiler``; the port's profiler is
not ported yet (ROADMAP A5), so spans go to ``export_chrome`` only.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..observability import registry as _obsreg


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
        self.timed_out = 0          # retired past their deadline
        self.failed = 0             # retirements with finish_reason error
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
        # overload control (serving/overload.py)
        self.shed = 0               # retired with finish_reason "shed"
        # tokens of requests that finished as asked (eos, stop, length):
        # inside their deadline, or without one
        self.goodput_tokens = 0
        self.watchdog_stalls = 0    # step attempts over the budget
        self.step_retries = 0       # watchdog retry attempts
        self.degradation_level = 0  # gauge: current ladder level
        self.health_state = 0       # gauge: 0 serving / 1 degraded / 2 failed
        # speculative decoding (serving/speculative.py)
        self.spec_tokens_drafted = 0    # draft proposals verified
        self.spec_tokens_accepted = 0   # proposals the target accepted
        self.stream_active = 0      # requests with on_token in flight
        # the KV pool's storage: dtype code (0 full precision / 1 int8 /
        # 2 fp8) and the f32 scale bytes one block carries per side
        self.kv_cache_dtype_code = 0
        self.kv_quant_scale_bytes = 0
        self._occupancy_sum = 0.0
        self._cache_util_sum = 0.0
        self._gauge_samples = 0
        self.last_batch_occupancy = 0.0
        self.last_cache_utilization = 0.0
        self.requests: Dict[str, RequestTimeline] = {}
        # chrome spans: (name, start_ns, end_ns, category)
        self._spans: List[tuple] = []

    # handles are looked up per event (not cached) so a test calling
    # ``registry.clear()`` never leaves a mirror pointing at dead metrics
    @staticmethod
    def _obs():
        return _obsreg.get_registry() if _obsreg.enabled() else None

    # ------------------------------------------------------- lifecycle
    def on_submit(self, request_id: str):
        self.submitted += 1
        self.requests[request_id] = RequestTimeline(submitted_ns=_now_ns())
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_requests_submitted_total",
                        "requests submitted to the engine").inc()

    def on_reject(self):
        self.rejected += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_requests_rejected_total",
                        "requests rejected at admission").inc()

    def on_admit(self, request_id: str):
        t = self.requests[request_id]
        was = t.admitted_ns
        t.admitted_ns = _now_ns()
        self.prefills += 1
        if was == 0:
            self._span(f"queued:{request_id}", t.submitted_ns,
                       t.admitted_ns)
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_prefills_total", "prefill passes").inc()
            if was == 0:
                reg.histogram(
                    "serving_queue_seconds",
                    "submit-to-first-admission wait").observe(
                        (t.admitted_ns - t.submitted_ns) / 1e9)

    def on_first_token(self, request_id: str):
        t = self.requests[request_id]
        if t.first_token_ns == 0:
            t.first_token_ns = _now_ns()
            reg = self._obs()
            if reg is not None:
                reg.histogram("serving_ttft_seconds",
                              "time to first token").observe(
                                  (t.first_token_ns - t.submitted_ns) / 1e9)

    def on_prefix_lookup(self, request_id: str, cached_tokens: int,
                         prompt_tokens: int):
        """One admission's prefix-cache outcome: how many of the
        prompt's tokens came from cached blocks (0 == miss)."""
        if cached_tokens > 0:
            self.prefix_cache_hits += 1
        else:
            self.prefix_cache_misses += 1
        self._cached_tokens_sum += cached_tokens
        self._prompt_tokens_sum += prompt_tokens
        reg = self._obs()
        if reg is not None:
            if cached_tokens > 0:
                reg.counter("serving_prefix_cache_hits_total",
                            "admissions reusing cached prefix blocks"
                            ).inc()
            else:
                reg.counter("serving_prefix_cache_misses_total",
                            "admissions with no cached prefix").inc()
            reg.gauge("serving_prefix_cached_token_ratio",
                      "prompt tokens served from the prefix cache, "
                      "cumulative ratio").set(
                          self._cached_tokens_sum
                          / max(self._prompt_tokens_sum, 1))

    def on_prefill_complete(self, request_id: str, chunks: int):
        """Prompt fully prefilled in ``chunks`` fixed-shape chunks."""
        self.prefill_chunks += chunks
        reg = self._obs()
        if reg is not None:
            reg.histogram("serving_prefill_chunks_per_request",
                          "prefill chunks per admitted prompt",
                          buckets=(1, 2, 4, 8, 16, 32, 64)
                          ).observe(chunks)

    def on_evictions(self, n: int):
        """``n`` cached blocks evicted from the pool's prefix LRU."""
        self.prefix_cache_evictions += n
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_prefix_cache_evictions_total",
                        "prefix-cache blocks evicted (LRU)").inc(n)

    def on_preempt(self, request_id: str):
        self.preempted += 1
        self.requests[request_id].preemptions += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_preemptions_total",
                        "requests preempted out of the batch").inc()

    def on_finish(self, request_id: str, tokens: int, reason: str):
        self.completed += 1
        if reason == "timeout":
            self.timed_out += 1
        elif reason == "error":
            self.failed += 1
        elif reason == "shed":
            self.shed += 1
        self.tokens_generated += tokens
        # goodput: tokens worth producing (timeouts, sheds and errors
        # contribute 0)
        if reason in ("eos", "stop", "length"):
            self.goodput_tokens += tokens
        t = self.requests[request_id]
        t.finished_ns = _now_ns()
        t.tokens_generated = tokens
        t.finish_reason = reason
        self._span(f"decode:{request_id}", t.first_token_ns, t.finished_ns)
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_requests_completed_total",
                        "requests retired, by finish reason").inc(
                            reason=reason)
            if reason == "timeout":
                reg.counter("serving_requests_timed_out_total",
                            "requests retired past their deadline").inc()
            elif reason == "error":
                reg.counter("serving_requests_failed_total",
                            "requests retired with an error").inc()
            elif reason == "shed":
                reg.counter("serving_requests_shed_total",
                            "requests shed at admission (estimated TTFT "
                            "past the deadline)").inc()
            reg.counter("serving_tokens_generated_total",
                        "tokens produced by decode").inc(tokens)
            if reason in ("eos", "stop", "length"):
                reg.counter("serving_goodput_tokens_total",
                            "tokens from requests finished within "
                            "deadline").inc(tokens)
            d = t.to_dict()
            if d["tpot_s"] is not None:
                reg.histogram("serving_tpot_seconds",
                              "time per output token (decode phase)"
                              ).observe(d["tpot_s"])
            if d["e2e_s"] is not None:
                reg.histogram("serving_e2e_seconds",
                              "submit-to-finish request latency"
                              ).observe(d["e2e_s"])

    # --------------------------------------------- speculative decoding
    def on_spec_commit(self, accepted_len: int):
        """One slot's verify outcome: ``accepted_len`` tokens committed
        this iteration (accepted drafts and the bonus or correction
        token, so 1..K+1)."""
        reg = self._obs()
        if reg is not None:
            reg.histogram("serving_accepted_per_step",
                          "tokens committed per request per speculative "
                          "verify step (accepted drafts + bonus)",
                          buckets=(1, 2, 3, 4, 5, 6, 8, 12, 16)
                          ).observe(accepted_len)

    def on_spec_step(self, drafted: int, accepted: int):
        """One speculative iteration over the bucket: ``drafted`` draft
        proposals verified, ``accepted`` of them kept; the accept-rate
        gauge is cumulative."""
        self.spec_tokens_drafted += drafted
        self.spec_tokens_accepted += accepted
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_spec_tokens_drafted_total",
                        "draft-model proposals verified by the target"
                        ).inc(drafted)
            reg.counter("serving_spec_tokens_accepted_total",
                        "draft proposals accepted by the target"
                        ).inc(accepted)
            reg.gauge("serving_spec_accept_rate",
                      "accepted / drafted speculative tokens, "
                      "cumulative").set(self.spec_accept_rate())

    def spec_accept_rate(self) -> float:
        return self.spec_tokens_accepted \
            / max(self.spec_tokens_drafted, 1)

    # -------------------------------------------------------- streaming
    def on_stream_start(self):
        self.stream_active += 1
        reg = self._obs()
        if reg is not None:
            reg.gauge("serving_stream_active",
                      "streaming requests currently in flight").set(
                          self.stream_active)

    def on_stream_end(self):
        self.stream_active -= 1
        reg = self._obs()
        if reg is not None:
            reg.gauge("serving_stream_active",
                      "streaming requests currently in flight").set(
                          self.stream_active)

    # ------------------------------------------------ overload control
    def on_watchdog_stall(self, label: str):
        """One step attempt ran past its watchdog budget."""
        self.watchdog_stalls += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_watchdog_stalls_total",
                        "compiled-step attempts over the watchdog "
                        "latency budget").inc(step=label)

    def on_step_retry(self, label: str):
        """One bounded-retry attempt after a stall or step exception."""
        self.step_retries += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_step_retries_total",
                        "compiled-step retries (stall or transient "
                        "exception)").inc(step=label)

    def on_degradation_level(self, level: int):
        """Degradation ladder moved to ``level`` (0 = normal)."""
        self.degradation_level = level
        reg = self._obs()
        if reg is not None:
            reg.gauge("serving_degradation_level",
                      "memory-pressure degradation ladder level "
                      "(0 normal .. 4 preempt)").set(level)

    def on_health(self, code: int):
        """Engine health gauge (0 serving / 1 degraded / 2 failed)."""
        self.health_state = code
        reg = self._obs()
        if reg is not None:
            reg.gauge("serving_health_state",
                      "engine health (0 serving / 1 degraded / "
                      "2 failed)").set(code)

    def on_kv_cache_config(self, dtype_code: int, scale_bytes: int):
        """The engine reports its pool's storage format: ``dtype_code``
        per ``kernels.kv_quant.KV_DTYPE_CODES`` and ``scale_bytes``, the
        f32 scale bytes of one block of one (k or v) side."""
        self.kv_cache_dtype_code = int(dtype_code)
        self.kv_quant_scale_bytes = int(scale_bytes)
        reg = self._obs()
        if reg is not None:
            reg.gauge("serving_kv_cache_dtype",
                      "KV-pool storage dtype code (0 fp32 / 1 int8 / "
                      "2 fp8)").set(self.kv_cache_dtype_code)
            reg.gauge("kv_quant_scale_bytes",
                      "per-block f32 absmax scale sidecar bytes of one "
                      "quantized KV pool side (0 unquantized)").set(
                          self.kv_quant_scale_bytes)

    def on_decode_iteration(self, active: int, batch_size: int,
                            cache_utilization: float):
        self.decode_iterations += 1
        occ = active / batch_size if batch_size else 0.0
        self.last_batch_occupancy = occ
        self.last_cache_utilization = cache_utilization
        self._occupancy_sum += occ
        self._cache_util_sum += cache_utilization
        self._gauge_samples += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("serving_decode_iterations_total",
                        "decode loop iterations").inc()
            reg.gauge("serving_batch_occupancy",
                      "active slots / batch size, last iteration").set(occ)
            reg.gauge("serving_cache_utilization",
                      "paged KV cache pages in use, last iteration").set(
                          cache_utilization)

    # --------------------------------------------------------- export
    def _span(self, name: str, start_ns: int, end_ns: int,
              category: str = "serving"):
        if not start_ns or end_ns < start_ns:
            return
        self._spans.append((name, start_ns, end_ns, category))

    def as_dict(self) -> dict:
        n = max(self._gauge_samples, 1)
        return {
            "counters": {
                "requests_submitted": self.submitted,
                "requests_rejected": self.rejected,
                "requests_completed": self.completed,
                "requests_timed_out": self.timed_out,
                "requests_failed": self.failed,
                "preemptions": self.preempted,
                "tokens_generated": self.tokens_generated,
                "decode_iterations": self.decode_iterations,
                "prefills": self.prefills,
                "prefix_cache_hits": self.prefix_cache_hits,
                "prefix_cache_misses": self.prefix_cache_misses,
                "prefix_cache_evictions": self.prefix_cache_evictions,
                "prefill_chunks": self.prefill_chunks,
                "requests_shed": self.shed,
                "goodput_tokens": self.goodput_tokens,
                "watchdog_stalls": self.watchdog_stalls,
                "step_retries": self.step_retries,
                "spec_tokens_drafted": self.spec_tokens_drafted,
                "spec_tokens_accepted": self.spec_tokens_accepted,
            },
            "gauges": {
                "degradation_level": self.degradation_level,
                "health_state": self.health_state,
                "spec_accept_rate": round(self.spec_accept_rate(), 4),
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

    def export_chrome(self, path: str) -> str:
        """chrome://tracing JSON of the request spans (one complete
        event each, times in microseconds); returns ``path``."""
        events = [{"name": name, "cat": cat, "ph": "X",
                   "ts": start / 1000.0, "dur": (end - start) / 1000.0,
                   "pid": 0, "tid": 0}
                  for name, start, end, cat in self._spans]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        return path
