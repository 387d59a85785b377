"""Overload control for the serving engine: load shedding, a KV
memory-pressure degradation ladder, and a hung-step watchdog (the port
of ``paddle_tpu/serving/overload.py``).

Three cooperating mechanisms, all host-side (nothing here is inside a
captured graph, so the steps' one-graph contract is untouched):

* **Load shedding** (:meth:`OverloadController.should_shed`): at
  ``submit()`` time, estimate the candidate's TTFT from the pending
  prefill tokens ahead of it and EWMAs of the chunk and decode step
  latencies.  When the OPTIMISTIC estimate already busts the deadline,
  retire the request at once with ``finish_reason="shed"``.  Sheds never
  fire while the EWMAs are cold (a fresh engine admits everything).

* **Degradation ladder** (:class:`DegradationLadder`): high/low
  watermarks with hysteresis over the pool's used byte fraction (free
  and parked blocks both count as headroom).  Strictly above the high
  watermark the engine walks one level per iteration: evict parked
  prefix-cache blocks -> shrink the prefill budget to one chunk per
  iteration -> pause admissions -> preempt the lowest-priority,
  youngest running request.  Below the low watermark it unwinds one
  level per iteration.  Every transition is a gauge
  (``serving_degradation_level``) and a log line.

* **Step watchdog** (:class:`StepWatchdog`): wraps each call of a step
  (decode, sampled decode, prefill chunk) with a monotonic-clock budget
  (``watchdog_budget_mult`` x the step's EWMA, floored by
  ``watchdog_floor_s``).  A stall or a step exception gets bounded
  retries with exponential backoff, after which the engine is
  quarantined: ``DEGRADED`` when it still produces results (slow),
  ``FAILED`` when retries run out on exceptions
  (:class:`EngineQuarantined` propagates out of ``step()``).
  ``DEGRADED`` heals itself after ``health_recovery_steps`` in-budget
  steps in a row; ``FAILED`` needs ``Engine.revive()``.

Where the port differs from the reference, and why:

* **The watchdog times device work.**  A step here is a CUDA graph
  replay, which returns before its kernels run.  So the engine hands the
  watchdog a callable that ends with the step's output read to the host
  (the decode steps' tokens, a final chunk's first token), or with a
  synchronize of the current stream (a chunk that is not the last).
  The reference's decode does the same on purpose; its prefill times
  dispatch only, which on the GPU would read tens of microseconds, so
  the TTFT estimate would never shed and a stalled device would never
  trip the budget.
* **A capture is the compile observation.**  The reference takes each
  EWMA's first observation as its compile (``LatencyEWMA.compile_s``)
  and floors the budget so that compile never trips it.  Here the
  engine tells each watchdog how many graphs its step has captured
  (``StepWatchdog.compiles``): a call during which that count grew (a
  capture, with its warmup, and on a cold build directory the kernels'
  build) is that EWMA's compile observation — never a stall and never a
  latency sample — and every other call is a sample, the first one
  included.  In an engine that captured nothing before serving this is
  the first call, as in the reference; in one whose graphs were
  captured at start-up, the first watched replay is a real sample.
* **Retries re-run a step that writes its pools in place.**  The
  reference's steps return new pools, bound only after success.  The
  port's write the K/V rows of the step's positions in place; that is
  idempotent on the same host inputs and the same per-slot device
  state, so the engine moves its host state (frontiers, pending tokens,
  prefill positions, sampling counters) only after the watched call
  returns, and a retry writes the same rows again.

:class:`~paddle_tpu_torch.observability.RetraceError` is never retried
(a contract violation, not a transient fault).
"""
from __future__ import annotations

import logging
import math
import time
from typing import Callable, List, Optional, Tuple

log = logging.getLogger("paddle_tpu_torch.serving")

# engine health states (Engine.health()["state"])
SERVING = "serving"
DEGRADED = "degraded"
FAILED = "failed"

_HEALTH_CODE = {SERVING: 0, DEGRADED: 1, FAILED: 2}

# degradation-ladder levels, walked one step per engine iteration
LADDER_LEVELS = ("normal", "evict_cache", "shrink_prefill",
                 "pause_admissions", "preempt")


class EngineQuarantined(RuntimeError):
    """The step watchdog exhausted its bounded retries on step
    exceptions: the engine is quarantined FAILED and refuses work until
    ``Engine.revive()``."""


class LatencyEWMA:
    """Exponentially-weighted moving average of a step latency.

    Compile observations are recorded separately as ``compile_s`` and
    kept out of the average: they are dominated by the capture (and a
    kernel build) and would otherwise poison both the TTFT estimate
    (over-shedding) and the watchdog budget for the engine's lifetime.
    ``observe(dt)`` takes the reference's rule (the FIRST observation is
    the compile); ``observe(dt, compiled=...)`` says which it is."""

    def __init__(self, alpha: float = 0.2):
        self.alpha = alpha
        self.value: Optional[float] = None
        self.compile_s: Optional[float] = None
        self.samples = 0

    def observe(self, dt: float, compiled: Optional[bool] = None):
        if compiled or (compiled is None and self.compile_s is None):
            self.compile_s = dt if self.compile_s is None \
                else self.compile_s + dt
            return
        self.samples += 1
        self.value = dt if self.value is None else (
            self.alpha * dt + (1.0 - self.alpha) * self.value)

    @property
    def warmed(self) -> bool:
        return self.value is not None


class EngineHealth:
    """SERVING / DEGRADED / FAILED state machine fed by the watchdogs.

    DEGRADED (stalls detected, engine still producing) heals itself
    after ``recovery_steps`` consecutive in-budget steps; FAILED
    (retries exhausted on step exceptions) is sticky until
    ``revive()``."""

    def __init__(self, metrics=None, recovery_steps: int = 3):
        self.state = SERVING
        self.recovery_steps = recovery_steps
        self.last_error: Optional[str] = None
        self._clean = 0
        self._metrics = metrics
        self._publish()

    def _publish(self):
        if self._metrics is not None:
            self._metrics.on_health(_HEALTH_CODE[self.state])

    def _transition(self, new: str, why: str):
        if new != self.state:
            log.warning("engine health %s -> %s (%s)",
                        self.state, new, why)
            self.state = new
            self._publish()

    def on_stall(self, label: str, dt: float, budget: float):
        self._clean = 0
        if self.state != FAILED:
            self._transition(
                DEGRADED, f"{label} stalled {dt:.3f}s > {budget:.3f}s")

    def on_failure(self, label: str, error: BaseException):
        self.last_error = f"{type(error).__name__}: {error}"
        self._clean = 0
        self._transition(FAILED, f"{label}: {self.last_error}")

    def on_clean_step(self):
        if self.state == DEGRADED:
            self._clean += 1
            if self._clean >= self.recovery_steps:
                self._transition(
                    SERVING, f"{self._clean} consecutive in-budget steps")
        else:
            self._clean = 0

    def revive(self):
        """Operator override: clear FAILED/DEGRADED back to SERVING."""
        self.last_error = None
        self._clean = 0
        self._transition(SERVING, "revive()")

    @property
    def failed(self) -> bool:
        return self.state == FAILED


class StepWatchdog:
    """Monotonic-clock watchdog and bounded retry around ONE step entry
    point (decode, sampled decode or prefill chunk).

    ``compiles``, when set, reads how many graphs the watched step has
    captured: a call during which it grew is the EWMA's compile
    observation (module docstring).  Unset, the first observation is,
    as in the reference.  The chaos hook fires INSIDE the timed window,
    before the step runs, so injected delays register as stalls and
    injected exceptions exercise the retry path."""

    def __init__(self, label: str, ewma: LatencyEWMA, health: EngineHealth,
                 metrics, *, budget_mult: float, floor_s: float,
                 max_retries: int, backoff_s: float,
                 compiles: Optional[Callable[[], int]] = None):
        self.label = label
        self.ewma = ewma
        self.health = health
        self.metrics = metrics
        self.budget_mult = budget_mult
        self.floor_s = floor_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.compiles = compiles
        self.stalls = 0
        self.retries = 0

    def budget_s(self) -> float:
        """Per-attempt latency budget: a multiple of the EWMA, floored
        by ``floor_s``."""
        if not self.ewma.warmed:
            return self.floor_s
        return max(self.floor_s, self.budget_mult * self.ewma.value)

    def call(self, fn: Callable, *args):
        """Run ``fn(*args)`` under the budget with bounded retries.

        A capturing call (``compiles`` grew) is the compile observation.
        Stall (slow but successful) -> count it, mark the engine
        DEGRADED, retry; if every attempt stalls, keep the LAST result
        (degrade, don't fail — the step did complete).  Exception ->
        retry with exponential backoff; exhausted -> quarantine FAILED
        and raise :class:`EngineQuarantined`.  A retry runs the same
        step on the same inputs: the same result, a replay of the same
        graph, no retrace."""
        from ..observability import RetraceError
        from ..resilience import chaos

        last_error: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            if attempt:
                time.sleep(self.backoff_s * (2 ** (attempt - 1)))
            before = self.compiles() if self.compiles is not None else None
            t0 = time.monotonic()
            try:
                chaos.maybe_fail_serving_step(self.label)
                out = fn(*args)
            except RetraceError:
                raise       # contract violation, not a transient fault
            except Exception as e:  # noqa: BLE001 — bounded retry
                last_error = e
                self.retries += 1
                self.metrics.on_step_retry(self.label)
                log.warning("%s attempt %d/%d failed: %s", self.label,
                            attempt + 1, self.max_retries + 1, e)
                continue
            dt = time.monotonic() - t0
            compiled = None if before is None else self.compiles() > before
            if compiled:
                self.ewma.observe(dt, compiled=True)
                self.health.on_clean_step()
                return out
            budget = self.budget_s()
            if dt > budget:
                self.stalls += 1
                self.metrics.on_watchdog_stall(self.label)
                self.health.on_stall(self.label, dt, budget)
                if attempt < self.max_retries:
                    self.retries += 1
                    self.metrics.on_step_retry(self.label)
                    continue
                return out      # every attempt stalled: degrade, keep it
            self.ewma.observe(dt, compiled=compiled)
            self.health.on_clean_step()
            return out
        self.health.on_failure(self.label, last_error)
        raise EngineQuarantined(
            f"{self.label}: {self.max_retries + 1} attempts failed; "
            f"engine quarantined FAILED (last: {last_error!r})"
        ) from last_error


class DegradationLadder:
    """Hysteresis watermarks over KV-pool pressure driving the explicit
    degradation ladder (module docstring).  One level per engine
    iteration in either direction; the unwind retraces the same
    rungs."""

    def __init__(self, metrics, *, high: float, low: float):
        if not 0.0 <= low <= high <= 1.0:
            raise ValueError(
                f"watermarks need 0 <= low <= high <= 1, got "
                f"low={low} high={high}")
        self.high = high
        self.low = low
        self.level = 0
        self.metrics = metrics
        # (engine iteration ordinal, new level) — tests assert ordering
        self.transitions: List[Tuple[int, int]] = []
        self._ticks = 0

    @property
    def level_name(self) -> str:
        return LADDER_LEVELS[self.level]

    @property
    def admissions_paused(self) -> bool:
        return self.level >= LADDER_LEVELS.index("pause_admissions")

    def effective_prefill_budget(self, configured: int) -> int:
        """The per-iteration prefill token budget: ONE token at or above
        the shrink level (each chunk still advances a full
        ``chunk_tokens``, but only one chunk runs per iteration, keeping
        decode responsive under pressure)."""
        if self.level >= LADDER_LEVELS.index("shrink_prefill"):
            return 1
        return configured

    def _set_level(self, level: int, pressure: float):
        log.warning(
            "degradation ladder %s -> %s (kv pressure %.2f, "
            "high=%.2f low=%.2f)", self.level_name,
            LADDER_LEVELS[level], pressure, self.high, self.low)
        self.level = level
        self.transitions.append((self._ticks, level))
        self.metrics.on_degradation_level(level)

    def tick(self, engine) -> int:
        """One hysteresis step against the pool's current pressure,
        applying the level's action.  Returns the level."""
        self._ticks += 1
        # used KV bytes over the pool's byte capacity (scale rows
        # included): a statement about device memory, comparable across
        # KV dtypes sized from one kv_pool_bytes budget
        pressure = engine.pool.byte_utilization()
        # STRICTLY above the high watermark: the default high of 1.0 can
        # never be exceeded, so the ladder engages only when a deployment
        # sets kv_high_watermark < 1.0
        if pressure > self.high and self.level < len(LADDER_LEVELS) - 1:
            self._set_level(self.level + 1, pressure)
        elif pressure < self.low and self.level > 0:
            self._set_level(self.level - 1, pressure)
        if self.level >= LADDER_LEVELS.index("evict_cache"):
            # parked prefix blocks are reclaimable headroom: give them
            # back now rather than one by one in allocate()
            engine.pool.evict_parked()
        if self.level >= LADDER_LEVELS.index("preempt") \
                and len(engine.scheduler.running) > 1:
            # never the sole running request: preempting it frees
            # nothing durable, it would come straight back
            victim = engine.scheduler.pick_victim()
            if victim is not None:
                engine._preempt(victim)
        return self.level


class OverloadController:
    """The engine's overload state: the EWMAs, the ladder, the health
    state machine and the step watchdogs."""

    def __init__(self, config, metrics):
        self.config = config
        self.metrics = metrics
        self.chunk_ewma = LatencyEWMA()
        self.decode_ewma = LatencyEWMA()
        self.health = EngineHealth(
            metrics, recovery_steps=config.health_recovery_steps)
        self.ladder = DegradationLadder(
            metrics, high=config.kv_high_watermark,
            low=config.kv_low_watermark)
        # a named engine (ServingConfig(name=...)) tags its step labels,
        # so a chaos plan or a metric can target ONE engine
        tag = f"@{config.name}" if getattr(config, "name", "") else ""
        self._tag = tag
        self.prefill_watchdog = self._watchdog("prefill_step",
                                               self.chunk_ewma)
        self.decode_watchdog = self._watchdog("decode_step",
                                              self.decode_ewma)

    def _watchdog(self, kind: str, ewma: LatencyEWMA) -> StepWatchdog:
        cfg = self.config
        return StepWatchdog(
            f"serving::{kind}{self._tag}", ewma, self.health, self.metrics,
            budget_mult=cfg.watchdog_budget_mult,
            floor_s=cfg.watchdog_floor_s, max_retries=cfg.step_max_retries,
            backoff_s=cfg.step_retry_backoff_s)

    def extra_watchdog(self, kind: str) -> StepWatchdog:
        """A watchdog for an ADDITIONAL step entry point (the sampled
        decode step) with its OWN LatencyEWMA: sharing one would record
        the second step's capture as a latency sample."""
        return self._watchdog(kind, LatencyEWMA())

    # ------------------------------------------------------ load shedding
    def can_estimate(self) -> bool:
        """Shedding fires only once the chunk EWMA has a real (post-
        capture) sample: a fresh engine admits everything."""
        return self.config.enable_load_shedding and self.chunk_ewma.warmed

    def estimate_ttft_s(self, engine, prompt) -> float:
        """Optimistic TTFT estimate for a CANDIDATE prompt arriving now:
        every prefill token ahead of it (waiting queue + mid-prefill
        remainders) plus its own uncached tokens, paced by the
        per-iteration prefill budget with one decode step interleaved
        per iteration.  Optimistic by design (it ignores decode-slot
        contention and future arrivals), so a shed only happens when
        even the best case busts the deadline."""
        C = engine.chunk_tokens
        chunk_s = self.chunk_ewma.value
        decode_s = self.decode_ewma.value or 0.0
        pending = engine.pending_prefill_tokens()
        matched, _, _ = engine.pool.admission_plan(prompt, extra_tokens=0)
        own = max(1, len(prompt) - len(matched) * engine.pool.block_size)
        chunks = math.ceil(pending / C) + math.ceil(own / C)
        budget = self.ladder.effective_prefill_budget(
            self.config.prefill_token_budget or C)
        chunks_per_iter = max(1, budget // C)
        iters = math.ceil(chunks / chunks_per_iter)
        return chunks * chunk_s + iters * decode_s

    def should_shed(self, engine, prompt,
                    deadline_s: Optional[float]) -> bool:
        if deadline_s is None or not self.can_estimate():
            return False
        est = self.estimate_ttft_s(engine, prompt)
        shed = est > deadline_s * self.config.shed_safety_factor
        if shed:
            log.info("shedding request: est TTFT %.3fs > deadline %.3fs",
                     est, deadline_s)
        return shed

    # ------------------------------------------------------------- health
    def snapshot(self, engine) -> dict:
        """``Engine.health()``'s payload (the reference's keys): a
        host-side dict, cheap enough to poll every second.  The stall
        and retry totals are the prefill and decode watchdogs', as the
        reference's (the metrics counters count every watchdog)."""
        return {
            "state": self.health.state,
            "last_error": self.health.last_error,
            "degradation_level": self.ladder.level,
            "degradation_level_name": self.ladder.level_name,
            "admissions_paused": self.ladder.admissions_paused,
            "watchdog_stalls": (self.prefill_watchdog.stalls
                                + self.decode_watchdog.stalls),
            "step_retries": (self.prefill_watchdog.retries
                             + self.decode_watchdog.retries),
            "ewma_chunk_s": self.chunk_ewma.value,
            "ewma_decode_s": self.decode_ewma.value,
            "queue_depth": len(engine.scheduler.waiting),
            "kv_pressure": engine.pool.byte_utilization(),
            "kv_dtype": engine.pool.kv_dtype_tag,
            "kv_used_bytes": engine.pool.used_bytes(),
            "kv_capacity_bytes": engine.pool.capacity_bytes(),
        }


__all__ = ["SERVING", "DEGRADED", "FAILED", "LADDER_LEVELS",
           "EngineQuarantined", "LatencyEWMA", "EngineHealth",
           "StepWatchdog", "DegradationLadder", "OverloadController"]
