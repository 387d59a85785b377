"""The port's overload controller (paddle_tpu_torch/serving/overload.py:
deadlines, priorities, load shedding, the KV-pressure degradation
ladder, the step watchdog, health and revive) and its fault plan
(paddle_tpu_torch/resilience/chaos.py) against the JAX package.

The tiny f32 Llama of ``tests/test_torch_serving.py`` (the JAX model's
weights through numpy into the port) behind both packages' engines, the
JAX one on its fused steps, at the reference's ``tests/test_overload.py``
configs.  Each package runs its own ``FaultPlan`` under the same
schedule.  Tolerance: tokens, finish reasons, ladder transitions, the
counters, health states and the fault plans' logs equal.

Every test runs on a virtual monotonic clock (``torch_clock``) that
moves only by the plans' injected delays and the watchdogs' backoffs:
a step takes no time, so each stall and timeout is the schedule's (an
injected 0.6 s against a 0.25 s floor) and the same in both packages,
however loaded the CPU is.  The watchdog's timing of real device work
is held on the card (``tests/test_torch_observability.py``, ``cuda``).
"""
import os
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.resilience import FaultPlan as JaxFaultPlan
from paddle_tpu.resilience.chaos import burst_prompts as jax_burst_prompts
from paddle_tpu.serving import AdmissionError as JaxAdmissionError
from paddle_tpu.serving import Endpoint as JaxEndpoint
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import EngineQuarantined as JaxEngineQuarantined
from paddle_tpu.serving import Request as JaxRequest
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import overload as jax_overload
from paddle_tpu.serving.scheduler import Scheduler as JaxScheduler
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.resilience import ChaosError, FaultPlan
from paddle_tpu_torch.resilience.chaos import burst_prompts
from paddle_tpu_torch.serving import (FAILED, LADDER_LEVELS, SERVING,
                                      AdmissionError, Endpoint, Engine,
                                      EngineQuarantined, Request,
                                      ServingConfig, overload)
from paddle_tpu_torch.serving.scheduler import (PREFILLING, QUEUED,
                                                Scheduler)
from torch_clock import virtual_clock

COUNTERS = ("requests_completed", "requests_timed_out", "requests_failed",
            "requests_shed", "requests_rejected", "preemptions",
            "watchdog_stalls", "step_retries", "goodput_tokens",
            "tokens_generated", "prefill_chunks", "decode_iterations",
            "prefix_cache_hits")
# Engine.health()'s keys whose values do not depend on timing
HEALTH = ("state", "last_error", "degradation_level",
          "degradation_level_name", "admissions_paused", "watchdog_stalls",
          "step_retries", "queue_depth", "kv_pressure", "kv_dtype",
          "kv_used_bytes", "kv_capacity_bytes")


def _config(cls, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_queue_len", 16)
    kw.setdefault("chunk_tokens", 4)
    return cls(fused_kernels=True, **kw)


PACKAGES = {
    "jax": dict(engine=JaxEngine, config=JaxServingConfig,
                plan=JaxFaultPlan, quarantined=JaxEngineQuarantined,
                admission=JaxAdmissionError, endpoint=JaxEndpoint),
    "torch": dict(engine=Engine, config=ServingConfig, plan=FaultPlan,
                  quarantined=EngineQuarantined, admission=AdmissionError,
                  endpoint=Endpoint),
}


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    return virtual_clock(monkeypatch)


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    jax_model.eval()
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return {"jax": jax_model,
            "torch": from_jax_state_dict(named, LlamaConfig.tiny(),
                                         device="cpu")}


def _prompts(lengths, seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32)
            for n in lengths]


def _engine(models, pkg, **kw):
    p = PACKAGES[pkg]
    return p["engine"](models[pkg], _config(p["config"], **kw))


def _health_log(eng):
    """The health gauge's values from now on (the state machine
    publishes each transition through ``metrics.on_health``)."""
    seen = []
    publish = eng.metrics.on_health

    def record(code):
        seen.append(code)
        publish(code)
    eng.metrics.on_health = record
    return seen


def _warm(eng, prompt_len=8, max_new=4):
    """One drained request: each step's first observation (the
    reference's compile, the port's capture) is out of the EWMA after
    it, and both latency EWMAs hold a real sample."""
    (p,) = _prompts([prompt_len], seed=42)
    eng.generate([p], max_new_tokens=max_new)
    assert eng.overload.chunk_ewma.warmed and eng.overload.decode_ewma.warmed


def _outcome(eng, reqs):
    c = eng.stats()["counters"]
    return {"tokens": [[int(t) for t in r.generated] for r in reqs],
            "reasons": [r.finish_reason for r in reqs],
            "counters": {k: c[k] for k in COUNTERS},
            "gauges": {k: eng.stats()["gauges"][k]
                       for k in ("degradation_level", "health_state")},
            "health": {k: eng.health()[k] for k in HEALTH},
            "transitions": list(eng.overload.ladder.transitions)}


# ---------------------------------------------------------------------------
# the controller's parts, fed the same inputs in both packages
# ---------------------------------------------------------------------------

class _FakeMetrics:
    def __init__(self):
        self.levels, self.health, self.stalls, self.retries = [], [], [], []

    def on_degradation_level(self, level):
        self.levels.append(level)

    def on_health(self, code):
        self.health.append(code)

    def on_watchdog_stall(self, label):
        self.stalls.append(label)

    def on_step_retry(self, label):
        self.retries.append(label)


class _FakeEngine:
    """The reference's ``tests/test_overload.py`` fake: a pool whose
    pressure the test sets, a scheduler whose youngest request is the
    victim."""

    class _Pool:
        def __init__(self):
            self.pressure = 0.0
            self.evict_calls = 0

        def byte_utilization(self):
            return self.pressure

        def evict_parked(self, n=None):
            self.evict_calls += 1
            return 0

    class _Sched:
        def __init__(self):
            self.running = []

        def pick_victim(self):
            return self.running[-1] if self.running else None

    def __init__(self):
        self.pool = self._Pool()
        self.scheduler = self._Sched()
        self.preempted = []

    def _preempt(self, victim):
        self.preempted.append(victim)
        self.scheduler.running.remove(victim)


MODULES = {"jax": jax_overload, "torch": overload}


class TestPartsMatchJax:
    @pytest.mark.parametrize("samples", [
        [9.0, 1.0], [5.0, 1.0, 2.0], [0.3, 0.1, 0.2, 0.4, 0.05],
        [2.0]])
    def test_latency_ewma(self, samples):
        states = {}
        for pkg, mod in MODULES.items():
            e, seen = mod.LatencyEWMA(alpha=0.2), []
            for dt in samples:
                e.observe(dt)
                seen.append((e.value, e.compile_s, e.samples, e.warmed))
            states[pkg] = seen
        assert states["torch"] == states["jax"]

    def test_latency_ewma_told_which_call_compiled(self):
        e = overload.LatencyEWMA(alpha=0.2)
        e.observe(1.0, compiled=False)   # a replay of a graph captured
        assert e.warmed and e.value == 1.0 and e.compile_s is None
        e.observe(4.0, compiled=True)    # a capture: never a sample
        e.observe(2.0, compiled=True)
        assert e.compile_s == 6.0 and e.value == 1.0 and e.samples == 1
        e.observe(2.0, compiled=False)
        assert e.value == pytest.approx(0.2 * 2.0 + 0.8 * 1.0)

    @pytest.mark.parametrize("events", [
        ["stall", "clean", "clean", "clean"],
        ["stall", "clean", "stall", "clean", "clean", "clean", "clean"],
        ["failure", "clean", "stall", "revive", "clean"],
        ["stall", "failure", "clean", "revive"]])
    def test_engine_health(self, events):
        states = {}
        for pkg, mod in MODULES.items():
            m = _FakeMetrics()
            h, seen = mod.EngineHealth(m, recovery_steps=3), []
            for ev in events:
                if ev == "stall":
                    h.on_stall("step", 2.0, 1.0)
                elif ev == "failure":
                    h.on_failure("step", RuntimeError("boom"))
                elif ev == "clean":
                    h.on_clean_step()
                else:
                    h.revive()
                seen.append((h.state, h.last_error, h.failed))
            states[pkg] = (seen, m.health)
        assert states["torch"] == states["jax"]

    @pytest.mark.parametrize("schedule,retries", [
        (dict(fail_step_at={2}), 1), (dict(fail_step_at={1, 2}), 1),
        (dict(fail_step_at={1, 2, 3}), 2), (dict(step_delay_s={1: 0.12}), 1),
        (dict(step_delay_s={1: 0.12, 2: 0.12}), 1),
        (dict(step_delay_s={2: 0.12}, fail_step_at={3}), 2)])
    def test_step_watchdog(self, schedule, retries):
        """Four calls of a watched step under each package's own plan:
        the same results or quarantine, stalls, retries, health and
        injected log."""
        out = {}
        for pkg, mod in MODULES.items():
            m = _FakeMetrics()
            health = mod.EngineHealth(m, recovery_steps=2)
            wd = mod.StepWatchdog(
                "serving::decode_step", mod.LatencyEWMA(), health, m,
                budget_mult=50.0, floor_s=0.08, max_retries=retries,
                backoff_s=0.001)
            seen = []
            with PACKAGES[pkg]["plan"](**schedule) as plan:
                for i in range(4):
                    try:
                        seen.append(wd.call(lambda x: x + 1, i))
                    except PACKAGES[pkg]["quarantined"]:
                        seen.append("quarantined")
                        health.revive()
            out[pkg] = (seen, wd.stalls, wd.retries, m.stalls, m.retries,
                        m.health, plan.injected)
        assert out["torch"] == out["jax"]

    def test_step_watchdog_capture_is_the_compile_observation(self):
        """With the step's capture count, a call that captured is the
        EWMA's compile observation however long it took (never a stall),
        and the first call that did not is a latency sample."""
        m, graphs = _FakeMetrics(), [0]
        health = overload.EngineHealth(m)
        wd = overload.StepWatchdog(
            "serving::decode_step", overload.LatencyEWMA(), health, m,
            budget_mult=50.0, floor_s=0.02, max_retries=1, backoff_s=0.0,
            compiles=lambda: graphs[0])

        def capture():
            graphs[0] += 1
            time.sleep(0.06)
            return "captured"
        assert wd.call(capture) == "captured"
        assert wd.stalls == 0 and wd.ewma.compile_s == pytest.approx(0.06)
        assert not wd.ewma.warmed
        assert wd.call(lambda: "replayed") == "replayed"
        assert wd.ewma.warmed and wd.ewma.samples == 1
        assert m.stalls == [] and health.state == SERVING

    @pytest.mark.parametrize("pressures", [
        [0.9] * 6 + [0.4] + [0.1] * 5,
        [0.6, 0.6, 0.45, 0.2, 0.2, 0.2, 0.6, 0.1, 0.1],
        [0.5, 0.51, 0.3, 0.29, 0.29]])
    def test_degradation_ladder(self, pressures):
        out = {}
        for pkg, mod in MODULES.items():
            m, eng = _FakeMetrics(), _FakeEngine()
            ladder = mod.DegradationLadder(m, high=0.5, low=0.3)
            eng.scheduler.running = ["a", "b", "c"]
            seen = []
            for p in pressures:
                eng.pool.pressure = p
                seen.append((ladder.tick(eng), ladder.level_name,
                             ladder.admissions_paused,
                             ladder.effective_prefill_budget(256)))
            out[pkg] = (seen, ladder.transitions, m.levels, eng.preempted,
                        eng.pool.evict_calls)
        assert out["torch"] == out["jax"]

    @pytest.mark.parametrize("high,low", [(0.3, 0.5), (1.2, 0.5),
                                          (0.5, -0.1)])
    def test_watermark_validation(self, high, low):
        for mod in MODULES.values():
            with pytest.raises(ValueError, match="watermarks"):
                mod.DegradationLadder(_FakeMetrics(), high=high, low=low)


# ---------------------------------------------------------------------------
# the degradation ladder under a seeded burst
# ---------------------------------------------------------------------------

class TestLadderBurst:
    def test_burst_engages_and_unwinds_as_the_jax_engine(self, models):
        out = {}
        for pkg, burst_fn in (("jax", jax_burst_prompts),
                              ("torch", burst_prompts)):
            eng = _engine(models, pkg, num_blocks=16, max_queue_len=32,
                          kv_high_watermark=0.5, kv_low_watermark=0.3)
            _warm(eng)
            burst = burst_fn(seed=5, n=8, min_len=8, max_len=16)
            reqs = [eng.submit(p, max_new_tokens=4) for p in burst]
            done = eng.run_until_complete()
            assert len(done) == 8
            ladder = eng.overload.ladder
            levels = [lvl for _, lvl in ladder.transitions]
            assert levels, "the burst never engaged the ladder"
            assert all(abs(b - a) == 1
                       for a, b in zip([0] + levels, levels))
            assert max(levels) >= LADDER_LEVELS.index("pause_admissions")
            assert eng.stats()["counters"]["preemptions"] > 0
            engaged = _outcome(eng, reqs)
            for _ in range(len(LADDER_LEVELS)):   # idle ticks unwind
                eng.step()
            assert ladder.level == 0
            assert eng.stats()["gauges"]["degradation_level"] == 0
            assert eng._decode_step.retraces == 0
            assert eng._prefill_step.retraces == 0
            eng.pool.check_leaks()
            out[pkg] = (engaged, list(ladder.transitions),
                        [p.tolist() for p in burst])
        assert out["torch"] == out["jax"]
        assert set(out["torch"][0]["reasons"]) == {"length"}


# ---------------------------------------------------------------------------
# priorities
# ---------------------------------------------------------------------------

class _AnyPool:
    """A pool that can hold any prompt now."""

    def admission_plan(self, tokens, extra_tokens=1):
        return [], 0, True


class TestPriorities:
    @pytest.mark.parametrize("priorities", [
        (1, 0, 0), (0, 0, 0), (2, 5, 5, 1), (3, 1, 3, 1, 0)])
    def test_pick_victim_shed_candidate_and_admission_order(
            self, priorities):
        out = {}
        for pkg, (req_cls, sched_cls) in {
                "jax": (JaxRequest, JaxScheduler),
                "torch": (Request, Scheduler)}.items():
            reqs = [req_cls(prompt=np.asarray([1, 2], np.int32),
                            priority=p) for p in priorities]
            idx = {id(r): i for i, r in enumerate(reqs)}
            s = sched_cls(pool=None)
            s.running = list(reqs)
            victims = []
            while s.running:
                v = s.pick_victim()
                victims.append(idx[id(v)])
                s.running.remove(v)
            s.waiting.extend(reqs)
            sheds = [None if s.shed_candidate(p) is None
                     else idx[id(s.shed_candidate(p))]
                     for p in range(-1, 7)]
            s.pool = _AnyPool()
            order = []
            while s.waiting:
                order.append(idx[id(s.next_admittable())])
            out[pkg] = (victims, sheds, order)
        assert out["torch"] == out["jax"]
        if set(priorities) == {0}:
            # every priority 0: youngest victim, FCFS admission
            assert out["torch"][0] == [2, 1, 0]
            assert out["torch"][2] == [0, 1, 2]

    def test_admission_prefers_high_priority(self, models):
        out = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, max_batch_size=1)
            lo = eng.submit(_prompts([6], seed=5)[0], max_new_tokens=2,
                            priority=0)
            hi = eng.submit(_prompts([6], seed=6)[0], max_new_tokens=2,
                            priority=3)
            eng.step()                    # one admission decision
            states = (hi.state != QUEUED, lo.state == QUEUED)
            eng.run_until_complete()
            out[pkg] = (states, _outcome(eng, [lo, hi]))
        assert out["torch"] == out["jax"]
        assert out["torch"][0] == (True, True)

    def test_full_queue_sheds_lower_priority(self, models):
        out = {}
        for pkg, p in PACKAGES.items():
            eng = _engine(models, pkg, max_queue_len=2)
            lo = [eng.submit(x, max_new_tokens=2, priority=0)
                  for x in _prompts([6, 6], seed=3)]
            (x,) = _prompts([6], seed=4)
            with pytest.raises(p["admission"], match="wait queue full"):
                eng.submit(x, max_new_tokens=2, priority=0)
            hi = eng.submit(x, max_new_tokens=2, priority=5)
            shed = (hi.state, lo[1].finish_reason, lo[0].state)
            eng.run_until_complete()
            eng.pool.check_leaks()
            out[pkg] = (shed, _outcome(eng, lo + [hi]))
        assert out["torch"] == out["jax"]
        assert out["torch"][0] == (QUEUED, "shed", QUEUED)


# ---------------------------------------------------------------------------
# the submit arguments that raised until this slice, each with its effect
# ---------------------------------------------------------------------------

class TestSubmitOverloadArguments:
    @pytest.mark.parametrize("kwargs", [
        {"token_deadline_s": 0.0}, {"deadline_s": 0.0}, {"priority": 1}])
    def test_submit(self, models, kwargs):
        """Each argument is taken and acts as in the JAX engine: a
        deadline of 0 times its request out unserved (a cold engine
        sheds nothing); priority 1 is admitted before an older request
        of priority 0 into a single slot."""
        out = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, max_batch_size=1)
            older = eng.submit(_prompts([5], seed=1)[0], max_new_tokens=3)
            req = eng.submit(_prompts([7], seed=2)[0], max_new_tokens=3,
                             **kwargs)
            (name, value), = kwargs.items()
            assert getattr(req, name) == value
            eng.step()
            first = [r.state for r in (older, req)]
            eng.run_until_complete()
            eng.pool.check_leaks()
            out[pkg] = (first, _outcome(eng, [older, req]))
        assert out["torch"] == out["jax"]
        reasons = out["torch"][1]["reasons"]
        if "priority" in kwargs:
            assert out["torch"][0] == [QUEUED, PREFILLING]
            assert reasons == ["length", "length"]
        else:
            assert reasons == ["length", "timeout"]
            assert out["torch"][1]["tokens"][1] == []


# ---------------------------------------------------------------------------
# the step watchdog on the engine
# ---------------------------------------------------------------------------

def _faulted(models, pkg, schedule, prompts, submit_kwargs=None,
             catch=False, **cfg):
    """Serve ``prompts`` on a fresh engine of ``pkg`` under its own
    FaultPlan(**schedule)."""
    p = PACKAGES[pkg]
    eng = _engine(models, pkg, **cfg)
    seen = _health_log(eng)
    kws = submit_kwargs or [{}] * len(prompts)
    reqs = [eng.submit(x, max_new_tokens=6, **kw)
            for x, kw in zip(prompts, kws)]
    raised = None
    with p["plan"](**schedule) as plan:
        try:
            eng.run_until_complete()
        except p["quarantined"] as e:
            if not catch:
                raise
            raised = type(e).__name__
    return eng, reqs, plan, seen, raised


class TestWatchdogMatchesJax:
    WATCHED = dict(watchdog_floor_s=0.25, watchdog_budget_mult=50.0,
                   step_max_retries=1, health_recovery_steps=2)

    def test_stall_detected_degraded_then_recovers(self, models):
        out = {}
        for pkg in PACKAGES:
            eng, reqs, plan, seen, _ = _faulted(
                models, pkg, dict(step_delay_s={3: 0.6}),
                _prompts([4], seed=7), **self.WATCHED)
            out[pkg] = (_outcome(eng, reqs), plan.injected, seen)
        assert out["torch"] == out["jax"]
        got, injected, seen = out["torch"]
        # attempt 1 is the prefill chunk, 2 and 3 decode attempts: the
        # stalled one ran its step, the retry ran it again on the same
        # inputs (the pools written in place, the same rows)
        assert injected == [("serving_delay", 3, "serving::decode_step")]
        assert got["counters"]["watchdog_stalls"] == 1
        assert got["counters"]["step_retries"] == 1
        assert seen == [1, 0] and got["health"]["state"] == SERVING
        assert got["gauges"]["health_state"] == 0
        assert got["reasons"] == ["length"]

    def test_transient_step_failure_retried(self, models):
        out = {}
        for pkg in PACKAGES:
            eng, reqs, plan, seen, _ = _faulted(
                models, pkg, dict(fail_step_at={2}), _prompts([8], seed=8),
                step_retry_backoff_s=0.01)
            out[pkg] = (_outcome(eng, reqs), plan.injected, seen,
                        eng._prefill_step.retraces)
        assert out["torch"] == out["jax"]
        got, injected, _, retraces = out["torch"]
        assert injected == [("serving_fail", 2, "serving::prefill_step")]
        assert got["health"]["state"] == SERVING and retraces == 0
        assert got["counters"]["step_retries"] == 1

    def test_exhausted_retries_quarantine_and_revive(self, models):
        out = {}
        for pkg, p in PACKAGES.items():
            eng, reqs, plan, seen, raised = _faulted(
                models, pkg, dict(fail_step_at={1, 2}),
                _prompts([8], seed=9), catch=True, step_max_retries=1,
                step_retry_backoff_s=0.01)
            h = eng.health()
            assert h["state"] == FAILED and "ChaosError" in h["last_error"]
            with pytest.raises(p["admission"], match="quarantined"):
                eng.submit(_prompts([4], seed=10)[0], max_new_tokens=2)
            with pytest.raises(p["quarantined"]):
                eng.step()
            quarantined = {k: h[k] for k in HEALTH}
            eng.revive()
            assert eng.health()["state"] == SERVING
            eng.run_until_complete()
            eng.pool.check_leaks()
            out[pkg] = (raised is not None, quarantined,
                        _outcome(eng, reqs), plan.injected, seen)
        assert out["torch"] == out["jax"]
        assert out["torch"][0] and out["torch"][4] == [2, 0]
        assert out["torch"][2]["reasons"] == ["length"]
        assert out["torch"][2]["counters"]["requests_rejected"] == 1

    @pytest.mark.parametrize("schedule", [
        dict(step_delay_s={2: 0.6}), dict(fail_step_at={2}),
        dict(step_delay_s={3: 0.6}, fail_step_at={5})])
    def test_retried_sampled_step_keeps_the_jax_tokens(self, models,
                                                       schedule):
        """A sampled decode attempt that stalls (its step ran) or fails
        (it did not) and is retried: the retry draws at the same token
        index, so every token is the JAX engine's and an unfaulted
        run's.  The plan counts sampled decode attempts only
        (``step_fault_scope``)."""
        schedule = dict(schedule, step_fault_scope="sampled_decode_step")
        prompts = _prompts([8, 5], seed=12)
        kws = [dict(temperature=0.8, top_k=20, seed=3), {}]
        watched = self.WATCHED
        out = {}
        for pkg in PACKAGES:
            eng, reqs, plan, seen, _ = _faulted(
                models, pkg, schedule, prompts, submit_kwargs=kws,
                **watched)
            out[pkg] = (_outcome(eng, reqs), plan.injected, seen)
        assert out["torch"] == out["jax"]
        clean, creqs, _, _, _ = _faulted(models, "torch", {}, prompts,
                                         submit_kwargs=kws, **watched)
        assert out["torch"][0]["tokens"] == _outcome(clean, creqs)["tokens"]
        labels = {x[-1] for x in out["torch"][1]}
        assert labels == {"serving::sampled_decode_step"}
        assert out["torch"][0]["counters"]["step_retries"] >= 1

    def test_poisoned_request_retired_others_unaffected(self, models):
        out = {}
        prompts = _prompts([8, 6, 9], seed=13)
        for pkg in PACKAGES:
            eng = _engine(models, pkg)
            reqs = [eng.submit(x, max_new_tokens=5, request_id=f"r{i}")
                    for i, x in enumerate(prompts)]
            with PACKAGES[pkg]["plan"](fail_request_ids={"r1"}) as plan:
                eng.run_until_complete()
            eng.pool.check_leaks()
            out[pkg] = (_outcome(eng, reqs), plan.injected,
                        "ChaosError" in reqs[1].error)
        assert out["torch"] == out["jax"]
        assert out["torch"][0]["reasons"] == ["length", "error", "length"]
        assert out["torch"][2]

    def test_a_retrace_in_prefill_is_not_poison(self, models):
        """A rebound pool is the engine's fault: under strict_no_retrace
        the prefill chunk's RetraceError propagates (the reference
        would retire the request as an error and serve on)."""
        from paddle_tpu_torch.observability import RetraceError

        eng = _engine(models, "torch")
        eng.generate(_prompts([5]), max_new_tokens=2)
        eng.pool.layers = [tuple(t.clone() for t in e)
                           for e in eng.pool.layers]
        eng.submit(_prompts([6], seed=1)[0], max_new_tokens=2)
        with pytest.raises(RetraceError):
            eng.run_until_complete()


class TestCaptureCarveOut:
    def test_pre_captured_steps_take_no_stall(self, models):
        """Graphs captured before serving (as ``chip_smoke.py`` does):
        the first watched calls are replays, real samples, under a
        0.05 s floor, and none stalls."""
        eng = _engine(models, "torch", watchdog_floor_s=0.05)
        S, nbs = eng.config.max_batch_size, eng.max_blocks_per_seq
        z = lambda *shape: np.zeros(shape, np.int32)    # noqa: E731
        eng._steps["prefill_step"](z(1, eng.chunk_tokens), eng.pool.layers,
                                   z(1, nbs), z(1), 0)
        eng._steps["decode_step"](z(S, 1), eng.pool.layers, z(S, nbs),
                                  z(S))
        r = eng.submit(_prompts([8], seed=14)[0], max_new_tokens=4)
        eng.run_until_complete()
        o = eng.overload
        assert r.finish_reason == "length"
        assert o.decode_watchdog.stalls == o.prefill_watchdog.stalls == 0
        assert o.chunk_ewma.compile_s is None
        assert o.decode_ewma.compile_s is None
        assert o.chunk_ewma.samples == 2 and o.decode_ewma.samples == 3
        assert eng.decode_cache_size() == eng.prefill_cache_size() == 1

    def test_a_capturing_call_is_never_a_stall(self, models):
        """A delay injected into the call that captures the prefill
        step's graph (attempt 1) lands in ``compile_s``, not in a
        stall, even at a floor far below it."""
        eng = _engine(models, "torch", watchdog_floor_s=0.05)
        r = eng.submit(_prompts([8], seed=14)[0], max_new_tokens=4)
        with FaultPlan(step_delay_s={1: 0.2}) as plan:
            eng.run_until_complete()
        o = eng.overload
        assert plan.injected == [("serving_delay", 1,
                                  "serving::prefill_step")]
        assert r.finish_reason == "length"
        assert o.prefill_watchdog.stalls == 0
        assert o.chunk_ewma.compile_s == pytest.approx(0.2)
        assert o.chunk_ewma.samples == 1 and o.decode_ewma.samples == 2
        assert eng.health()["state"] == SERVING


# ---------------------------------------------------------------------------
# expiry
# ---------------------------------------------------------------------------

class TestExpiry:
    def test_expiry_mid_prefill_with_prefix_hit(self, models):
        out = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, num_blocks=32, max_batch_size=2)
            (big,) = _prompts([24], seed=11)
            head = big[:8]
            first = eng.submit(head, max_new_tokens=2)
            eng.run_until_complete()
            hits_before = eng.metrics.prefix_cache_hits
            req = eng.submit(big, max_new_tokens=4, deadline_s=3600.0)
            eng.step()
            mid = (req.state, req.cached_tokens,
                   eng.metrics.prefix_cache_hits - hits_before)
            req.deadline_t = time.monotonic() - 1.0   # force expiry
            eng.run_until_complete()
            # exactly-once release: a double free would have raised
            eng.pool.check_leaks()
            again = eng.submit(head, max_new_tokens=2)
            eng.run_until_complete()
            eng.pool.check_leaks()
            out[pkg] = (mid, _outcome(eng, [first, req, again]))
        assert out["torch"] == out["jax"]
        mid, got = out["torch"]
        assert mid[0] == PREFILLING and mid[1] >= 8 and mid[2] == 1
        assert got["reasons"] == ["length", "timeout", "length"]
        assert got["counters"]["prefix_cache_hits"] == 2

    def test_stalled_stream_times_out_on_its_token_deadline(self, models):
        """A stream whose first chunk stalls past its rolling token
        deadline times out before its next chunk, with no tokens; the
        other request is unaffected."""
        out = {}
        for pkg in PACKAGES:
            eng, reqs, plan, _, _ = _faulted(
                models, pkg, dict(step_delay_s={1: 0.4}),
                _prompts([12, 6], seed=15),
                submit_kwargs=[dict(token_deadline_s=0.3), {}])
            eng.pool.check_leaks()
            out[pkg] = (_outcome(eng, reqs), plan.injected)
        assert out["torch"] == out["jax"]
        got = out["torch"][0]
        assert got["reasons"] == ["timeout", "length"]
        assert got["tokens"][0] == []
        assert got["counters"]["requests_timed_out"] == 1


# ---------------------------------------------------------------------------
# load shedding
# ---------------------------------------------------------------------------

class TestShedding:
    @pytest.mark.parametrize("cfg", [{}, {"prefill_token_budget": 8},
                                     {"shed_safety_factor": 2.0}])
    def test_estimate_and_decision_equal(self, models, cfg):
        """Both engines in the same queue state, their EWMAs set to the
        same values: the same TTFT estimate and the same decisions."""
        out = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, **cfg)
            eng.generate(_prompts([8], seed=42), max_new_tokens=2)
            for x in _prompts([12, 9, 16], seed=1):
                eng.submit(x, max_new_tokens=4)
            eng.step()        # one admitted and mid-prefill
            o = eng.overload
            o.chunk_ewma.value, o.decode_ewma.value = 0.0125, 0.003
            ests, decisions = [], []
            for x in _prompts([12, 3, 25], seed=2):
                est = o.estimate_ttft_s(eng, x)
                ests.append(est)
                decisions.append([o.should_shed(eng, x, est * f)
                                  for f in (0.25, 0.45, 0.9, 1.1, 4.0)])
            out[pkg] = (eng.pending_prefill_tokens(), ests, decisions)
        assert out["torch"] == out["jax"]
        assert any(any(d) for d in out["torch"][2])
        assert not all(all(d) for d in out["torch"][2])

    def test_cold_engine_never_sheds(self, models):
        out = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg)
            assert not eng.overload.can_estimate()
            req = eng.submit(_prompts([6])[0], max_new_tokens=4,
                             deadline_s=0.0)
            state = req.state
            eng.run_until_complete()
            out[pkg] = (state, _outcome(eng, [req]))
        assert out["torch"] == out["jax"]
        assert out["torch"][0] == QUEUED
        assert out["torch"][1]["reasons"] == ["timeout"]

    @pytest.mark.parametrize("shedding", [True, False])
    def test_warm_engine_hopeless_deadline(self, models, shedding):
        """Every attempt takes 2 ms of the virtual clock (the plan's
        delay): EWMAs of 2 ms put the backlog's estimate far past a 1 ms
        deadline and far inside an hour."""
        out = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, enable_load_shedding=shedding)
            with PACKAGES[pkg]["plan"](step_delay_s=0.002):
                _warm(eng)
                backlog = [eng.submit(x, max_new_tokens=4)
                           for x in _prompts([12, 12, 12], seed=1)]
                (x,) = _prompts([12], seed=2)
                assert eng.overload.estimate_ttft_s(eng, x) > 0.001
                doomed = eng.submit(x, max_new_tokens=4, deadline_s=0.001)
                state = doomed.state
                ok = eng.submit(x, max_new_tokens=4, deadline_s=3600.0)
                done = eng.run_until_complete()
            eng.pool.check_leaks()
            out[pkg] = (state, doomed.request_id in done,
                        _outcome(eng, backlog + [doomed, ok]))
        assert out["torch"] == out["jax"]
        state, reported, got = out["torch"]
        assert reported
        assert got["reasons"] == ["length"] * 3 + [
            "shed" if shedding else "timeout", "length"]
        assert state == ("finished" if shedding else QUEUED)
        assert got["counters"]["requests_shed"] == int(shedding)
        assert got["counters"]["goodput_tokens"] == 4 * 4 + 4


class TestOverloadAcceptance:
    """The reference's acceptance burst, shedding on against off: one
    feasible request, then four whose prefill alone (24 chunks under an
    injected 0.03 s an attempt) can never meet a 0.7 s deadline."""

    def _burst(self, models, pkg, shed_on, burst_fn):
        eng = _engine(models, pkg, max_queue_len=32,
                      enable_load_shedding=shed_on)
        with PACKAGES[pkg]["plan"](seed=11, step_delay_s=0.03):
            _warm(eng)
            sizes = (eng.decode_cache_size(), eng.prefill_cache_size())
            feasible = _prompts([8], seed=12)
            doomed = burst_fn(seed=11, n=4, min_len=96, max_len=96)
            reqs = [eng.submit(x, max_new_tokens=4, deadline_s=0.7)
                    for x in feasible + doomed]
            eng.run_until_complete()
        assert eng._decode_step.retraces == eng._prefill_step.retraces == 0
        assert (eng.decode_cache_size(), eng.prefill_cache_size()) == sizes
        assert eng.health()["state"] == SERVING
        eng.pool.check_leaks()
        c = eng.stats()["counters"]
        return reqs, c

    def test_shedding_keeps_admitted_requests_within_deadline(self, models):
        runs = {}
        for pkg, fn in (("jax", jax_burst_prompts),
                        ("torch", burst_prompts)):
            for on in (False, True):
                reqs, c = self._burst(models, pkg, on, fn)
                runs[pkg, on] = (
                    [r.finish_reason for r in reqs],
                    reqs[0].output_ids().tolist(),
                    {k: c[k] for k in ("requests_shed",
                                       "requests_timed_out")},
                    c["goodput_tokens"], c["prefill_chunks"])
        for on in (False, True):
            assert runs["torch", on][:3] == runs["jax", on][:3]
        off, on = runs["torch", False], runs["torch", True]
        assert off[2] == {"requests_shed": 0, "requests_timed_out": 4}
        assert on[2] == {"requests_shed": 4, "requests_timed_out": 0}
        assert on[0] == ["length"] + ["shed"] * 4
        assert on[1] == off[1]
        assert on[3] >= off[3] and on[4] <= off[4]


# ---------------------------------------------------------------------------
# health snapshots
# ---------------------------------------------------------------------------

class TestHealthSnapshots:
    @pytest.mark.parametrize("front", ["engine", "endpoint"])
    def test_keys_and_values(self, models, front):
        out = {}
        for pkg, p in PACKAGES.items():
            eng = _engine(models, pkg)
            eng.generate(_prompts([6, 9]), max_new_tokens=3)
            eng.submit(_prompts([5], seed=3)[0], max_new_tokens=2)
            h = eng.health() if front == "engine" \
                else p["endpoint"](eng).health()
            out[pkg] = (sorted(h), {k: h[k] for k in HEALTH})
            assert h["ewma_decode_s"] is not None
        assert out["torch"] == out["jax"]
        assert out["torch"][1]["state"] == SERVING
        assert out["torch"][1]["queue_depth"] == 1

    def test_stats_carry_health_and_pending_prefill_tokens(self, models):
        out = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg)
            for x in _prompts([9, 14]):
                eng.submit(x, max_new_tokens=2)
            eng.step()
            st = eng.stats()
            out[pkg] = (st["pending_prefill_tokens"],
                        eng.pending_prefill_tokens(),
                        {k: st["health"][k] for k in HEALTH})
        assert out["torch"] == out["jax"]
        assert out["torch"][0] == 9 + 14 - 4     # one chunk of the oldest


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------

class TestFaultPlan:
    def test_burst_prompts_are_the_jax_packages(self):
        for kw in (dict(seed=5, n=8, min_len=8, max_len=16),
                   dict(seed=11, n=4, min_len=96, max_len=96, vocab=1000)):
            got, want = burst_prompts(**kw), jax_burst_prompts(**kw)
            assert [p.tolist() for p in got] == [p.tolist() for p in want]
            assert all(p.dtype == np.int32 for p in got)

    def test_one_plan_at_a_time_and_scope(self):
        with FaultPlan(fail_step_at={1}, step_fault_scope="@b") as plan:
            with pytest.raises(RuntimeError, match="nest"):
                FaultPlan().__enter__()
            from paddle_tpu_torch.resilience import chaos
            chaos.maybe_fail_serving_step("serving::decode_step@a")
            with pytest.raises(ChaosError):
                chaos.maybe_fail_serving_step("serving::decode_step@b")
        assert plan.injected == [("serving_fail", 1,
                                  "serving::decode_step@b")]
        chaos.maybe_fail_serving_step("serving::decode_step@b")  # inactive

    @pytest.mark.parametrize("arg,value,off", [
        ("kill_at_step", 3, None), ("nan_batch_steps", [2], ()),
        ("crash_on_save", 1, None),
        ("corrupt_after_save", {1: "truncate"}, {}),
        ("kill_hard", True, False)])
    def test_training_arguments_wait_for_a5(self, arg, value, off):
        with pytest.raises(NotImplementedError, match=arg):
            FaultPlan(**{arg: value})
        FaultPlan(**{arg: off})             # off: taken, as the reference

    def test_named_engine_tags_its_steps(self, models):
        eng = _engine(models, "torch", name="replica-1")
        with FaultPlan(fail_step_at={1},
                       step_fault_scope="@replica-1") as plan:
            eng.generate(_prompts([4]), max_new_tokens=2)
        assert plan.injected == [("serving_fail", 1,
                                  "serving::prefill_step@replica-1")]


# ---------------------------------------------------------------------------
# H111: the port's deadline and watchdog layers read the monotonic clock
# ---------------------------------------------------------------------------

def test_serving_and_resilience_are_free_of_wall_clock_deadlines():
    import paddle_tpu_torch
    from paddle_tpu.analysis import scan_wall_clock_deadlines

    root = os.path.dirname(paddle_tpu_torch.__file__)
    diags = scan_wall_clock_deadlines(
        [os.path.join(root, "serving"), os.path.join(root, "resilience")])
    assert diags == [], diags
