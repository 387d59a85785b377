"""The port's metrics registry and exporters
(paddle_tpu_torch/observability: stdlib copies of the reference's), the
serving engine's mirror into it, the compile tracker's mirror of graph
captures, and the request spans' chrome trace, against the JAX package.

Tolerance: the same sequence of registry operations gives the same
Prometheus text and JSON (less the JSON's wall-clock ``ts``); a served
run gives the same ``serving_*`` metric names, counter and gauge values
and histogram counts in both packages (histogram sums and buckets are
host timings).  The JAX package is imported inside the tests that need
it, so the ``cuda`` test at the end runs on a machine without JAX
(``python -m pytest --noconftest -m cuda tests/test_torch_observability.py``):
the watchdog around a real graph replay reads at least the replay's
CUDA-event time.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from paddle_tpu_torch.observability import exporters, registry


@pytest.fixture(scope="module")
def jax_obs():
    """The JAX package's registry and exporters."""
    pytest.importorskip("jax")
    from paddle_tpu.observability import exporters as jax_exporters
    from paddle_tpu.observability import registry as jax_registry
    return jax_registry, jax_exporters


PORT = (registry, exporters)


def _ops_counters(reg):
    c = reg.counter("requests_total", "requests by route")
    c.inc()
    c.inc(2.5, route="/v1")
    c.inc(route='a "quoted"\nroute\\x')
    reg.counter("requests_total").inc(4, route="/v1")
    return c.value(route="/v1")


def _ops_gauges(reg):
    g = reg.gauge("queue_depth", "waiting requests")
    g.set(7)
    g.inc(3, pool="a")
    g.dec(1.25, pool="a")
    g.set(-2, pool="b")
    return g.value(pool="a")


def _ops_histograms(reg):
    h = reg.histogram("latency_seconds", "step latency")
    for v in (0.0001, 0.003, 0.003, 0.7, 45.0, 120.0):
        h.observe(v)
    k = reg.histogram("chunks", "chunks a request",
                      buckets=(1, 2, 4, 8, float("inf")))
    for v in (1, 3, 3, 9):
        k.observe(v, kind="prefill")
    return h.count(), h.sum(), k.count(kind="prefill")


def _ops_overflow(reg):
    c = reg.counter("by_user", "per-user (capped)", max_series=2)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        for user in ("a", "b", "c", "d"):
            c.inc(user=user)
    return c.labels_count(), len(w), c.value(overflow="true")


OPS = {"counters": _ops_counters, "gauges": _ops_gauges,
       "histograms": _ops_histograms, "overflow": _ops_overflow}


class TestRegistryMatchesJax:
    @pytest.mark.parametrize("ops", sorted(OPS))
    def test_same_operations_same_exports(self, jax_obs, ops):
        out = []
        for reg_mod, exp in (jax_obs, PORT):
            reg = reg_mod.MetricsRegistry()
            got = OPS[ops](reg)
            js = exp.to_json(reg)
            assert isinstance(js.pop("ts"), float)
            out.append((got, exp.prometheus_text(reg), js, reg.names()))
        assert out[1] == out[0]
        assert out[1][1].startswith("# HELP")

    @pytest.mark.parametrize("case", [
        "bad_name", "bad_label", "decrease", "kind_clash", "buckets_clash",
        "unsorted_buckets", "duplicate_register"])
    def test_same_refusals(self, jax_obs, case):
        kinds = []
        for reg_mod, _ in (jax_obs, PORT):
            reg = reg_mod.MetricsRegistry()
            try:
                if case == "bad_name":
                    reg.counter("1bad name")
                elif case == "bad_label":
                    reg.counter("ok").inc(**{"bad-label": 1})
                elif case == "decrease":
                    reg.counter("ok").inc(-1)
                elif case == "kind_clash":
                    reg.counter("ok")
                    reg.gauge("ok")
                elif case == "buckets_clash":
                    reg.histogram("h", buckets=(1, 2))
                    reg.histogram("h", buckets=(1, 3))
                elif case == "unsorted_buckets":
                    reg.histogram("h", buckets=(2, 1))
                else:
                    reg_mod.Counter("ok", registry=reg)
                    reg_mod.Counter("ok", registry=reg)
            except Exception as e:   # noqa: BLE001 (the type is compared)
                kinds.append(type(e).__name__)
        assert len(kinds) == 2 and kinds[1] == kinds[0]

    def test_enable_switch_and_file_sink(self, tmp_path):
        assert not registry.enabled()
        reg = registry.MetricsRegistry()
        reg.gauge("g", "a gauge").set(3)
        with exporters.FileSink(str(tmp_path), interval_s=None,
                                registry=reg) as sink:
            assert registry.enabled()
        assert not registry.enabled() and sink.writes == 1
        assert "g 3" in (tmp_path / "metrics.prom").read_text()
        dumped = json.loads((tmp_path / "metrics.json").read_text())
        assert dumped["metrics"][0]["series"][0]["value"] == 3.0


# ---------------------------------------------------------------------------
# the serving engine's mirror
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    pytest.importorskip("jax")
    import paddle_tpu as paddle
    from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
    from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
    from paddle_tpu_torch.convert import from_jax_state_dict
    from paddle_tpu_torch.models import LlamaConfig

    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    jax_model.eval()
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return jax_model, from_jax_state_dict(named, LlamaConfig.tiny(),
                                          device="cpu")


def _engines(models, **kw):
    from paddle_tpu.serving import Engine as JaxEngine
    from paddle_tpu.serving import ServingConfig as JaxServingConfig
    from paddle_tpu_torch.serving import Engine, ServingConfig

    cfg = dict(max_batch_size=3, block_size=4, num_blocks=10,
               chunk_tokens=8, max_queue_len=5, fused_kernels=True, **kw)
    return (JaxEngine(models[0], JaxServingConfig(**cfg)),
            Engine(models[1], ServingConfig(**cfg)))


def _workload(eng):
    """Greedy, sampled and streamed requests, a prefix hit, preemption in
    a small pool, a timeout, a queue-full rejection."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 256, size=12)
    got = []
    reqs = [eng.submit(np.concatenate([prefix, rng.randint(1, 256, 3)]),
                       max_new_tokens=8),
            eng.submit(rng.randint(1, 256, 9), max_new_tokens=10,
                       temperature=0.8, seed=4),
            eng.submit(rng.randint(1, 256, 6), max_new_tokens=6,
                       on_token=got.append),
            eng.submit(rng.randint(1, 256, 5), max_new_tokens=3,
                       deadline_s=0.0)]
    while not reqs[0].generated:
        eng.step()
    reqs.append(eng.submit(np.concatenate([prefix, rng.randint(1, 256, 4)]),
                           max_new_tokens=6))
    for _ in range(2):
        reqs.append(eng.submit(rng.randint(1, 256, 4), max_new_tokens=2))
    try:
        for _ in range(5):
            eng.submit(rng.randint(1, 256, 4), max_new_tokens=2)
    except Exception as e:   # noqa: BLE001 (the queue is full)
        assert "queue full" in str(e)
    eng.run_until_complete()
    eng.pool.check_leaks()
    return [r.finish_reason for r in reqs]


def _served_metrics(reg_mod, eng):
    reg_mod.get_registry().clear()
    prev = reg_mod.enable()
    try:
        reasons = _workload(eng)
    finally:
        reg_mod.enable(prev)
    out = {}
    for snap in reg_mod.collect():
        if not snap.name.startswith(("serving_", "kv_quant")):
            continue
        out[snap.name] = (snap.kind, {
            k: (v["count"] if snap.kind == "histogram" else v)
            for k, v in snap.series.items()})
    return reasons, out


class TestServingMirrorMatchesJax:
    def test_names_and_values(self, models, jax_obs):
        jax_eng, eng = _engines(models)
        want = _served_metrics(jax_obs[0], jax_eng)
        got = _served_metrics(registry, eng)
        assert got == want
        reasons, metrics = got
        assert "timeout" in reasons and "length" in reasons
        for name in ("serving_requests_timed_out_total",
                     "serving_preemptions_total",
                     "serving_prefix_cache_hits_total",
                     "serving_requests_rejected_total",
                     "serving_ttft_seconds", "serving_stream_active"):
            assert name in metrics, name
        assert metrics["serving_requests_completed_total"][1][
            (("reason", "timeout"),)] == 1

    def test_overload_metrics(self, models, jax_obs, monkeypatch):
        """Stalls, retries and the ladder under one fault plan, on a
        virtual monotonic clock (``torch_clock``): the same counters by
        step and the same gauges."""
        from paddle_tpu.resilience import FaultPlan as JaxFaultPlan
        from paddle_tpu_torch.resilience import FaultPlan
        from torch_clock import virtual_clock

        virtual_clock(monkeypatch)
        kw = dict(watchdog_floor_s=0.25, watchdog_budget_mult=50.0,
                  step_max_retries=1, health_recovery_steps=1,
                  kv_high_watermark=0.5, kv_low_watermark=0.3)
        out = []
        for (reg_mod, _), eng, plan in zip(
                (jax_obs, PORT), _engines(models, **kw),
                (JaxFaultPlan, FaultPlan)):
            eng.generate([np.arange(1, 9)], max_new_tokens=3)
            reg_mod.get_registry().clear()
            prev = reg_mod.enable()
            try:
                with plan(step_delay_s={3: 0.6}, fail_step_at={6}):
                    _workload(eng)
            finally:
                reg_mod.enable(prev)
            reg = reg_mod.get_registry()
            out.append({n: dict(reg.get(n).snapshot().series)
                        for n in ("serving_watchdog_stalls_total",
                                  "serving_step_retries_total",
                                  "serving_degradation_level",
                                  "serving_health_state")
                        if reg.get(n) is not None})
        assert out[1] == out[0]
        assert out[1]["serving_watchdog_stalls_total"]
        assert "serving_degradation_level" in out[1]


class TestCompileMirror:
    def test_one_capture_per_step(self, models):
        from paddle_tpu_torch.serving import Engine, ServingConfig

        reg = registry.get_registry()
        reg.clear()
        prev = registry.enable()
        try:
            eng = Engine(models[1], ServingConfig(
                max_batch_size=2, block_size=4, num_blocks=32,
                chunk_tokens=8))
            eng.submit(np.arange(1, 12), max_new_tokens=4)
            eng.submit(np.arange(3, 9), max_new_tokens=4, temperature=0.7,
                       seed=1)
            eng.run_until_complete()
            counted = Engine(models[1], ServingConfig(
                max_batch_size=2, block_size=4, num_blocks=32,
                chunk_tokens=8, strict_no_retrace=False))
            counted.generate([np.arange(1, 6)], max_new_tokens=2)
            counted.pool.layers = [tuple(t.clone() for t in e)
                                   for e in counted.pool.layers]
            counted.generate([np.arange(2, 7)], max_new_tokens=2)
        finally:
            registry.enable(prev)
        steps = ("serving::decode_step", "serving::prefill_step",
                 "serving::sampled_decode_step")
        compiles = reg.get("xla_compiles_total")
        # the first engine's three captures, the second's two and its two
        # retraces (the rebound pool)
        assert [compiles.value(fn=s) for s in steps] == [3, 3, 1]
        assert [reg.get("xla_jit_cache_entries").value(fn=s)
                for s in steps] == [2, 2, 1]
        assert reg.get("xla_compile_seconds_total").value(
            fn="serving::prefill_step") > 0
        assert [reg.get("xla_retraces_total").value(fn=s)
                for s in steps] == [1, 1, 0]
        text = exporters.prometheus_text(reg)
        assert 'xla_compiles_total{fn="serving::sampled_decode_step"} 1' \
            in text


class TestChromeSpans:
    def test_export_chrome_matches_jax(self, models, tmp_path):
        out = []
        for eng in _engines(models):
            _workload(eng)
            path = eng.metrics.export_chrome(str(tmp_path / "trace.json"))
            with open(path) as f:
                trace = json.load(f)
            events = trace["traceEvents"]
            for ev in events:
                assert ev["ph"] == "X" and ev["cat"] == "serving"
                assert ev["dur"] >= 0 and ev["ts"] > 0
            out.append(sorted(ev["name"] for ev in events))
        assert out[1] == out[0]
        assert "queued:req-0" in out[1] and "decode:req-0" in out[1]


# ---------------------------------------------------------------------------
# on the card: the watchdog times the device's work
# ---------------------------------------------------------------------------

@pytest.mark.cuda
class TestCudaWatchdogTimesTheDevice:
    def test_watched_time_covers_the_replay(self):
        """Every watched decode and prefill call reads at least the CUDA
        events around its graph's replay: the watched callable ends with
        the step's output on the host (or a synchronize), so ``dt``
        covers the device's work, not the replay's launch."""
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device")
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.serving import Engine, ServingConfig

        dev = torch.device("cuda")
        cfg = LlamaConfig.tiny(dtype="bfloat16", hidden_size=1024,
                               intermediate_size=2816,
                               num_attention_heads=8, num_key_value_heads=2,
                               num_hidden_layers=4,
                               max_position_embeddings=1024)
        model = LlamaForCausalLM(cfg, device=dev, seed=0)
        eng = Engine(model, ServingConfig(max_batch_size=4, block_size=16,
                                          num_blocks=64, chunk_tokens=128))
        seen = {}
        for name, wd in (("decode_step", eng.overload.decode_watchdog),
                         ("prefill_step", eng.overload.prefill_watchdog)):
            events, dts = [], []
            step = getattr(eng, f"_{name}")

            def spy(*args, step=step, events=events):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = step(*args)
                end.record()
                events.append((start, end))
                return out
            setattr(eng, f"_{name}", spy)
            observe = wd.ewma.observe

            def record(dt, compiled=None, observe=observe, dts=dts):
                dts.append(dt)
                observe(dt, compiled)
            wd.ewma.observe = record
            seen[name] = (events, dts)
        rng = np.random.RandomState(0)
        for n in (300, 200, 45):
            eng.submit(rng.randint(1, 256, n), max_new_tokens=12)
        eng.run_until_complete()
        torch.cuda.synchronize()
        for name, (events, dts) in seen.items():
            assert len(events) == len(dts) > 2, name
            for (start, end), dt in zip(events, dts):
                assert dt * 1e3 >= start.elapsed_time(end), name
        h = eng.health()
        assert h["ewma_decode_s"] > 0 and h["ewma_chunk_s"] > 0
        assert eng.overload.decode_watchdog.stalls == 0
