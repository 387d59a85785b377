"""Sampled decoding, streaming and the Endpoint of the port's serving
slice (paddle_tpu_torch.serving) against the JAX package, and fault C3
(the reference's ServingConfig fields).

The tiny f32 Llama of ``tests/test_torch_serving.py`` (the JAX model's
weights through numpy into the port) behind both packages' engines, the
JAX one on its fused steps.  Tolerance: tokens equal, greedy and
sampled under the same seeds.  The port draws its sampled tokens from
the JAX package's own key schedule (``serving/sampling.py``), so a token
can differ only where two Gumbel-perturbed logits lie within a rounding
of each other; on any difference a test fails with the perturbed top-2
margin of the port's logits at that token.
"""
import json
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.resilience import FaultPlan as JaxFaultPlan
from paddle_tpu.resilience.chaos import burst_prompts as jax_burst_prompts
from paddle_tpu.serving import Endpoint as JaxEndpoint
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import EngineQuarantined as JaxEngineQuarantined
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import sse_stream as jax_sse_stream
from paddle_tpu.serving import stream_events as jax_stream_events
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.generation import make_chunked_prefill_step
from paddle_tpu_torch.resilience import FaultPlan
from paddle_tpu_torch.resilience.chaos import burst_prompts
from paddle_tpu_torch.serving import (DONE_FRAME, Endpoint, Engine,
                                      EngineQuarantined,
                                      ServingConfig, sse_event, sse_stream,
                                      stream_events)
from paddle_tpu_torch.serving.cache import BlockKVPool
from paddle_tpu_torch.serving.engine import LATER_SLICE_OPTIONS
from paddle_tpu_torch.serving.sampling import (filter_logits, fold_keys,
                                               gumbel)
from torch_clock import virtual_clock

COUNTERS = ("requests_completed", "preemptions", "prefix_cache_hits",
            "prefix_cache_misses", "prefill_chunks", "decode_iterations",
            "tokens_generated")
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
# requests 0, 2 and 4 sample (each filter, and none), 1 and 3 are greedy
MIXED = [dict(SAMPLED, seed=1000), {}, dict(temperature=1.0, seed=7), {},
         dict(temperature=0.6, top_p=0.9, seed=2 ** 31 - 1)]


@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    jax_model.eval()
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return jax_model, from_jax_state_dict(named, LlamaConfig.tiny(),
                                          device="cpu")


def _prompts():
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 256, size=20)
    return [np.concatenate([prefix, rng.randint(1, 256, size=5)]),
            rng.randint(1, 256, size=13), rng.randint(1, 256, size=3),
            rng.randint(1, 256, size=30),
            np.concatenate([prefix, rng.randint(1, 256, size=9)])]


def _config(cls, num_blocks=64, prefix_cache=True, **kw):
    return cls(max_batch_size=4, block_size=8, num_blocks=num_blocks,
               chunk_tokens=16, enable_prefix_cache=prefix_cache,
               fused_kernels=True, **kw)


def _serve(engine, prompts, kws, **common):
    """As ``test_torch_serving._serve``: all but the last prompt, steps
    until the first has its first token (its prompt blocks registered),
    then the last (sharing the first one's prefix), drained."""
    reqs = [engine.submit(p, **common, **kw)
            for p, kw in zip(prompts[:-1], kws)]
    while not reqs[0].generated:
        engine.step()
    reqs.append(engine.submit(prompts[-1], **common, **kws[-1]))
    engine.run_until_complete()
    engine.pool.check_leaks()
    counters = engine.stats()["counters"]
    return ([[int(t) for t in r.generated] for r in reqs],
            [r.finish_reason for r in reqs],
            {k: counters[k] for k in COUNTERS}, reqs)


def _both(models, kws, num_blocks=64, prefix_cache=True, **common):
    out = []
    for model, engine_cls, config_cls in (
            (models[0], JaxEngine, JaxServingConfig),
            (models[1], Engine, ServingConfig)):
        engine = engine_cls(model, _config(config_cls, num_blocks,
                                           prefix_cache))
        out.append(_serve(engine, _prompts(), kws, **common))
    return out


def _margin(model, prompt, generated, j, kw):
    """The top-2 margin of the logits the port drew token ``j`` of this
    request from (a fresh prefill of the prompt and its first j tokens),
    Gumbel-perturbed and filtered as the sampler did for a sampled
    request."""
    cfg = model.config
    ids = np.concatenate([prompt, generated[:j]]).astype(np.int32)
    bs = 8
    n = -(-len(ids) // bs)
    pool = BlockKVPool(cfg.num_hidden_layers, n + 1, bs,
                       cfg.num_key_value_heads, cfg.head_dim,
                       cfg.torch_dtype, device="cpu")
    bt = torch.zeros((1, -(-cfg.max_position_embeddings // bs)),
                     dtype=torch.int32)
    bt[0, :n] = torch.arange(1, n + 1)
    last = make_chunked_prefill_step(model)(
        torch.from_numpy(ids[None]), pool.layers, bt,
        torch.tensor([0], dtype=torch.int32), len(ids) - 1)
    if kw.get("temperature"):
        from paddle_tpu_torch.serving.sampling import prng_key
        keys = torch.from_numpy(prng_key(kw["seed"])[None])
        last = filter_logits(
            last, torch.tensor([kw["temperature"]]),
            torch.tensor([kw.get("top_k", 0)]),
            torch.tensor([kw.get("top_p", 1.0)])) + \
            gumbel(fold_keys(keys, j), last.shape[-1])
    top2 = torch.topk(last[0], 2).values
    return float(top2[0] - top2[1])


def _assert_tokens_equal(models, got, want, kws, prompts=None):
    prompts = prompts or _prompts()
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        j = next((k for k, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        m = _margin(models[1], prompts[i], a, j, kws[i])
        pytest.fail(f"request {i} token {j}: port {a[j:j + 1]}, JAX "
                    f"{b[j:j + 1]}; perturbed top-2 margin of the port's "
                    f"logits there {m:.4e}")


class TestSampledEngineMatchesJax:
    @pytest.mark.parametrize("prefix_cache", [True, False])
    @pytest.mark.parametrize("num_blocks", [64, 12])
    def test_mixed_bucket(self, models, prefix_cache, num_blocks):
        # 12 blocks: the pool runs dry mid-decode and the youngest
        # requests are preempted and recomputed from their prompts
        jax_out, torch_out = _both(models, MIXED, num_blocks, prefix_cache,
                                   max_new_tokens=12)
        _assert_tokens_equal(models, torch_out[0], jax_out[0], MIXED)
        assert torch_out[1:3] == jax_out[1:3]
        counters = torch_out[2]
        assert counters["requests_completed"] == 5
        assert (counters["preemptions"] > 0) == (num_blocks == 12)
        assert (counters["prefix_cache_hits"] > 0) == prefix_cache

    def test_generate(self, models):
        prompts = _prompts()[:3]
        outs = []
        for model, engine_cls, config_cls in (
                (models[0], JaxEngine, JaxServingConfig),
                (models[1], Engine, ServingConfig)):
            engine = engine_cls(model, _config(config_cls, 32))
            outs.append(engine.generate(prompts, max_new_tokens=6,
                                        temperature=0.9, top_k=20,
                                        seed=5))
        for got, want in zip(outs[1], outs[0]):
            np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("kwargs", [{"top_k": 5}, {"top_p": 0.9},
                                        {"seed": 3}])
    def test_filters_without_temperature_stay_greedy(self, models, kwargs):
        kws = [kwargs] * 5
        jax_out, torch_out = _both(models, kws, max_new_tokens=8)
        assert torch_out[:3] == jax_out[:3]
        greedy = _both(models, [{}] * 5, max_new_tokens=8)[1]
        assert torch_out[0] == greedy[0]
        assert all(r.sampling is None for r in torch_out[3])


class TestSampledEngineInvariants:
    def _engine(self, models, num_blocks=64, **kw):
        return Engine(models[1], _config(ServingConfig, num_blocks, **kw))

    def test_seed_alone_batched_and_preempted(self, models):
        kws = [dict(temperature=1.0, top_k=40, seed=s)
               for s in (11, 12, 13, 14, 15)]
        alone = []
        for p, kw in zip(_prompts(), kws):
            eng = self._engine(models)
            req = eng.submit(p, max_new_tokens=10, **kw)
            eng.run_until_complete()
            alone.append(req.generated)
        batched = _serve(self._engine(models), _prompts(), kws,
                         max_new_tokens=10)
        preempted = _serve(self._engine(models, 12), _prompts(), kws,
                           max_new_tokens=10)
        assert preempted[2]["preemptions"] > 0
        assert batched[0] == alone and preempted[0] == alone

    def test_different_seeds_diverge(self, models):
        p = _prompts()[3]
        eng = self._engine(models)
        reqs = [eng.submit(p, max_new_tokens=12, temperature=1.0, seed=s)
                for s in (1, 2, 1)]
        eng.run_until_complete()
        assert reqs[0].generated == reqs[2].generated
        assert reqs[0].generated != reqs[1].generated

    def test_greedy_lanes_in_a_mixed_bucket(self, models):
        mixed = _serve(self._engine(models), _prompts(), MIXED,
                       max_new_tokens=12)[0]
        greedy = _serve(self._engine(models), _prompts(), [{}] * 5,
                        max_new_tokens=12)[0]
        for i, kw in enumerate(MIXED):
            if not kw:
                assert mixed[i] == greedy[i]
        assert any(mixed[i] != greedy[i] for i, kw in enumerate(MIXED)
                   if kw)

    @pytest.mark.parametrize("kws,runs", [([{}] * 5, False),
                                          (MIXED, True)])
    def test_sampled_step_runs_only_with_a_sampled_slot(self, models, kws,
                                                        runs):
        eng = self._engine(models)
        calls = []
        step = eng._sampled_decode_step
        eng._sampled_decode_step = lambda *a: calls.append(1) or step(*a)
        _serve(eng, _prompts(), kws, max_new_tokens=6)
        assert bool(calls) == runs
        # every slot's sampling state is cleared once its request leaves
        assert not eng._temps.any() and not eng._top_ks.any()
        assert not eng._keys.any() and not eng._counters.any()
        assert bool((eng._top_ps == 1).all())

    def test_seedless_requests_follow_the_generator(self, models):
        toks = []
        for gen in (torch.Generator().manual_seed(9),
                    torch.Generator().manual_seed(9), None, None):
            eng = Engine(models[1], _config(ServingConfig), generator=gen)
            req = eng.submit(_prompts()[1], max_new_tokens=8,
                             do_sample=True)
            eng.run_until_complete()
            assert req.sampling.temperature == 1.0
            toks.append(req.generated)
        assert toks[0] == toks[1] and toks[2] == toks[3]


class TestStreaming:
    @pytest.mark.parametrize("kw", [{}, SAMPLED | {"seed": 4}])
    def test_on_token_delivers_the_tokens_in_order(self, models, kw):
        got = []
        eng = Engine(models[1], _config(ServingConfig))
        req = eng.submit(_prompts()[0], max_new_tokens=8,
                         on_token=got.append, **kw)
        eng.run_until_complete()
        assert got == req.generated
        assert got == req.output_ids()[len(_prompts()[0]):].tolist()

    @pytest.mark.parametrize("kw", [{}, SAMPLED | {"seed": 4}])
    def test_stream_events_and_sse_equal_jax(self, models, kw):
        p = _prompts()[2]
        jax_eng = JaxEngine(models[0], _config(JaxServingConfig))
        eng = Engine(models[1], _config(ServingConfig))
        events = list(stream_events(eng, p, max_new_tokens=6, **kw))
        assert events == list(jax_stream_events(jax_eng, p,
                                                max_new_tokens=6, **kw))
        assert [e["index"] for e in events[:-1]] == list(range(6))
        assert events[-1]["finish_reason"] == "length"
        frames = list(sse_stream(eng, p, max_new_tokens=6, **kw))
        assert frames == list(jax_sse_stream(jax_eng, p, max_new_tokens=6,
                                             **kw))
        assert frames[-1] == DONE_FRAME == "data: [DONE]\n\n"
        assert [json.loads(f[len("data: "):])["token"]
                for f in frames[:-2]] == [e["token"] for e in events[:-1]]
        assert sse_event({"a": 1}) == 'data: {"a":1}\n\n'

    def test_stream_active_tracks_the_lifecycle(self, models):
        eng = Engine(models[1], _config(ServingConfig))
        req = eng.submit(_prompts()[2], max_new_tokens=3,
                         on_token=lambda t: None)
        other = eng.submit(_prompts()[1], max_new_tokens=3)
        assert eng.stats()["gauges"]["stream_active"] == 1
        eng.run_until_complete()
        assert req.finish_reason == other.finish_reason == "length"
        assert eng.stats()["gauges"]["stream_active"] == 0

    @pytest.mark.parametrize("fail_at", [0, 2])
    def test_a_raising_callback_retires_only_its_request(self, models,
                                                         fail_at):
        # at 0 the callback raises on the prefill's token, at 2 mid-decode
        def callback(tok, seen=[]):
            seen.append(tok)
            if len(seen) > fail_at:
                raise ValueError("client went away")

        outs = []
        for model, engine_cls, config_cls in (
                (models[0], JaxEngine, JaxServingConfig),
                (models[1], Engine, ServingConfig)):
            eng = engine_cls(model, _config(config_cls))
            seen = []
            bad = eng.submit(_prompts()[2], max_new_tokens=6,
                             on_token=lambda t: callback(t, seen))
            good = eng.submit(_prompts()[1], max_new_tokens=6, **SAMPLED,
                              seed=3)
            eng.run_until_complete()
            eng.pool.check_leaks()
            ctr = eng.stats()["counters"]
            outs.append((bad.finish_reason, bad.generated, good.generated,
                         good.finish_reason, ctr["requests_failed"],
                         ctr["goodput_tokens"]))
            assert "on_token" in bad.error and "client went away" in bad.error
            assert eng.stats()["gauges"]["stream_active"] == 0
        assert outs[1] == outs[0]
        assert outs[1][0] == "error" and len(outs[1][1]) == fail_at + 1
        assert outs[1][3] == "length" and outs[1][4] == 1
        assert outs[1][5] == 6            # the error's tokens are no goodput


class TestEndpoint:
    def _both(self, models, **defaults):
        return (JaxEndpoint(models[0], _config(JaxServingConfig),
                            **defaults),
                Endpoint(models[1], _config(ServingConfig), **defaults))

    def test_run_and_handles(self, models):
        rng = np.random.RandomState(3)
        batch = rng.randint(1, 256, size=(3, 7)).astype(np.int32)
        outs = []
        for ep in self._both(models, max_new_tokens=6):
            assert ep.get_input_names() == ["input_0"]
            h = ep.get_input_handle("input_0")
            h.copy_from_cpu(batch)
            assert h.shape == [3, 7]
            got = ep.run(temperature=0.7, seed=21)
            outs.append((ep.get_output_handle("output_0").copy_to_cpu(),
                         got))
        np.testing.assert_array_equal(outs[1][0], outs[0][0])
        for a, b in zip(outs[1][1], outs[0][1]):
            np.testing.assert_array_equal(a, b)
        # the rectangle is padded with eos where a request stopped early
        eos = int(outs[1][0][0, 9])
        rects = []
        for ep in self._both(models, max_new_tokens=6, eos_token_id=eos):
            ep.run(list(batch))
            rects.append(ep.get_output_handle("output_0").copy_to_cpu())
        np.testing.assert_array_equal(rects[1], rects[0])

    def test_submit_poll_result_and_stream(self, models):
        res = []
        for ep in self._both(models, max_new_tokens=5):
            a = ep.submit(_prompts()[0], temperature=0.9, seed=8)
            b = ep.submit(_prompts()[1])
            assert ep.result(a) is None
            frames = list(ep.stream(_prompts()[3], **SAMPLED, seed=2))
            while ep.poll():
                pass
            done = ep.drain()
            res.append((ep.result(a).tolist(), ep.result(b).tolist(),
                        frames, sorted(done), ep.metrics()["counters"][
                            "requests_completed"]))
        assert res[1] == res[0]

    def test_health_is_the_engines(self, models):
        """``Endpoint.health()`` is its engine's snapshot, with the
        reference's keys and, but for the latency EWMAs, its values."""
        res = []
        for ep in self._both(models, max_new_tokens=4):
            ep.run([_prompts()[1], _prompts()[2]])
            ep.submit(_prompts()[3])
            h = ep.health()
            assert h == ep.engine.health()
            assert h["ewma_chunk_s"] > 0 and h["ewma_decode_s"] > 0
            res.append({k: v for k, v in h.items()
                        if not k.startswith("ewma_")})
        assert res[1] == res[0]
        assert res[1]["state"] == "serving" and res[1]["queue_depth"] == 1

    def test_takes_an_engine_but_not_a_second_config(self, models):
        eng = Engine(models[1], _config(ServingConfig))
        assert Endpoint(eng).engine is eng
        with pytest.raises(ValueError, match="ServingConfig"):
            Endpoint(eng, _config(ServingConfig))


# the 13 ServingConfig fields of fault C3, at the reference's defaults
C3_FIELDS = ("name", "strict_no_retrace", "hbm_budget_bytes", "xray_chip",
             "enable_load_shedding", "shed_safety_factor",
             "kv_high_watermark", "kv_low_watermark",
             "watchdog_budget_mult", "watchdog_floor_s", "step_max_retries",
             "step_retry_backoff_s", "health_recovery_steps")
REFUSED = {"hbm_budget_bytes": 1 << 30, "xray_chip": "v5p"}
# the overload controller's fields, refused until it was ported, at the
# values the refusal tests gave them
OVERLOAD = {"enable_load_shedding": False, "shed_safety_factor": 2.0,
            "kv_high_watermark": 0.9, "kv_low_watermark": 0.5,
            "watchdog_budget_mult": 5.0, "watchdog_floor_s": 1.0,
            "step_max_retries": 0, "step_retry_backoff_s": 0.5,
            "health_recovery_steps": 1}


def _shedding(eng, plan):
    """The same queue and EWMAs: the estimate, should_shed at five
    deadlines around it, and whether a request at 0.75 of it is shed."""
    eng.generate([_prompts()[2]], max_new_tokens=2)
    for p in _prompts()[:3]:
        eng.submit(p, max_new_tokens=2)
    o = eng.overload
    o.chunk_ewma.value, o.decode_ewma.value = 0.0125, 0.003
    p = _prompts()[3]
    est = o.estimate_ttft_s(eng, p)
    decisions = [o.should_shed(eng, p, est * f)
                 for f in (0.3, 0.45, 0.75, 1.1, 3.0)]
    req = eng.submit(p, max_new_tokens=2, deadline_s=3600.0)
    doomed = eng.submit(p, max_new_tokens=2, deadline_s=est * 0.75)
    return est, decisions, req.finish_reason, doomed.finish_reason


def _ladder(eng, plan):
    """A seeded burst (each package's own ``burst_prompts``) into a
    pool of 12 blocks: the ladder's transitions, the preemptions and
    every request's tokens."""
    burst = (burst_prompts if plan is FaultPlan else jax_burst_prompts)(
        seed=5, n=6, min_len=8, max_len=24)
    reqs = [eng.submit(p, max_new_tokens=6) for p in burst]
    eng.run_until_complete()
    for _ in range(5):
        eng.step()
    eng.pool.check_leaks()
    return (eng.overload.ladder.transitions,
            eng.stats()["counters"]["preemptions"],
            [r.generated for r in reqs], [r.finish_reason for r in reqs])


def _budgets(eng, plan):
    """Each watchdog's budget cold and at two EWMA values."""
    out = []
    for wd in (eng.overload.decode_watchdog, eng.overload.prefill_watchdog):
        out.append(wd.budget_s())
        for v in (0.01, 10.0):
            wd.ewma.value = v
            out.append(wd.budget_s())
    return out


def _retries(eng, plan):
    """Attempt 2 (the second prefill chunk) fails: with one attempt the
    engine quarantines, after a backoff it retries; then revive and
    drain."""
    req = eng.submit(_prompts()[3], max_new_tokens=4)
    t0 = time.monotonic()
    with plan(fail_step_at={2}) as p:
        try:
            eng.run_until_complete()
            raised = False
        except (JaxEngineQuarantined, EngineQuarantined):
            raised = True
    waited = time.monotonic() - t0
    state = eng.health()["state"]
    eng.revive()
    eng.run_until_complete()
    c = eng.stats()["counters"]
    backoff = eng.config.step_retry_backoff_s
    return (raised, state, p.injected, req.generated, req.finish_reason,
            c["step_retries"], waited >= backoff if backoff >= 0.5 else None)


def _recovery(eng, plan):
    """A decode attempt stalls 0.6 s against a 0.25 s floor: the health
    state after every step until the request finishes."""
    eng.generate([_prompts()[2]], max_new_tokens=2)   # captures, compiles
    req = eng.submit(_prompts()[2], max_new_tokens=6)
    states = []
    with plan(step_delay_s={2: 0.6}) as p:
        while eng.step():
            states.append(eng.health()["state"])
    return states, p.injected, req.generated, eng.health()["watchdog_stalls"]


OVERLOAD_EFFECTS = {
    "enable_load_shedding": (_shedding, {}),
    "shed_safety_factor": (_shedding, {}),
    "kv_high_watermark": (_ladder, {"num_blocks": 12}),
    "kv_low_watermark": (_ladder, {"num_blocks": 12,
                                   "kv_high_watermark": 0.8}),
    "watchdog_budget_mult": (_budgets, {}),
    "watchdog_floor_s": (_budgets, {}),
    "step_max_retries": (_retries, {}),
    "step_retry_backoff_s": (_retries, {}),
    "health_recovery_steps": (_recovery, {"watchdog_floor_s": 0.25,
                                          "watchdog_budget_mult": 50.0,
                                          "step_max_retries": 1}),
}


class TestServingConfigC3:
    def test_both_configs_from_one_dict(self, models):
        ref = JaxServingConfig()
        fields = {f: getattr(ref, f) for f in C3_FIELDS}
        jax_cfg = JaxServingConfig(**fields)
        cfg = ServingConfig(**fields)
        assert {f: getattr(cfg, f) for f in C3_FIELDS} == \
            {f: getattr(jax_cfg, f) for f in C3_FIELDS}
        Engine(models[1], cfg)

    @pytest.mark.parametrize("field", sorted(REFUSED))
    def test_a_later_slice_field_raises_naming_it(self, models, field):
        assert field in LATER_SLICE_OPTIONS
        with pytest.raises(NotImplementedError, match=field):
            Engine(models[1], ServingConfig(**{field: REFUSED[field]}))

    @pytest.mark.parametrize("field", sorted(OVERLOAD))
    def test_an_overload_field_is_taken(self, models, field, monkeypatch):
        """Each field the overload controller reads is taken at the
        value it was refused at, and acts as in the JAX engine (on a
        virtual monotonic clock, ``torch_clock``: the stalls and backoffs
        are the schedule's, whatever the CPU's load)."""
        virtual_clock(monkeypatch)
        assert field not in LATER_SLICE_OPTIONS
        scenario, extra = OVERLOAD_EFFECTS[field]
        out = []
        for model, engine_cls, config_cls, plan in (
                (models[0], JaxEngine, JaxServingConfig, JaxFaultPlan),
                (models[1], Engine, ServingConfig, FaultPlan)):
            eng = engine_cls(model, _config(
                config_cls, **{field: OVERLOAD[field]}, **extra))
            assert getattr(eng.config, field) == OVERLOAD[field]
            out.append(scenario(eng, plan))
        assert out[1] == out[0]
        # the value moved something that a default engine does otherwise
        default = Engine(models[1], _config(ServingConfig, **extra))
        assert scenario(default, FaultPlan) != out[1]

    @pytest.mark.parametrize("field,value", [("name", "replica-1"),
                                             ("strict_no_retrace", False)])
    def test_name_and_strict_no_retrace_are_taken(self, models, field,
                                                  value):
        eng = Engine(models[1], _config(ServingConfig, **{field: value}))
        greedy = _serve(eng, _prompts(), [{}] * 5, max_new_tokens=4)
        want = _serve(Engine(models[1], _config(ServingConfig)), _prompts(),
                      [{}] * 5, max_new_tokens=4)
        assert greedy[:3] == want[:3]
