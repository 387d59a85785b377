"""The port's multi-tenant trace replay (paddle_tpu_torch/serving/replay.py)
against the JAX package's.

- ``build_trace``: the default tenant mix at three seeds and a custom mix
  equal to the JAX trace field by field (steps, tenants, ids, prompts,
  token budgets, deadlines, priorities, sampling and per-request seeds),
  since both draw from one ``numpy.random.RandomState(seed)``;
- ``replay_trace``: the reference's cases (``tests/test_router.py``
  ``TestReplay``) through both packages' fleets of the tiny f32 Llama
  (the JAX model's weights through ``convert``), the reports equal;
  affinity ahead of round-robin on cached tokens.

The replays run on a virtual monotonic clock (``torch_clock``) whose
nanoseconds also stamp both packages' request timelines, so every
TTFT in the reports is the clock's and equal in both (0: a step takes
no time there); the TTFTs on the card are ``chip_smoke.py`` phase 6r's.
"""
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.serving import metrics as jax_metrics
from paddle_tpu_torch import serving as torch_serving
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.serving import metrics as torch_metrics
from torch_clock import virtual_clock

SERVING = {"jax": jax_serving, "torch": torch_serving}
ARRIVAL_FIELDS = ("step", "tenant", "max_new_tokens", "deadline_s",
                  "priority", "request_id", "temperature", "top_k", "top_p",
                  "seed")


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    c = virtual_clock(monkeypatch)
    for mod in (jax_metrics, torch_metrics):
        monkeypatch.setattr(mod, "_now_ns", lambda: int(c.now * 1e9))
    return c


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


def _fleet(models, pkg, n=2, **router_kw):
    s = SERVING[pkg]
    engines = [s.Engine(models[pkg], s.ServingConfig(
        name=f"replica-{i}", max_batch_size=4, block_size=4, num_blocks=64,
        max_queue_len=32, chunk_tokens=16, fused_kernels=True))
        for i in range(n)]
    return s.Router(engines, **router_kw)


def _same_trace(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ARRIVAL_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        assert a.prompt.dtype == b.prompt.dtype == np.int32
        assert a.prompt.tobytes() == b.prompt.tobytes()


def _tenants(pkg, specs):
    return [SERVING[pkg].Tenant(name, **kw) for name, kw in specs]


MIX = [("chat", dict(requests=5, shared_prefix_tokens=24, tail_tokens=(2, 6),
                     max_new_tokens=3)),
       ("burst", dict(kind="burst", requests=4, shared_prefix_tokens=12,
                      tail_tokens=(2, 4), max_new_tokens=2))]


class TestBuildTrace:
    @pytest.mark.parametrize("seed", [0, 21, 1234])
    def test_default_tenants_equal_jax(self, seed):
        assert [vars(t) for t in torch_serving.default_tenants()] == \
            [vars(t) for t in jax_serving.default_tenants()]
        _same_trace(torch_serving.build_trace(seed=seed, horizon=12),
                    jax_serving.build_trace(seed=seed, horizon=12))

    def test_custom_mix_and_vocab_equal_jax(self):
        specs = MIX + [("sampled", dict(requests=3, temperature=0.8,
                                        top_k=50, top_p=0.95,
                                        deadline_s=2.0, priority=1))]
        got, want = (SERVING[pkg].build_trace(
            _tenants(pkg, specs), seed=5, horizon=24, vocab=128256)
            for pkg in ("torch", "jax"))
        _same_trace(got, want)
        assert all(a.seed is not None for a in got if a.tenant == "sampled")

    def test_seed_determinism_and_burst(self):
        a = torch_serving.build_trace(seed=21, horizon=12)
        b = torch_serving.build_trace(seed=21, horizon=12)
        _same_trace(a, b)
        assert len(a) == sum(t.requests
                             for t in torch_serving.default_tenants())
        c = torch_serving.build_trace(seed=22, horizon=12)
        assert any(not np.array_equal(x.prompt, y.prompt)
                   for x, y in zip(a, c))
        trace = torch_serving.build_trace(seed=0, horizon=16)
        steps = {x.step for x in trace if x.tenant == "burst"}
        assert max(steps) - min(steps) <= 1    # a two-iteration window
        chat = [x for x in trace if x.tenant == "chat"]
        assert all(np.array_equal(x.prompt[:48], chat[0].prompt[:48])
                   for x in chat)
        assert all(x.prompt.min() >= 1 for x in trace)   # no pad ids


class TestReplayTrace:
    def test_replay_accounts_every_request(self, models):
        def run(pkg):
            s = SERVING[pkg]
            return s.replay_trace(_fleet(models, pkg), s.build_trace(
                _tenants(pkg, MIX), seed=23, horizon=8))

        got = {pkg: run(pkg) for pkg in ("jax", "torch")}
        assert got["torch"] == got["jax"]
        report = got["torch"]
        assert set(report["tenants"]) == {"chat", "burst"}
        for name, t in report["tenants"].items():
            n = {"chat": 5, "burst": 4}[name]
            assert t["submitted"] == n
            assert sum(t["finished"].values()) == n    # all accounted
            assert t["finished"].get("length", 0) == n
            assert t["goodput_tokens"] > 0
            assert t["mean_ttft_s"] is not None
        fl = report["fleet"]
        assert fl["requests"] == 9 and fl["policy"] == "affinity"
        assert fl["quarantines"] == 0 and fl["resubmits"] == 0

    def test_default_mix_with_sampling_equal_jax(self, models):
        """The stock four tenants, the sampled one on its per-request
        seeds: the same report, and the same tokens a request."""
        def run(pkg):
            s = SERVING[pkg]
            router = _fleet(models, pkg)
            report = s.replay_trace(router, s.build_trace(seed=3,
                                                          horizon=10))
            tokens = {rid: [int(x) for x in t.handle.generated]
                      for rid, t in router._tracked.items()}
            return report, router.placement_log_text(), tokens

        got = {pkg: run(pkg) for pkg in ("jax", "torch")}
        assert got["torch"] == got["jax"]
        finished = got["torch"][0]["tenants"]["sampled"]["finished"]
        assert finished == {"length": 4}

    def test_affinity_beats_round_robin_on_cached_tokens(self, models):
        ratios = {}
        for pkg in ("jax", "torch"):
            s = SERVING[pkg]
            trace = s.build_trace(
                [s.Tenant("chat", requests=6, shared_prefix_tokens=48,
                          tail_tokens=(2, 6), max_new_tokens=2)],
                seed=24, horizon=6)
            for policy in ("affinity", "round_robin"):
                router = _fleet(models, pkg, policy=policy,
                                affinity_weight=8.0)
                ratios[pkg, policy] = s.replay_trace(
                    router, trace)["fleet"]["cached_token_ratio"]
        for policy in ("affinity", "round_robin"):
            assert ratios["torch", policy] == ratios["jax", policy]
        assert ratios["torch", "affinity"] > ratios["torch", "round_robin"]
