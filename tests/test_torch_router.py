"""The port's fleet router (paddle_tpu_torch/serving/router.py) against the
JAX package's, case for case with the reference's ``tests/test_router.py``
and its mixed-dtype fleet (``tests/test_quantized_serving.py``).

The tiny f32 Llama of ``tests/test_torch_serving.py`` (the JAX model's
weights carried into the port through ``convert``) behind both
packages' engines, each fleet built from the same configs and fed the
same prompts.  Tolerance: placement logs byte for byte, tokens, finish
reasons, the router's ``stats()`` counters, the ``health()`` keys and
states, the replicas' prefix summaries and the error messages equal.

Every test runs on a virtual monotonic clock (``torch_clock``): a step
takes no time, so a warmed EWMA holds the same value in both packages
and a placement after a failover scores alike.  The engines serve
through the fused steps; the mixed-dtype fleet through the unfused ones,
as the reference's test does.
"""
import os

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import serving as jax_serving
from paddle_tpu.inference import \
    create_serving_endpoint as jax_create_serving_endpoint
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.resilience import FaultPlan as JaxFaultPlan
from paddle_tpu_torch import serving as torch_serving
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.inference import create_serving_endpoint
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.resilience import FaultPlan
from torch_clock import virtual_clock

PACKAGES = {
    "jax": dict(serving=jax_serving, plan=JaxFaultPlan,
                endpoint=jax_create_serving_endpoint),
    "torch": dict(serving=torch_serving, plan=FaultPlan,
                  endpoint=create_serving_endpoint),
}
PKGS = tuple(PACKAGES)


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


def _prompts(lengths, vocab=256, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32)
            for n in lengths]


def _engine(models, pkg, name="", **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_queue_len", 32)
    kw.setdefault("chunk_tokens", 16)
    kw.setdefault("fused_kernels", True)
    s = PACKAGES[pkg]["serving"]
    return s.Engine(models[pkg], s.ServingConfig(name=name, **kw))


def _fleet(models, pkg, n=2, engine_kw=None, **router_kw):
    engines = [_engine(models, pkg, name=f"replica-{i}",
                       **(engine_kw or {})) for i in range(n)]
    return PACKAGES[pkg]["serving"].Router(engines, **router_kw), engines


def _tokens(done):
    return {rid: [int(t) for t in r.generated] for rid, r in done.items()}


def _both(fn):
    """``fn(pkg)`` for each package: {pkg: result}."""
    return {pkg: fn(pkg) for pkg in PKGS}


def _home(line):
    return line.split(" -> ")[1].split()[0]


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------

class TestRouterValidation:
    @pytest.mark.parametrize("case", [
        "empty", "policy", "block_size", "duplicate"])
    def test_refusals_match(self, models, case):
        def build(pkg):
            s = PACKAGES[pkg]["serving"]
            if case == "empty":
                replicas, kw = [], {}
            elif case == "policy":
                replicas, kw = [_engine(models, pkg)], {"policy": "sticky"}
            elif case == "block_size":
                replicas, kw = [_engine(models, pkg, block_size=4),
                                _engine(models, pkg, block_size=8)], {}
            else:
                replicas, kw = [_engine(models, pkg, name="a"),
                                _engine(models, pkg, name="a")], {}
            with pytest.raises(ValueError) as err:
                s.Router(replicas, **kw)
            return str(err.value)

        msgs = _both(build)
        assert msgs["torch"] == msgs["jax"]
        assert {"empty": "at least one", "policy": "unknown policy",
                "block_size": "block_size",
                "duplicate": "duplicate"}[case] in msgs["torch"]

    def test_policies_and_positional_names(self, models):
        assert torch_serving.ROUTER_POLICIES == jax_serving.ROUTER_POLICIES
        names = _both(lambda pkg: [
            r.name for r in _fleet(models, pkg, n=2)[0].replicas])
        assert names["torch"] == names["jax"] == ["replica-0", "replica-1"]


# ---------------------------------------------------------------------------
# tokens: a fleet gives a single engine's and generate()'s
# ---------------------------------------------------------------------------

class TestRouterParity:
    def test_token_parity_with_engine_and_generate(self, models):
        prompts = _prompts([5, 9, 3, 12, 7, 6], seed=1)

        def run(pkg):
            router, engines = _fleet(models, pkg, n=2)
            out = router.generate(prompts, max_new_tokens=6)
            for eng in engines:
                assert eng._decode_step.retraces == 0
                assert eng._prefill_step.retraces == 0
                eng.pool.check_leaks()
            return [o.tolist() for o in out], router.placement_log_text()

        got = _both(run)
        assert got["torch"] == got["jax"]
        single = _engine(models, "torch").generate(list(prompts),
                                                   max_new_tokens=6)
        assert got["torch"][0] == [o.tolist() for o in single]
        # the JAX model's own generate() (static cache), the oracle of
        # the reference's test
        for i in (0, 3):
            ref = models["jax"].generate(
                paddle.to_tensor(prompts[i][None, :]), max_new_tokens=6,
                temperature=0.0, use_static_cache=True)
            assert got["torch"][0][i] == np.asarray(ref.numpy())[0].tolist()


# ---------------------------------------------------------------------------
# placement: a cold fleet's log is the JAX router's, byte for byte
# ---------------------------------------------------------------------------

class TestPlacementDeterminism:
    @pytest.mark.parametrize("policy", ["affinity", "round_robin"])
    def test_cold_fleet_placement_log_byte_identical(self, models, policy):
        prompts = _prompts([8, 8, 5, 8, 11, 8, 6, 8], seed=2)
        shared = _prompts([20], seed=3)[0]
        prompts += [np.concatenate([shared, p]) for p in
                    _prompts([3, 5, 2], seed=4)]

        def run(pkg):
            router, _ = _fleet(models, pkg, n=2, seed=7, policy=policy)
            for p in prompts:
                router.submit(p, max_new_tokens=4)
            log = router.placement_log_text()
            done = router.run_until_complete()
            assert len(done) == len(prompts)
            return log, _tokens(done), router.metrics.placements

        got = _both(run)
        assert got["torch"][0].encode() == got["jax"][0].encode()
        assert got["torch"][1:] == got["jax"][1:]
        assert len(got["torch"][0].splitlines()) == len(prompts)
        # a second cold fleet repeats it
        assert run("torch")[0] == got["torch"][0]
        if policy == "round_robin":
            assert got["torch"][2] == {"replica-0": 6, "replica-1": 5}


# ---------------------------------------------------------------------------
# prefix affinity
# ---------------------------------------------------------------------------

class TestAffinity:
    def test_shared_prefix_family_consolidates(self, models):
        system = _prompts([32], seed=6)[0]
        family = [np.concatenate([system, t])
                  for t in _prompts([5, 3, 7, 4], seed=7)]
        solo = _prompts([9, 6], seed=8)

        def run(pkg):
            router, _ = _fleet(models, pkg, n=2)
            reqs = [router.submit(p, max_new_tokens=4)
                    for p in family + solo]
            done = router.run_until_complete()
            assert len(done) == len(reqs)
            return router.placement_log_text(), _tokens(done)

        got = _both(run)
        assert got["torch"] == got["jax"]
        lines = got["torch"][0].splitlines()[:len(family)]
        assert len({_home(line) for line in lines}) == 1, lines
        affs = [int(line.split("aff=")[1].split()[0]) for line in lines]
        assert affs[0] == 0 and all(a > 0 for a in affs[1:]), affs

    def test_registered_prefix_attracts_follow_up(self, models):
        shared = _prompts([24], seed=9)[0]
        first = np.concatenate([shared, _prompts([4], seed=10)[0]])
        follow = np.concatenate([shared, _prompts([6], seed=11)[0]])

        def run(pkg):
            router, _ = _fleet(models, pkg, n=2)
            router.generate([first], max_new_tokens=2)
            for rep in router.replicas:   # the registered index alone
                rep.pending_hashes.clear()
            summary = {r.name: r.engine.pool.prefix_summary()
                       for r in router.replicas}
            router.generate([follow], max_new_tokens=2)
            return router.placement_log, summary

        got = _both(run)
        assert got["torch"] == got["jax"]
        log = got["torch"][0]
        assert _home(log[1]) == _home(log[0])
        assert int(log[1].split("aff=")[1].split()[0]) > 0


# ---------------------------------------------------------------------------
# fleet-boundary shedding
# ---------------------------------------------------------------------------

def _warm_estimators(router, chunk_s=0.5, decode_s=0.05):
    """Every replica's TTFT estimator warmed without a step: the first
    observation is the compile, the second the value."""
    for rep in router.replicas:
        ov = rep.engine.overload
        for _ in range(2):
            ov.chunk_ewma.observe(chunk_s)
            ov.decode_ewma.observe(decode_s)
        assert ov.can_estimate()


class TestGlobalShedding:
    @pytest.mark.parametrize("case", ["warm", "cold", "disabled"])
    def test_shedding(self, models, case):
        def run(pkg):
            router, engines = _fleet(
                models, pkg, n=2,
                enable_global_shedding=case != "disabled")
            if case != "cold":
                _warm_estimators(router)
            prompt = _prompts([8 if case == "cold" else 20],
                              seed=13 if case == "cold" else 12)[0]
            req = router.submit(prompt, max_new_tokens=4, deadline_s=1e-4)
            shed_where = [eng.metrics.shed for eng in engines]
            busy = [eng.has_work() for eng in engines]
            done = router.run_until_complete()
            for eng in engines:
                eng.pool.check_leaks()
            return (req.finish_reason, router.metrics.shed_global,
                    router.placement_log_text(), shed_where, busy,
                    sorted(done))

        got = _both(run)
        assert got["torch"] == got["jax"]
        reason, shed_global, log, shed_where, busy, done = got["torch"]
        assert done == ["rq-0"]            # retired, never lost
        if case == "warm":
            assert (reason, shed_global) == ("shed", 1)
            assert log.endswith("SHED policy=global")
            assert shed_where == [0, 0] and busy == [False, False]
        elif case == "cold":
            assert reason != "shed" and shed_global == 0
        else:
            # the replica's own shedding is the backstop
            assert (reason, shed_global) == ("shed", 0)


# ---------------------------------------------------------------------------
# failover: quarantine, drain, resubmit
# ---------------------------------------------------------------------------

CHAOS = dict(step_max_retries=1, step_retry_backoff_s=0.0)


class TestFailover:
    def test_replica_kill_zero_lost_token_parity(self, models):
        prompts = _prompts([6, 10, 5, 8, 7], seed=14)

        def run(pkg):
            router, engines = _fleet(models, pkg, n=2, engine_kw=CHAOS)
            reqs = [router.submit(p, max_new_tokens=4) for p in prompts]
            with PACKAGES[pkg]["plan"](step_fault_scope="@replica-1",
                                       fail_step_at={1, 2}):
                done = router.run_until_complete()
            h = router.health()
            for eng in engines:
                assert eng._decode_step.retraces == 0
                eng.pool.check_leaks()     # the drain freed the KV
            router.revive("replica-1")
            after = router.health()["state"]
            return (router.placement_log_text(),
                    [done[r.request_id].finish_reason for r in reqs],
                    [done[r.request_id].output_ids().tolist()
                     for r in reqs],
                    router.stats()["router"],
                    {k: h[k] for k in ("state", "serving_replicas",
                                       "failed_replicas", "queue_depth",
                                       "pending_prefill_tokens")},
                    after)

        got = _both(run)
        assert got["torch"] == got["jax"]
        log, reasons, outs, stats, health, after = got["torch"]
        assert stats["replica_quarantines"] == 1
        assert stats["requests_resubmitted"] > 0
        assert "resubmit=1" in log
        assert reasons == ["length"] * len(prompts)
        single = _engine(models, "torch").generate(list(prompts),
                                                   max_new_tokens=4)
        assert outs == [o.tolist() for o in single]
        assert health["state"] == "degraded"
        assert (health["failed_replicas"], health["serving_replicas"]) \
            == (1, 1)
        assert after == "serving"

    def test_no_healthy_replica_retires_explicitly(self, models):
        prompts = _prompts([5, 7, 4], seed=15)

        def run(pkg):
            s = PACKAGES[pkg]["serving"]
            router, _ = _fleet(models, pkg, n=1, engine_kw=CHAOS)
            reqs = [router.submit(p, max_new_tokens=3) for p in prompts]
            with PACKAGES[pkg]["plan"](step_fault_scope="@replica-0",
                                       fail_step_at={1, 2}):
                done = router.run_until_complete()
            state = router.health()["state"]
            with pytest.raises(s.AdmissionError, match="revive") as err:
                router.submit(_prompts([4], seed=16)[0])
            router.revive()
            out = router.generate(_prompts([5], seed=17), max_new_tokens=2)
            return ([done[r.request_id].finish_reason for r in reqs],
                    [done[r.request_id].error for r in reqs], state,
                    str(err.value), [o.tolist() for o in out],
                    router.stats()["router"])

        got = _both(run)
        assert got["torch"] == got["jax"]
        reasons, errors, state, msg, out, _ = got["torch"]
        assert reasons == ["error"] * 3
        assert set(errors) == {"all replicas quarantined FAILED"}
        assert state == "failed" and len(out) == 1


# ---------------------------------------------------------------------------
# observation
# ---------------------------------------------------------------------------

class TestObservation:
    def test_stats_and_health_schema(self, models):
        def run(pkg):
            router, _ = _fleet(models, pkg, n=2)
            router.generate(_prompts([6, 9], seed=18), max_new_tokens=3)
            return router.stats(), router.health()

        got = _both(run)
        (st, h), (jst, jh) = got["torch"], got["jax"]
        assert st["router"] == jst["router"]
        r = st["router"]
        assert r["policy"] == "affinity" and r["seed"] == 0
        assert r["replicas"] == ["replica-0", "replica-1"]
        assert r["requests_submitted"] == 2
        assert sum(r["placements"].values()) == 2
        assert 0.0 <= r["cached_token_ratio"] <= 1.0
        assert 0.0 <= r["affinity_token_ratio"] <= 1.0
        assert set(st["replicas"]) == set(jst["replicas"])
        for name, rep in st["replicas"].items():
            # the reference's keys, and the port's compile accounting
            assert set(jst["replicas"][name]) <= set(rep)
            assert rep["prefix_index"] == jst["replicas"][name][
                "prefix_index"]
            assert rep["pending_prefill_tokens"] == 0
        assert set(h) == set(jh)
        for key in ("state", "serving_replicas", "failed_replicas",
                    "queue_depth", "pending_prefill_tokens"):
            assert h[key] == jh[key], key
        assert h["state"] == "serving"
        assert (h["serving_replicas"], h["failed_replicas"]) == (2, 0)
        assert set(h["replicas"]) == {"replica-0", "replica-1"}
        for name, rh in h["replicas"].items():
            assert set(rh) == set(jh["replicas"][name])

    def test_router_metrics_mirror(self, models):
        """``router_*`` in the observability registry, as the JAX
        router mirrors them."""
        from paddle_tpu.observability import registry as jax_registry
        from paddle_tpu_torch.observability import registry

        def run(pkg):
            reg_mod = registry if pkg == "torch" else jax_registry
            reg_mod.get_registry().clear()
            prev = reg_mod.enable()
            try:
                router, _ = _fleet(models, pkg, n=2)
                router.generate(_prompts([6, 9, 7], seed=30),
                                max_new_tokens=2)
                return {snap.name: (snap.kind, dict(snap.series))
                        for snap in reg_mod.collect()
                        if snap.name.startswith("router_")}
            finally:
                reg_mod.enable(prev)
                reg_mod.get_registry().clear()

        got = _both(run)
        assert got["torch"] == got["jax"]
        assert "router_placements_total" in got["torch"]


class TestEndpoint:
    def test_endpoint_accepts_router(self, models):
        prompts = _prompts([5, 8, 6], seed=19)

        def run(pkg):
            s = PACKAGES[pkg]["serving"]
            router, _ = _fleet(models, pkg, n=2)
            ep = s.Endpoint(router)
            outs = ep.run(prompts, max_new_tokens=4)
            health = ep.health()
            ep2 = PACKAGES[pkg]["endpoint"](_fleet(models, pkg, n=2)[0],
                                            max_new_tokens=2)
            return ([o.tolist() for o in outs],
                    ep.get_output_handle("output_0").copy_to_cpu().tolist(),
                    health["serving_replicas"], health["state"],
                    [o.tolist() for o in ep2.run(prompts[:1])])

        got = _both(run)
        assert got["torch"] == got["jax"]
        single = _engine(models, "torch").generate(list(prompts),
                                                   max_new_tokens=4)
        assert got["torch"][0] == [o.tolist() for o in single]
        assert got["torch"][2] == 2      # the fleet's health

    @pytest.mark.parametrize("what", ["router", "engine"])
    def test_endpoint_rejects_config_with_prebuilt(self, models, what):
        def run(pkg):
            s = PACKAGES[pkg]["serving"]
            built = _fleet(models, pkg, n=1)[0] if what == "router" \
                else _engine(models, pkg)
            msgs = []
            for make in (s.Endpoint, PACKAGES[pkg]["endpoint"]):
                with pytest.raises(ValueError,
                                   match="carries its config") as err:
                    make(built, s.ServingConfig())
                msgs.append(str(err.value))
            return msgs

        got = _both(run)
        assert got["torch"] == got["jax"]


# ---------------------------------------------------------------------------
# the mixed-dtype fleet (tests/test_quantized_serving.py TestMixedDtypeFleet)
# ---------------------------------------------------------------------------

def _mixed_config(pkg, **over):
    base = dict(max_batch_size=2, num_blocks=32, block_size=8,
                fused_kernels=False)
    base.update(over)
    return PACKAGES[pkg]["serving"].ServingConfig(**base)


class TestMixedDtypeFleet:
    def test_mixed_fleet_routes_and_matches_parity(self, models):
        prompts = _prompts([9, 9, 12], vocab=250, seed=3)

        def run(pkg):
            s = PACKAGES[pkg]["serving"]
            e_fp = s.Engine(models[pkg], _mixed_config(pkg, name="fp32"))
            e_q = s.Engine(models[pkg], _mixed_config(
                pkg, name="int8", kv_cache_dtype="int8"))
            router = s.Router([e_fp, e_q], seed=0)
            reqs = [router.submit(p, max_new_tokens=5) for p in prompts]
            done = router.run_until_complete()
            for e in (e_fp, e_q):
                e.pool.check_leaks()
            return ([done[r.request_id].generated for r in reqs],
                    router.placement_log_text(),
                    sorted(router._chain_hex(prompts[2])))

        got = _both(run)
        assert got["torch"] == got["jax"]
        assert got["torch"][2] == ["fp32:float32", "int8"]
        ref = torch_serving.Engine(models["torch"], _mixed_config("torch"))
        want = [o[len(p):].tolist() for o, p in zip(
            ref.generate(prompts, max_new_tokens=5), prompts)]
        assert got["torch"][0] == want

    def test_affinity_walk_uses_per_dtype_chain(self, models):
        prompt = _prompts([17], vocab=250, seed=4)[0]

        def run(pkg):
            s = PACKAGES[pkg]["serving"]
            e_q = s.Engine(models[pkg], _mixed_config(
                pkg, name="int8", kv_cache_dtype="int8"))
            router = s.Router([e_q], seed=0)
            router.submit(prompt, max_new_tokens=2)
            router.run_until_complete()
            chains = router._chain_hex(prompt)
            rep = router.replicas[0]
            return (chains, router._affinity_tokens(rep, prompt, chains),
                    router._affinity_tokens(
                        rep, prompt, {"fp32:float32": chains["int8"]}))

        got = _both(run)
        assert got["torch"] == got["jax"]
        chains, aff, foreign = got["torch"]
        assert set(chains) == {"int8"}
        assert aff > 0           # the int8 chain finds the registered prefix
        assert foreign == 0      # a foreign-dtype chain scores nothing


# ---------------------------------------------------------------------------
# hazards: the router and replay read the monotonic clock only (H111)
# ---------------------------------------------------------------------------

class TestRouterHazards:
    def test_h111_clean(self):
        from paddle_tpu.analysis import scan_wall_clock_deadlines

        root = os.path.dirname(torch_serving.__file__)
        diags = scan_wall_clock_deadlines(
            [os.path.join(root, "router.py"),
             os.path.join(root, "replay.py")])
        assert diags == [], diags
