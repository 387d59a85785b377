"""Speculative decoding of the port's serving slice
(paddle_tpu_torch/serving/speculative.py and the engine's spec path)
against the JAX package on the CPU.

The tiny f32 Llama of ``tests/test_spec_sampling.py`` (seed 0) and its
1-layer draft (seed 123), the JAX models' weights through numpy into
the port (``convert``), behind both packages' engines, the JAX one on
its fused steps.  Tolerances: tokens, committed tokens, accepted lengths
and every counter equal; the two draws acceptance adds equal to
``jax.random``'s (the uniform bit for bit, the categorical's token);
the steps' probabilities and logits within ``LOGIT_TOL`` (1e-4,
``tests/test_torch_serving.py``'s) and their pools within 1e-5.  The
replay of each speculative CUDA graph against its eager function is in
``tests/test_torch_cuda.py`` (``TestCudaSpecGraphSteps``), which runs
without JAX on the card.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.dispatch import no_grad_ctx
from paddle_tpu.core.tensor import Tensor as JaxTensor
from paddle_tpu.kernels.fusion import serving_fusion
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models.generation import generate as jax_generate
from paddle_tpu.models.llama import PagedKVCache as JaxPagedKVCache
from paddle_tpu.observability import registry as jax_registry
from paddle_tpu.resilience import FaultPlan as JaxFaultPlan
from paddle_tpu.serving import AdmissionError as JaxAdmissionError
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import SpeculativeConfig as JaxSpeculativeConfig
from paddle_tpu.serving import stream_events as jax_stream_events
from paddle_tpu.serving.sampling import filtered_probs as jax_filtered_probs
from paddle_tpu.serving.speculative import _spec_acceptance
from paddle_tpu.serving.speculative import \
    make_draft_propose_step as jax_propose_step
from paddle_tpu.serving.speculative import \
    make_spec_verify_step as jax_verify_step
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.generation import _paged_caches
from paddle_tpu_torch.observability import registry
from paddle_tpu_torch.resilience import FaultPlan
from paddle_tpu_torch.serving import (AdmissionError, Engine, ServingConfig,
                                      SpeculativeConfig, stream_events)
from paddle_tpu_torch.serving.sampling import (categorical, filtered_probs,
                                               prng_key, uniform)
from paddle_tpu_torch.serving.speculative import (make_draft_propose_step,
                                                  make_spec_verify_step,
                                                  spec_acceptance)
from torch_clock import virtual_clock

LOGIT_TOL = 1e-4
POOL_TOL = 1e-5
SAMPLED = dict(temperature=0.8, top_k=16, top_p=0.95)
# requests 0 and 2 sample (with filters and without), 1 and 3 are greedy
MIXED = [dict(SAMPLED, seed=9), {}, dict(temperature=1.0, seed=4), {}]


def _convert(jax_model, cfg):
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return from_jax_state_dict(named, cfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    """{"jax" | "torch": (target, 1-layer draft)}, the same weights."""
    paddle.seed(0)
    target = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    target.eval()
    paddle.seed(123)
    draft = JaxLlamaForCausalLM(dataclasses.replace(JaxLlamaConfig.tiny(),
                                                    num_hidden_layers=1))
    draft.eval()
    return {"jax": (target, draft),
            "torch": (_convert(target, LlamaConfig.tiny()),
                      _convert(draft, LlamaConfig.tiny(num_hidden_layers=1)))}


PACKAGES = {"jax": (JaxEngine, JaxServingConfig, JaxSpeculativeConfig),
            "torch": (Engine, ServingConfig, SpeculativeConfig)}


def _engine(models, pkg, draft="random", k=3, **kw):
    """An engine of ``pkg`` over the tiny target with the random draft
    or the target itself (``draft="self"``) proposing ``k`` tokens."""
    engine_cls, config_cls, spec_cls = PACKAGES[pkg]
    target, rand = models[pkg]
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("max_queue_len", 16)
    spec = spec_cls(draft_model=target if draft == "self" else rand,
                    num_draft_tokens=k)
    return engine_cls(target, config_cls(fused_kernels=True,
                                         speculative=spec, **kw))


def _prompts(lengths, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=(n,)).astype(np.int32)
            for n in lengths]


def _generate(models, prompt, **kw):
    """The JAX package's greedy ``generate()``: prompt + new tokens."""
    out = jax_generate(models["jax"][0], paddle.to_tensor(prompt[None, :]),
                       temperature=0.0, use_static_cache=True, **kw)
    return np.asarray(out.numpy())[0]


def _spec_counters(eng):
    c = eng.stats()["counters"]
    return (c["spec_tokens_drafted"], c["spec_tokens_accepted"],
            c["decode_iterations"], c["tokens_generated"],
            c["preemptions"], c["requests_completed"])


# ---------------------------------------------------------------------------
# the two draws acceptance adds, against jax.random
# ---------------------------------------------------------------------------

def _keys(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 2 ** 32, size=(n, 2), dtype=np.uint64) \
        .astype(np.uint32)


class TestDraws:
    def test_uniform_is_jax_bit_for_bit(self):
        keys = _keys(300, 0)
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(
            jnp.asarray(keys)))
        got = uniform(torch.from_numpy(keys.astype(np.int64)))
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)
        # any leading shape: [S, K, 2] keys give [S, K]
        got = uniform(torch.from_numpy(keys.astype(np.int64))
                      .reshape(30, 10, 2))
        np.testing.assert_array_equal(got.numpy(), want.reshape(30, 10))

    @pytest.mark.parametrize("V", [8, 256])
    def test_categorical_is_jax_token_for_token(self, V):
        """The bonus draw: ``categorical(key, log(dist + 1e-30))`` over
        distributions with zeros (a filtered or a residual row)."""
        keys = _keys(300, V)
        rng = np.random.RandomState(V)
        dist = rng.dirichlet(np.full(V, 0.3), size=300).astype(np.float32)
        dist[rng.rand(300, V) < 0.3] = 0.0
        dist[np.arange(300), rng.randint(0, V, 300)] += 0.1
        dist /= dist.sum(-1, keepdims=True)
        logits = np.log(dist + np.float32(1e-30))
        want = np.asarray(jax.vmap(jax.random.categorical)(
            jnp.asarray(keys), jnp.asarray(logits)))
        got = categorical(torch.from_numpy(keys.astype(np.int64)),
                          torch.log(torch.from_numpy(dist) + 1e-30))
        np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the acceptance rule
# ---------------------------------------------------------------------------

def _acceptance_args(lg, proposals, draft_probs, temps, seed=0,
                     top_ks=None, top_ps=None, counters=None):
    s = np.shape(proposals)[0]
    return dict(
        lg=np.asarray(lg, np.float32),
        proposals=np.asarray(proposals, np.int32),
        draft_probs=np.asarray(draft_probs, np.float32),
        temps=np.asarray(temps, np.float32),
        top_ks=np.zeros(s, np.int32) if top_ks is None else top_ks,
        top_ps=np.ones(s, np.float32) if top_ps is None else top_ps,
        keys=np.broadcast_to(prng_key(seed).astype(np.uint32), (s, 2)),
        counters=np.zeros(s, np.int32) if counters is None else counters)


_jax_acceptance = jax.jit(_spec_acceptance)


def _both_acceptances(a):
    """(port's, JAX's) (committed, accepted) of the same arguments."""
    port = spec_acceptance(*(torch.from_numpy(np.ascontiguousarray(
        a[n]).astype(np.int64 if n == "keys" else a[n].dtype))
        for n in a))
    ref = _jax_acceptance(*(jnp.asarray(a[n]) for n in a))
    return tuple(x.numpy() for x in port), tuple(np.asarray(x) for x in ref)


def _peaked_logits(argmaxes, v=8, hi=9.0):
    lg = np.zeros((len(argmaxes), v), np.float32)
    for i, a in enumerate(argmaxes):
        lg[i, a] = hi
    return lg


class TestAcceptanceRule:
    """The reference's four crafted cases (``tests/test_spec_sampling.py``
    ``TestAcceptanceRule``), each also equal to its ``_spec_acceptance``,
    then seeded random cases."""

    def test_greedy_boundaries_zero_partial_full(self):
        lg = np.stack([_peaked_logits([2, 5, 7, 6])] * 3)
        proposals = [[4, 5, 7], [2, 5, 1], [2, 5, 7]]
        a = _acceptance_args(lg, proposals, np.full((3, 3, 8), 1 / 8),
                             np.zeros(3))
        (committed, accepted), ref = _both_acceptances(a)
        assert accepted.tolist() == [1, 3, 4]
        assert committed.tolist() == [[2, 0, 0, 0], [2, 5, 7, 0],
                                      [2, 5, 7, 6]]
        np.testing.assert_array_equal(committed, ref[0])
        np.testing.assert_array_equal(accepted, ref[1])

    def test_greedy_commit_is_greedy_continuation(self):
        rng = np.random.RandomState(3)
        for _ in range(10):
            arg = rng.randint(0, 8, size=4)
            a = _acceptance_args(_peaked_logits(arg)[None],
                                 rng.randint(0, 8, size=(1, 3)),
                                 np.full((1, 3, 8), 1 / 8), np.zeros(1))
            (committed, accepted), ref = _both_acceptances(a)
            n = int(accepted[0])
            assert committed[0, :n].tolist() == arg[:n].tolist()
            np.testing.assert_array_equal(committed, ref[0])

    def test_stochastic_identical_dists_accept_all(self):
        lg = np.stack([_peaked_logits([1, 2, 3, 4], hi=2.0)] * 2)
        tp = filtered_probs(torch.from_numpy(lg.reshape(8, 8)),
                            torch.ones(8), torch.zeros(8, dtype=torch.int64),
                            torch.ones(8)).numpy().reshape(2, 4, 8)
        a = _acceptance_args(lg, [[1, 2, 3]] * 2, tp[:, :3], np.ones(2))
        (committed, accepted), ref = _both_acceptances(a)
        assert accepted.tolist() == [4, 4]
        np.testing.assert_array_equal(committed, ref[0])

    def test_stochastic_impossible_proposal_rejects_with_residual(self):
        lg = np.zeros((1, 4, 8), np.float32)
        lg[:, :, 2] = 9.0
        dp = np.zeros((1, 3, 8), np.float32)
        dp[:, :, 5] = 1.0
        a = _acceptance_args(lg, np.full((1, 3), 5), dp, np.ones(1))
        (committed, accepted), ref = _both_acceptances(a)
        assert accepted.tolist() == [1] and committed[0, 0] == 2
        np.testing.assert_array_equal(committed, ref[0])
        np.testing.assert_array_equal(accepted, ref[1])

    @pytest.mark.parametrize("k", [1, 3, 4])
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_random_lanes_equal_jax(self, k, seed):
        """Greedy and sampled lanes (temperature, top-k and top-p on and
        off) over logits whose draft is the target's own distribution
        perturbed, so accept lengths spread over 1..K+1; counters and
        keys random.  Committed tokens and accepted lengths equal."""
        rng = np.random.RandomState(seed)
        s, v = 16, 32
        lg = rng.randn(s, k + 1, v).astype(np.float32) * 2.0
        temps = np.where(np.arange(s) % 4 == 0, 0.0,
                         rng.uniform(0.5, 1.5, s)).astype(np.float32)
        top_ks = np.where(np.arange(s) % 3 == 1, 8, 0).astype(np.int32)
        top_ps = np.where(np.arange(s) % 5 == 2, 0.9, 1.0) \
            .astype(np.float32)
        tprobs = np.asarray(jax_filtered_probs(
            jnp.asarray(lg.reshape(-1, v)), jnp.repeat(temps, k + 1),
            jnp.repeat(top_ks, k + 1), jnp.repeat(top_ps, k + 1))) \
            .reshape(s, k + 1, v)
        noisy = tprobs[:, :k] * np.exp(rng.randn(s, k, v) * 0.5)
        dp = (noisy / noisy.sum(-1, keepdims=True)).astype(np.float32)
        # greedy lanes propose the argmax mostly, sampled lanes a draw
        props = np.where(rng.rand(s, k) < 0.8, lg[:, :k].argmax(-1),
                         rng.randint(0, v, (s, k)))
        for i in range(s):
            if temps[i] > 0:
                props[i] = [rng.choice(v, p=dp[i, j] / dp[i, j].sum())
                            for j in range(k)]
        a = _acceptance_args(lg, props, dp, temps, seed=seed,
                             top_ks=top_ks, top_ps=top_ps,
                             counters=rng.randint(0, 50, s).astype(np.int32))
        a["keys"] = _keys(s, 100 + seed)
        (committed, accepted), ref = _both_acceptances(a)
        np.testing.assert_array_equal(accepted, ref[1])
        np.testing.assert_array_equal(committed, ref[0])
        assert len(set(accepted.tolist())) > 1


# ---------------------------------------------------------------------------
# the two steps against the JAX package's on the same pools
# ---------------------------------------------------------------------------

S_STEP, BS, NBS = 4, 4, 8
LENGTHS = np.array([5, 9, 2, 13], np.int32)


def _step_inputs(n_layers, seed=0):
    """Pools of ``n_layers`` layers (random, block 0 too), block tables
    holding K+1 positions past each frontier, tokens and sampling state
    for 4 slots (greedy, top-k and top-p, temperature only, top-p)."""
    rng = np.random.RandomState(seed)
    kvh, d = 2, 16
    nb = 1 + S_STEP * NBS
    pools = [tuple(rng.randn(nb, BS, kvh, d).astype(np.float32) * 0.5
                   for _ in range(2)) for _ in range(n_layers)]
    bt = np.zeros((S_STEP, NBS), np.int32)
    perm = 1 + rng.permutation(nb - 1)
    for s in range(S_STEP):
        bt[s] = perm[s * NBS:(s + 1) * NBS]
    return dict(
        pools=pools, bt=bt, tok=rng.randint(1, 256, (S_STEP,)).astype(
            np.int32), temps=np.array([0.0, 0.8, 1.0, 0.6], np.float32),
        top_ks=np.array([0, 12, 0, 0], np.int32),
        top_ps=np.array([1.0, 0.9, 1.0, 0.95], np.float32),
        keys=np.stack([prng_key(s) for s in (0, 1000, 7, 2 ** 31 - 1)]),
        counters=np.array([3, 7, 1, 4], np.int32))


def _jax_pools(pools):
    return [tuple(jnp.asarray(x) for x in e) for e in pools]


def _torch_pools(pools):
    return [tuple(torch.from_numpy(x.copy()) for x in e) for e in pools]


def _state(x, pkg):
    names = ("temps", "top_ks", "top_ps", "keys", "counters")
    if pkg == "jax":
        return [jnp.asarray(x[n].astype(np.uint32) if n == "keys" else x[n])
                for n in names]
    return [torch.from_numpy(x[n].astype(np.int64) if n in
                             ("keys", "top_ks", "counters") else x[n])
            for n in names]


def _assert_pools_close(got, want):
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       rtol=POOL_TOL, atol=POOL_TOL)


class TestStepsMatchJax:
    @pytest.mark.parametrize("k", [1, 3])
    def test_propose(self, models, k):
        x = _step_inputs(1)
        jprops, jprobs, jpools = jax_propose_step(
            models["jax"][1], k, fused=True)(
            jnp.asarray(x["tok"][:, None]), _jax_pools(x["pools"]),
            jnp.asarray(x["bt"]), jnp.asarray(LENGTHS), *_state(x, "jax"))
        pools = _torch_pools(x["pools"])
        props, probs = make_draft_propose_step(models["torch"][1], k)(
            x["tok"][:, None], pools, x["bt"], LENGTHS, *_state(x, "torch"))
        assert props.shape == (S_STEP, k) and probs.shape == (S_STEP, k, 256)
        np.testing.assert_array_equal(props.numpy(), np.asarray(jprops))
        np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        # the draft's KV at lengths .. lengths + K: K+1 passes
        _assert_pools_close(pools, jpools)
        written = [int(b) for s in range(S_STEP)
                   for b in {x["bt"][s, (LENGTHS[s] + i) // BS]
                             for i in range(k + 1)}]
        assert all(not np.array_equal(pools[0][0][b].numpy(),
                                      x["pools"][0][0][b])
                   for b in written)

    @pytest.mark.parametrize("draft", ["random", "self"])
    def test_verify(self, models, draft):
        """The verify over the draft's proposals (rejected mostly) and
        over the target's own (accepted at every greedy lane), from the
        same proposals and probabilities: committed tokens and accepted
        lengths equal, the verify's logits and the pools close."""
        k = 3
        x = _step_inputs(2, seed=1)
        d = 0 if draft == "self" else 1
        dpools = x["pools"] if draft == "self" else _step_inputs(1)["pools"]
        props, probs, _ = jax_propose_step(models["jax"][d], k, fused=True)(
            jnp.asarray(x["tok"][:, None]), _jax_pools(dpools),
            jnp.asarray(x["bt"]), jnp.asarray(LENGTHS), *_state(x, "jax"))
        props, probs = np.asarray(props), np.asarray(probs)
        jc, ja, jpools = jax_verify_step(models["jax"][0], k, fused=True)(
            jnp.asarray(x["tok"]), jnp.asarray(props), jnp.asarray(probs),
            _jax_pools(x["pools"]), jnp.asarray(x["bt"]),
            jnp.asarray(LENGTHS), *_state(x, "jax"))
        pools = _torch_pools(x["pools"])
        committed, accepted = make_spec_verify_step(models["torch"][0], k)(
            x["tok"], torch.from_numpy(props.astype(np.int64)),
            torch.from_numpy(probs.copy()), pools, x["bt"], LENGTHS,
            *_state(x, "torch"))
        np.testing.assert_array_equal(accepted.numpy(), np.asarray(ja))
        np.testing.assert_array_equal(committed.numpy(), np.asarray(jc))
        _assert_pools_close(pools, jpools)
        if draft == "self":
            assert accepted[0] == k + 1     # the greedy lane
        else:
            assert (accepted < k + 1).any()
        # the target's logits at the K+1 positions, on the input pools
        ids = np.concatenate([x["tok"][:, None], props], 1).astype(np.int32)
        with no_grad_ctx(), serving_fusion(True):
            want, _ = models["jax"][0](
                JaxTensor(jnp.asarray(ids)), caches=[
                    JaxPagedKVCache(kk, vv, jnp.asarray(x["bt"]))
                    for kk, vv in _jax_pools(x["pools"])],
                position_offset=jnp.asarray(LENGTHS))
        with torch.inference_mode():
            got = models["torch"][0](
                torch.from_numpy(ids).long(), _paged_caches(
                    _torch_pools(x["pools"]), torch.from_numpy(x["bt"]),
                    None), torch.from_numpy(LENGTHS),
                write_mask=torch.ones(ids.shape, dtype=torch.bool))
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)


# ---------------------------------------------------------------------------
# the engine against the JAX engine (TestSpeculativeParity's cases)
# ---------------------------------------------------------------------------

class TestSpeculativeEngineMatchesJax:
    def test_random_draft_greedy(self, models):
        prompts = _prompts([3, 7, 5, 11, 4, 6])
        out, counters = {}, {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg)
            out[pkg] = eng.generate(prompts, max_new_tokens=9)
            counters[pkg] = _spec_counters(eng)
            eng.pool.check_leaks()
        plain = Engine(models["torch"][0], ServingConfig(
            max_batch_size=4, block_size=4, num_blocks=64)).generate(
            prompts, max_new_tokens=9)
        for got, want, pl in zip(out["torch"], out["jax"], plain):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, pl)
        # generate() (a static cache compiled per prompt length) on two
        for i in (0, 3):
            np.testing.assert_array_equal(
                out["torch"][i], _generate(models, prompts[i],
                                           max_new_tokens=9))
        assert counters["torch"] == counters["jax"]
        drafted, accepted = counters["torch"][:2]
        assert 0 < drafted and accepted < drafted

    def test_self_draft_accepts_every_proposal(self, models):
        prompts = _prompts([3, 6, 9])
        rates = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, draft="self", k=4)
            outs = eng.generate(prompts, max_new_tokens=10)
            rates[pkg] = eng.metrics.spec_accept_rate()
            for p, got in zip(prompts, outs):
                np.testing.assert_array_equal(
                    got, _generate(models, p, max_new_tokens=10))
        assert rates["torch"] == rates["jax"] == 1.0

    @pytest.mark.parametrize("draft", ["random", "self"])
    def test_eos_in_mid_commit(self, models, draft):
        """With self-draft a verify commits K+1 tokens, so the eos (the
        request's third token) lands inside a commit: the tokens after
        it are dropped."""
        p = _prompts([5])[0]
        eos = int(_generate(models, p, max_new_tokens=8)[5 + 2])
        want = _generate(models, p, max_new_tokens=8, eos_token_id=eos)
        got = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, draft=draft)
            req = eng.submit(p, max_new_tokens=8, eos_token_id=eos)
            eng.run_until_complete()
            eng.pool.check_leaks()
            got[pkg] = (req.finish_reason, list(req.output_ids()),
                        _spec_counters(eng))
        assert got["torch"] == got["jax"]
        assert got["torch"][0] == "eos"
        assert got["torch"][1] == want.tolist()

    def test_preemption_keeps_parity(self, models):
        prompts = _prompts([4, 4], seed=7)
        got = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, max_batch_size=2, num_blocks=8)
            reqs = [eng.submit(p, max_new_tokens=10) for p in prompts]
            eng.run_until_complete()
            eng.pool.check_leaks()
            got[pkg] = ([r.output_ids().tolist() for r in reqs],
                        _spec_counters(eng))
        assert got["torch"] == got["jax"]
        assert got["torch"][1][4] >= 1                   # preemptions
        for p, out in zip(prompts, got["torch"][0]):
            assert out == _generate(models, p, max_new_tokens=10).tolist()

    @pytest.mark.parametrize("draft", ["random", "self"])
    def test_rejected_drafts_leak_no_blocks(self, models, draft):
        eng = _engine(models, "torch", draft=draft)
        freed = []
        rollback = eng._rollback_blocks

        def spy(req):
            n = len(req.blocks)
            rollback(req)
            freed.append(n - len(req.blocks))

        eng._rollback_blocks = spy
        eng.generate(_prompts([3, 7, 5, 11, 4]), max_new_tokens=7)
        eng.pool.check_leaks()
        assert eng.pool.num_free == eng.pool.capacity_blocks
        # the random draft's rejections leave blocks past the frontier
        assert (sum(freed) > 0) == (draft == "random")

    def test_zero_retraces_after_warmup(self, models):
        eng = _engine(models, "torch")
        eng.generate(_prompts([3, 5]), max_new_tokens=5)
        warm = eng.spec_cache_sizes()
        assert warm == {"draft_prefill": 1, "draft_propose": 1,
                        "spec_verify": 1}
        eng.generate(_prompts([9, 2, 7], seed=3), max_new_tokens=8)
        assert eng.spec_cache_sizes() == warm
        for step in (eng._draft_prefill_step, eng._draft_propose_step,
                     eng._spec_verify_step):
            assert step.retraces == 0
        # the plain decode steps never run under speculation
        assert eng.decode_cache_size() == 0
        assert eng.sampled_decode_cache_size() == 0
        labels = set(eng.stats()["compiles"])
        assert {"serving::draft_prefill_step", "serving::draft_propose_step",
                "serving::spec_verify_step"} <= labels
        assert _engine(models, "torch").spec_cache_sizes() == {
            "draft_prefill": 0, "draft_propose": 0, "spec_verify": 0}
        assert Engine(models["torch"][0], ServingConfig(
            num_blocks=8)).spec_cache_sizes() == {}

    @pytest.mark.parametrize("draft", ["random", "self"])
    def test_sampled_speculation_equals_jax(self, models, draft):
        """Mixed greedy and sampled lanes: the port's tokens are the JAX
        engine's, and a second run of the port repeats them."""
        prompts = _prompts([5, 8, 3, 6], seed=2)
        got = {}
        for pkg in PACKAGES:
            runs = []
            for _ in range(2 if pkg == "torch" else 1):
                eng = _engine(models, pkg, draft=draft)
                reqs = [eng.submit(p, max_new_tokens=8, **kw)
                        for p, kw in zip(prompts, MIXED)]
                eng.run_until_complete()
                eng.pool.check_leaks()
                runs.append(([r.generated for r in reqs],
                             _spec_counters(eng)))
            got[pkg] = runs
        assert got["torch"][0] == got["torch"][1] == got["jax"][0]
        greedy = _engine(models, "torch", draft=draft).generate(
            [prompts[1]], max_new_tokens=8)[0]
        assert got["torch"][0][0][1] == greedy[8:].tolist()

    def test_config_errors(self, models):
        target = models["torch"][0]
        other = _convert(JaxLlamaForCausalLM(dataclasses.replace(
            JaxLlamaConfig.tiny(), num_key_value_heads=1,
            num_attention_heads=1)), LlamaConfig.tiny(
            num_key_value_heads=1, num_attention_heads=1))
        with pytest.raises(ValueError, match="cache layout"):
            Engine(target, ServingConfig(speculative=SpeculativeConfig(
                other)))
        vocab = _convert(JaxLlamaForCausalLM(dataclasses.replace(
            JaxLlamaConfig.tiny(), vocab_size=128)),
            LlamaConfig.tiny(vocab_size=128))
        with pytest.raises(ValueError, match="shared tokenizer"):
            Engine(target, ServingConfig(speculative=vocab))
        short = _convert(models["jax"][1], LlamaConfig.tiny(
            num_hidden_layers=1, max_position_embeddings=64))
        with pytest.raises(ValueError, match="max_position_embeddings"):
            Engine(target, ServingConfig(speculative=short))
        Engine(target, ServingConfig(speculative=short, max_model_len=64))
        with pytest.raises(ValueError, match="speculative"):
            Engine(target, ServingConfig(
                kv_cache_dtype="int8", speculative=SpeculativeConfig(
                    models["torch"][1], num_draft_tokens=2)))
        with pytest.raises(ValueError, match="num_draft_tokens"):
            SpeculativeConfig(models["torch"][1], num_draft_tokens=0)

    def test_admission_limit_leaves_room_for_the_drafts(self, models):
        """``max_model_len - K``: the deepest draft write stays inside
        the model's positions, in both packages."""
        out = {}
        for pkg, refused in (("jax", JaxAdmissionError),
                             ("torch", AdmissionError)):
            eng = _engine(models, pkg, k=3, max_model_len=32)
            ok = eng.submit(np.arange(1, 21), max_new_tokens=9)
            with pytest.raises(refused, match=r"max_model_len \(29\)"):
                eng.submit(np.arange(1, 21), max_new_tokens=10)
            eng.run_until_complete()
            out[pkg] = (ok.output_ids().tolist(),
                        eng.stats()["counters"]["requests_rejected"])
        assert out["torch"] == out["jax"]
        assert len(out["torch"][0]) == 29 and out["torch"][1] == 1

    def test_bare_draft_model_is_wrapped_with_four_tokens(self, models):
        eng = Engine(models["torch"][0], ServingConfig(
            speculative=models["torch"][1], block_size=4, num_blocks=64))
        assert isinstance(eng.spec, SpeculativeConfig)
        assert eng.spec.num_draft_tokens == 4
        assert eng.spec.draft_model is models["torch"][1]
        # one pool of the target's 2 layers, then the draft's 1
        assert len(eng.pool.layers) == 3
        assert len(eng._target_pools()) == 2 and len(eng._draft_pools()) == 1

    def test_kv_pool_bytes_sized_over_both_models(self, models):
        per_layer_block = 2 * 4 * 2 * 16 * 4      # k and v, f32
        budget = 20 * 3 * per_layer_block
        nums = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, kv_pool_bytes=budget)
            nums[pkg] = (eng.num_blocks,
                         eng.stats()["pool"]["block_bytes"])
        assert nums["torch"] == nums["jax"] == (20, 3 * per_layer_block)


class TestSpeculativeStreamingAndMetrics:
    def test_on_token_fires_per_accepted_token(self, models):
        """Several tokens an iteration under self-draft, in order, the
        JAX engine's."""
        p = _prompts([5])[0]
        got = {}
        for pkg in PACKAGES:
            eng = _engine(models, pkg, draft="self")
            seen, per_step = [], []
            req = eng.submit(p, max_new_tokens=9, on_token=seen.append)
            while eng.step():
                per_step.append(len(seen))
            eng.run_until_complete()
            assert seen == req.generated
            got[pkg] = (seen, per_step)
        assert got["torch"] == got["jax"]
        # the first step's prefill token, then up to K = 3 drafts and the
        # bonus a verify
        steps = np.diff([0] + got["torch"][1])
        assert steps[0] == 5 and steps.max() == 5

    @pytest.mark.parametrize("kw", [{}, dict(SAMPLED, seed=3)])
    def test_stream_events_equal_jax(self, models, kw):
        p = _prompts([6], seed=4)[0]
        events = [list(fn(_engine(models, pkg, draft="self"), p,
                          max_new_tokens=7, **kw))
                  for fn, pkg in ((jax_stream_events, "jax"),
                                  (stream_events, "torch"))]
        assert events[1] == events[0]
        assert [e["index"] for e in events[1][:-1]] == list(range(7))

    def test_metrics_registry_equals_jax(self, models):
        """The same serving_* metrics (counters, the accepted-per-step
        histogram's counts, the accept-rate gauge) by name and value."""
        out = {}
        for pkg, reg_mod in (("jax", jax_registry), ("torch", registry)):
            reg_mod.get_registry().clear()
            prev = reg_mod.enable()
            try:
                eng = _engine(models, pkg)
                eng.generate(_prompts([3, 7, 5]), max_new_tokens=6)
                eng.generate(_prompts([4], seed=1), max_new_tokens=6,
                             **SAMPLED, seed=5)
                eng2 = _engine(models, pkg, draft="self")
                eng2.generate(_prompts([6], seed=2), max_new_tokens=9)
            finally:
                reg_mod.enable(prev)
            snaps = {}
            for snap in reg_mod.collect():
                if snap.name.startswith("serving_") and "seconds" not in \
                        snap.name:
                    snaps[snap.name] = (snap.kind, {
                        k: (v["count"], v["sum"]) if snap.kind == "histogram"
                        else v for k, v in snap.series.items()})
            out[pkg] = (snaps, eng.stats()["counters"],
                        eng.stats()["gauges"]["spec_accept_rate"])
        assert out["torch"][0] == out["jax"][0]
        for name in ("serving_accepted_per_step",
                     "serving_spec_tokens_drafted_total",
                     "serving_spec_tokens_accepted_total",
                     "serving_spec_accept_rate"):
            assert name in out["torch"][0], name
        for key in ("spec_tokens_drafted", "spec_tokens_accepted"):
            assert out["torch"][1][key] == out["jax"][1][key]
        assert out["torch"][2] == out["jax"][2]


class TestSpeculativeWatchdog:
    WATCHED = dict(watchdog_floor_s=0.25, watchdog_budget_mult=50.0,
                   step_max_retries=1, health_recovery_steps=2)

    def test_verify_stall_retried(self, models, monkeypatch):
        """A verify attempt delayed past its budget on the virtual clock
        (``tests/torch_clock.py``): one stall, one retry of the verify on
        the same inputs, the JAX engine's tokens and counters.  Attempts
        1 and 2 are the prefill and the draft's prefill, 3 and 4 the
        first propose and verify (their compiles), 6 the second
        verify."""
        virtual_clock(monkeypatch)
        p = _prompts([4], seed=7)[0]
        out = {}
        for pkg, plan_cls in (("jax", JaxFaultPlan), ("torch", FaultPlan)):
            eng = _engine(models, pkg, **self.WATCHED)
            req = eng.submit(p, max_new_tokens=8)
            with plan_cls(step_delay_s={6: 0.6}) as plan:
                eng.run_until_complete()
            c = eng.stats()["counters"]
            out[pkg] = (req.generated, req.finish_reason, plan.injected,
                        c["watchdog_stalls"], c["step_retries"],
                        _spec_counters(eng))
        assert out["torch"] == out["jax"]
        assert out["torch"][2] == [("serving_delay", 6,
                                    "serving::spec_verify_step")]
        assert out["torch"][3:5] == (1, 1)
        assert out["torch"][0] == _generate(
            models, p, max_new_tokens=8)[4:].tolist()
