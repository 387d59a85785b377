"""The port's mixture-of-experts slice (``kernels/moe_dispatch`` and
``LlamaMoEMLP``) against the JAX package, on the CPU.

- ``dispatch_plain`` / ``combine_plain`` against the JAX ``moe_dispatch``
  / ``moe_combine`` with ``interpret=True``, so the Pallas kernel bodies
  run (without it, off the TPU, the JAX package takes its XLA formulas):
  random routing with slots up to C + 1 (dropped choices), slots named by
  several choices, slots nobody names, and the clamped zero-weight form
  the backward passes use.  Bit-identical for unique slots of weight 1;
  otherwise 1e-6 in f32 and one bf16 ulp of each output in bf16 (the
  f32 sums run in another order);
- the autograd pair's gradients against ``jax.grad`` through the
  interpret-mode pair, within 1e-5;
- ``LlamaMoEMLP`` against the JAX layer with converted weights, at a
  dropping and a dropless capacity, within 1e-5;
- the tiny MoE ``LlamaForCausalLM``: no-cache loss, every gradient and 5
  AdamW steps against the JAX model (1e-5 / 1e-4), a padded prefill chunk
  and a decode step with an idle slot (1e-4), and the ``Engine``'s greedy
  tokens and counters against the JAX ``Engine`` at the dropless factor
  2.0 (E / K), with the prefix cache on and off, forced preemption,
  int8 and fp8 KV pools and int8 weights.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import moe_dispatch as jmoe
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models.generation import (
    make_chunked_prefill_step as jax_make_chunked_prefill_step)
from paddle_tpu.models.generation import (
    make_paged_decode_step as jax_make_paged_decode_step)
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.kernels import moe_dispatch as tmoe
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models.generation import (make_chunked_prefill_step,
                                                make_paged_decode_step)
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, ServingConfig
from torch_operands import moe_routing

F32_TOL = 1e-6          # the plain kernels against the Pallas kernels
TOL = 1e-5              # layers, losses and gradients
STEP_TOL = 1e-4         # losses after AdamW steps; serving logits
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
T, M, E, C, K = 64, 128, 4, 16, 2
COUNTERS = ("requests_completed", "preemptions", "prefix_cache_hits",
            "prefix_cache_misses", "prefill_chunks", "decode_iterations",
            "tokens_generated")


DTYPES = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}


def t(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def as_np(x):
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.detach().numpy()


def routing(case, seed=0):
    return moe_routing(case, T, E, C, K, seed)


def ulp_close(got, want):
    """Each bf16 output within one ulp of the reference's."""
    g, w = (np.asarray(x, np.float32) for x in (got, want))
    mag = np.maximum(np.abs(g), np.abs(w))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(np.abs(g - w) <= ulp)


def hold(got, want, dtype, exact):
    if exact:
        np.testing.assert_array_equal(np.asarray(got, np.float32),
                                      np.asarray(want, np.float32))
    elif dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
    else:
        ulp_close(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["random", "unique", "clamped"])
class TestPlainMatchesPallas:
    def _inputs(self, dtype):
        rng = np.random.RandomState(1)
        tok = rng.randn(T, M).astype(np.float32).astype(DTYPES[dtype])
        eo = rng.randn(E, C, M).astype(np.float32).astype(DTYPES[dtype])
        return tok, eo

    def test_dispatch(self, case, dtype):
        tok, _ = self._inputs(dtype)
        eidx, sidx, w = routing(case)
        want = jmoe.moe_dispatch(jnp.asarray(tok), jnp.asarray(eidx),
                                 jnp.asarray(sidx), jnp.asarray(w), E, C,
                                 jmoe.DEFAULT_BT, jmoe.DEFAULT_BC, True)
        got = tmoe.dispatch_plain(t(tok), t(eidx), t(sidx), t(w), E, C)
        hold(as_np(got), np.asarray(want), dtype, case == "unique")
        if case == "random":        # a slot nobody names is exactly zero
            named = np.zeros((E, C), bool)
            keep = sidx < C
            named[eidx[keep], sidx[keep]] = True
            assert (~named).any()
            assert not np.asarray(got.float())[~named].any()

    def test_combine(self, case, dtype):
        _, eo = self._inputs(dtype)
        eidx, sidx, w = routing(case)
        want = jmoe.moe_combine(jnp.asarray(eo), jnp.asarray(eidx),
                                jnp.asarray(sidx), jnp.asarray(w),
                                jmoe.DEFAULT_BT, jmoe.DEFAULT_BC, True)
        got = tmoe.combine_plain(t(eo), t(eidx), t(sidx), t(w))
        hold(as_np(got), np.asarray(want), dtype, case == "unique")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_sums_several_choices_in_ascending_order(dtype):
    """Slots named by up to 5 choices of nonzero weight: the plain
    dispatch (which the card's kernel is held to bit for bit) is the f32
    sum from 0 in ascending (t, k) order, each product and sum rounded
    once, then one rounding to the tokens' dtype; and it agrees with the
    JAX kernel in interpret mode as the other random cases do."""
    rng = np.random.RandomState(11)
    tok = rng.randn(T, M).astype(np.float32).astype(DTYPES[dtype])
    eidx = rng.randint(0, 2, (T, K)).astype(np.int32)   # 2 of the 4 experts
    sidx = rng.randint(0, 3, (T, K)).astype(np.int32)   # 3 of the C slots
    w = (rng.rand(T, K) + 0.25).astype(np.float32)
    got = tmoe.dispatch_plain(t(tok), t(eidx), t(sidx), t(w), E, C)
    want = np.zeros((E, C, M), np.float32)
    for i in range(T * K):
        e, c = eidx.flat[i], sidx.flat[i]
        want[e, c] += np.float32(w.flat[i]) * tok[i // K].astype(np.float32)
    assert np.bincount(eidx.reshape(-1) * C + sidx.reshape(-1)).max() >= 5
    np.testing.assert_array_equal(
        np.asarray(as_np(got), np.float32),
        np.asarray(want.astype(DTYPES[dtype]), np.float32))
    jax_out = jmoe.moe_dispatch(jnp.asarray(tok), jnp.asarray(eidx),
                                jnp.asarray(sidx), jnp.asarray(w), E, C,
                                jmoe.DEFAULT_BT, jmoe.DEFAULT_BC, True)
    hold(as_np(got), np.asarray(jax_out), dtype, False)


class TestAutograd:
    def test_gradients_match_jax_grad(self):
        """loss = sum(combine(dispatch(tok, wd) * Q, wc) * R): gradients
        of tok, wd and wc through the interpret-mode Pallas pair."""
        rng = np.random.RandomState(2)
        tok = rng.randn(T, M).astype(np.float32)
        q = rng.randn(E, C, M).astype(np.float32)
        r = rng.randn(T, M).astype(np.float32)
        eidx, sidx, wc = routing("random", seed=3)
        wd = rng.rand(T, K).astype(np.float32) + 0.5

        def jax_loss(tok_, wd_, wc_):
            d = jmoe.moe_dispatch(tok_, eidx, sidx, wd_, E, C,
                                  jmoe.DEFAULT_BT, jmoe.DEFAULT_BC, True)
            out = jmoe.moe_combine(d * q, eidx, sidx, wc_, jmoe.DEFAULT_BT,
                                   jmoe.DEFAULT_BC, True)
            return jnp.sum(out * r)

        want = jax.grad(jax_loss, argnums=(0, 1, 2))(
            jnp.asarray(tok), jnp.asarray(wd), jnp.asarray(wc))
        args = [t(x).requires_grad_() for x in (tok, wd, wc)]
        d = tmoe.moe_dispatch(args[0], t(eidx), t(sidx), args[1], E, C)
        out = tmoe.moe_combine(d * t(q), t(eidx), t(sidx), args[2])
        (out * t(r)).sum().backward()
        for a, w in zip(args, want):
            w = np.asarray(w)
            np.testing.assert_allclose(a.grad.numpy(), w, rtol=TOL,
                                       atol=TOL * np.abs(w).max())

    def test_token_gradient_without_weight_gradient(self):
        # weights that need no gradient (the model's dispatch weights):
        # d tokens of sum(dispatch) counts each token's kept choices
        tok = t(np.random.RandomState(4).randn(T, M).astype(np.float32))
        eidx, sidx, w = routing("unique")
        tok.requires_grad_()
        tmoe.moe_dispatch(tok, t(eidx), t(sidx), t(w), E, C).sum().backward()
        kept = (sidx < C).sum(1).astype(np.float32)
        np.testing.assert_array_equal(tok.grad.numpy(),
                                      np.repeat(kept[:, None], M, 1))

    def test_capacity_matches_jax(self):
        for n, e, k, cf in ((8, 8, 2, 4.0), (256, 8, 2, 4.0), (24, 4, 2, 1.0),
                            (1, 8, 2, 1.0), (100, 3, 1, 1.25)):
            assert tmoe.moe_capacity(n, e, k, cf) == \
                jmoe.moe_capacity(n, e, k, cf)


# --------------------------------------------------------------- models
def _jax_model(**opts):
    paddle.seed(0)
    m = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**{**MOE, **opts}))
    m.eval()
    return m


def _port_model(jax_model, **opts):
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()
             if not k.endswith(("weight_int8", "weight_scale"))}
    return from_jax_state_dict(named, LlamaConfig.tiny(**{**MOE, **opts}),
                               device="cpu")


@pytest.fixture(scope="module")
def models():
    jax_model = _jax_model()
    return jax_model, _port_model(jax_model)


class TestLayer:
    @pytest.mark.parametrize("cf", [1.0, 2.0])
    def test_moe_mlp_matches_jax(self, cf):
        jax_model = _jax_model(moe_capacity_factor=cf)
        model = _port_model(jax_model, moe_capacity_factor=cf)
        x = np.random.RandomState(5).randn(2, 32, 64).astype(np.float32)
        mlp = model.model.layers[0].mlp
        want = np.asarray(jax_model.model.layers[0].mlp(
            paddle.to_tensor(x)).numpy())
        with torch.no_grad():
            got = mlp(t(x)).numpy()
            eidx, sidx, _ = mlp.route(t(x))
        C_ = tmoe.moe_capacity(64, 4, 2, cf)
        assert bool((sidx >= C_).any()) == (cf == 1.0)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    def test_weights_and_names_convert(self, models):
        jax_model, model = models
        layer = model.model.layers[1].mlp
        state = jax_model.state_dict()
        for name, p in (("router.weight", layer.router.weight),
                        ("w_gate", layer.w_gate), ("w_up", layer.w_up),
                        ("w_down", layer.w_down)):
            np.testing.assert_array_equal(p.detach().numpy(), np.asarray(
                state[f"model.layers.1.mlp.{name}"].numpy()))
        assert tuple(layer.w_gate.shape) == (4, 64, 128)
        assert tuple(layer.w_down.shape) == (4, 128, 64)

    def test_random_init_from_seed(self):
        a = LlamaForCausalLM(LlamaConfig.tiny(**MOE), device="cpu", seed=7)
        b = LlamaForCausalLM(LlamaConfig.tiny(**MOE), device="cpu", seed=7)
        mlp = a.model.layers[0].mlp
        assert torch.equal(mlp.w_down, b.model.layers[0].mlp.w_down)
        assert abs(float(mlp.w_gate.std()) - 64 ** -0.5) < 0.01
        assert abs(float(mlp.w_down.std()) - 128 ** -0.5) < 0.01

    def test_ties_go_to_the_lower_expert(self):
        model = LlamaForCausalLM(LlamaConfig.tiny(**MOE), device="cpu")
        mlp = model.model.layers[0].mlp
        with torch.no_grad():
            mlp.router.weight.zero_()       # every expert ties
            eidx, sidx, gate = mlp.route(torch.ones(1, 3, 64))
        assert eidx.tolist() == [[0, 1]] * 3
        assert sidx.tolist() == [[0, 0], [1, 1], [2, 2]]
        assert torch.equal(gate, torch.full((3, 2), 0.5))


class TestTrainingMatchesJax:
    def test_loss_gradients_and_adamw_steps(self):
        jax_model = _jax_model()
        model = _port_model(jax_model)
        tokens = np.random.RandomState(0).randint(0, 256, (2, 24)) \
            .astype(np.int32)
        x, xt = paddle.to_tensor(tokens), torch.from_numpy(tokens)
        jopt = JaxAdamW(1e-3, parameters=jax_model.parameters())
        opt = AdamW(1e-3, parameters=model.named_parameters())
        jax_losses, losses = [], []
        for step in range(5):
            jl, jlogits = jax_model(x, labels=x)
            jl.backward()
            loss, logits = model(xt, labels=xt)
            loss.backward()
            if step == 0:
                np.testing.assert_allclose(
                    logits.detach().numpy(), np.asarray(jlogits.numpy()),
                    rtol=TOL, atol=TOL)
                np.testing.assert_allclose(float(loss.detach()),
                                           float(jl.numpy()), rtol=TOL,
                                           atol=TOL)
                want = {n: np.asarray(p.grad.numpy())
                        for n, p in jax_model.named_parameters()}
                got = dict(model.named_parameters())
                assert set(got) == set(want)
                for name, w in want.items():
                    err = float(np.abs(got[name].grad.numpy() - w).max())
                    assert err <= TOL * float(np.abs(w).max()), (name, err)
            jopt.step()
            jopt.clear_grad()
            opt.step()
            opt.clear_grad()
            jax_losses.append(float(jl.numpy()))
            losses.append(float(loss.detach()))
        np.testing.assert_allclose(losses, jax_losses, rtol=STEP_TOL,
                                   atol=STEP_TOL)
        assert losses[-1] < losses[0]


class TestStepsMatchJax:
    def test_prefill_chunk_and_decode_logits(self, models):
        """One padded prefill chunk (its tail routes too), then one decode
        step over a bucket with an idle slot: logits within 1e-4."""
        jax_model, model = models
        cfg = model.config
        nb, bs, C_ = 16, 8, 16
        nbs = cfg.max_position_embeddings // bs
        shape = (nb, bs, cfg.num_key_value_heads, cfg.head_dim)
        rng = np.random.RandomState(7)
        pools0 = [(rng.randn(*shape).astype(np.float32),
                   rng.randn(*shape).astype(np.float32))
                  for _ in range(cfg.num_hidden_layers)]
        jpools = [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools0]
        tpools = [(t(k), t(v)) for k, v in pools0]
        ids = np.zeros((1, C_), np.int32)
        ids[0, :11] = rng.randint(1, 256, size=11)
        bt = np.zeros((2, nbs), np.int32)
        bt[0, :2] = [3, 5]
        start = np.array([0], np.int32)
        jlast, jpools = jax_make_chunked_prefill_step(jax_model, fused=True)(
            jnp.asarray(ids), jpools, jnp.asarray(bt[:1]),
            jnp.asarray(start), jnp.int32(10))
        tlast = make_chunked_prefill_step(model)(
            t(ids), tpools, t(bt[:1]), t(start), 10)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   rtol=STEP_TOL, atol=STEP_TOL)
        tok = np.array([[int(np.argmax(np.asarray(jlast)[0]))], [0]],
                       np.int32)
        lengths = np.array([11, 0], np.int32)
        jlog, _ = jax_make_paged_decode_step(jax_model, fused=True)(
            jnp.asarray(tok), jpools, jnp.asarray(bt), jnp.asarray(lengths))
        tlog = make_paged_decode_step(model)(t(tok), tpools, t(bt),
                                             t(lengths))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=STEP_TOL, atol=STEP_TOL)


def _prompts():
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 256, size=20)
    return [np.concatenate([prefix, rng.randint(1, 256, size=5)]),
            rng.randint(1, 256, size=13), rng.randint(1, 256, size=3),
            rng.randint(1, 256, size=30),
            np.concatenate([prefix, rng.randint(1, 256, size=9)])]


def _serve(engine, prompts):
    """The last prompt shares the first's prefix and is submitted once
    that prefix is registered."""
    reqs = [engine.submit(p, max_new_tokens=10) for p in prompts[:-1]]
    while not reqs[0].generated:
        engine.step()
    reqs.append(engine.submit(prompts[-1], max_new_tokens=10))
    engine.run_until_complete()
    engine.pool.check_leaks()
    counters = engine.stats()["counters"]
    return ([[int(x) for x in r.generated] for r in reqs],
            {k: counters[k] for k in COUNTERS})


class TestEngineMatchesJax:
    @pytest.mark.parametrize("config", [
        dict(num_blocks=64), dict(num_blocks=64, enable_prefix_cache=False),
        dict(num_blocks=12), dict(num_blocks=12, kv_cache_dtype="int8"),
        dict(num_blocks=64, kv_cache_dtype="fp8"),
        dict(num_blocks=64, weight_dtype="int8")],
        ids=["prefix-cache", "no-prefix-cache", "preemption", "int8-kv",
             "fp8-kv", "int8-weights"])
    def test_greedy_tokens(self, models, config):
        if "weight_dtype" in config:          # quantized in place
            jax_model = _jax_model()
            models = (jax_model, _port_model(jax_model))
        out = []
        for m, engine_cls, config_cls in ((models[0], JaxEngine,
                                           JaxServingConfig),
                                          (models[1], Engine, ServingConfig)):
            engine = engine_cls(m, config_cls(
                max_batch_size=4, block_size=8, chunk_tokens=16,
                fused_kernels=True, **config))
            out.append(_serve(engine, _prompts()))
        (jtok, jctr), (tok, ctr) = out
        assert tok == jtok and ctr == jctr
        assert ctr["requests_completed"] == 5
        assert (ctr["preemptions"] > 0) == (config["num_blocks"] == 12)
        assert (ctr["prefix_cache_hits"] > 0) == \
            config.get("enable_prefix_cache", True)
        if "weight_dtype" in config:          # the router, not the stacks
            mlp = models[1].model.layers[0].mlp
            assert mlp.router.weight_int8.shape == (64, 4)
            assert not hasattr(mlp, "weight_int8")
