"""Tied word embeddings (LlamaConfig.tie_word_embeddings) against the
JAX package, and the full training recipe on a tied model.

The JAX ``LlamaForCausalLM`` on ``LlamaConfig.tiny(tie_word_embeddings=
True)`` (f32) is built from a seed; its state dict, which has no
``lm_head.weight``, goes into the port through
``convert.from_jax_state_dict``.  The head is the embedding table: the
logits are ``hidden @ embed_tokens.weight.T`` and the fused loss reads
the table as vocab-major.  Tolerances (f32, the two frameworks sum in
different orders): the loss within LOSS_TOL, every
gradient (the embedding's, which sums the lookup's and the head's,
included) within GRAD_TOL of its largest JAX entry, the logits within
LOSS_TOL of their largest magnitude, the losses of 5
training steps within STEP_TOL, each step's learning rate exactly and
its global gradient norm within NORM_TOL relative.  Served greedy,
sampled and as a speculative draft, a tied model gives the JAX
engine's tokens exactly.  The random tied model's std-1 table makes its
logits large (its first loss near 40, not ln 256), as in the JAX model.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.clip as jclip
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.quantization.serving import \
    quantize_model_weights as jax_quantize_model_weights
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import SpeculativeConfig as JaxSpeculativeConfig
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.quantization import serving as tqs
from paddle_tpu_torch.serving import Engine, ServingConfig, SpeculativeConfig

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
NORM_TOL = 1e-5
CHUNK = 16
TIED = dict(tie_word_embeddings=True)
COUNTERS = ("requests_completed", "preemptions", "prefix_cache_hits",
            "prefill_chunks", "decode_iterations", "tokens_generated")


def _named(jax_model):
    return {k: np.asarray(v.numpy())
            for k, v in jax_model.state_dict().items()
            if not k.endswith(("weight_int8", "weight_scale"))}


def _pair(seed=0, **opts):
    paddle.seed(seed)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**opts))
    return jax_model, from_jax_state_dict(_named(jax_model),
                                          LlamaConfig.tiny(**opts),
                                          device="cpu")


def _close_logits(got, want):
    """Logits within LOSS_TOL of their largest magnitude (the tied
    head's logits reach 20 and more)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOSS_TOL * float(np.abs(want).max()))


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (2, 24)) \
        .astype(np.int32)


@pytest.mark.parametrize("fused", [False, True])
class TestTiedMatchesJax:
    def test_loss_logits_and_every_gradient(self, fused):
        opts = dict(TIED, fused_lm_loss=fused, lm_loss_chunk=CHUNK)
        jax_model, model = _pair(**opts)
        assert not hasattr(model, "lm_head")
        tokens = _tokens(1)
        x, xt = paddle.to_tensor(tokens), torch.from_numpy(tokens)
        jl, jlogits = jax_model(x, labels=x)
        jl.backward()
        loss, logits = model(xt, labels=xt)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl.numpy()),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        assert float(loss.detach()) > 10.0   # the tied head's large logits
        if fused:
            assert logits is None and jlogits is None
        else:
            _close_logits(logits.detach().numpy(), jlogits.numpy())
        want = {n: np.asarray(p.grad.numpy())
                for n, p in jax_model.named_parameters()}
        got = dict(model.named_parameters())
        assert set(got) == set(want)
        assert "lm_head.weight" not in got
        for name, w in want.items():
            err = float(np.abs(got[name].grad.numpy() - w).max())
            assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)

    def test_no_grad_logits(self, fused):
        jax_model, model = _pair(**TIED, fused_lm_loss=fused)
        tokens = _tokens(2)
        with torch.no_grad():
            logits = model(torch.from_numpy(tokens))
        want = jax_model(paddle.to_tensor(tokens))
        _close_logits(logits.numpy(), want.numpy())


class TestTiedHead:
    def test_embedding_gradient_sums_lookup_and_head(self):
        # the tied model's table gradient is an untied twin's embedding
        # gradient plus its head's, the head holding the table transposed
        tied = LlamaForCausalLM(LlamaConfig.tiny(**TIED), device="cpu",
                                seed=4)
        untied = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=4)
        state = dict(tied.state_dict())
        state["lm_head.weight"] = state["model.embed_tokens.weight"].t()
        untied.load_state_dict(state)
        xt = torch.from_numpy(_tokens(3))
        for m in (tied, untied):
            m(xt, labels=xt)[0].backward()
        emb = untied.model.embed_tokens.weight.grad
        want = emb + untied.lm_head.weight.grad.t()
        got = tied.model.embed_tokens.weight.grad
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        assert float((got - emb).abs().max()) > 1e-3

    def test_fused_loss_reads_a_view_of_the_table(self):
        # the head's f32 weight is a transposed view of the table's f32
        # copy: no [hidden, V] copy is made
        from paddle_tpu_torch.models import llama

        seen = []
        real = llama._F32Logits.apply

        def spy(h, w):
            seen.append(w)
            return real(h, w)

        model = LlamaForCausalLM(LlamaConfig.tiny(
            **TIED, fused_lm_loss=True, lm_loss_chunk=CHUNK), device="cpu")
        llama._F32Logits.apply = spy
        try:
            xt = torch.from_numpy(_tokens())
            model(xt, labels=xt)[0].backward()
        finally:
            llama._F32Logits.apply = real
        table = model.model.embed_tokens.weight
        assert len(seen) == 6           # 3 chunks, each recomputed
        for w in seen:
            assert tuple(w.shape) == (table.shape[1], table.shape[0])
            assert w.stride() == (1, table.shape[1])

    def test_random_init_draws_no_head(self):
        # the same seed gives a tied model the untied one's weights but
        # the head, which is drawn last
        tied = LlamaForCausalLM(LlamaConfig.tiny(**TIED), device="cpu",
                                seed=9)
        untied = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", seed=9)
        a, b = dict(tied.named_parameters()), dict(untied.named_parameters())
        assert set(b) - set(a) == {"lm_head.weight"}
        for name, p in a.items():
            assert torch.equal(p, b[name]), name


class TestConvert:
    def test_tied_state_dict_loads(self):
        jax_model, model = _pair(**TIED)
        named = _named(jax_model)
        assert "lm_head.weight" not in named
        assert torch.equal(model.model.embed_tokens.weight,
                           torch.from_numpy(
                               named["model.embed_tokens.weight"].copy()))

    def test_stray_lm_head_refused(self):
        jax_model, _ = _pair(**TIED)
        named = _named(jax_model)
        named["lm_head.weight"] = named["model.embed_tokens.weight"].T
        with pytest.raises(KeyError, match="lm_head.weight"):
            from_jax_state_dict(named, LlamaConfig.tiny(**TIED),
                                device="cpu")

    def test_untied_state_dict_refused_by_a_tied_config(self):
        paddle.seed(0)
        named = _named(JaxLlamaForCausalLM(JaxLlamaConfig.tiny()))
        with pytest.raises(KeyError, match="unexpected.*lm_head.weight"):
            from_jax_state_dict(named, LlamaConfig.tiny(**TIED),
                                device="cpu")


def _prompts():
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 256, size=20)
    return [np.concatenate([prefix, rng.randint(1, 256, size=5)]),
            rng.randint(1, 256, size=13), rng.randint(1, 256, size=3),
            rng.randint(1, 256, size=30),
            np.concatenate([prefix, rng.randint(1, 256, size=9)])]


def _serve(engine, kws):
    prompts = _prompts()
    reqs = [engine.submit(p, max_new_tokens=10, **kw)
            for p, kw in zip(prompts[:-1], kws)]
    while not reqs[0].generated:
        engine.step()
    reqs.append(engine.submit(prompts[-1], max_new_tokens=10, **kws[-1]))
    engine.run_until_complete()
    engine.pool.check_leaks()
    counters = engine.stats()["counters"]
    return ([[int(t) for t in r.generated] for r in reqs],
            {k: counters[k] for k in COUNTERS})


SAMPLED = [dict(temperature=0.8, top_k=16, top_p=0.95, seed=9), {},
           dict(temperature=1.0, seed=4), {}, dict(temperature=0.7, seed=3)]


class TestServing:
    @pytest.mark.parametrize("kws,num_blocks", [
        ([{}] * 5, 64), ([{}] * 5, 12), (SAMPLED, 64)],
        ids=["greedy", "greedy_preempted", "sampled"])
    def test_engine_tokens_match_jax(self, kws, num_blocks):
        jax_model, model = _pair(**TIED)
        jax_model.eval()
        out = []
        for m, engine_cls, config_cls in (
                (jax_model, JaxEngine, JaxServingConfig),
                (model, Engine, ServingConfig)):
            out.append(_serve(engine_cls(m, config_cls(
                max_batch_size=4, block_size=8, num_blocks=num_blocks,
                chunk_tokens=16, fused_kernels=True)), kws))
        assert out[1] == out[0]
        assert out[1][1]["requests_completed"] == 5

    def test_int8_weights_leave_the_table_in_full_precision(self):
        jax_model, model = _pair(**TIED)
        jax_model.eval()
        table = model.model.embed_tokens.weight.detach().clone()
        want = jax_quantize_model_weights(jax_model, "int8")
        got = tqs.quantize_model_weights(model, "int8")
        assert got == want
        assert got["layers"] == 7 * 2               # no head to quantize
        assert torch.equal(model.model.embed_tokens.weight, table)
        assert not hasattr(model.model.embed_tokens, "weight_int8")
        np.testing.assert_array_equal(
            table.numpy(),
            np.asarray(jax_model.model.embed_tokens.weight.numpy()))

    def test_int8_engine_tokens_match_jax(self):
        jax_model, model = _pair(**TIED)
        jax_model.eval()
        out = []
        for m, engine_cls, config_cls in (
                (jax_model, JaxEngine, JaxServingConfig),
                (model, Engine, ServingConfig)):
            out.append(_serve(engine_cls(m, config_cls(
                max_batch_size=4, block_size=8, num_blocks=64,
                chunk_tokens=16, fused_kernels=True,
                weight_dtype="int8")), [{}] * 5))
        assert out[1] == out[0]

    @pytest.mark.parametrize("kws", [[{}] * 5, SAMPLED],
                             ids=["greedy", "sampled"])
    def test_tied_speculative_draft_matches_jax(self, kws):
        # an untied target with a tied 1-layer draft, as Llama-3-8B with
        # Llama-3.2-3B
        jax_target, target = _pair()
        jax_draft, draft = _pair(seed=123, num_hidden_layers=1, **TIED)
        out = []
        for t, d, engine_cls, config_cls, spec_cls in (
                (jax_target, jax_draft, JaxEngine, JaxServingConfig,
                 JaxSpeculativeConfig),
                (target, draft, Engine, ServingConfig, SpeculativeConfig)):
            t.eval()
            d.eval()
            eng = engine_cls(t, config_cls(
                max_batch_size=4, block_size=4, num_blocks=96,
                fused_kernels=True,
                speculative=spec_cls(draft_model=d, num_draft_tokens=3)))
            toks, _ = _serve(eng, kws)
            c = eng.stats()["counters"]
            out.append((toks, c["spec_tokens_drafted"],
                        c["spec_tokens_accepted"]))
        assert out[1] == out[0]


class TestFullRecipe:
    """5 steps of the Llama recipe on the tied tiny model, in both
    packages: recomputation, the fused loss, AdamW (beta2 0.95, epsilon
    1e-5, weight decay 0.1) over WarmupCosine (2 warmup steps of 10,
    min_ratio 0.1) and a global-norm clip small enough to scale every
    step."""

    def test_five_steps_match_jax(self):
        opts = dict(TIED, recompute=True, fused_lm_loss=True,
                    lm_loss_chunk=CHUNK)
        jax_model, model = _pair(**opts)
        sched = dict(learning_rate=3e-3, warmup_steps=2, total_steps=10,
                     min_ratio=0.1)
        js, ts = jlr.WarmupCosine(**sched), tlr.WarmupCosine(**sched)
        jclipper = jclip.ClipGradByGlobalNorm(1.0)
        tclipper = tnn.ClipGradByGlobalNorm(1.0)
        recipe = dict(beta1=0.9, beta2=0.95, epsilon=1e-5, weight_decay=0.1)
        jopt = JaxAdamW(js, parameters=jax_model.parameters(),
                        grad_clip=jclipper, **recipe)
        opt = AdamW(ts, parameters=model.named_parameters(),
                    grad_clip=tclipper, **recipe)
        tokens = _tokens(4)
        x, xt = paddle.to_tensor(tokens), torch.from_numpy(tokens)
        jax_losses, losses, lrs = [], [], []
        for _ in range(5):
            jl, _ = jax_model(x, labels=x)
            jl.backward()
            pairs = [(p, p.grad) for p in jax_model.parameters()
                     if p.grad is not None]
            jnorm = float(np.asarray(jclipper._global_norm(pairs)._value))
            jopt.step()
            jopt.clear_grad()
            jax_losses.append(float(jl.numpy()))
            loss, _ = model(xt, labels=xt)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
            norm = float(tclipper.last_global_norm)
            assert abs(norm - jnorm) <= NORM_TOL * jnorm
            assert norm > 1.0                      # the clip scaled
            lrs.append((opt.get_lr(), jopt.get_lr()))
            js.step()
            ts.step()
        assert all(a == b for a, b in lrs)
        # warmup from 0, the peak at step 2, then the cosine decay
        assert [a for a, _ in lrs[:3]] == [0.0, 1.5e-3, 3e-3]
        assert 3e-3 > lrs[3][0] > lrs[4][0] > 3e-4
        np.testing.assert_allclose(losses, jax_losses, rtol=STEP_TOL,
                                   atol=STEP_TOL)
        assert losses[-1] < losses[0]
