"""The port's serving slice (paddle_tpu_torch.serving.Engine over
paddle_tpu_torch.models.LlamaForCausalLM) against the JAX package.

The JAX ``LlamaForCausalLM`` on ``LlamaConfig.tiny()`` (f32) is built
from a seed; its ``state_dict()`` goes through numpy into the port with
``convert.from_jax_state_dict``.  The JAX engine runs its fused steps
(``ServingConfig(fused_kernels=True)``: the XLA versions of the Pallas
kernels on the CPU), the port its plain PyTorch versions.  Greedy tokens
must be identical, the scheduling counters equal and the pools free of
leaks; one prefill chunk's and one decode step's logits agree within
1e-4 (f32, the two frameworks sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models.generation import (
    make_chunked_prefill_step as jax_make_chunked_prefill_step)
from paddle_tpu.models.generation import (
    make_paged_decode_step as jax_make_paged_decode_step)
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.generation import (make_chunked_prefill_step,
                                                make_paged_decode_step)
from paddle_tpu_torch.serving import Engine, ServingConfig

LOGIT_TOL = 1e-4
COUNTERS = ("requests_completed", "preemptions", "prefix_cache_hits",
            "prefix_cache_misses", "prefill_chunks", "decode_iterations",
            "tokens_generated")


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


def _serve(engine, prompts, **submit_kwargs):
    """Submit all but the last prompt, step until the first has its
    first token (its prompt blocks are registered then), submit the last
    (which shares the first one's prefix) and drain."""
    reqs = [engine.submit(p, **submit_kwargs) for p in prompts[:-1]]
    while not reqs[0].generated:
        engine.step()
    reqs.append(engine.submit(prompts[-1], **submit_kwargs))
    engine.run_until_complete()
    engine.pool.check_leaks()
    counters = engine.stats()["counters"]
    return ([[int(t) for t in r.generated] for r in reqs],
            [r.finish_reason for r in reqs],
            {k: counters[k] for k in COUNTERS})


def _both(models, prompts, num_blocks, prefix_cache=True, **submit_kwargs):
    out = []
    for model, engine_cls, config_cls in (
            (models[0], JaxEngine, JaxServingConfig),
            (models[1], Engine, ServingConfig)):
        engine = engine_cls(model, config_cls(
            max_batch_size=4, block_size=8, num_blocks=num_blocks,
            chunk_tokens=16, enable_prefix_cache=prefix_cache,
            fused_kernels=True))
        out.append(_serve(engine, prompts, **submit_kwargs))
    return out


class TestEngineMatchesJax:
    @pytest.mark.parametrize("prefix_cache", [True, False])
    @pytest.mark.parametrize("num_blocks", [64, 12])
    def test_greedy_tokens(self, models, prefix_cache, num_blocks):
        # 64 blocks: no pressure; 12: the pool runs dry mid-decode and
        # the youngest requests are preempted and recomputed
        jax_out, torch_out = _both(models, _prompts(), num_blocks,
                                   prefix_cache, max_new_tokens=12)
        assert torch_out == jax_out
        counters = torch_out[2]
        assert counters["requests_completed"] == 5
        assert (counters["preemptions"] > 0) == (num_blocks == 12)
        assert (counters["prefix_cache_hits"] > 0) == prefix_cache

    def test_eos_and_stop_sequences(self, models):
        prompts = _prompts()
        (tokens, _, _), _ = _both(models, prompts, 64, max_new_tokens=12)
        # an eos that request 0 emits third; a stop pair that request 1
        # emits at its tokens 4..5
        eos = tokens[0][2]
        stop = tokens[1][4:6]
        jax_out, torch_out = _both(models, prompts, 64, max_new_tokens=12,
                                   eos_token_id=eos, stop_sequences=[stop])
        assert torch_out == jax_out
        generated, reasons, _ = torch_out
        assert reasons[0] == "eos" and generated[0][-1] == eos
        assert len(generated[0]) <= 3
        assert "stop" in reasons and generated[1][-2:] in (stop, [eos])

    def test_generate(self, models):
        prompts = _prompts()[:3]
        outs = []
        for model, engine_cls, config_cls in (
                (models[0], JaxEngine, JaxServingConfig),
                (models[1], Engine, ServingConfig)):
            engine = engine_cls(model, config_cls(
                max_batch_size=2, block_size=8, num_blocks=32,
                chunk_tokens=8, fused_kernels=True))
            outs.append(engine.generate(prompts, max_new_tokens=5))
        for got, want, prompt in zip(outs[1], outs[0], prompts):
            np.testing.assert_array_equal(got, want)
            assert len(got) == len(prompt) + 5


class TestStepsMatchJax:
    def test_prefill_chunk_and_decode_logits(self, models):
        """One padded prefill chunk, then one decode step over a bucket
        with an idle slot (block 0, frontier 0): logits within 1e-4 and
        the pools written alike."""
        jax_model, model = models
        cfg = model.config
        nb, bs, C = 16, 8, 16
        nbs = cfg.max_position_embeddings // bs
        shape = (nb, bs, cfg.num_key_value_heads, cfg.head_dim)
        rng = np.random.RandomState(7)
        pools0 = [(rng.randn(*shape).astype(np.float32),
                   rng.randn(*shape).astype(np.float32))
                  for _ in range(cfg.num_hidden_layers)]
        jpools = [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools0]
        tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                  for k, v in pools0]
        prompt = rng.randint(1, 256, size=11).astype(np.int32)
        ids = np.zeros((1, C), np.int32)
        ids[0, :11] = prompt
        bt = np.zeros((2, nbs), np.int32)
        bt[0, :2] = [3, 5]
        start = np.array([0], np.int32)

        jlast, jpools = jax_make_chunked_prefill_step(jax_model, fused=True)(
            jnp.asarray(ids), jpools, jnp.asarray(bt[:1]),
            jnp.asarray(start), jnp.int32(10))
        tlast = make_chunked_prefill_step(model)(
            torch.from_numpy(ids), tpools, torch.from_numpy(bt[:1]),
            torch.from_numpy(start), 10)
        np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        self._pools_close(tpools, jpools)

        tok = np.array([[int(np.argmax(np.asarray(jlast)[0]))], [0]],
                       np.int32)
        lengths = np.array([11, 0], np.int32)
        jlog, jpools = jax_make_paged_decode_step(jax_model, fused=True)(
            jnp.asarray(tok), jpools, jnp.asarray(bt), jnp.asarray(lengths))
        tlog = make_paged_decode_step(model)(
            torch.from_numpy(tok), tpools, torch.from_numpy(bt),
            torch.from_numpy(lengths))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        self._pools_close(tpools, jpools)

    @staticmethod
    def _pools_close(tpools, jpools):
        for (tk, tv), (jk, jv) in zip(tpools, jpools):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       rtol=1e-5, atol=1e-5)


class TestConvert:
    def test_missing_and_misshapen_names_raise(self, models):
        named = {k: v.numpy() for k, v in models[1].named_parameters()}
        cfg = LlamaConfig.tiny()
        lost = dict(named)
        lost.pop("lm_head.weight")
        with pytest.raises(KeyError, match="lm_head.weight"):
            from_jax_state_dict(lost, cfg, device="cpu")
        bad = dict(named)
        bad["model.norm.weight"] = np.ones(3, np.float32)
        with pytest.raises(ValueError, match="model.norm.weight"):
            from_jax_state_dict(bad, cfg, device="cpu")

    def test_linear_weights_keep_the_in_out_layout(self, models):
        q = models[1].model.layers[0].self_attn.q_proj.weight
        jq = models[0].state_dict()["model.layers.0.self_attn.q_proj.weight"]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq.numpy()))
