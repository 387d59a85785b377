"""head_dim 256 (Gemma-2B's and Gemma-7B's width), on the CPU: the port's
``Engine`` against the JAX ``Engine``, and three training steps against
the JAX model, on a tiny f32 Llama of hidden 512 with 2 query heads over
1 kv head (head_dim 256) served from pages of 12 tokens.

On the card this shape takes the general paged decode, the general
chunked prefill, the attention forward and dQ on their wgmma instances
of 256 columns and dK/dV on its general one (``chip_smoke.py`` phases 2c
and 4c, ``tests/test_torch_cuda.py::TestCudaGeneral`` and
``TestCudaWgmmaHeadDims``); here the wrappers run their plain
versions.  Tolerances: greedy tokens and scheduling counters
identical; the loss within 1e-5, every gradient within 1e-5 of its
largest JAX entry, and the losses of 3 AdamW steps within 1e-4, as
``tests/test_torch_training.py`` states them (f32, the two frameworks
sum in different orders).
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.serving import Engine, ServingConfig

# hidden 512 over 2 q heads: head_dim 256, GQA rep 2
D256 = dict(hidden_size=512, num_attention_heads=2, num_key_value_heads=1)
LOSS_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-5, 1e-4
COUNTERS = ("requests_completed", "preemptions", "prefix_cache_hits",
            "prefix_cache_misses", "prefill_chunks", "decode_iterations",
            "tokens_generated")


def _models(**opts):
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**D256, **opts))
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return jax_model, from_jax_state_dict(
        named, LlamaConfig.tiny(**D256, **opts), device="cpu")


def _prompts():
    rng = np.random.RandomState(1)
    prefix = rng.randint(1, 256, size=26)
    return [np.concatenate([prefix, rng.randint(1, 256, size=5)]),
            rng.randint(1, 256, size=13), rng.randint(1, 256, size=3),
            rng.randint(1, 256, size=30),
            np.concatenate([prefix, rng.randint(1, 256, size=9)])]


def _serve(engine, prompts):
    """The last prompt shares the first's 26-token prefix (two pages of
    12) and is submitted once that prefix is registered."""
    reqs = [engine.submit(p, max_new_tokens=10) for p in prompts[:-1]]
    while not reqs[0].generated:
        engine.step()
    reqs.append(engine.submit(prompts[-1], max_new_tokens=10))
    engine.run_until_complete()
    engine.pool.check_leaks()
    counters = engine.stats()["counters"]
    return ([[int(x) for x in r.generated] for r in reqs],
            {k: counters[k] for k in COUNTERS})


@pytest.mark.parametrize("config", [dict(num_blocks=48),
                                    dict(num_blocks=6)],
                         ids=["prefix-cache", "preemption"])
def test_engine_matches_jax(config):
    jax_model, model = _models()
    jax_model.eval()
    out = [_serve(cls(m, cfg_cls(max_batch_size=4, block_size=12,
                                 chunk_tokens=16, fused_kernels=True,
                                 **config)), _prompts())
           for m, cls, cfg_cls in ((jax_model, JaxEngine, JaxServingConfig),
                                   (model, Engine, ServingConfig))]
    (jtok, jctr), (tok, ctr) = out
    assert tok == jtok and ctr == jctr
    assert ctr["requests_completed"] == 5
    assert (ctr["preemptions"] > 0) == (config["num_blocks"] == 6)
    assert ctr["prefix_cache_hits"] > 0


def test_three_training_steps_match_jax():
    # the loss and every gradient of the first step, then 3 AdamW steps,
    # with the fused chunked loss
    jax_model, model = _models(fused_lm_loss=True, lm_loss_chunk=16)
    tokens = np.random.RandomState(2).randint(0, 256, (2, 24)) \
        .astype(np.int32)
    jopt = JaxAdamW(1e-3, parameters=jax_model.parameters())
    opt = AdamW(1e-3, parameters=model.named_parameters())
    jax_losses, losses = [], []
    for step in range(3):
        x = paddle.to_tensor(tokens)
        jl, _ = jax_model(x, labels=x)
        jl.backward()
        t = torch.from_numpy(tokens)
        loss, _ = model(t, labels=t)
        loss.backward()
        if step == 0:
            np.testing.assert_allclose(float(loss.detach()),
                                       float(jl.numpy()), rtol=LOSS_TOL,
                                       atol=LOSS_TOL)
            want = {n: np.asarray(p.grad.numpy())
                    for n, p in jax_model.named_parameters()}
            got = dict(model.named_parameters())
            assert set(got) == set(want)
            for name, w in want.items():
                err = float(np.abs(got[name].grad.numpy() - w).max())
                assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)
        jopt.step()
        jopt.clear_grad()
        opt.step()
        opt.clear_grad()
        jax_losses.append(float(jl.numpy()))
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, jax_losses, rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert losses[-1] < losses[0]
