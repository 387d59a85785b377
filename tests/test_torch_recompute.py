"""Per-layer recomputation (LlamaConfig.recompute and
paddle_tpu_torch.distributed.recompute) against the JAX package.

The JAX ``LlamaForCausalLM`` on ``LlamaConfig.tiny(recompute=True)``
(f32, dense, and MoE at the dropless capacity factor 2.0) is built from
a seed and its weights go into the port through
``convert.from_jax_state_dict``; on the CPU the JAX model runs its XLA
paths under ``jax.checkpoint`` and the port its plain versions under
``torch.utils.checkpoint``.  Tolerances (f32, the two frameworks sum in
different orders): the loss within LOSS_TOL, every gradient within
GRAD_TOL of its largest JAX entry, the losses of 5 AdamW steps within
STEP_TOL.  Against itself the port is exact: its gradients with
recomputation equal those without, bit for bit, as do the gradients
through a dropout drawing from an explicit generator.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.distributed import (RecomputeWrapper, recompute,
                                          recompute_sequential)
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.nn import Dropout
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.optimizer import AdamW

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
KINDS = {"dense": {}, "moe": MOE,
         "dense_fused": dict(fused_lm_loss=True, lm_loss_chunk=16)}


def _pair(**opts):
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**opts))
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return jax_model, from_jax_state_dict(named, LlamaConfig.tiny(**opts),
                                          device="cpu")


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (2, 24)) \
        .astype(np.int32)


def _grads(model):
    return {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("kind", sorted(KINDS))
class TestRecomputeMatchesJax:
    def test_loss_and_every_gradient(self, kind):
        jax_model, model = _pair(recompute=True, **KINDS[kind])
        tokens = _tokens(1)
        x = paddle.to_tensor(tokens)
        jl, _ = jax_model(x, labels=x)
        jl.backward()
        xt = torch.from_numpy(tokens)
        loss, _ = model(xt, labels=xt)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(jl.numpy()),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        want = {n: np.asarray(p.grad.numpy())
                for n, p in jax_model.named_parameters()}
        got = dict(model.named_parameters())
        assert set(got) == set(want)
        for name, w in want.items():
            err = float(np.abs(got[name].grad.numpy() - w).max())
            assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)

    def test_gradients_equal_without_recompute_bit_for_bit(self, kind):
        xt = torch.from_numpy(_tokens(2))
        out = []
        for rc in (False, True):
            model = LlamaForCausalLM(LlamaConfig.tiny(recompute=rc,
                                                      **KINDS[kind]),
                                     device="cpu", seed=5)
            loss, _ = model(xt, labels=xt)
            loss.backward()
            out.append((loss.detach(), _grads(model)))
        assert torch.equal(out[0][0], out[1][0])
        assert out[0][1].keys() == out[1][1].keys()
        for name, g in out[0][1].items():
            assert torch.equal(g, out[1][1][name]), name

    def test_five_adamw_steps(self, kind):
        jax_model, model = _pair(recompute=True, **KINDS[kind])
        jopt = JaxAdamW(1e-3, parameters=jax_model.parameters())
        opt = AdamW(1e-3, parameters=model.named_parameters())
        tokens = _tokens(3)
        x, xt = paddle.to_tensor(tokens), torch.from_numpy(tokens)
        jax_losses, losses = [], []
        for _ in range(5):
            jl, _ = jax_model(x, labels=x)
            jl.backward()
            jopt.step()
            jopt.clear_grad()
            jax_losses.append(float(jl.numpy()))
            loss, _ = model(xt, labels=xt)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        np.testing.assert_allclose(losses, jax_losses, rtol=STEP_TOL,
                                   atol=STEP_TOL)
        assert losses[-1] < losses[0]


class TestWhereRecomputeRuns:
    """Only the no-cache forward with grad on recomputes: an eval forward
    without grad and every serving step run the layers as they are."""

    def _spy(self, monkeypatch):
        calls = []

        def spy(fn, *args, **kwargs):
            calls.append(fn)
            return recompute(fn, *args, **kwargs)

        monkeypatch.setattr(tllama, "recompute", spy)
        return calls

    def test_training_forward_recomputes_every_layer(self, monkeypatch):
        calls = self._spy(monkeypatch)
        model = LlamaForCausalLM(LlamaConfig.tiny(recompute=True),
                                 device="cpu", seed=0)
        xt = torch.from_numpy(_tokens())
        model(xt, labels=xt)[0].backward()
        assert calls == list(model.model.layers)

    def test_no_grad_forward_does_not(self, monkeypatch):
        calls = self._spy(monkeypatch)
        models = [LlamaForCausalLM(LlamaConfig.tiny(recompute=rc),
                                   device="cpu", seed=0)
                  for rc in (False, True)]
        xt = torch.from_numpy(_tokens())
        with torch.no_grad():
            logits = [m(xt) for m in models]
            losses = [m(xt, labels=xt)[0] for m in models]
        assert calls == []
        assert torch.equal(logits[0], logits[1])
        assert torch.equal(losses[0], losses[1])

    def test_serving_does_not(self, monkeypatch):
        from paddle_tpu_torch.serving import Engine, ServingConfig

        calls = self._spy(monkeypatch)
        prompts = [np.arange(1, 12), np.arange(40, 45)]
        got = []
        for rc in (False, True):
            model = LlamaForCausalLM(LlamaConfig.tiny(recompute=rc),
                                     device="cpu", seed=0)
            eng = Engine(model, ServingConfig(num_blocks=16, block_size=8,
                                              chunk_tokens=8))
            reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
            eng.run_until_complete()
            got.append([r.generated for r in reqs])
        assert calls == [] and got[0] == got[1]


class TestRecomputeFunction:
    def _net(self, seed=0):
        g = torch.Generator().manual_seed(seed)
        return torch.nn.Sequential(*(torch.nn.Linear(8, 8) for _ in
                                     range(4))), g

    def test_explicit_generator_replays_its_masks(self):
        # a dropout drawing from an explicit generator: under recompute
        # the replay draws the forward's masks (gradients bit-equal to a
        # run without recomputation) and leaves the generator where that
        # run leaves it
        torch.manual_seed(0)
        lin = torch.nn.Linear(8, 8)
        gen = torch.Generator().manual_seed(3)
        x0 = torch.randn(4, 8)

        def f(x):
            h = TF.dropout(lin(x), 0.5, True, gen)
            return TF.dropout(h.tanh(), 0.3, True, gen) * 2.0

        start = gen.get_state()
        out = []
        for fn in (f, lambda x: recompute(f, x)):
            gen.set_state(start)
            x = x0.clone().requires_grad_()
            lin.zero_grad()
            y = fn(x)
            y.square().sum().backward()
            out.append((y.detach(), x.grad, lin.weight.grad.clone(),
                        gen.get_state()))
        for a, b in zip(*out):
            assert torch.equal(a, b)

    def test_dropout_module_under_recompute_wrapper(self):
        gen = torch.Generator().manual_seed(11)
        drop = Dropout(0.4, generator=gen)
        lin = torch.nn.Linear(6, 6)

        def block(x):
            return drop(lin(x)).relu()

        x0 = torch.randn(3, 6)
        start = gen.get_state()
        grads = []
        for fn in (block, RecomputeWrapper(block)):
            gen.set_state(start)
            lin.zero_grad()
            x = x0.clone().requires_grad_()
            fn(x).sum().backward()
            grads.append((x.grad, lin.bias.grad.clone()))
        assert torch.equal(grads[0][0], grads[1][0])
        assert torch.equal(grads[0][1], grads[1][1])

    def test_without_preserve_rng_state_the_replay_draws_anew(self):
        # the documented opt-out: the generators are not restored, so the
        # replay's masks are the generator's next ones
        lin = torch.nn.Linear(8, 8)
        gen = torch.Generator().manual_seed(3)
        x0 = torch.randn(16, 8)

        def f(x):
            return TF.dropout(lin(x), 0.5, True, gen)

        start = gen.get_state()
        grads = []
        for kw in ({}, {"preserve_rng_state": False}):
            gen.set_state(start)
            x = x0.clone().requires_grad_()
            recompute(f, x, **kw).sum().backward()
            grads.append(x.grad)
        assert not torch.equal(grads[0], grads[1])

    @pytest.mark.parametrize("segments", [1, 2, 3, 4])
    def test_sequential_segments(self, segments):
        net, _ = self._net()
        x0 = torch.randn(5, 8)
        out = []
        for run in (lambda x: net(x),
                    lambda x: recompute_sequential({"segments": segments},
                                                   net, x)):
            net.zero_grad()
            x = x0.clone().requires_grad_()
            y = run(x)
            y.pow(3).sum().backward()
            out.append((y.detach(), x.grad,
                        [p.grad.clone() for p in net.parameters()]))
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1], out[1][1])
        for a, b in zip(out[0][2], out[1][2]):
            assert torch.equal(a, b)

    def test_sequential_without_ctx_and_kwargs(self):
        net, _ = self._net(1)
        x = torch.randn(2, 8, requires_grad=True)
        y = recompute_sequential(net, x)
        assert torch.equal(y, net(x))

        def scaled(x, scale=1.0):
            return x * scale

        z = recompute(scaled, x, scale=3.0)
        z.sum().backward()
        assert torch.equal(x.grad, torch.full_like(x, 3.0))
