"""The port's training slice (paddle_tpu_torch's no-cache LlamaForCausalLM
forward and backward, and AdamW) against the JAX package.

The JAX ``LlamaForCausalLM`` on ``LlamaConfig.tiny()`` (f32) is built
from a seed; its ``state_dict()`` goes through numpy into the port with
``convert.from_jax_state_dict``.  On the CPU the JAX model runs its XLA
paths (``apply_rope``, ``_attn_reference``, the XLA RMSNorm) and the
port its plain PyTorch versions of the kernels.  Tolerances (f32, the
two frameworks sum in different orders): the loss within 1e-5, every
parameter's gradient within 1e-5 of its largest JAX entry, and the
losses of 5 AdamW steps within 1e-4.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.optimizer import AdamW

LOSS_TOL = 1e-5
GRAD_TOL = 1e-5
STEP_TOL = 1e-4
# fused_lm_loss with a chunk that splits the 2 x 23 predicted tokens into
# 3 chunks of 16, the last one padded
CHUNK = 16


def _pair(fused):
    paddle.seed(0)
    opts = dict(fused_lm_loss=fused, lm_loss_chunk=CHUNK)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**opts))
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return jax_model, from_jax_state_dict(named, LlamaConfig.tiny(**opts),
                                          device="cpu")


def _tokens(seed=0):
    return np.random.RandomState(seed).randint(0, 256, (2, 24)) \
        .astype(np.int32)


def _jax_loss(model, tokens):
    x = paddle.to_tensor(tokens)
    loss, logits = model(x, labels=x)
    return loss, logits


def _torch_loss(model, tokens):
    x = torch.from_numpy(tokens)
    return model(x, labels=x)


@pytest.mark.parametrize("fused", [False, True])
class TestTrainingMatchesJax:
    def test_loss(self, fused):
        jax_model, model = _pair(fused)
        jl, jlogits = _jax_loss(jax_model, _tokens())
        loss, logits = _torch_loss(model, _tokens())
        np.testing.assert_allclose(float(loss.detach()), float(jl.numpy()),
                                   rtol=LOSS_TOL, atol=LOSS_TOL)
        if fused:
            assert logits is None and jlogits is None
        else:
            np.testing.assert_allclose(logits.detach().numpy(),
                                       np.asarray(jlogits.numpy()),
                                       rtol=LOSS_TOL, atol=LOSS_TOL)

    def test_every_gradient(self, fused):
        jax_model, model = _pair(fused)
        jl, _ = _jax_loss(jax_model, _tokens(1))
        jl.backward()
        loss, _ = _torch_loss(model, _tokens(1))
        loss.backward()
        want = {n: np.asarray(p.grad.numpy())
                for n, p in jax_model.named_parameters()}
        got = dict(model.named_parameters())
        assert set(got) == set(want)
        for name, w in want.items():
            g = got[name].grad
            assert g is not None, name
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_TOL * float(np.abs(w).max()), (name, err)

    def test_five_adamw_steps(self, fused):
        jax_model, model = _pair(fused)
        jopt = JaxAdamW(1e-3, parameters=jax_model.parameters())
        opt = AdamW(1e-3, parameters=model.named_parameters())
        tokens = _tokens(2)
        jax_losses, losses = [], []
        for _ in range(5):
            jl, _ = _jax_loss(jax_model, tokens)
            jl.backward()
            jopt.step()
            jopt.clear_grad()
            jax_losses.append(float(jl.numpy()))
            loss, _ = _torch_loss(model, tokens)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        np.testing.assert_allclose(losses, jax_losses, rtol=STEP_TOL,
                                   atol=STEP_TOL)
        assert losses[-1] < losses[0]


class TestTrainingPath:
    def test_serving_forward_unchanged_by_training_options(self):
        # the no-cache logits equal the chunked-prefill logits of the
        # same tokens through a fresh pool
        from paddle_tpu_torch.models.generation import \
            make_chunked_prefill_step
        from paddle_tpu_torch.serving.cache import BlockKVPool

        cfg = LlamaConfig.tiny(fused_lm_loss=True)
        model = LlamaForCausalLM(cfg, device="cpu", seed=3)
        toks = _tokens(3)[:1, :16]
        with torch.no_grad():
            logits = model(torch.from_numpy(toks))
        pool = BlockKVPool(cfg.num_hidden_layers, 5, 8,
                           cfg.num_key_value_heads, cfg.head_dim,
                           cfg.torch_dtype, device="cpu")
        bt = torch.zeros((1, 16), dtype=torch.int32)
        bt[0, :2] = torch.tensor([1, 2], dtype=torch.int32)
        step = make_chunked_prefill_step(model)
        last = step(torch.from_numpy(toks), pool.layers, bt,
                    torch.tensor([0], dtype=torch.int32), 15)
        np.testing.assert_allclose(last[0].numpy(), logits[0, -1].numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_parameters_are_trainable(self):
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        params = list(model.parameters())
        assert params and all(p.requires_grad for p in params)

    def test_labels_with_caches_refused(self):
        model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
        x = torch.zeros((1, 4), dtype=torch.long)
        with pytest.raises(ValueError, match="no-cache"):
            model(x, caches=[], positions=x[:, 0], labels=x)

    @pytest.mark.parametrize("option,value", [
        ("sequence_parallel", True), ("context_parallel", "ring")])
    def test_unported_config_options_raise(self, option, value):
        # the sequence options, which the port once refused (hence the
        # name): with no mesh with an sp axis the option leaves the model
        # dense (the JAX model's fallback), the same loss and gradients
        # bit for bit
        ids = torch.from_numpy(np.random.RandomState(3).randint(
            0, 256, (2, 16)))
        grads = []
        for cfg in (LlamaConfig.tiny(**{option: value}), LlamaConfig.tiny()):
            model = LlamaForCausalLM(cfg, device="cpu", seed=5)
            loss, _ = model(ids, labels=ids)
            loss.backward()
            grads.append([loss.detach()] + [p.grad for p in
                                            model.parameters()])
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=0, atol=0)

    def test_unknown_config_option_refused(self):
        with pytest.raises(TypeError):
            LlamaConfig.tiny(use_flash_attention=False)


class TestLossPrecision:
    """The fused loss picks its products' precision itself: TF32 on the
    card for bf16 rows (exact operands), full f32 for f32 rows, and the
    caller's setting back afterwards."""

    @pytest.mark.parametrize("dtype,inside", [
        (torch.bfloat16, True), (torch.float16, True),
        (torch.float32, False)])
    def test_tf32_only_for_exact_operands(self, dtype, inside):
        from paddle_tpu_torch.device import tf32_if_exact

        mm = torch.backends.cuda.matmul
        before = mm.allow_tf32
        try:
            mm.allow_tf32 = False
            with tf32_if_exact(dtype):
                assert mm.allow_tf32 is inside
            assert mm.allow_tf32 is False
        finally:
            mm.allow_tf32 = before

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_f32_logits_gradients(self, dtype):
        # the Function's backward is the autograd of h.float() @ w
        from paddle_tpu_torch.models.llama import _F32Logits

        rng = np.random.RandomState(4)
        h0 = torch.from_numpy(rng.randn(6, 16).astype(np.float32)).to(dtype)
        w0 = torch.from_numpy(rng.randn(16, 40).astype(np.float32))
        g = torch.from_numpy(rng.randn(6, 40).astype(np.float32))
        grads = []
        for fn in (_F32Logits.apply, lambda h, w: h.float() @ w):
            h, w = h0.clone().requires_grad_(), w0.clone().requires_grad_()
            out = fn(h, w)
            assert out.dtype == torch.float32
            out.backward(g)
            grads.append((out.detach(), h.grad, w.grad))
        for got, want in zip(*grads):
            assert got.dtype == want.dtype
            torch.testing.assert_close(got, want, rtol=0, atol=0)
