"""FlashAttention at head_dims other than 64 and 128, on the CPU.

On the card the bf16 forward, dQ and dK/dV run on wgmma instances of
64, 128 and 256 columns that take every head_dim D that is a multiple of
8 up to 256: TMA fills the columns D..W-1 of each box with zeros and the
stores skip them (``csrc/flash_attention.cu``); other head_dims take the
general instances.  Here: each kernel's route,
instance and launch name for the shapes of ``test_torch_c1.ATTN_SHAPES``
(meta tensors), the flag each launch hands the C entry (a fake binding),
the padded instances' arithmetic (the plain forward, LSE and gradients
over operands zero-padded to the instance's width equal the unpadded
ones), the plain attention at Phi-2's and Phi-3's head_dims against the
JAX kernels in interpret mode, and a tiny Llama of head_dim 96 trained 3
AdamW steps against the JAX model.

Tolerances: the padded arithmetic within 1e-6 (f32; the zero columns
add exact zeros, but a sum over more terms may round in another order);
against the JAX kernels those of ``tests/test_torch_train_kernels.py``
(forward 1e-5, gradients 1e-4); the training steps those of
``tests/test_torch_head_dim_256.py`` (loss 1e-5, every gradient 1e-5 of
its largest JAX entry, 3 AdamW steps' losses 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.flash_attention import _flash_fwd_lse_bhtd
from paddle_tpu.kernels.flash_attention import (flash_attention_bhtd as
                                                jax_flash_bhtd)
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.kernels import _build, launches
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.optimizer import AdamW
from test_torch_c1 import ATTN_SHAPES

PAD_TOL = 1e-6
FWD_TOL, GRAD_TOL = 1e-5, 1e-4
LOSS_TOL, STEP_GRAD_TOL, STEP_TOL = 1e-5, 1e-5, 1e-4
# hidden 192 over 2 q heads and 2 kv heads: head_dim 96, Phi-3-mini's
D96 = dict(hidden_size=192, num_attention_heads=2, num_key_value_heads=2)


def _width(D):
    """The wgmma instance of a bf16 head_dim D with strides TMA takes;
    None: the general instances."""
    return None if D % 8 else next(w for w in (64, 128, 256) if D <= w)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


# ------------------------------------------------------------ the routes
@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("tag,H,KVH,D,bs,fast", ATTN_SHAPES,
                         ids=[s[0] for s in ATTN_SHAPES])
def test_route_instance_and_name(tag, H, KVH, D, bs, fast, layout):
    # every kernel: the instance of 64, 128 or 256 columns that holds D
    # (any D that is a multiple of 8), the general instance else; the
    # launch names follow
    if layout == "bhtd":
        q, k = _meta(1, H, 64, D), _meta(1, KVH, 64, D)
    else:
        q = _meta(1, 64, H, D).transpose(1, 2)
        k = _meta(1, 64, KVH, D).transpose(1, 2)
    for kernel in (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV):
        assert fa.wgmma_width(q, k, kernel) == _width(D)
        assert fa._launch_name(kernel, q, k) == (
            kernel if _width(D) else kernel + fa.GENERAL)
    assert (_width(D) is not None) == (tag != "tiny_c1")


@pytest.mark.parametrize("D", [80, 96, 256])
def test_strides_tma_refuses_and_f32_take_the_general_instances(D):
    # rows padded by 4 elements (8 bytes) have no tensor map; f32 has no
    # wgmma instance: every kernel on its general instance, f32 under the
    # plain names
    q = torch.empty(1, 2, 16, D + 4, dtype=torch.bfloat16,
                    device="meta")[..., :D]
    k = _meta(1, 1, 16, D)
    f32 = _meta(1, 2, 16, D, dtype=torch.float32)
    for kernel in (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV):
        assert fa.wgmma_width(q, k, kernel) is None
        assert fa._launch_name(kernel, q, k) == kernel + fa.GENERAL
        assert fa.general_route(f32, f32, kernel)
        assert fa._launch_name(kernel, f32, f32) == kernel
    with pytest.raises(ValueError, match="no kernel"):
        fa.wgmma_width(k, k, "flash_attention_bwd")


@pytest.mark.parametrize("D", [20, 32, 80, 96, 132, 160, 256])
def test_each_launch_hands_the_c_entry_its_route(monkeypatch, D):
    # one launch of each kernel through a fake binding over meta tensors:
    # the general flag each C entry gets, and the counter it adds to
    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "bind", lambda lib, fn, argtypes: (
        lambda *args: calls.append((fn, args)) or 0))
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    q = _meta(2, 40, 8, D).transpose(1, 2)
    k = _meta(2, 40, 1, D).transpose(1, 2)
    launches.reset()
    o, lse = fa._fwd_kernel(q, k, k, True, D ** -0.5, True)
    fa._fwd_kernel(q, k, k, True, D ** -0.5, False)
    ops = fa._bwd_operands(q, k, k, q, lse, lse)
    fa._dq_kernel(*ops, True, D ** -0.5)
    fa._dkv_kernel(*ops, True, D ** -0.5)
    general = {fn: args[-2] for fn, args in calls}
    wgmma = _width(D) is not None
    assert [fn for fn, _ in calls] == ["flash_fwd", "flash_fwd",
                                       "flash_bwd_dq", "flash_bwd_dkv"]
    assert general == {"flash_fwd": int(not wgmma),
                       "flash_bwd_dq": int(not wgmma),
                       "flash_bwd_dkv": int(not wgmma)}
    g = "" if wgmma else fa.GENERAL
    want = {fa.FWD_LSE + g: 1, fa.FWD + g: 1, fa.BWD_DQ + g: 1,
            fa.BWD_DKV + g: 1}
    assert launches.snapshot() == want
    # the instance, tallied beside each name: the wgmma width, or the
    # general instance of head_dim up to 128 or 256
    inst = f"w{_width(D)}" if wgmma else f"maxd{128 if D <= 128 else 256}"
    assert launches.by_instance() == {f"{n}@{inst}": 1 for n in want}
    assert o.stride() == q.stride()


# ----------------------------------------------- the padded arithmetic
def _operands(B, H, KVH, Tq, Tk, D, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))
            for shape, s in (((B, H, Tq, D), 0.5), ((B, KVH, Tk, D), 0.5),
                             ((B, KVH, Tk, D), 1.0), ((B, H, Tq, D), 1.0))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [16, 80, 96, 160, 256])
def test_zero_padded_columns_change_nothing(D, causal):
    # what the padded instances compute: q, k, v and dO with zero columns
    # up to the instance's width W, at the true D's scale, give the
    # unpadded O, LSE, dQ, dK and dV in their first D columns and zeros
    # past them (the columns the kernels do not store)
    W = _width(D)
    q, k, v, do = _operands(1, 4, 2, 37, 45, D, D)
    pad = [torch.nn.functional.pad(x, (0, W - D)) for x in (q, k, v, do)]
    scale = D ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    po, plse = fa.flash_fwd_plain(*pad[:3], causal, scale)
    grads = fa.flash_bwd_plain(q, k, v, o, lse, do, causal, scale)
    pgrads = fa.flash_bwd_plain(*pad[:3], po, plse, pad[3], causal, scale)
    torch.testing.assert_close(plse, lse, rtol=PAD_TOL, atol=PAD_TOL)
    for want, got in zip((o, *grads), (po, *pgrads)):
        torch.testing.assert_close(got[..., :D], want, rtol=PAD_TOL,
                                   atol=PAD_TOL)
        assert not got[..., D:].any()


# ------------------------------------------- against the JAX kernels
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [80, 96])
def test_forward_and_lse_match_jax_kernel(D, causal):
    q, k, v, _ = _operands(2, 2, 2, 32, 32, D, 1)
    scale = D ** -0.5
    o, lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    wo, wlse = _flash_fwd_lse_bhtd(*(jnp.asarray(x.numpy())
                                     for x in (q, k, v)),
                                   causal, scale, 16, 16, True)
    np.testing.assert_allclose(o.numpy(), np.asarray(wo), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy().reshape(-1, 32),
                               np.asarray(wlse).reshape(-1, 32),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [80, 96])
def test_grads_match_jax_kernel(D, causal):
    q, k, v, g = _operands(2, 2, 2, 32, 32, D, 2)
    jq, jk, jv = (jnp.asarray(x.numpy()) for x in (q, k, v))

    def f(q_, k_, v_):
        return (jax_flash_bhtd(q_, k_, v_, causal=causal, block_q=16,
                               block_k=16, interpret=True)
                * jnp.asarray(g.numpy())).sum()

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    fa.flash_attention_bhtd(qt, kt, vt, causal).backward(g)
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                   rtol=GRAD_TOL, atol=GRAD_TOL)


# --------------------------------------------- a model of head_dim 96
def test_head_dim_96_training_matches_jax():
    # the loss and every gradient of the first step, then 3 AdamW steps,
    # with the fused chunked loss
    opts = dict(D96, fused_lm_loss=True, lm_loss_chunk=16)
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**opts))
    named = {n: np.asarray(p.numpy())
             for n, p in jax_model.state_dict().items()}
    model = from_jax_state_dict(named, LlamaConfig.tiny(**opts),
                                device="cpu")
    assert model.config.head_dim == 96
    tokens = np.random.RandomState(3).randint(0, 256, (2, 24)) \
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
                assert err <= STEP_GRAD_TOL * float(np.abs(w).max()), \
                    (name, err)
        jopt.step()
        jopt.clear_grad()
        opt.step()
        opt.clear_grad()
        jax_losses.append(float(jl.numpy()))
        losses.append(float(loss.detach()))
    np.testing.assert_allclose(losses, jax_losses, rtol=STEP_TOL,
                               atol=STEP_TOL)
    assert losses[-1] < losses[0]
