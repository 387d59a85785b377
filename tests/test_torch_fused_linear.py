"""The port's fused_linear (paddle_tpu_torch/kernels/fused_linear.py)
against the JAX kernel (paddle_tpu/kernels/fused_linear.py).

On the CPU the port's wrapper runs its plain PyTorch version; the JAX
function runs its Pallas kernel in interpret mode (``interpret=True``,
tile sizes that divide the shapes, as tests/test_kernels.py does), so
the kernel body itself runs.  The same numpy inputs go to both; the JAX
weight is [K, N] and the port's its transpose [N, K].  Tolerances: f32
outputs and gradients 1e-5 (the two sum in different orders; gradients
relative to their largest entry); bf16 one bf16 ulp (2^-7) of the
largest output, since both round one f32 result once.

The CUDA kernel is held against the plain version on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_linear import fused_linear as jax_fused_linear
from paddle_tpu_torch.kernels import fused_linear as fl
from paddle_tpu_torch.kernels import launches

TOL = 1e-5
ACTS = ["none", "relu", "gelu", "gelu_tanh", "silu"]
TILES = dict(bm=32, bn=32, bk=64, interpret=True)


def operands(lead, K, N, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, K).astype(np.float32)
    w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)      # [K, N]
    b = rng.randn(N).astype(np.float32)
    return x, w, b


def run_jax(x, w, b, act):
    return np.asarray(jax_fused_linear(
        jnp.asarray(x), jnp.asarray(w), None if b is None else jnp.asarray(b),
        activation=act, **TILES))


def run_port(x, w, b, act):
    return fl.fused_linear(torch.from_numpy(x), torch.from_numpy(w.T.copy()),
                           None if b is None else torch.from_numpy(b), act)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_pallas_interpret(act, bias):
    x, w, b = operands((64,), 128, 96, seed=ACTS.index(act))
    b = b if bias else None
    before = launches.snapshot()
    got = run_port(x, w, b, act)
    assert launches.snapshot() == before     # a CPU tensor launches nothing
    np.testing.assert_allclose(got.numpy(), run_jax(x, w, b, act),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_leading_dims(act):
    x, w, b = operands((2, 3, 16), 64, 32, seed=7)        # M = 96
    got = run_port(x, w, b, act)
    assert got.shape == (2, 3, 16, 32)
    np.testing.assert_allclose(got.numpy(), run_jax(x, w, b, act),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("act", ACTS)
def test_gradients_match_jax_grad(act, bias):
    """dx, dw and db of sum(out * cot) against jax.grad of the JAX
    fused_linear (its custom vjp, ``_vjp_bwd``)."""
    x, w, b = operands((64,), 64, 32, seed=11 + ACTS.index(act))
    cot = np.random.RandomState(3).randn(64, 32).astype(np.float32)
    args = (x, w, b) if bias else (x, w)

    def f(*a):
        out = jax_fused_linear(a[0], a[1], a[2] if bias else None,
                               activation=act, **TILES)
        return jnp.sum(out * cot)

    want = jax.grad(f, argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    bt = torch.from_numpy(b).requires_grad_() if bias else None
    (fl.fused_linear(xt, wt, bt, act) * torch.from_numpy(cot)).sum() \
        .backward()
    got = [xt.grad.numpy(), wt.grad.numpy().T] + \
        ([bt.grad.numpy()] if bias else [])
    for name, g, jw in zip("xwb", got, want):
        jw = np.asarray(jw)
        np.testing.assert_allclose(g, jw, rtol=TOL,
                                   atol=TOL * float(np.abs(jw).max()),
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_bf16_within_one_ulp(act):
    x, w, b = operands((64,), 128, 64, seed=5)
    xt, wt, bt = (torch.from_numpy(a).bfloat16() for a in (x, w.T.copy(), b))
    want = np.asarray(jax_fused_linear(
        *(jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
          for t in (xt, wt.t().contiguous(), bt)),
        activation=act, **TILES).astype(jnp.float32))
    got = fl.fused_linear(xt, wt, bt, act)
    assert got.dtype == torch.bfloat16
    err = float(np.abs(got.float().numpy() - want).max())
    assert err <= float(np.abs(want).max()) * 2.0 ** -7, err


def test_ragged_shapes_match_jax_fallback():
    # tiles that do not divide M, N or K send the JAX function to its XLA
    # path (_fused_linear_fwd :66-70); the port takes every shape
    x, w, b = operands((37,), 40, 13, seed=9)
    np.testing.assert_allclose(run_port(x, w, b, "gelu").numpy(),
                               run_jax(x, w, b, "gelu"), rtol=TOL, atol=TOL)


def test_zero_rows_and_refusals():
    w, b = torch.randn(8, 16), torch.randn(8)
    assert fl.fused_linear(torch.randn(0, 16), w, b, "relu").shape == (0, 8)
    with pytest.raises(ValueError, match="unsupported activation"):
        fl.fused_linear(torch.randn(2, 16), w, b, "tanh")
    # a tensor that is not on the CPU never takes the plain version
    meta = [t.to("meta") for t in (torch.randn(4, 16), w, b)]
    with pytest.raises(ValueError, match="CUDA device"):
        fl.fused_linear(*meta, "gelu")
