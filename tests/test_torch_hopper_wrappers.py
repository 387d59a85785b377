"""The Python side of the port's Hopper (wgmma + TMA) kernels, on the CPU:
the grouped fused_norm_linear against the JAX package and against its
single-weight calls and the groups it refuses, the strides the
FlashAttention forward's tensor maps take, and fused_linear at widths
that are not a multiple of 8 against the JAX kernel.

On the CPU the wrappers run their plain PyTorch versions; the JAX
functions run their XLA fallback or their Pallas kernel in interpret
mode.  f32 tolerance 1e-5 (the two frameworks sum in different orders).
The CUDA kernels are held against the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_linear import fused_linear as jax_fused_linear
from paddle_tpu.kernels.fused_norm_linear import (fused_norm_linear as
                                                  jax_fused_norm_linear)
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_linear as fl
from paddle_tpu_torch.kernels import fused_norm_linear as fnl
from paddle_tpu_torch.kernels import launches

TOL = 1e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------- fused_norm_linear
@pytest.mark.parametrize("acts", [["none"], ["none"] * 3, ["silu", "none"],
                                  ["none", "silu", "silu"]])
@pytest.mark.parametrize("lead", [(4,), (2, 10)])
def test_group_matches_jax_and_single_calls(lead, acts):
    rng = np.random.RandomState(len(acts) + len(lead))
    K = 24
    x = rng.randn(*lead, K).astype(np.float32)
    nw = rng.randn(K).astype(np.float32)
    ws = [rng.randn(K, 8 * (i + 1)).astype(np.float32)
          for i in range(len(acts))]
    rs = fnl.rms_scale(t(x), 1e-5)
    before = launches.snapshot()
    outs = fnl.fused_norm_linear_group(t(x), rs, t(nw), [t(w) for w in ws],
                                       acts)
    assert launches.snapshot() == before      # a CPU tensor launches nothing
    assert len(outs) == len(ws)
    for out, w, act in zip(outs, ws, acts):
        assert out.shape == (*lead, w.shape[1])
        assert torch.equal(out, fnl.fused_norm_linear(t(x), rs, t(nw), t(w),
                                                      act))
        close(out.numpy().reshape(-1, w.shape[1]), jax_fused_norm_linear(
            jnp.asarray(x.reshape(-1, K)),
            jnp.asarray(rs.numpy().reshape(-1, 1)), jnp.asarray(nw),
            jnp.asarray(w), act, use_pallas=False))


@pytest.mark.parametrize("n,acts", [
    (2, ["none"]), (2, ["none", "gelu"]), (0, []), (4, ["none"] * 4)])
def test_group_rejects_what_it_does_not_take(n, acts):
    # activations one a weight, none or silu; 1 to MAX_GROUP weights
    assert fnl.MAX_GROUP == 3
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="fused_norm_linear_group"):
        fnl.fused_norm_linear_group(x, torch.ones(4, 1), torch.ones(8),
                                    [torch.zeros(8, 8)] * n, acts)


# ------------------------------------------------------- flash attention
def _view(B, H, T, D, layout, pad=0):
    """A [B, H, T, D] view in the given memory order; ``pad`` extra
    elements at the end of each row of D."""
    bf = torch.bfloat16
    if layout == "bhtd":
        return torch.zeros(B, H, T, D + pad, dtype=bf)[..., :D]
    return torch.zeros(B, T, H, D + pad, dtype=bf)[..., :D].transpose(1, 2)


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("D", [64, 128])
def test_tma_strides_of_dense_views(layout, D):
    q = _view(2, 4, 33, D, layout)
    assert fa.tma_strides(q) == list(q.stride()[:3])


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("pad", [1, 3, 4])
def test_tma_strides_refuse_what_tma_cannot_take(layout, pad):
    # rows of D + pad bf16 are not a multiple of 16 bytes apart
    q = _view(2, 4, 33, 64, layout, pad)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.tma_strides(q)


def test_tma_strides_take_rows_padded_to_16_bytes():
    q = _view(1, 2, 5, 64, "bhtd", pad=8)
    assert fa.tma_strides(q) == [q.numel(), 5 * 72, 72]


@pytest.mark.parametrize("shape", [(1, 4, 33, 64), (2, 1, 33, 64),
                                   (1, 1, 1, 128)])
def test_strides_of_unit_axes_never_matter(shape):
    # an axis of extent 1 gets the view's element count (a multiple of
    # D), whatever stride PyTorch gave it
    q = torch.zeros(shape).bfloat16()
    odd = q.as_strided(shape, [7 if n == 1 else s
                               for n, s in zip(shape, q.stride())])
    want = [q.numel() if n == 1 else s
            for n, s in zip(shape[:3], q.stride()[:3])]
    assert fa._strides(odd) == want
    assert fa.tma_strides(odd) == want


# ----------------------------------------------------------- fused_linear
@pytest.mark.parametrize("K", [3, 5, 12, 37])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_linear_any_k_matches_jax(K, act):
    # K % 8 != 0 runs on the card too (predicated loads there); the JAX
    # kernel in interpret mode takes a K its tile covers whole
    rng = np.random.RandomState(K)
    x = rng.randn(32, K).astype(np.float32)
    w = (rng.randn(K, 24) / np.sqrt(K)).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    got = fl.fused_linear(t(x), t(w.T.copy()), t(b), act)
    want = jax_fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            activation=act, bm=32, bn=24, bk=K,
                            interpret=True)
    close(got.numpy(), np.asarray(want))
