"""The port's gradient clipping (paddle_tpu_torch.nn.clip) against the
JAX package's (paddle_tpu.nn.clip), on the same numpy gradients.

Tolerances: an f32 result within 1e-6 of each entry, relative (both
packages sum the squares in their own order, and PyTorch's CPU square
root is not always correctly rounded, so a norm, and the scale formed
from it, may differ in its last places); a bf16 result within one bf16
ulp (the scale's last place can move a product across a bf16 rounding
boundary); a norm within 1e-6 relative; clamping by value exact.  A scale of 1 (a limit above
every norm) returns each gradient unchanged, bit for bit, in both.
The classes return new gradients and leave ``p.grad`` alone; the
``*_`` functions write ``p.grad`` in place.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.clip as jclip
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import clip as tclip

SHAPES = [(12, 16), (16,), (4, 6, 5), (7,)]
NORM_TOL = 1e-6
F32_RTOL = 1e-6


def _ulps(a, b, dtype):
    """Largest distance of two arrays (as f32) in units of the last
    place of ``dtype``, through their bit patterns."""
    a, b = (torch.from_numpy(np.asarray(x, np.float32).copy()) for x in (a, b))
    if dtype == "bfloat16":
        ia, ib = (x.bfloat16().view(torch.int16).int() for x in (a, b))
    else:
        ia, ib = (x.view(torch.int32).long() for x in (a, b))
    return int((ia - ib).abs().max()) if ia.numel() else 0


def _arrays(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _jax_pairs(grads, dtype, none_at=None, frozen_at=None):
    out = []
    for i, g in enumerate(grads):
        p = JParameter(jnp.zeros(g.shape, getattr(jnp, dtype)),
                       trainable=i != frozen_at)
        out.append((p, None if i == none_at
                    else JTensor(jnp.asarray(g, getattr(jnp, dtype)))))
    return out


def _torch_pairs(grads, dtype, none_at=None, frozen_at=None):
    out = []
    for i, g in enumerate(grads):
        p = torch.nn.Parameter(torch.zeros(g.shape, dtype=getattr(
            torch, dtype)), requires_grad=i != frozen_at)
        out.append((p, None if i == none_at
                    else torch.from_numpy(g).to(getattr(torch, dtype))))
    return out


def _close(want, got, dtype, exact=False):
    """``got`` (a torch tensor) against ``want`` (a JAX array): equal
    when ``exact``, else within F32_RTOL of each entry (f32) or one
    bf16 ulp (bf16)."""
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    elif dtype == "bfloat16":
        assert _ulps(want, got, dtype) <= 1
    else:
        np.testing.assert_allclose(got, want, rtol=F32_RTOL, atol=0)


def _same(jpairs, tpairs, dtype, exact=False):
    assert len(jpairs) == len(tpairs)
    for (_, jg), (_, tg) in zip(jpairs, tpairs):
        if jg is None:
            assert tg is None
            continue
        assert tg.dtype == getattr(torch, dtype)
        _close(jg._value, tg, dtype, exact)


def _clips(kind, limit):
    if kind == "value":
        return jclip.ClipGradByValue(limit), tnn.ClipGradByValue(limit)
    if kind == "value_min":
        return (jclip.ClipGradByValue(limit, -limit / 3),
                tnn.ClipGradByValue(limit, -limit / 3))
    if kind == "norm":
        return jclip.ClipGradByNorm(limit), tnn.ClipGradByNorm(limit)
    return jclip.ClipGradByGlobalNorm(limit), tnn.ClipGradByGlobalNorm(limit)


# limits that clip every gradient, and (value: none) none of them
LIMITS = {"value": 0.5, "value_min": 0.5, "norm": 1.0, "global_norm": 2.0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", sorted(LIMITS))
@pytest.mark.parametrize("edge", ["plain", "none_grad", "frozen"])
def test_class_matches_jax(kind, dtype, edge):
    grads = _arrays(0)
    where = dict(plain={}, none_grad={"none_at": 1},
                 frozen={"frozen_at": 2})[edge]
    jc, tc = _clips(kind, LIMITS[kind])
    jpairs = _jax_pairs(grads, dtype, **where)
    tpairs = _torch_pairs(grads, dtype, **where)
    before = [None if g is None else g.clone() for _, g in tpairs]
    jout, tout = jc(jpairs), tc(tpairs)
    _same(jout, tout, dtype)
    # the pairs handed in are untouched, a skipped one passed through
    for (p, g), b, (q, h) in zip(tpairs, before, tout):
        assert q is p
        if b is not None:
            assert torch.equal(g, b)
        if b is None or not p.requires_grad:
            assert h is g
    if kind != "value" and kind != "value_min":
        # every trainable gradient was scaled down
        for (p, g), (_, h) in zip(tpairs, tout):
            if g is not None and p.requires_grad:
                assert float(h.float().norm()) < float(g.float().norm())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["norm", "global_norm", "value"])
def test_scale_of_one_changes_nothing(kind, dtype):
    grads = _arrays(1, scale=1e-3)
    jc, tc = _clips(kind, 1e3)
    tpairs = _torch_pairs(grads, dtype)
    jout, tout = jc(_jax_pairs(grads, dtype)), tc(tpairs)
    _same(jout, tout, dtype, exact=True)
    for (_, g), (_, h) in zip(tpairs, tout):
        assert torch.equal(g, h)


def test_global_norm_matches_jax_and_is_kept():
    grads = _arrays(2)
    jc, tc = _clips("global_norm", 1.0)
    want = float(np.asarray(jc._global_norm(_jax_pairs(grads, "float32"))
                            ._value))
    assert tc.last_global_norm is None
    tc(_torch_pairs(grads, "float32", frozen_at=0))
    frozen = float(tc.last_global_norm)
    tc(_torch_pairs(grads, "float32"))
    got = float(tc.last_global_norm)
    assert tc.last_global_norm.dtype == torch.float32
    assert abs(got - want) <= NORM_TOL * want
    assert frozen < got
    # no gradient at all: nothing to clip, the pairs come back
    pairs = _torch_pairs(grads, "float32", none_at=0)[:1]
    assert tc(pairs) == pairs and tc.last_global_norm is None


def _jax_params(grads, dtype):
    ps = []
    for g in grads:
        p = JParameter(jnp.zeros(g.shape if g is not None else (3,),
                                 getattr(jnp, dtype)))
        p.grad = None if g is None else JTensor(jnp.asarray(
            g, getattr(jnp, dtype)))
        ps.append(p)
    return ps


def _torch_params(grads, dtype):
    ps = []
    for g in grads:
        p = torch.nn.Parameter(torch.zeros(g.shape if g is not None
                                           else (3,),
                                           dtype=getattr(torch, dtype)))
        p.grad = None if g is None else torch.from_numpy(g).to(
            getattr(torch, dtype))
        ps.append(p)
    return ps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type", [2.0, float("inf"), 1.0, 3.0])
def test_clip_grad_norm_matches_jax(norm_type, dtype):
    grads = _arrays(3)
    grads.insert(1, None)
    jps, tps = _jax_params(grads, dtype), _torch_params(grads, dtype)
    jtotal = jclip.clip_grad_norm_(jps, 1.5, norm_type)
    ttotal = tclip.clip_grad_norm_(tps, 1.5, norm_type)
    want = float(np.asarray(jtotal._value.astype(jnp.float32)))
    assert ttotal.dtype == (torch.bfloat16 if dtype == "bfloat16" and
                            norm_type == float("inf") else torch.float32)
    assert abs(float(ttotal) - want) <= NORM_TOL * want
    for jp, tp in zip(jps, tps):
        if jp.grad is None:
            assert tp.grad is None
            continue
        assert tp.grad.dtype == getattr(torch, dtype)
        _close(jp.grad._value, tp.grad, dtype)


def test_clip_grad_norm_mixed_dtypes_and_no_grads():
    grads = _arrays(4)
    jps = _jax_params(grads[:2], "bfloat16") + _jax_params(grads[2:],
                                                          "float32")
    tps = _torch_params(grads[:2], "bfloat16") + _torch_params(grads[2:],
                                                              "float32")
    jt = jclip.clip_grad_norm_(jps, 0.7, float("inf"))
    tt = tclip.clip_grad_norm_(tps, 0.7, float("inf"))
    assert tt.dtype == torch.float32
    assert float(tt) == float(np.asarray(jt._value))
    for jp, tp in zip(jps, tps):
        dt = "bfloat16" if tp.grad.dtype == torch.bfloat16 else "float32"
        _close(jp.grad._value, tp.grad, dt)
    empty = _torch_params([None, None], "float32")
    assert float(tclip.clip_grad_norm_(empty, 1.0)) == 0.0
    single = _torch_params(grads[:1], "float32")[0]
    tclip.clip_grad_norm_(single, 1.0)
    assert float(single.grad.norm()) <= 1.0 + 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_grad_value_matches_jax(dtype):
    grads = _arrays(5)
    grads.append(None)
    jps, tps = _jax_params(grads, dtype), _torch_params(grads, dtype)
    jclip.clip_grad_value_(jps, 0.25)
    tclip.clip_grad_value_(tps, 0.25)
    for jp, tp in zip(jps, tps):
        if jp.grad is None:
            assert tp.grad is None
            continue
        _close(jp.grad._value, tp.grad, dtype, exact=True)
        assert float(tp.grad.float().abs().max()) <= 0.25


def test_exported_from_nn():
    assert tnn.ClipGradByGlobalNorm is tclip.ClipGradByGlobalNorm
    assert tnn.ClipGradByNorm is tclip.ClipGradByNorm
    assert tnn.ClipGradByValue is tclip.ClipGradByValue
