"""The training slice's kernels and optimizer rule (paddle_tpu_torch) against
the JAX package.

On the CPU each wrapper runs its plain PyTorch version.  The same numpy
inputs go to it and to the JAX function: RoPE against ``fused_rope``,
FlashAttention against ``_flash_fwd_lse_bhtd`` and ``jax.grad`` of
``flash_attention_bhtd``/``flash_attention_bthd`` (their Pallas kernels
in interpret mode where the shape tiles, ``_attn_reference`` where it
does not, as the JAX function itself falls back), the RMSNorm backward
against ``jax.vjp`` of the JAX ``rms_norm`` and the AdamW rule against
``_adamw_rule``.  f32 throughout, except where a case says bf16.

Tolerances: forward 1e-5 and gradients 1e-4 (f32; the two frameworks
sum in different orders); the AdamW rule (f32 and bf16 parameters)
identical up to one ulp of each output's dtype (the same operations in
the same order, its multiply-adds fused as XLA fuses them; the bias
correction's ``beta ** step`` goes through another power routine).  Each CUDA kernel is held against its plain version on the
card in tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.flash_attention import (_attn_reference,
                                                _flash_fwd_lse_bhtd)
from paddle_tpu.kernels.flash_attention import (flash_attention_bhtd as
                                                jax_flash_bhtd)
from paddle_tpu.kernels.flash_attention import (flash_attention_bthd as
                                                jax_flash_bthd)
from paddle_tpu.kernels.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu.kernels.rope import fused_rope as jax_fused_rope
from paddle_tpu.optimizer.optimizer import _adamw_rule
from paddle_tpu_torch.kernels import _build, launches
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import rms_norm, rope
from paddle_tpu_torch.optimizer import AdamW, adamw_rule

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a, requires_grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(requires_grad)


def rope_tables(D, max_pos, theta=10000.0):
    inv = 1.0 / (theta ** (np.arange(0, D, 2) / D))
    ang = np.arange(max_pos)[:, None] * inv[None, :]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

class TestRope:
    # H * D = 128 and T a multiple of block_t: the Pallas kernel runs
    B, T, H, D, BLOCK_T = 2, 16, 4, 32, 8

    def _operands(self, seed=0):
        rng = np.random.RandomState(seed)
        x = rng.randn(self.B, self.T, self.H, self.D).astype(np.float32)
        g = rng.randn(*x.shape).astype(np.float32)
        return x, g, *rope_tables(self.D, 32)

    @pytest.mark.parametrize("offset", [0, 7])
    def test_forward_matches_jax(self, offset):
        x, _, cos, sin = self._operands()
        got = rope.fused_rope(t(x), t(cos), t(sin), offset)
        want = jax_fused_rope(jnp.asarray(x), jnp.asarray(cos),
                              jnp.asarray(sin), offset, block_t=self.BLOCK_T,
                              interpret=True)
        close(got.numpy(), want, FWD_TOL)

    @pytest.mark.parametrize("offset", [0, 7])
    def test_grad_matches_jax(self, offset):
        x, g, cos, sin = self._operands(1)
        xt = t(x, requires_grad=True)
        rope.fused_rope(xt, t(cos), t(sin), offset).backward(t(g))
        want = jax.grad(lambda x_: (jax_fused_rope(
            x_, jnp.asarray(cos), jnp.asarray(sin), offset,
            block_t=self.BLOCK_T, interpret=True) * jnp.asarray(g)).sum())(
                jnp.asarray(x))
        close(xt.grad.numpy(), want, GRAD_TOL)

    def test_bf16_rounds_once_like_the_kernel(self):
        # the Pallas kernel raises x and the tables to f32 and rounds
        # once; the two agree to one bf16 ulp of the largest output
        # (XLA may contract x1 * c - x2 * s into one multiply-add)
        x, _, cos, sin = self._operands(2)
        xb, cb, sb = (jnp.asarray(a, jnp.bfloat16) for a in (x, cos, sin))
        want = np.asarray(jax_fused_rope(xb, cb, sb, 3, block_t=self.BLOCK_T,
                                         interpret=True), np.float32)
        got = rope.fused_rope(t(x).bfloat16(), t(cos).bfloat16(),
                              t(sin).bfloat16(), 3).float().numpy()
        assert np.abs(got - want).max() <= np.abs(want).max() / 128

    def test_positions_past_the_table_raise(self):
        x, _, cos, sin = self._operands()
        with pytest.raises(ValueError, match="past the table"):
            rope.fused_rope(t(x), t(cos), t(sin), 20)


# ---------------------------------------------------------------------------
# FlashAttention
# ---------------------------------------------------------------------------

def _attn_operands(B, H, KVH, Tq, Tk, D, seed):
    rng = np.random.RandomState(seed)
    q = (rng.randn(B, H, Tq, D) * 0.5).astype(np.float32)
    k = (rng.randn(B, KVH, Tk, D) * 0.5).astype(np.float32)
    v = rng.randn(B, KVH, Tk, D).astype(np.float32)
    g = rng.randn(B, H, Tq, D).astype(np.float32)
    return q, k, v, g


# (Tq, Tk, block): tiled square, tiled Tq < Tk, and a T that is not a
# multiple of the block (the JAX function falls back to _attn_reference)
SHAPES = [(32, 32, 16), (16, 48, 16), (20, 20, 16)]


class TestFlashAttention:
    B, H, D = 2, 2, 16

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("Tq,Tk,block", SHAPES[:2])
    def test_forward_and_lse_match_jax_kernel(self, Tq, Tk, block, causal):
        q, k, v, _ = _attn_operands(self.B, self.H, self.H, Tq, Tk, self.D, 0)
        scale = 1.0 / np.sqrt(self.D)
        o, lse = fa.flash_fwd_plain(t(q), t(k), t(v), causal, scale)
        wo, wlse = _flash_fwd_lse_bhtd(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal, scale, block,
                                       block, True)
        close(o.numpy(), wo, FWD_TOL)
        close(lse.numpy().reshape(-1, Tq), wlse, FWD_TOL)
        close(fa.attn_reference(t(q), t(k), t(v), causal, scale).numpy(),
              _attn_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, scale), FWD_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("Tq,Tk,block", SHAPES)
    def test_grads_match_jax(self, Tq, Tk, block, causal):
        q, k, v, g = _attn_operands(self.B, self.H, self.H, Tq, Tk, self.D, 1)
        scale = 1.0 / np.sqrt(self.D)

        def f(q_, k_, v_):
            return (jax_flash_bhtd(q_, k_, v_, causal=causal, block_q=block,
                                   block_k=block, interpret=True)
                    * jnp.asarray(g)).sum()

        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        want_o = jax_flash_bhtd(jq, jk, jv, causal=causal, block_q=block,
                                block_k=block, interpret=True)
        want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
        # the plain FA-2 backward, from the plain forward's O and LSE
        o, lse = fa.flash_fwd_plain(t(q), t(k), t(v), causal, scale)
        close(o.numpy(), want_o, FWD_TOL)
        plain = fa.flash_bwd_plain(t(q), t(k), t(v), o, lse, t(g), causal,
                                   scale)
        # and the autograd.Function around it
        qt, kt, vt = (t(a, requires_grad=True) for a in (q, k, v))
        fa.flash_attention_bhtd(qt, kt, vt, causal).backward(t(g))
        for got_p, got_a, w in zip(plain, (qt.grad, kt.grad, vt.grad), want):
            close(got_p.numpy(), w, GRAD_TOL)
            close(got_a.numpy(), w, GRAD_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_gqa_bthd_matches_jax(self, causal):
        # 4 query heads over 2 kv heads, [B, T, H, D]: the port reads kv
        # head h // 2 and sums dK/dV over each group, the JAX function
        # repeats k/v (its vjp is the same sum)
        q, k, v, g = _attn_operands(2, 4, 2, 24, 40, self.D, 2)
        q, k, v, g = (np.ascontiguousarray(a.transpose(0, 2, 1, 3))
                      for a in (q, k, v, g))
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))

        def f(q_, k_, v_):
            return (jax_flash_bthd(q_, k_, v_, causal=causal, block_q=8,
                                   block_k=8, interpret=True)
                    * jnp.asarray(g)).sum()

        want_o = jax_flash_bthd(jq, jk, jv, causal=causal, block_q=8,
                                block_k=8, interpret=True)
        want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
        qt, kt, vt = (t(a, requires_grad=True) for a in (q, k, v))
        out = fa.flash_attention_bthd(qt, kt, vt, causal)
        close(out.detach().numpy(), want_o, FWD_TOL)
        out.backward(t(g))
        for got, w in zip((qt.grad, kt.grad, vt.grad), want):
            assert got.shape == w.shape
            close(got.numpy(), w, GRAD_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_autograd_matches_torch_autograd_of_reference(self, causal):
        q, k, v, g = _attn_operands(1, 4, 2, 13, 29, 8, 3)
        qt, kt, vt = (t(a, requires_grad=True) for a in (q, k, v))
        fa.flash_attention_bhtd(qt, kt, vt, causal, 0.3).backward(t(g))
        rq, rk, rv = (t(a, requires_grad=True) for a in (q, k, v))
        fa.attn_reference(rq, rk.repeat_interleave(2, 1),
                          rv.repeat_interleave(2, 1), causal, 0.3).backward(
                              t(g))
        for got, want in zip((qt.grad, kt.grad, vt.grad),
                             (rq.grad, rk.grad, rv.grad)):
            close(got.numpy(), want.numpy(), GRAD_TOL)

    def test_no_grad_forward_equals_grad_forward(self):
        q, k, v, _ = _attn_operands(1, 2, 2, 9, 9, 8, 4)
        with torch.no_grad():
            a = fa.flash_attention_bhtd(t(q), t(k), t(v), True)
        b = fa.flash_attention_bhtd(t(q, True), t(k), t(v), True)
        assert torch.equal(a, b.detach())

    def test_causal_rows_without_a_visible_key_are_refused(self):
        # causal with Tq > Tk: the first Tq - Tk rows see no key; the
        # JAX kernel gives them uniform weights over masked keys, the
        # port refuses the shape (training always has Tq == Tk)
        q, k, v, _ = _attn_operands(1, 2, 2, 12, 8, 8, 5)
        with pytest.raises(ValueError, match="no visible key"):
            fa.flash_attention_bhtd(t(q), t(k), t(v), causal=True)
        # not causal, the same shape is fine
        fa.flash_attention_bhtd(t(q), t(k), t(v), causal=False)

    def test_mismatched_heads_refused(self):
        q, k, v, _ = _attn_operands(1, 3, 2, 8, 8, 8, 6)
        with pytest.raises(ValueError, match="does not fit"):
            fa.flash_attention_bhtd(t(q), t(k), t(v))


# ---------------------------------------------------------------------------
# RMSNorm backward
# ---------------------------------------------------------------------------

class TestRmsNormBackward:
    @pytest.mark.parametrize("shape", [(4, 64), (2, 3, 32), (512, 16)])
    def test_vjp_matches_jax(self, shape):
        rng = np.random.RandomState(0)
        x = (rng.randn(*shape) * 3).astype(np.float32)
        w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
        g = rng.randn(*shape).astype(np.float32)
        xt, wt = t(x, True), t(w, True)
        out = rms_norm.rms_norm(xt, wt, 1e-5)
        out.backward(t(g))
        want_out, vjp = jax.vjp(
            lambda x_, w_: jax_rms_norm(x_, w_, 1e-5, interpret=True),
            jnp.asarray(x), jnp.asarray(w))
        dx, dw = vjp(jnp.asarray(g))
        close(out.detach().numpy(), want_out, FWD_TOL)
        close(xt.grad.numpy(), dx, GRAD_TOL)
        close(wt.grad.numpy(), dw, GRAD_TOL)

    def test_written_out_vjp_is_autograd_of_the_plain_version(self):
        rng = np.random.RandomState(1)
        x, g = rng.randn(6, 40).astype(np.float32), rng.randn(6, 40)
        w = rng.randn(40).astype(np.float32)
        xt, wt = t(x, True), t(w, True)
        rms_norm.rms_norm_plain(xt, wt, 1e-6).backward(t(g).float())
        dx, dw = rms_norm.rms_norm_bwd_plain(t(x), t(w), 1e-6, t(g).float())
        close(dx.numpy(), xt.grad.numpy(), GRAD_TOL)
        close(dw.numpy(), wt.grad.numpy(), GRAD_TOL)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def _bf16_ulps(a, b):
    """Largest distance between two bf16 arrays (given as float32) in
    units of the last place, through their bit patterns (same-sign
    values)."""
    ia, ib = (torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
              .view(torch.int16).int() for x in (a, b))
    return int((ia - ib).abs().max())


class TestAdamW:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("step", [1, 3, 100])
    def test_rule_matches_jax(self, dtype, step):
        rng = np.random.RandomState(step)
        shape = (64, 48)
        p = (rng.randn(*shape) * 0.02).astype(np.float32)
        g = (rng.randn(*shape) * 0.01).astype(np.float32)
        first = step == 1
        m = np.zeros(shape, np.float32) if first else \
            (rng.randn(*shape) * 1e-3).astype(np.float32)
        v = np.zeros(shape, np.float32) if first else \
            (rng.rand(*shape) * 1e-5).astype(np.float32)
        args = (1e-3, 0.9, 0.999, 1e-8)
        jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
        wp, wm, wv = _adamw_rule(jnp.asarray(p, jdt), jnp.asarray(m),
                                 jnp.asarray(v), jnp.asarray(g, jdt), *args,
                                 jnp.asarray(step, jnp.int32), 0.01)
        tm, tv = t(m), t(v)
        got = adamw_rule(t(p).to(tdt), tm, tv, t(g).to(tdt), *args, step,
                         0.01)
        assert got.dtype == tdt
        got, wp = got.float().numpy(), np.asarray(wp, np.float32)
        if dtype == "bfloat16":
            assert _bf16_ulps(got, wp) <= 1
        else:
            np.testing.assert_array_max_ulp(got, wp, maxulp=1)
        np.testing.assert_array_max_ulp(tm.numpy(), np.asarray(wm), maxulp=1)
        np.testing.assert_array_max_ulp(tv.numpy(), np.asarray(wv), maxulp=1)

    def test_decay_applies_before_the_update_and_by_name(self):
        # a zero gradient leaves only the decoupled decay p * (1 - lr wd)
        # on the parameters apply_decay_param_fun selects
        a = torch.nn.Parameter(torch.ones(4))
        b = torch.nn.Parameter(torch.ones(4))
        opt = AdamW(0.1, parameters=[("w.decay", a), ("w.keep", b)],
                    weight_decay=0.5,
                    apply_decay_param_fun=lambda n: n.endswith("decay"))
        a.grad, b.grad = torch.zeros(4), torch.zeros(4)
        opt.step()
        assert torch.equal(a.detach(), torch.full((4,), np.float32(0.95)))
        assert torch.equal(b.detach(), torch.ones(4))
        opt.clear_grad()
        assert a.grad is None and opt.get_lr() == 0.1

    def test_unported_options_raise(self):
        # lr_ratio and per-group options are taken and ignored, with a
        # warning, as the JAX package ignores them
        # (test_torch_optimizer_state.py holds the updates to it); a
        # learning rate must be a number or an LRScheduler
        p = [torch.nn.Parameter(torch.ones(2))]
        with pytest.warns(UserWarning, match="lr_ratio"):
            AdamW(parameters=p, lr_ratio=lambda p: 1.0)
        with pytest.warns(UserWarning, match="learning_rate"):
            AdamW(parameters=[{"params": p, "learning_rate": 0.5}])
        with pytest.raises(TypeError, match="learning_rate"):
            AdamW(parameters=p, learning_rate=object())


# ---------------------------------------------------------------------------
# launch names, no fallback off the CPU
# ---------------------------------------------------------------------------

class TestKernelPath:
    def test_launch_names(self):
        assert rope.KERNEL == "rope"
        assert (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV) == (
            "flash_attention_fwd", "flash_attention_fwd_lse",
            "flash_attention_bwd_dq", "flash_attention_bwd_dkv")

    def test_cpu_tensors_launch_nothing(self):
        launches.reset()
        q, k, v, g = _attn_operands(1, 2, 1, 8, 8, 8, 7)
        qt = t(q, True)
        fa.flash_attention_bhtd(qt, t(k), t(v), True).backward(t(g))
        x = torch.ones(1, 4, 2, 8, requires_grad=True)
        cos, sin = (t(a) for a in rope_tables(8, 4))
        rope.fused_rope(x, cos, sin).sum().backward()
        assert launches.snapshot() == {}

    def test_launch_counter_counts_per_name(self):
        c = _build.LaunchCounter()
        for name in (fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DQ):
            c.add(name)
        assert c.snapshot() == {fa.FWD_LSE: 1, fa.BWD_DQ: 2}

    @pytest.mark.parametrize("grad", [False, True])
    def test_non_cpu_tensors_never_take_the_plain_version(self, grad):
        # a tensor that is not on the CPU goes to the kernel path, which
        # refuses anything but CUDA tensors, forward and backward alike
        q = torch.empty(1, 2, 8, 64, device="meta", requires_grad=grad)
        k = torch.empty(1, 1, 8, 64, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_bhtd(q, k, k, True)
        x = torch.empty(1, 8, 2, 64, device="meta", requires_grad=grad)
        tab = torch.empty(8, 32, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            rope.fused_rope(x, tab, tab)
        w = torch.empty(64, device="meta", requires_grad=grad)
        with pytest.raises(ValueError, match="CUDA"):
            rms_norm.rms_norm(x, w, 1e-5)
