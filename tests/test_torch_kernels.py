"""The port's kernels (paddle_tpu_torch/kernels) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; every case here
feeds the same numpy inputs to it and to the JAX function, both through
the JAX function's XLA fallback and through its Pallas kernel in
interpret mode (``use_pallas=True, interpret=True``), and holds them to
1e-5 (f32; the two frameworks sum in different orders).

Each CUDA kernel is held against its plain version on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.chunked_prefill import fused_chunked_attention
from paddle_tpu.kernels.fused_norm_linear import (fused_norm_linear as
                                                  jax_fused_norm_linear)
from paddle_tpu.kernels.fused_norm_linear import rms_scale as jax_rms_scale
from paddle_tpu.kernels.paged_attention import (fused_paged_decode as
                                                jax_fused_paged_decode)
from paddle_tpu.kernels.rms_norm import _rms_ref
from paddle_tpu.kernels.rms_norm import rms_norm as jax_rms_norm
from paddle_tpu_torch.kernels import (_build, chunked_prefill,
                                      fused_norm_linear, paged_attention,
                                      rms_norm)
from paddle_tpu_torch.models.llama import PagedKVCache, _scatter_chunk
from torch_jax_steps import jax_chunk_write
from torch_operands import chunk_operands, decode_operands

TOL = 1e-5      # f32, same math, different summation order


@pytest.fixture(autouse=True)
def _int_cost_estimates(monkeypatch):
    """The JAX kernels pass float flop counts to ``pl.CostEstimate``,
    which newer JAX releases refuse; round them for the duration of a
    test so the Pallas kernels still run in interpret mode.  Nothing of
    the kernels' math is touched."""
    from jax.experimental import pallas as pl

    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# rms_norm
# ---------------------------------------------------------------------------

class TestRmsNorm:
    @pytest.mark.parametrize("shape", [(4, 64), (2, 3, 32), (512, 16)])
    def test_plain_matches_jax(self, shape):
        rng = np.random.RandomState(0)
        x = (rng.randn(*shape) * 3).astype(np.float32)
        w = (1 + 0.1 * rng.randn(shape[-1])).astype(np.float32)
        got = rms_norm.rms_norm(t(x), t(w), 1e-5).numpy()
        close(got, _rms_ref(jnp.asarray(x), jnp.asarray(w), 1e-5))
        close(got, jax_rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                interpret=True))

    def test_keeps_llama_cast_points_in_bf16(self):
        # rounds the normalized row to bf16 BEFORE the weight multiply,
        # as LlamaRMSNorm does (the TPU kernel multiplies in f32 first)
        rng = np.random.RandomState(1)
        x = torch.from_numpy(rng.randn(8, 64).astype(np.float32)).bfloat16()
        w = torch.from_numpy(
            (1 + 0.3 * rng.randn(64)).astype(np.float32)).bfloat16()
        xf = x.float()
        normed = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True)
                                   + 1e-6)).bfloat16()
        assert torch.equal(rms_norm.rms_norm(x, w, 1e-6), normed * w)


# ---------------------------------------------------------------------------
# fused_norm_linear
# ---------------------------------------------------------------------------

class TestFusedNormLinear:
    @pytest.mark.parametrize("act", ["none", "silu"])
    @pytest.mark.parametrize("M,K,N", [(8, 16, 32), (32, 64, 48),
                                       (3, 24, 40)])
    def test_plain_matches_jax(self, act, M, K, N):
        rng = np.random.RandomState(M + K + N)
        x = rng.randn(M, K).astype(np.float32)
        nw = rng.randn(K).astype(np.float32)
        w = rng.randn(K, N).astype(np.float32)
        rs = fused_norm_linear.rms_scale(t(x), 1e-5)
        close(rs.numpy(), jax_rms_scale(jnp.asarray(x), 1e-5))
        got = fused_norm_linear.fused_norm_linear(t(x), rs, t(nw), t(w),
                                                  act).numpy()
        jx, jrs = jnp.asarray(x), jnp.asarray(rs.numpy())
        close(got, jax_fused_norm_linear(jx, jrs, jnp.asarray(nw),
                                         jnp.asarray(w), act,
                                         use_pallas=False))
        # the Pallas kernel with several tiles along every axis
        close(got, jax_fused_norm_linear(
            jx, jrs, jnp.asarray(nw), jnp.asarray(w), act,
            bm=min(M, 8) if M % 8 == 0 else M, bn=8 if N % 8 == 0 else N,
            bk=8 if K % 8 == 0 else K, use_pallas=True, interpret=True))

    def test_leading_dims_and_shared_row_scale(self):
        rng = np.random.RandomState(3)
        x = t(rng.randn(2, 5, 16).astype(np.float32))
        nw = t(rng.randn(16).astype(np.float32))
        rs = fused_norm_linear.rms_scale(x, 1e-6)
        for n in (8, 24):
            w = t(rng.randn(16, n).astype(np.float32))
            out = fused_norm_linear.fused_norm_linear(x, rs, nw, w)
            assert out.shape == (2, 5, n)
            flat = fused_norm_linear.fused_norm_linear(
                x.reshape(10, 16), rs.reshape(10, 1), nw, w)
            assert torch.equal(out.reshape(10, n), flat)

    def test_bad_activation_rejected(self):
        with pytest.raises(ValueError, match="activation"):
            fused_norm_linear.fused_norm_linear(
                torch.zeros(4, 8), torch.ones(4, 1), torch.ones(8),
                torch.zeros(8, 8), activation="gelu")

    def test_kernel_choice_by_rows(self):
        assert fused_norm_linear.kernel_name(8) == "fused_norm_linear_skinny"
        assert fused_norm_linear.kernel_name(9) == "fused_norm_linear_tiled"

    @pytest.mark.parametrize("N,K,elem,splits", [
        (1024, 4096, 2, 64),     # 4 strips of 256 bf16 columns
        (4096, 4096, 2, 32), (14336, 4096, 2, 8),
        (128, 64, 4, 1),         # too few rows of w to split
        (32, 1000, 4, 8)])       # 125 rows a block; 16 would give 62
    def test_skinny_splits(self, N, K, elem, splits):
        assert fused_norm_linear.skinny_splits(N, K, elem, 132) == splits


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _check_decode(args, num_splits):
    got, kp, vp = paged_attention.fused_paged_decode(
        *[t(a) for a in args], num_splits=num_splits)
    for use_pallas in (False, True):
        want, wkp, wvp = jax_fused_paged_decode(
            *[jnp.asarray(a) for a in args], num_splits=num_splits,
            use_pallas=use_pallas, interpret=True)
        close(got.numpy(), want)
        close(kp.numpy(), wkp)
        close(vp.numpy(), wvp)
    return got


class TestPagedDecode:
    @pytest.mark.parametrize("num_splits", [1, 2, 4])
    def test_gqa_matches_jax(self, num_splits):
        _check_decode(decode_operands(), num_splits)

    def test_mha_matches_jax(self):
        _check_decode(decode_operands(KVH=4, rep=1, seed=4), 2)

    @pytest.mark.parametrize("positions", [[30, 29], [1, 2]])
    def test_fully_masked_splits_match_jax(self, positions):
        # frontiers near the start leave whole splits masked; near the
        # end every split contributes
        args = decode_operands(nbs=8, seed=2)
        args[6] = np.array(positions, np.int32)
        for s in (4, 8):
            _check_decode(args, s)

    @pytest.mark.parametrize("positions", [[63, 64], [65, 127], [0, 100]])
    def test_frontiers_straddling_the_cuda_chunks_match_jax(self, positions):
        # the CUDA kernel cuts each sequence's live keys into chunks of
        # CHUNK_KEYS (64); the plain version, which the card's tests hold
        # it to, is held to the JAX kernels at those edges
        args = decode_operands(bs=16, nbs=8, seed=6)
        args[6] = np.array(positions, np.int32)
        _check_decode(args, 2)

    def test_garbage_block_zero_never_leaks(self):
        out = _check_decode(decode_operands(seed=1), 2)
        assert float(out.abs().max()) < 50.0

    def test_idle_slot_decodes_against_block_zero(self):
        # an idle engine slot: whole table on block 0, frontier 0
        args = decode_operands(seed=5)
        args[5][1] = 0
        args[6][1] = 0
        _check_decode(args, 2)

    def test_multi_token_rejected(self):
        args = [t(a) for a in decode_operands()]
        args[0] = torch.zeros(2, 2, 4, 8)
        with pytest.raises(ValueError, match="single-token"):
            paged_attention.fused_paged_decode(*args)

    def test_default_splits_match_jax(self):
        from paddle_tpu.kernels.paged_attention import _default_splits

        for nbs in (1, 2, 3, 4, 8, 16, 512):
            assert paged_attention._default_splits(nbs) == \
                _default_splits(nbs)


# ---------------------------------------------------------------------------
# chunked prefill
# ---------------------------------------------------------------------------

def _check_chunk(args):
    got = chunked_prefill.chunked_attention(*[t(a) for a in args]).numpy()
    for use_pallas in (False, True):
        close(got, fused_chunked_attention(
            *[jnp.asarray(a) for a in args], use_pallas=use_pallas,
            interpret=True))
    return got


class TestChunkedPrefill:
    def test_gqa_matches_jax(self):
        _check_chunk(chunk_operands())

    def test_mha_matches_jax(self):
        _check_chunk(chunk_operands(KVH=4, rep=1, seed=1))

    def test_padded_tail_and_unused_table_entries(self):
        # the chunk runs past the sequence's allocated blocks: table
        # entries past them point at the poisoned block 0, as the engine
        # leaves them
        args = chunk_operands(B=1, T=8, nbs=6, seed=2)
        args[3][0, 3:] = 0
        args[4] = np.array([5], np.int32)
        got = _check_chunk(args)
        # rows whose keys stay in real blocks never see the poison
        assert np.abs(got[0, :7]).max() < 50.0

    @pytest.mark.parametrize("positions", [[63, 64], [65, 15], [0, 127]])
    def test_frontiers_straddling_the_cuda_tiles_match_jax(self, positions):
        # the bf16 CUDA kernel loads keys in tiles of 64 (pages of 16 as
        # whole TMA boxes) and packs rows t * rep + r in tiles of 64
        # (tokens 0-31 and 32-39 here); the plain version, which the
        # card's tests hold it to, is held to the JAX kernels at those
        # edges
        assert not chunked_prefill.copy_producer(16)
        args = chunk_operands(T=40, bs=16, nbs=12, seed=7)
        args[4] = np.array(positions, np.int32)
        _check_chunk(args)


# ---------------------------------------------------------------------------
# the KV write into f32 and bf16 pools (kv_quant.kv_write)
# ---------------------------------------------------------------------------

def _as(a, dtype):
    """numpy f32 -> (numpy of dtype, torch tensor of the same bits)."""
    if dtype == "float32":
        return a, t(a)
    b = a.astype(ml_dtypes.bfloat16)
    return b, torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype == ml_dtypes.bfloat16 else np.int32)


def _torch_bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32) \
        .numpy()


class TestKVWrite:
    @pytest.mark.parametrize("positions", [[3, 4], [5, 7], [8, 16],
                                           [0, 17]])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_decode_pools_match_jax(self, dtype, positions):
        # fused_paged_decode's write (k rotated in f32 and rounded once,
        # then v and k at their rows) bit for bit against the JAX
        # function's returned pools; block size 4, 4 blocks a table:
        # page edges -1, 0 and +1, and positions 16 and 17, past the
        # table's width (the column clamp)
        args = decode_operands(nbs=4, seed=9)
        args[6] = np.array(positions, np.int32)
        args[7] = np.concatenate([args[7], args[7][-1:]])   # row 17
        args[8] = np.concatenate([args[8], args[8][-1:]])
        ops = [args[i] if i in (5, 6) else _as(args[i], dtype)[0]
               for i in range(9)]
        got = paged_attention.fused_paged_decode(
            *[t(a) if i in (5, 6) else _as(args[i], dtype)[1]
              for i, a in enumerate(args)], num_splits=2)
        want = jax_fused_paged_decode(*[jnp.asarray(a) for a in ops],
                                      num_splits=2, use_pallas=False)
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_torch_bits(g), _bits(w))

    @pytest.mark.parametrize("positions", [[0, 15], [3, 12]])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_chunk_pools_match_jax(self, dtype, positions):
        """``_scatter_chunk`` of f32 / bf16 pools against the pools a JAX
        prefill chunk step returns (the reference's ``LlamaAttention``
        forward with a paged cache and a write mask, which writes through
        ``_scatter``): chunks across page edges, a padded tail, masked
        positions past the table's width."""
        rng = np.random.RandomState(10)
        B, T, KVH, D, bs, nbs = 2, 6, 2, 8, 4, 5
        nb = 1 + B * nbs
        pools = [_as(rng.randn(nb, bs, KVH, D).astype(np.float32), dtype)
                 for _ in range(2)]
        new = [_as(rng.randn(B, T, KVH, D).astype(np.float32), dtype)
               for _ in range(2)]
        bt = (1 + np.arange(B * nbs)).reshape(B, nbs).astype(np.int32)
        positions = np.array(positions, np.int32)
        wmask = np.ones((B, T), bool)
        wmask[1, 4:] = False

        cache = PagedKVCache(pools[0][1].clone(), pools[1][1].clone(),
                             t(bt))
        _scatter_chunk(cache, new[0][1], new[1][1], t(positions), t(wmask))
        want = jax_chunk_write(pools[0][0], pools[1][0], new[0][0],
                               new[1][0], bt, positions, wmask)
        for got, w, (x, _) in zip((cache.k, cache.v), want, new):
            w = _bits(w)
            # row 0 of the garbage block takes both padded writes: which
            # one lands there is unspecified in both frameworks
            np.testing.assert_array_equal(_torch_bits(got)[1:], w[1:])
            np.testing.assert_array_equal(_torch_bits(got)[0, 1:], w[0, 1:])
            assert any(np.array_equal(_torch_bits(got)[0, 0],
                                      _bits(x)[1, j]) for j in (4, 5))


# ---------------------------------------------------------------------------
# no fallback off the CPU
# ---------------------------------------------------------------------------

class TestNoFallback:
    def test_non_cpu_tensor_never_takes_the_plain_version(self):
        # a tensor that is not on the CPU goes to the kernel path, which
        # refuses anything but contiguous CUDA tensors
        x = torch.empty(4, 8, device="meta")
        w = torch.empty(8, device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            rms_norm.rms_norm(x, w, 1e-5)

    def test_launch_counter(self):
        c = _build.LaunchCounter()
        c.add("k")
        c.add("k")
        assert c.snapshot() == {"k": 2}
        c.reset()
        assert c.snapshot() == {}
