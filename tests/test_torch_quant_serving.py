"""Quantized serving in the port (int8 / fp8 KV pools, int8 weights)
against the JAX package, on the CPU.

- the codec (``kernels/kv_quant``): codes and scales bit-identical to the
  JAX ``kv_quant`` for both schemes, zero rows, +-qmax and rounding ties
  included;
- the quantize-at-write scatter bit-identical to the JAX writes
  (``_scatter_token_quant``, and ``_scatter_q`` of a padded chunk);
- the plain quantized decode and chunk attention against the JAX
  ``fused_paged_decode`` / ``fused_chunked_attention`` with
  ``kv_cache_dtype``, through their XLA versions and their Pallas kernels
  in interpret mode: outputs within 1e-5 (f32, the two frameworks sum in
  different orders), returned pools and scales bit-identical;
- the pool's byte accounting, hash namespaces and copy-on-write;
- the ``Engine`` against the JAX ``Engine`` (fused steps) on the tiny
  f32 Llama: identical greedy tokens, equal counters, no leak, with the
  prefix cache and with forced preemption; ``kv_pool_bytes`` sizing;
- ``quantize_model_weights``: codes, scales, weights and report
  identical to the JAX package's, and identical tokens.

The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import kv_quant as jkv
from paddle_tpu.kernels.chunked_prefill import fused_chunked_attention
from paddle_tpu.kernels.paged_attention import (_scatter_token_quant,
                                                fused_paged_decode as
                                                jax_fused_paged_decode)
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.quantization.serving import (quantize_model_weights as
                                             jax_quantize_model_weights)
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving.cache import BlockKVPool as JaxBlockKVPool
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.kernels import chunked_prefill
from paddle_tpu_torch.kernels import kv_quant as tkv
from paddle_tpu_torch.kernels import paged_attention
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.llama import PagedKVCache, _scatter_chunk
from paddle_tpu_torch.quantization import serving as tqs
from paddle_tpu_torch.serving import Engine, ServingConfig
from paddle_tpu_torch.serving.cache import BlockKVPool
from torch_operands import chunk_operands, decode_operands

TOL = 1e-5
SCHEMES = ["int8", "fp8"]
COUNTERS = ("requests_completed", "preemptions", "prefix_cache_hits",
            "prefix_cache_misses", "prefill_chunks", "decode_iterations",
            "tokens_generated")


@pytest.fixture(autouse=True)
def _int_cost_estimates(monkeypatch):
    """As in tests/test_torch_kernels.py: newer JAX refuses the float
    flop counts the JAX kernels give ``pl.CostEstimate``; round them so
    the Pallas kernels run in interpret mode.  The math is untouched."""
    from jax.experimental import pallas as pl

    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))


def t(a):
    return torch.from_numpy(np.array(a))


def same(got, want):
    """Bit-identical (codes, scales)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _quantize_jax(x, scheme):
    codes, scale = jkv.quantize_kv(jnp.asarray(x), scheme)
    return np.asarray(codes), np.asarray(scale)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

def _codec_rows(scheme):
    """[rows, KVH=2, D=8] f32 rows: random at several magnitudes, an
    all-zero row, a row holding +-absmax, rows of exact rounding ties,
    and subnormal-scale values."""
    rng = np.random.RandomState(3)
    qmax = jkv.KV_QMAX[scheme]
    rows = [rng.randn(2, 8) * m for m in (1e-3, 0.7, 3.0, 250.0)]
    rows.append(np.zeros((2, 8)))
    r = rng.randn(2, 8)
    r[0, 0], r[1, 7] = 5.0, -5.0                   # codes +qmax and -qmax
    rows.append(r)
    # absmax == qmax gives scale 1.0 exactly, so x / scale is x and these
    # values sit exactly halfway between two codes
    if scheme == "int8":
        ties = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    else:   # e4m3 halfway points: 1 + 2^-4, 17, 200, 3.125, and half
        # the smallest subnormal
        ties = [1.0625, 17.0, 200.0, -1.0625, -17.0, 2.0 ** -10, 3.125,
                -3.125]
    tie_row = np.zeros((2, 8))
    tie_row[0] = ties
    tie_row[1, 0] = qmax
    rows.append(tie_row)
    rows.append(rng.randn(2, 8) * 1e-30)           # tiny, nonzero scale
    return np.stack(rows).astype(np.float32)


class TestCodec:
    def test_resolve_aliases_match_jax(self):
        for name in (None, "", "fp32", "float32", "auto", "int8", "I8",
                     "fp8", "fp8_e4m3", "float8_e4m3fn"):
            assert tkv.resolve_kv_cache_dtype(name) == \
                jkv.resolve_kv_cache_dtype(name)
        with pytest.raises(ValueError, match="kv_cache_dtype"):
            tkv.resolve_kv_cache_dtype("int3")

    def test_constants_match_jax(self):
        assert tkv.KV_SCHEMES == jkv.KV_SCHEMES
        assert tkv.KV_QMAX == jkv.KV_QMAX
        assert tkv.KV_DTYPE_CODES == jkv.KV_DTYPE_CODES
        for scheme in (None, "int8", "fp8"):
            assert tkv.kv_scale_bytes_per_block(16, scheme) == \
                jkv.kv_scale_bytes_per_block(16, scheme)
            for tdt, jdt in ((torch.float32, jnp.float32),
                             (torch.bfloat16, jnp.bfloat16)):
                assert tkv.kv_bytes_per_element(scheme, tdt) == \
                    jkv.kv_bytes_per_element(scheme, jdt)

    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_quantize_is_bit_identical(self, scheme):
        x = _codec_rows(scheme)
        codes, scale = tkv.quantize_kv(t(x), scheme)
        want_codes, want_scale = _quantize_jax(x, scheme)
        same(codes.numpy(), want_codes)
        same(scale.numpy(), want_scale)
        assert scale[4] == 1.0                      # the zero row
        assert int(codes[5].max()) == int(want_codes[5].max())
        # ties round half to even in both
        if scheme == "int8":
            assert codes[6, 0].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
        else:
            assert tkv.decode_codes(codes[6, 0], scheme).tolist() == \
                [1.0, 16.0, 192.0, -1.0, -16.0, 0.0, 3.0, -3.0]

    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_bf16_rows_are_bit_identical(self, scheme):
        x = _codec_rows(scheme)
        codes, scale = tkv.quantize_kv(t(x).bfloat16(), scheme)
        want_codes, want_scale = _quantize_jax(
            x.astype(ml_dtypes.bfloat16), scheme)
        same(codes.numpy(), want_codes)
        same(scale.numpy(), want_scale)

    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_decode_and_dequantize_are_bit_identical(self, scheme):
        codes = np.arange(-128, 128, dtype=np.int8)
        if scheme == "fp8":     # 0x7F and 0xFF are e4m3fn's NaNs
            codes = codes[(codes != 127) & (codes != -1)]
        same(tkv.decode_codes(t(codes), scheme).numpy(),
             np.asarray(jkv.decode_codes(jnp.asarray(codes), scheme)))
        c = codes[:96].reshape(6, 2, 8)
        s = np.random.RandomState(0).rand(6).astype(np.float32) + 0.1
        same(tkv.dequantize_kv(t(c), t(s), scheme).numpy(),
             np.asarray(jkv.dequantize_kv(jnp.asarray(c), jnp.asarray(s),
                                          scheme)))


# ---------------------------------------------------------------------------
# quantize-at-write scatter
# ---------------------------------------------------------------------------

def _quant_pools(k_pool, v_pool, scheme):
    """numpy (codes, scales) of float pools [nb, bs, KVH, D]."""
    kc, ks = _quantize_jax(k_pool, scheme)
    vc, vs = _quantize_jax(v_pool, scheme)
    return kc, vc, ks, vs


class TestScatter:
    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_decode_token_matches_scatter_token_quant(self, scheme):
        args = decode_operands(B=3, nbs=4, seed=8)
        args[6] = np.array([5, 0, 14], np.int32)
        kc, vc, ks, vs = _quant_pools(args[3], args[4], scheme)
        k_new, v_new = args[1][:, 0], args[2][:, 0]
        bt, pos = args[5], args[6]
        tpools = [t(a) for a in (kc, vc, ks, vs)]
        rows = paged_attention._token_rows(t(bt), t(pos).long(),
                                           kc.shape[1])
        tkv.quantize_scatter(*tpools, t(k_new), t(v_new), rows, scheme)
        for pool, sc, new, got_pool, got_sc in (
                (kc, ks, k_new, tpools[0], tpools[2]),
                (vc, vs, v_new, tpools[1], tpools[3])):
            want_pool, want_sc = _scatter_token_quant(
                jnp.asarray(pool), jnp.asarray(sc), jnp.asarray(new),
                jnp.asarray(bt), jnp.asarray(pos), scheme)
            same(got_pool.numpy(), want_pool)
            same(got_sc.numpy(), want_sc)

    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_padded_chunk_matches_scatter_q(self, scheme):
        """``_scatter_chunk`` of a quantized cache against the reference's
        chunk write (``models/llama.py`` ``_scatter_q``, restated here
        line for line: it is a closure inside the JAX forward)."""
        rng = np.random.RandomState(9)
        B, T, KVH, D, bs, nbs = 2, 6, 2, 8, 4, 5
        nb = 1 + B * nbs
        kc, vc, ks, vs = _quant_pools(
            rng.randn(nb, bs, KVH, D).astype(np.float32),
            rng.randn(nb, bs, KVH, D).astype(np.float32), scheme)
        k = rng.randn(B, T, KVH, D).astype(np.float32)
        v = rng.randn(B, T, KVH, D).astype(np.float32)
        bt = (1 + np.arange(B * nbs)).reshape(B, nbs).astype(np.int32)
        positions = np.array([0, 15], np.int32)
        wmask = np.ones((B, T), bool)
        wmask[1, 4:] = False            # a padded tail

        def scatter_q(pool, scales, new):
            pos = jnp.asarray(positions)[:, None] + jnp.arange(T)
            rows = jnp.arange(B)[:, None]
            col = jnp.minimum(pos // bs, nbs - 1)
            idx = jnp.asarray(bt)[rows, col] * bs + pos % bs
            idx = jnp.where(jnp.asarray(wmask), idx, 0)
            codes, sc = jkv.quantize_kv(jnp.asarray(new), scheme)
            flat = jnp.asarray(pool).reshape(nb * bs, KVH, D)
            flat = flat.at[idx.reshape(-1)].set(codes.reshape(-1, KVH, D))
            sflat = jnp.asarray(scales).reshape(nb * bs).at[
                idx.reshape(-1)].set(sc.reshape(-1))
            return flat.reshape(pool.shape), sflat.reshape(scales.shape)

        cache = PagedKVCache(t(kc), t(vc), t(bt), t(ks), t(vs), scheme)
        _scatter_chunk(cache, t(k), t(v), t(positions), t(wmask))
        for got_pool, got_sc, pool, sc, new in (
                (cache.k, cache.k_scale, kc, ks, k),
                (cache.v, cache.v_scale, vc, vs, v)):
            want_pool, want_sc = scatter_q(pool, sc, new)
            # row 0 of the garbage block takes both padded writes: which
            # one lands there is unspecified in both frameworks
            same(got_pool[1:].numpy(), np.asarray(want_pool)[1:])
            same(got_sc[1:].numpy(), np.asarray(want_sc)[1:])
            same(got_pool[0, 1:].numpy(), np.asarray(want_pool)[0, 1:])


# ---------------------------------------------------------------------------
# quantized attention, plain versions against the JAX functions
# ---------------------------------------------------------------------------

def _check_decode(args, scheme, num_splits):
    kc, vc, ks, vs = _quant_pools(args[3], args[4], scheme)
    ops = [args[0], args[1], args[2], kc, vc, *args[5:]]
    got = paged_attention.fused_paged_decode(
        *[t(a) for a in ops], num_splits=num_splits, k_scale=t(ks),
        v_scale=t(vs), kv_cache_dtype=scheme)
    assert len(got) == 5
    for use_pallas in (False, True):
        want = jax_fused_paged_decode(
            *[jnp.asarray(a) for a in ops], num_splits=num_splits,
            use_pallas=use_pallas, interpret=True, k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs), kv_cache_dtype=scheme)
        close(got[0].numpy(), want[0])
        for g, w in zip(got[1:], want[1:]):
            same(g.numpy(), w)
    return got[0]


def _check_chunk(args, scheme):
    kc, vc, ks, vs = _quant_pools(args[1], args[2], scheme)
    ops = [args[0], kc, vc, args[3], args[4]]
    got = chunked_prefill.chunked_attention(
        *[t(a) for a in ops], t(ks), t(vs), scheme).numpy()
    for use_pallas in (False, True):
        close(got, fused_chunked_attention(
            *[jnp.asarray(a) for a in ops], use_pallas=use_pallas,
            interpret=True, k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs), kv_cache_dtype=scheme))
    return got


class TestQuantizedDecode:
    @pytest.mark.parametrize("num_splits", [1, 2, 4])
    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_gqa_matches_jax(self, scheme, num_splits):
        _check_decode(decode_operands(), scheme, num_splits)

    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_mha_and_masked_splits_match_jax(self, scheme):
        _check_decode(decode_operands(KVH=4, rep=1, seed=4), scheme, 2)
        args = decode_operands(nbs=8, seed=2)
        args[6] = np.array([1, 2], np.int32)
        _check_decode(args, scheme, 8)

    @pytest.mark.parametrize("positions", [[63, 64], [65, 127]])
    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_frontiers_straddling_the_cuda_chunks_match_jax(self, scheme,
                                                            positions):
        # the edges of the CUDA kernel's 64-key chunks (CHUNK_KEYS)
        args = decode_operands(bs=16, nbs=8, seed=6)
        args[6] = np.array(positions, np.int32)
        _check_decode(args, scheme, 2)

    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_idle_slot_decodes_against_block_zero(self, scheme):
        args = decode_operands(seed=5)
        args[5][1] = 0
        args[6][1] = 0
        out = _check_decode(args, scheme, 2)
        assert float(out[0].abs().max()) < 50.0


class TestQuantizedChunk:
    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_gqa_and_mha_match_jax(self, scheme):
        _check_chunk(chunk_operands(), scheme)
        _check_chunk(chunk_operands(KVH=4, rep=1, seed=1), scheme)

    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_padded_tail_and_unused_table_entries(self, scheme):
        args = chunk_operands(B=1, T=8, nbs=6, seed=2)
        args[3][0, 3:] = 0
        args[4] = np.array([5], np.int32)
        got = _check_chunk(args, scheme)
        assert np.abs(got[0, :7]).max() < 50.0


# ---------------------------------------------------------------------------
# the pool
# ---------------------------------------------------------------------------

class TestQuantizedPool:
    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_block_bytes_match_jax(self, scheme, dtype):
        want = JaxBlockKVPool.block_bytes_for(2, 8, 2, 16, dtype, scheme)
        assert BlockKVPool.block_bytes_for(
            2, 8, 2, 16, getattr(torch, dtype), scheme) == want
        pool = BlockKVPool(2, 16, 8, 2, 16, getattr(torch, dtype),
                           kv_cache_dtype=scheme)
        jpool = JaxBlockKVPool(2, 16, 8, 2, 16, dtype,
                               kv_cache_dtype=scheme)
        assert pool.stats() == jpool.stats()
        assert pool.capacity_bytes() == want * 15
        pool.allocate("r", 3)
        jpool.allocate("r", 3)
        assert pool.stats() == jpool.stats()

    def test_entries_carry_scales(self):
        pool = BlockKVPool(2, 16, 8, 2, 16, torch.bfloat16,
                           kv_cache_dtype="fp8")
        for k, v, ks, vs in pool.layers:
            assert k.dtype == v.dtype == torch.int8
            assert ks.shape == vs.shape == (16, 8)
            assert bool((ks == 1.0).all()) and ks.dtype == torch.float32
        assert len(BlockKVPool(2, 16, 8, 2, 16).layers[0]) == 2

    def test_hash_chains_match_jax_and_are_disjoint_across_dtypes(self):
        prompt = np.arange(1, 33, dtype=np.int32)
        chains = {}
        for scheme in (None, "int8", "fp8"):
            got = BlockKVPool(2, 16, 8, 2, 16, torch.float32,
                              kv_cache_dtype=scheme).hash_chain(prompt)
            assert got == JaxBlockKVPool(
                2, 16, 8, 2, 16, "float32",
                kv_cache_dtype=scheme).hash_chain(prompt)
            chains[scheme] = set(got)
        assert len(chains[None]) == 4
        for a in chains:
            for b in chains:
                if a != b:
                    assert not chains[a] & chains[b]

    def test_copy_on_write_carries_the_scale_rows(self):
        pool = BlockKVPool(2, 8, 4, 2, 8, torch.float32,
                           kv_cache_dtype="int8")
        rng = np.random.RandomState(1)
        (b,) = pool.allocate("a", 1)
        for entry in pool.layers:
            entry[0][b] = t(rng.randint(-127, 128, (4, 2, 8)).astype(np.int8))
            entry[1][b] = t(rng.randint(-127, 128, (4, 2, 8)).astype(np.int8))
            entry[2][b] = t(rng.rand(4).astype(np.float32))
            entry[3][b] = t(rng.rand(4).astype(np.float32))
        pool.register_prefix("a", np.arange(4), [b])
        pool.acquire("b", [b])
        new = pool.ensure_writable("b", b)
        assert new != b and pool.cow_copies == 1
        for entry in pool.layers:
            for x in entry:
                assert torch.equal(x[new], x[b])


# ---------------------------------------------------------------------------
# the engine against the JAX engine
# ---------------------------------------------------------------------------

def _jax_model():
    paddle.seed(0)
    m = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    m.eval()
    return m


def _port_model(jax_model):
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()
             if not k.endswith(("weight_int8", "weight_scale"))}
    return from_jax_state_dict(named, LlamaConfig.tiny(), device="cpu")


@pytest.fixture(scope="module")
def models():
    jax_model = _jax_model()
    return jax_model, _port_model(jax_model)


def _prompts():
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 256, size=20)
    return [np.concatenate([prefix, rng.randint(1, 256, size=5)]),
            rng.randint(1, 256, size=13), rng.randint(1, 256, size=3),
            rng.randint(1, 256, size=30),
            np.concatenate([prefix, rng.randint(1, 256, size=9)])]


def _serve(engine, prompts, new_tokens=12):
    """As tests/test_torch_serving.py: the last prompt shares the first's
    prefix and is submitted once that prefix is registered."""
    reqs = [engine.submit(p, max_new_tokens=new_tokens) for p in prompts[:-1]]
    while not reqs[0].generated:
        engine.step()
    reqs.append(engine.submit(prompts[-1], max_new_tokens=new_tokens))
    engine.run_until_complete()
    engine.pool.check_leaks()
    st = engine.stats()
    return ([[int(x) for x in r.generated] for r in reqs],
            {k: st["counters"][k] for k in COUNTERS},
            {k: st["gauges"][k] for k in ("serving_kv_cache_dtype",
                                          "kv_quant_scale_bytes")},
            st["pool"])


def _both(jax_model, model, **config):
    out = []
    for m, engine_cls, config_cls in ((jax_model, JaxEngine,
                                       JaxServingConfig),
                                      (model, Engine, ServingConfig)):
        engine = engine_cls(m, config_cls(
            max_batch_size=4, block_size=8, chunk_tokens=16,
            fused_kernels=True, **config))
        out.append(_serve(engine, _prompts()))
    return out


class TestEngineMatchesJax:
    @pytest.mark.parametrize("num_blocks,prefix_cache",
                             [(64, True), (12, True), (12, False)])
    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_greedy_tokens(self, models, scheme, num_blocks, prefix_cache):
        # 12 blocks: the pool runs dry mid-decode and the youngest
        # requests are preempted and recomputed
        (jtok, jctr, jg, jpool), (tok, ctr, g, pool) = _both(
            *models, num_blocks=num_blocks, kv_cache_dtype=scheme,
            enable_prefix_cache=prefix_cache)
        assert tok == jtok
        assert ctr == jctr and g == jg
        for key in ("kv_dtype", "block_bytes", "capacity_bytes",
                    "used_bytes", "cow_copies"):
            assert pool[key] == jpool[key], key
        assert ctr["requests_completed"] == 5
        assert (ctr["preemptions"] > 0) == (num_blocks == 12)
        assert (ctr["prefix_cache_hits"] > 0) == prefix_cache
        assert g == {"serving_kv_cache_dtype": tkv.KV_DTYPE_CODES[scheme],
                     "kv_quant_scale_bytes": 32}

    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    def test_kv_pool_bytes_derives_the_same_num_blocks(self, models,
                                                       scheme):
        budget = 16 * JaxBlockKVPool.block_bytes_for(2, 8, 2, 16, "float32",
                                                     None) + 100
        engines = [cls(m, cfg(block_size=8, num_blocks=None,
                              kv_pool_bytes=budget, kv_cache_dtype=scheme))
                   for m, cls, cfg in ((models[0], JaxEngine,
                                        JaxServingConfig),
                                       (models[1], Engine, ServingConfig))]
        assert engines[1].num_blocks == engines[0].num_blocks
        assert engines[1].pool.num_blocks == engines[1].num_blocks
        assert engines[1].pool.capacity_bytes() <= budget
        assert engines[1].num_blocks == (16 if scheme is None else 56)

    def test_kv_pool_bytes_too_small_raises(self, models):
        with pytest.raises(ValueError, match="kv_pool_bytes"):
            Engine(models[1], ServingConfig(kv_pool_bytes=1024))


# ---------------------------------------------------------------------------
# weight-only int8
# ---------------------------------------------------------------------------

class TestWeightQuant:
    def test_resolve_weight_dtype_matches_jax(self):
        from paddle_tpu.quantization.serving import resolve_weight_dtype

        for name in (None, "", "fp32", "auto", "int8", "I8", "w8",
                     "weight_int8"):
            assert tqs.resolve_weight_dtype(name) == \
                resolve_weight_dtype(name)
        with pytest.raises(ValueError, match="weight_dtype"):
            tqs.resolve_weight_dtype("int4")

    def test_codes_scales_weights_and_report_match_jax(self):
        jax_model = _jax_model()
        model = _port_model(jax_model)
        want = jax_quantize_model_weights(jax_model, "int8")
        got = tqs.quantize_model_weights(model, "int8")
        assert got == want
        assert got["layers"] == 7 * 2 + 1           # lm_head too
        jstate = {k: np.asarray(v.numpy())
                  for k, v in jax_model.state_dict().items()}
        names = [n for n, _ in model.named_buffers()
                 if n.endswith(("weight_int8", "weight_scale"))]
        assert len(names) == 2 * got["layers"]
        tstate = dict(model.state_dict())
        for name in names + [n.replace("weight_int8", "weight")
                             for n in names if n.endswith("weight_int8")]:
            same(tstate[name].detach().numpy(), jstate[name])

    def test_idempotent_and_irreversible(self, models):
        model = _port_model(models[0])
        rep = tqs.quantize_model_weights(model, "int8")
        w = model.lm_head.weight.detach().clone()
        assert tqs.quantize_model_weights(model, "w8") == rep
        assert torch.equal(model.lm_head.weight, w)
        with pytest.raises(ValueError, match="already quantized"):
            tqs.quantize_model_weights(model, None)

    @pytest.mark.parametrize("scheme", [None, "int8"])
    def test_engine_tokens_match_jax(self, scheme):
        jax_model = _jax_model()
        (jtok, jctr, _, _), (tok, ctr, _, _) = _both(
            jax_model, _port_model(jax_model), num_blocks=64,
            weight_dtype="int8", kv_cache_dtype=scheme)
        assert tok == jtok and ctr == jctr
