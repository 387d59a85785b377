"""The port's sampler (paddle_tpu_torch.serving.sampling) against the JAX
package's (paddle_tpu.serving.sampling) on the CPU.

Inputs come from seeds with numpy.  Tolerances:
- keys, fold-ins and uniform bits: bit-equal to ``jax.random``'s
  (integer arithmetic in both);
- Gumbel noise: within 4 f32 ulps of JAX's value or 1e-6, whichever is
  larger (the two ``log`` implementations round differently);
- ``filter_logits``: the same entries filtered, except entries whose
  cumulative probability lies within 1e-6 of ``top_p`` (the two
  frameworks sum the softmax in other orders), which are counted and
  bounded; the kept entries bit-equal;
- tokens: equal, greedy and sampled, over 64 counters.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from paddle_tpu.serving import sampling as jax_sampling
from paddle_tpu_torch.serving import sampling
from paddle_tpu_torch.serving.sampling import (SamplingParams, filter_logits,
                                               filtered_probs, fold_keys,
                                               gumbel, prng_key,
                                               resolve_sampling, sample_at,
                                               sample_tokens, uniform_bits)

SEEDS = (0, 1, 2 ** 31 - 1, -7)
COUNTERS = (0, 1, 2, 7, 255, 1000, 65536, 10 ** 6)
TINY = float(np.finfo(np.float32).tiny)
N, V = 16, 1000
# per-row (temperature, top_k, top_p): greedy rows, each filter alone and
# together, top-k 1, top-k past V, a narrow and a wide nucleus
LANES = ((0.0, 0, 1.0), (0.8, 0, 1.0), (1.0, 50, 1.0), (0.7, 0, 0.9),
         (0.8, 50, 0.95), (0.0, 5, 0.5), (1.3, 1000, 0.8), (1.0, 1, 1.0),
         (0.5, 3, 1.0), (2.0, 0, 0.3), (1.0, 2000, 0.99), (0.9, 10, 0.5),
         (1.0, 0, 1.0), (0.0, 0, 0.9), (1.5, 100, 1.0), (0.6, 0, 0.6))


def _lanes():
    temps = np.array([t for t, _, _ in LANES], np.float32)
    top_ks = np.array([k for _, k, _ in LANES], np.int32)
    top_ps = np.array([p for _, _, p in LANES], np.float32)
    return temps, top_ks, top_ps


def _logits(seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(N, V) * scale).astype(
        np.float32)


def _jax_keys(seeds):
    return np.stack([np.asarray(jax.random.PRNGKey(s))
                     for s in seeds]).astype(np.uint32)


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(
        np.int64 if np.asarray(a).dtype.kind in "iu" else np.float32))


class TestKeySchedule:
    @pytest.mark.parametrize("seed", SEEDS)
    def test_prng_key(self, seed):
        want = np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
        np.testing.assert_array_equal(prng_key(seed), want)
        np.testing.assert_array_equal(
            SamplingParams(temperature=1.0, seed=seed).base_key(),
            jax_sampling.SamplingParams(temperature=1.0,
                                        seed=seed).base_key())

    @pytest.mark.parametrize("seed", SEEDS)
    def test_fold_keys(self, seed):
        keys = np.repeat(_jax_keys([seed]), len(COUNTERS), axis=0)
        data = np.array(COUNTERS, np.int32)
        want = np.asarray(jax.vmap(jax.random.fold_in)(keys, data))
        got = fold_keys(_t(keys), _t(data)).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))
        # the reference's own vectorized fold, and a scalar counter
        np.testing.assert_array_equal(
            got, np.asarray(jax_sampling.fold_keys(keys, data)))
        np.testing.assert_array_equal(
            fold_keys(_t(keys[:1]), 5).numpy(),
            np.asarray(jax.random.fold_in(keys[0], 5))[None])

    @pytest.mark.parametrize("seed", SEEDS)
    def test_uniform_bits(self, seed):
        keys = np.asarray(jax.vmap(jax.random.fold_in)(
            np.repeat(_jax_keys([seed]), N, axis=0),
            np.arange(N, dtype=np.int32) * 7919))
        bits = uniform_bits(_t(keys), V).numpy()
        want = np.stack([np.asarray(jax.random.bits(k, (V,), jnp.uint32))
                         for k in keys])
        np.testing.assert_array_equal(bits, want.astype(np.int64))
        # the uniform the Gumbel noise is drawn from, bit for bit
        f = ((bits >> 9) | 0x3F800000).astype(np.int32).view(np.float32) - 1
        u = np.maximum(f * np.float32(1 - TINY) + np.float32(TINY),
                       np.float32(TINY))
        ju = np.stack([np.asarray(jax.random.uniform(k, (V,), minval=TINY))
                       for k in keys])
        np.testing.assert_array_equal(u.view(np.int32), ju.view(np.int32))

    def test_gumbel_within_4_ulps(self):
        keys = _jax_keys(range(N))
        want = np.stack([np.asarray(jax.random.gumbel(k, (V,)))
                         for k in keys])
        got = gumbel(_t(keys), V).numpy()
        tol = np.maximum(4 * np.spacing(np.abs(want)), 1e-6)
        assert np.all(np.abs(got - want) <= tol)
        assert np.isfinite(got).all()

    def test_no_torch_rng_state_is_used(self):
        temps, top_ks, top_ps = _lanes()
        before = torch.get_rng_state()
        sample_at(_t(_logits()), _t(temps), _t(top_ks), _t(top_ps),
                  _t(_jax_keys(range(N))), _t(np.arange(N)))
        assert torch.equal(before, torch.get_rng_state())


class TestFilter:
    @pytest.mark.parametrize("scale", [1.0, 3.0, 8.0])
    def test_filter_logits_masks(self, scale):
        logits = _logits(1, scale)
        temps, top_ks, top_ps = _lanes()
        want = np.asarray(jax_sampling.filter_logits(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(top_ps)))
        got = filter_logits(_t(logits), _t(temps), _t(top_ks),
                            _t(top_ps)).numpy()
        kept = ~np.isinf(want)
        differ = np.argwhere(np.isinf(got) != np.isinf(want))
        # each differing entry sits at its row's top-p boundary: the
        # probability (f64) of the entries above it within 1e-6 of top_p
        for row, col in differ:
            t, k, _ = LANES[row]
            scaled = np.float64(logits[row] / np.float32(t if t else 1.0))
            if k:
                scaled[scaled < np.sort(scaled)[::-1][min(k, V) - 1]] = \
                    -np.inf
            p = np.exp(scaled - scaled.max())
            before = p[scaled > scaled[col]].sum() / p.sum()
            assert abs(before - top_ps[row]) < 1e-6, (row, col, before)
        assert len(differ) <= 2
        both = kept & ~np.isinf(got)
        np.testing.assert_array_equal(got[both], want[both])

    def test_filtered_probs(self):
        logits = _logits(2)
        temps, top_ks, top_ps = _lanes()
        want = np.asarray(jax_sampling.filtered_probs(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(top_ps)))
        got = filtered_probs(_t(logits), _t(temps), _t(top_ks),
                             _t(top_ps)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-5)
        np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
        # top-k 1 leaves one entry; top-k 3 three
        assert (got[7] > 0).sum() == 1 and (got[8] > 0).sum() == 3


class TestSample:
    def test_sample_at_matches_jax_over_64_counters(self):
        logits = _logits(3)
        temps, top_ks, top_ps = _lanes()
        keys = _jax_keys([1000 + i for i in range(N)])
        for c in range(64):
            ctr = np.full(N, c, np.int32)
            want = np.asarray(jax_sampling.sample_at(
                logits, temps, top_ks, top_ps, keys, ctr))
            got = sample_at(_t(logits), _t(temps), _t(top_ks), _t(top_ps),
                            _t(keys), _t(ctr)).numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"counter {c}")

    def test_sample_tokens_matches_jax_and_greedy_lanes_are_argmax(self):
        logits = _logits(4)
        temps, top_ks, top_ps = _lanes()
        keys = np.asarray(jax.vmap(jax.random.fold_in)(
            _jax_keys(range(N)), np.arange(N, dtype=np.int32)))
        want = np.asarray(jax_sampling.sample_tokens(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(top_ps), keys))
        got = sample_tokens(_t(logits), _t(temps), _t(top_ks), _t(top_ps),
                            _t(keys)).numpy()
        np.testing.assert_array_equal(got, want)
        greedy = temps == 0
        np.testing.assert_array_equal(got[greedy],
                                      logits[greedy].argmax(-1))
        # top-k 1 is the argmax of the row too
        assert got[7] == logits[7].argmax()

    @pytest.mark.parametrize("lane", [(1.0, 0, 1.0), (0.7, 5, 1.0),
                                      (1.0, 0, 0.8), (1.3, 6, 0.9)])
    def test_chi_square_against_filtered_probs(self, lane):
        """8192 draws of one V = 16 row at counters 0..8191 of one key,
        against the row's filtered distribution: p > 1e-3 (deterministic
        under the fixed key)."""
        draws, v = 8192, 16
        row = (np.random.RandomState(5).randn(1, v) * 1.5).astype(
            np.float32)
        t, k, p = lane
        args = [_t(np.repeat(row, draws, 0)),
                torch.full((draws,), t), torch.full((draws,), k),
                torch.full((draws,), p)]
        keys = torch.from_numpy(np.repeat(prng_key(42)[None], draws, 0))
        toks = sample_at(*args, keys, torch.arange(draws)).numpy()
        probs = filtered_probs(*(a[:1] for a in args))[0].double().numpy()
        support = probs > 0
        assert np.all(support[toks])
        seen = np.bincount(toks, minlength=v)[support]
        expect = probs[support] / probs[support].sum() * draws
        assert stats.chisquare(seen, expect).pvalue > 1e-3


class TestResolveSampling:
    @pytest.mark.parametrize("kwargs", [
        {}, {"temperature": 0.0}, {"temperature": None},
        {"sampling": {"temperature": 0.0, "top_k": 3}},
        {"do_sample": True}, {"temperature": 0.7, "top_k": 8, "seed": 1},
        {"top_k": 5}, {"top_p": 0.9}, {"seed": 3},
        {"do_sample": True, "top_p": 0.5},
        {"sampling": {"temperature": 0.5, "top_k": 4}},
        {"sampling": {"temperature": 0.9, "top_p": 0.8, "seed": 11}}])
    def test_same_spec_as_the_reference(self, kwargs):
        want = jax_sampling.resolve_sampling(**kwargs)
        got = resolve_sampling(**kwargs)
        if want is None:
            assert got is None
        else:
            assert (got.temperature, got.top_k, got.top_p, got.seed) == \
                (want.temperature, want.top_k, want.top_p, want.seed)

    def test_sampling_params_object(self):
        assert resolve_sampling(
            sampling=SamplingParams(temperature=0.0)) is None
        sp = SamplingParams(temperature=0.5, top_k=2)
        assert resolve_sampling(sampling=sp) is sp

    @pytest.mark.parametrize("kwargs,error,match", [
        ({"sampling": 0.7}, TypeError, "SamplingParams"),
        ({"do_sample": True, "top_p": 0.0}, ValueError, "top_p"),
        ({"sampling": {"temperature": -1.0}}, ValueError, "temperature"),
        ({"temperature": 1.0, "top_k": -1}, ValueError, "top_k")])
    def test_refusals_as_the_reference(self, kwargs, error, match):
        with pytest.raises(error, match=match):
            jax_sampling.resolve_sampling(**kwargs)
        with pytest.raises(error, match=match):
            resolve_sampling(**kwargs)

    def test_seedless_key_comes_from_the_generator(self):
        sp = SamplingParams(temperature=1.0)
        a = sp.base_key(torch.Generator().manual_seed(3))
        b = sp.base_key(torch.Generator().manual_seed(3))
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int64 and np.all((a >= 0) & (a <= 0xFFFFFFFF))
        assert sampling.DRAFT_TAG == jax_sampling.DRAFT_TAG
        assert (sampling.ACCEPT_TAG, sampling.BONUS_TAG) == \
            (jax_sampling.ACCEPT_TAG, jax_sampling.BONUS_TAG)
