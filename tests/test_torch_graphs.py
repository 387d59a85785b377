"""The port's compiled steps (``paddle_tpu_torch.jit.GraphStep``) and its
no-retrace contract (``paddle_tpu_torch.observability``) against the JAX
package's ``jax.jit`` and ``paddle_tpu.observability``.

On the CPU a ``GraphStep`` runs its static-buffer path without capture,
so these tests hold what the device does not decide: the cache keys and
sizes, the compile and retrace counts, the copies into the static
buffers, and the launch counters' replay accounting (through a fake
binding and a fake graph).  The tiny f32 Llama of
``tests/test_torch_serving.py`` (the JAX model's weights through numpy
into the port) serves behind both packages' engines: the same cache
sizes after the same workloads and the same tokens; the chunked prefill
step's logits within 1e-4 of the JAX step's (f32, the frameworks sum in
different orders).  The replays on the card are held in
``tests/test_torch_cuda.py`` (``TestCudaGraphSteps``) and in
``chip_smoke.py`` phase 6g.
"""
import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import observability as jax_obs
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models.generation import (
    make_chunked_prefill_step as jax_make_chunked_prefill_step)
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.jit import GraphStep
from paddle_tpu_torch.kernels import launches
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.generation import make_chunked_prefill_step
from paddle_tpu_torch.serving import Engine, ServingConfig

LOGIT_TOL = 1e-4
# (shape, dtype) fed to both packages: churn, then steady
CHURN = [((2,), np.float32), ((2,), np.float32), ((3,), np.float32),
         ((3,), np.float32), ((2,), np.float32), ((2,), np.int32),
         ((4, 2), np.float32), ((2,), np.int32), ((3,), np.float32)]
SAMPLED = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1000), {},
           dict(temperature=1.0, seed=7), {}]


def _x(shape, dtype, k=0):
    return (np.arange(int(np.prod(shape))).reshape(shape) + k).astype(dtype)


def _double():
    """A new function each call: jax.jit's cache is keyed on the
    function, so two jits of one function share their entries."""
    return lambda x: x * 2


def _pair(make, label, **kw):
    """The port's wrapper over a GraphStep and the reference's over a
    jax.jit of the same function."""
    return (make[0](GraphStep(_double(), "cpu"), label=f"{label}_port",
                    **kw),
            make[1](jax.jit(_double()), label=f"{label}_jax", **kw))


TRACK = (obs.track_compiles, jax_obs.track_compiles)
GUARD = (obs.warn_on_retrace, jax_obs.warn_on_retrace)


class TestCompileTrackerMatchesJax:
    def test_track_compiles_counts_as_a_jit_does(self):
        port, ref = _pair(TRACK, "churn")
        for k, (shape, dtype) in enumerate(CHURN):
            x = _x(shape, dtype, k)
            np.testing.assert_array_equal(port(x).numpy(),
                                          np.asarray(ref(x)))
            assert (port.calls, port.compiles, port.cache_size(),
                    port._cache_size()) == (ref.calls, ref.compiles,
                                            ref.cache_size(),
                                            ref._cache_size())
        assert port.compiles == 4
        assert port.compile_seconds > 0
        assert obs.compile_stats()["churn_port"]["compiles"] == \
            jax_obs.compile_stats()["churn_jax"]["compiles"] == 4
        assert obs.compile_stats()["churn_port"]["cache_size"] == 4

    def test_python_numbers_key_by_type(self):
        port, ref = _pair(TRACK, "numbers")
        for x in (3, 5, 2.5, 7, 1.5):
            assert float(port(x)) == float(ref(x))
            assert port.compiles == ref.compiles
        assert port.cache_size() == ref.cache_size() == 2

    def test_decorator_form(self):
        for track in TRACK:
            wrap = track(label="deco")
            f = wrap(GraphStep(_double(), "cpu")
                     if track is obs.track_compiles else jax.jit(_double()))
            f(_x((2,), np.float32))
            assert f.label == "deco" and f.compiles == 1

    @pytest.mark.parametrize("track", TRACK)
    def test_untrackable_fn_rejected(self, track):
        with pytest.raises(TypeError, match="cannot read a jit cache"):
            track(lambda x: x)

    def test_warn_mode(self):
        port, ref = _pair(GUARD, "warned", after=1)
        for g, warning in ((port, obs.RetraceWarning),
                           (ref, jax_obs.RetraceWarning)):
            g(_x((2,), np.float32))               # warmup compile: allowed
            g(_x((2,), np.float32))               # cache hit: fine
            with pytest.warns(warning, match="retraced after warmup.*H101"):
                g(_x((3,), np.float32))           # retrace -> warns
        assert port.retraces == ref.retraces == 1

    def test_raise_mode(self):
        port, ref = _pair(GUARD, "raised", after=1, on_retrace="raise")
        raised = []
        for g, error in ((port, obs.RetraceError),
                         (ref, jax_obs.RetraceError)):
            at = None
            for k, (shape, dtype) in enumerate(CHURN):
                try:
                    g(_x(shape, dtype))
                except error as e:
                    assert "retraced after warmup" in str(e)
                    at = k
                    break
            raised.append(at)
        assert raised[0] == raised[1] == 2
        assert port.compiles == ref.compiles == 2

    def test_count_mode(self):
        port, ref = _pair(GUARD, "counted", after=0, on_retrace="count")
        with warnings.catch_warnings():
            warnings.simplefilter("error")        # counting must not warn
            for shape, dtype in CHURN:
                port(_x(shape, dtype))
                ref(_x(shape, dtype))
        assert port.retraces == ref.retraces == 4
        got, want = (stats()[label] for stats, label in (
            (obs.compile_stats, "counted_port"),
            (jax_obs.compile_stats, "counted_jax")))
        for key in ("calls", "compiles", "cache_size"):
            assert got[key] == want[key], key

    @pytest.mark.parametrize("kw,match", [
        (dict(after=-1), "after must be >= 0"),
        (dict(on_retrace="log"), "on_retrace must be 'warn', 'raise' or "
                                 "'count'")])
    def test_argument_refusals(self, kw, match):
        for guard, fn in zip(GUARD, (GraphStep(_double(), "cpu"),
                                     jax.jit(_double()))):
            with pytest.raises(ValueError, match=match):
                guard(fn, **kw)


# ---------------------------------------------------------------------------
# GraphStep's static buffers, keys and launch accounting
# ---------------------------------------------------------------------------

def _rows_step(x, pools, row, scale, t):
    """Adds x into row ``row`` of the bound pool and returns x * scale +
    t.sum(): every kind of input (host array, host numbers, a tensor, a
    bound pool)."""
    pools[0].index_add_(0, row.reshape(1).long(), x[None].float())
    return x * scale + t.sum()


class TestStaticBuffers:
    def test_each_call_returns_its_own_result(self):
        pool = [torch.zeros(4, 3)]
        step = GraphStep(_rows_step, "cpu", bound=(1,))
        rng = np.random.RandomState(0)
        want_pool = np.zeros((4, 3), np.float32)
        for k in range(6):
            x = rng.randn(3).astype(np.float32)
            t = torch.from_numpy(rng.randn(2).astype(np.float32))
            scale = float(k) + 0.5
            got = step(x, pool, k % 4, scale, t)
            np.testing.assert_allclose(got.numpy(),
                                       x * np.float32(scale) + t.sum().item(),
                                       rtol=1e-6)
            want_pool[k % 4] += x
        assert step._cache_size() == 1
        np.testing.assert_allclose(pool[0].numpy(), want_pool, rtol=1e-6)

    def test_keys(self):
        pool = [torch.zeros(4, 3)]
        step = GraphStep(_rows_step, "cpu", bound=(1,))
        x, t = np.ones(3, np.float32), torch.ones(2)
        step(x, pool, 1, 2.0, t)
        step(x + 1, pool, 2, 3.0, t + 1)                   # values: a hit
        assert step._cache_size() == 1
        step(np.ones(3, np.float64), pool, 1, 2.0, t)      # dtype
        assert step._cache_size() == 2
        step(x, pool, 1, 2.0, torch.ones(3))               # shape
        assert step._cache_size() == 3
        step(x, pool, 1, 2.0, t.numpy())                   # kind
        assert step._cache_size() == 4
        step(x, [pool[0].clone()], 1, 2.0, t)              # a rebound pool
        assert step._cache_size() == 5
        step(x, pool, 1, 2.0, t)                           # the first again
        assert step._cache_size() == 5

    def test_packed_host_inputs_keep_their_bits(self):
        """Host inputs of every type, odd sizes and 0-d, packed into one
        buffer at aligned offsets, each read back as given."""
        def echo(*args):
            return [a.clone() for a in args]
        step = GraphStep(echo, "cpu")
        rng = np.random.RandomState(1)
        for k in range(3):
            args = [rng.randint(-9, 9, size=(3, 5)).astype(np.int32),
                    np.asarray(rng.rand() < 0.5), rng.randn(7),
                    rng.randint(0, 2 ** 40, size=(2, 2), dtype=np.int64),
                    np.asarray(np.float32(rng.randn())), k,
                    np.zeros((0, 4), np.float32)]
            got = step(*args)
            for a, g in zip(args, got):
                want = np.asarray(a, np.int32 if isinstance(a, int) else None)
                assert g.numpy().dtype == want.dtype
                np.testing.assert_array_equal(g.numpy(), want)
        assert step._cache_size() == 1


class TestTicketBuffers:
    def test_an_outgrown_buffer_is_kept(self, monkeypatch):
        """Paged decode's tickets of one stream: a larger count grows the
        buffer, and the buffer it outgrew stays alive, since a CUDA graph
        captured with it keeps counting its tickets at its address."""
        import gc
        import weakref
        from types import SimpleNamespace

        from paddle_tpu_torch.kernels import paged_attention as pa

        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda device: SimpleNamespace(cuda_stream=7))
        monkeypatch.setattr(pa, "_ticket_buffers", {})
        monkeypatch.setattr(pa, "_outgrown_tickets", [])
        dev = torch.device("cpu")
        first = pa._tickets(dev, 8)
        assert first.numel() == 256 and pa._tickets(dev, 256) is first
        held = weakref.ref(first)
        del first
        grown = pa._tickets(dev, 300)
        gc.collect()
        assert grown.numel() == 300 and not grown.any()
        assert held() is not None and held() is not grown
        assert pa._tickets(dev, 10) is grown


def _fake_kernel(x):
    """A fake binding: counts its launch as a kernel wrapper does."""
    launches.add("fake_kernel", "w8")
    return x + 1


def _two_launches(x):
    return _fake_kernel(_fake_kernel(x) * 2)


class _FakeGraph:
    """Replays the captured call without running the wrappers' counting,
    as a CUDA graph's replay launches kernels without their wrappers."""

    def __init__(self, fn, call, out):
        self.fn, self.call, self.out = fn, call, out

    def replay(self):
        mark = launches.mark()
        res = self.fn(*self.call)
        launches.restore(mark)
        self.out.copy_(res)


class _FakeCapture(GraphStep):
    """A GraphStep that captures on the CPU into a :class:`_FakeGraph`."""

    captures = True
    fail = False

    def _capture_stream(self):
        return contextlib.nullcontext()

    def _record(self, call):
        out = self.eager(*call)
        if self.fail:
            raise RuntimeError("capture refused")
        return _FakeGraph(self.eager, call, out), out


class TestLaunchReplayAccounting:
    def test_counter_mark_since_restore_replay(self):
        launches.reset()
        launches.add("a")
        mark = launches.mark()
        launches.add("a", "w1")
        launches.add("b", "w2")
        delta = launches.since(mark)
        assert delta == ({"a": 1, "b": 1}, {"a@w1": 1, "b@w2": 1})
        launches.restore(mark)
        assert launches.snapshot() == {"a": 1} and launches.by_instance() == {}
        launches.replay(delta)
        launches.replay(delta)
        assert launches.snapshot() == {"a": 3, "b": 2}
        assert launches.by_instance() == {"a@w1": 2, "b@w2": 2}

    def test_replays_count_what_eager_calls_count(self):
        launches.reset()
        for k in range(3):
            _two_launches(torch.full((4,), float(k)))
        eager = (launches.snapshot(), launches.by_instance())
        launches.reset()
        step = _FakeCapture(_two_launches, "cpu")
        for k in range(3):
            out = step(np.full(4, k, np.float32))
            np.testing.assert_array_equal(out.numpy(), (k + 1) * 2 + 1)
        # the warmup and the capture count nothing, each replay its delta
        assert (launches.snapshot(), launches.by_instance()) == eager == (
            {"fake_kernel": 6}, {"fake_kernel@w8": 6})
        (entry,) = step._entries.values()
        assert entry.delta == ({"fake_kernel": 2}, {"fake_kernel@w8": 2})

    def test_a_failed_capture_raises_and_keeps_nothing(self):
        launches.reset()
        launches.add("before")
        step = _FakeCapture(_two_launches, "cpu")
        step.fail = True
        with pytest.raises(RuntimeError, match="capture refused"):
            step(np.zeros(4, np.float32))
        assert step._cache_size() == 0
        assert launches.snapshot() == {"before": 1}


# ---------------------------------------------------------------------------
# the engines: cache sizes, tokens, the chunked prefill step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    jax_model.eval()
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return jax_model, from_jax_state_dict(named, LlamaConfig.tiny(),
                                          device="cpu")


def _prompts(seed=0, lens=(13, 3, 30, 7)):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 256, size=n) for n in lens]


def _config(cls, **kw):
    return cls(max_batch_size=4, block_size=8, num_blocks=64,
               chunk_tokens=16, fused_kernels=True, **kw)


def _sizes(eng):
    return (eng.decode_cache_size(), eng.prefill_cache_size(),
            eng.sampled_decode_cache_size())


def _run(eng, prompts, kws, max_new_tokens=6):
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens, **kw)
            for p, kw in zip(prompts, kws)]
    eng.run_until_complete()
    eng.pool.check_leaks()
    return [[int(t) for t in r.generated] for r in reqs]


class TestEngineMatchesJax:
    def test_cache_sizes_greedy_then_sampled(self, models):
        """The reference's no-retrace property (``test_serving.py:118``),
        held beside the JAX engine: one graph of each step after a greedy
        workload and after a second one of other lengths, the sampled
        step's first graph at the first sampled iteration, the same
        tokens."""
        engines = [JaxEngine(models[0], _config(JaxServingConfig)),
                   Engine(models[1], _config(ServingConfig))]
        workloads = [(_prompts(), [{}] * 4), (_prompts(3, (9, 2, 17, 5)),
                                              [{}] * 4),
                     (_prompts(5), SAMPLED)]
        want_sizes = [(1, 1, 0), (1, 1, 0), (1, 1, 1)]
        for (prompts, kws), want in zip(workloads, want_sizes):
            jax_tokens, tokens = (_run(e, prompts, kws) for e in engines)
            assert tokens == jax_tokens
            assert _sizes(engines[0]) == _sizes(engines[1]) == want
        port = engines[1]
        compiles = port.stats()["compiles"]
        assert set(compiles) == {"serving::decode_step",
                                 "serving::prefill_step",
                                 "serving::sampled_decode_step"}
        for label, s in compiles.items():
            assert s["compiles"] == s["cache_size"] == 1, label
            assert s["calls"] > 1 and s["compile_seconds"] > 0
        assert port._decode_step.retraces == 0

    def test_a_second_engine_counts_its_own_compiles(self, models):
        first = Engine(models[1], _config(ServingConfig))
        _run(first, _prompts(), [{}] * 4)
        second = Engine(models[1], _config(ServingConfig))
        assert _sizes(second) == (0, 0, 0)
        _run(second, _prompts(), [{}] * 4)
        assert _sizes(second) == (1, 1, 0)
        assert second._decode_step.compiles == 1

    @pytest.mark.parametrize("strict", [True, False])
    def test_a_rebound_pool_is_a_retrace(self, models, strict):
        """A rebound pool changes the steps' keys: under
        ``strict_no_retrace`` the engine raises; otherwise it counts one
        retrace a step and serves the same tokens as an engine whose
        pool stayed put."""
        eng = Engine(models[1], _config(ServingConfig,
                                        strict_no_retrace=strict))
        ref = Engine(models[1], _config(ServingConfig))
        first, second = _prompts(), _prompts(3, (9, 2, 17, 5))
        assert _run(eng, first, [{}] * 4) == _run(ref, first, [{}] * 4)
        eng.pool.layers = [tuple(t.clone() for t in entry)
                           for entry in eng.pool.layers]
        if strict:
            with pytest.raises(obs.RetraceError,
                               match="serving::prefill_step: retraced"):
                _run(eng, second, [{}] * 4)
            return
        assert _run(eng, second, [{}] * 4) == _run(ref, second, [{}] * 4)
        assert _sizes(eng) == (2, 2, 0)
        assert eng._decode_step.retraces == eng._prefill_step.retraces == 1


class TestChunkedPrefillOneGraph:
    def test_every_chunk_of_every_prompt_one_graph(self, models):
        """Chunks at starts 0, 16 and 32 with last indices 15, 15 and 4,
        then a 5-token prompt (start 0, last index 4), each through ONE
        port step (cache size 1) and the JAX step, whose cache does not
        grow either: logits within 1e-4, the pools alike."""
        jax_model, model = models
        cfg = model.config
        nb, bs, C = 16, 8, 16
        nbs = cfg.max_position_embeddings // bs
        shape = (nb, bs, cfg.num_key_value_heads, cfg.head_dim)
        pools0 = [(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
                  for _ in range(cfg.num_hidden_layers)]
        jpools = [(jnp.asarray(k), jnp.asarray(v)) for k, v in pools0]
        tpools = [(torch.from_numpy(k.copy()), torch.from_numpy(v.copy()))
                  for k, v in pools0]
        rng = np.random.RandomState(7)
        long, short = (rng.randint(1, 256, size=n).astype(np.int32)
                       for n in (37, 5))
        chunks = [(long, 0, [1, 2, 3, 4, 5]), (long, 16, [1, 2, 3, 4, 5]),
                  (long, 32, [1, 2, 3, 4, 5]), (short, 0, [6])]
        jstep = jax_make_chunked_prefill_step(jax_model, fused=True)
        step = make_chunked_prefill_step(model)
        jax_sizes = []
        for prompt, start, blocks in chunks:
            part = prompt[start:start + C]
            ids = np.zeros((1, C), np.int32)
            ids[0, :len(part)] = part
            bt = np.zeros((1, nbs), np.int32)
            bt[0, :len(blocks)] = blocks
            begin = np.asarray([start], np.int32)
            jlast, jpools = jstep(jnp.asarray(ids), jpools, jnp.asarray(bt),
                                  jnp.asarray(begin), jnp.int32(len(part) - 1))
            tlast = step(ids, tpools, bt, begin, len(part) - 1)
            np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
            jax_sizes.append(jstep._cache_size())
            assert step._cache_size() == 1
        assert len(set(jax_sizes)) == 1
        for (tk, tv), (jk, jv) in zip(tpools, jpools):
            np.testing.assert_allclose(tk.numpy(), np.asarray(jk),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv),
                                       rtol=1e-5, atol=1e-5)

    def test_last_index_as_a_tensor(self, models):
        """The step's eager function takes ``last_index`` as an int or
        a one-element tensor (a captured step's static buffer) alike."""
        model = models[1]
        cfg = model.config
        shape = (4, 8, cfg.num_key_value_heads, cfg.head_dim)
        outs = []
        for last in (6, torch.tensor(6, dtype=torch.int32),
                     torch.tensor([6])):
            pools = [(torch.zeros(shape), torch.zeros(shape))
                     for _ in range(cfg.num_hidden_layers)]
            ids = torch.from_numpy(np.arange(1, 17, dtype=np.int32)[None])
            bt = torch.zeros((1, cfg.max_position_embeddings // 8),
                             dtype=torch.int32)
            bt[0, :2] = torch.tensor([1, 2])
            outs.append(make_chunked_prefill_step(model).eager(
                ids, pools, bt, torch.tensor([0], dtype=torch.int32), last))
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])
