"""The port's unfused serving path (``ServingConfig(fused_kernels=False)``,
``fused=False`` steps; ``models/llama.py`` ``LlamaAttention._unfused``
and ``gathered_attention``) against the JAX package's unfused path.

- the decode and chunk steps' logits against the JAX ``fused=False``
  steps on the same pools, over full-precision, int8 and fp8 pools of
  the tiny f32 Llama (logits within 1e-4, 1e-3 from int8 pools; f32
  pools within 1e-5; code pools dequantized within one code step, at
  most one code in a thousand off), and over the bf16-tagged pool of a
  tiny bf16 Llama (logits within 2^-5 of their magnitude, bf16 rounding
  on both sides).  The int8 tolerance: v = x @ w summed in another
  order differs in its last f32 bit, and a row whose code sits at a
  rounding tie then takes the next int8 code (1/127 of the row's
  absmax) in one package; on these inputs one code in 6144 does, and
  moves the logits of the steps that read it by up to 6e-4;
- the engine's tokens against the JAX ``fused_kernels=False`` engine,
  greedy from every pool, sampled on the JAX package's keys, and
  speculative with a random 1-layer draft (seed 123) and with the
  target as its own draft;
- fused against unfused in the port itself: the same tokens
  (the reference's ``tests/test_fused_serving.py`` ``TestFusedEngine``),
  distinct steps that reach distinct code (the unfused steps never
  call a fused kernel's wrapper, the fused ones never the gathered
  attention), and no retrace on either.

The JAX model's weights come into the port through ``convert``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import kv_quant as jkv
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.models.generation import \
    make_chunked_prefill_step as jax_chunk_step
from paddle_tpu.models.generation import \
    make_paged_decode_step as jax_decode_step
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu.serving import SpeculativeConfig as JaxSpeculativeConfig
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.kernels import kv_quant as tkv
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.generation import (make_chunked_prefill_step,
                                                make_paged_decode_step)
from paddle_tpu_torch.serving import Engine, ServingConfig, SpeculativeConfig

LOGIT_TOL = 1e-4
STEP_TOL = {None: LOGIT_TOL, "int8": 1e-3, "fp8": LOGIT_TOL}
POOL_TOL = 1e-5
BF16_REL = 2.0 ** -5
SCHEMES = [None, "int8", "fp8"]


def _convert(jax_model, cfg):
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return from_jax_state_dict(named, cfg, device="cpu")


@pytest.fixture(scope="module")
def models():
    """{"jax" | "torch": (target, 1-layer draft)}, the same weights."""
    paddle.seed(0)
    target = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    target.eval()
    paddle.seed(123)
    draft = JaxLlamaForCausalLM(dataclasses.replace(JaxLlamaConfig.tiny(),
                                                    num_hidden_layers=1))
    draft.eval()
    return {"jax": (target, draft),
            "torch": (_convert(target, LlamaConfig.tiny()),
                      _convert(draft, LlamaConfig.tiny(num_hidden_layers=1)))}


@pytest.fixture(scope="module")
def bf16_models():
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny())
    jax_model.eval()
    model = _convert(jax_model, LlamaConfig.tiny(dtype="bfloat16"))
    jax_model.bfloat16()
    return jax_model, model


def _prompts(lens, seed=0, vocab=256):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=(n,)).astype(np.int32) for n in lens]


# ---------------------------------------------------------------------------
# the steps against the JAX unfused steps, on the same pools
# ---------------------------------------------------------------------------

def _pools(cfg, nb, bs, scheme):
    shape = (nb, bs, cfg.num_key_value_heads, cfg.head_dim)
    if scheme is None:
        return [(np.zeros(shape, np.float32), np.zeros(shape, np.float32))
                for _ in range(cfg.num_hidden_layers)]
    return [(np.zeros(shape, np.int8), np.zeros(shape, np.int8),
             np.ones(shape[:2], np.float32), np.ones(shape[:2], np.float32))
            for _ in range(cfg.num_hidden_layers)]


def _to_torch(pools, dtype=None):
    return [tuple(torch.from_numpy(a.copy()) if dtype is None or
                  a.dtype != np.float32 or a.ndim == 2
                  else torch.from_numpy(a.copy()).to(dtype) for a in entry)
            for entry in pools]


def _to_jax(pools, dtype=None):
    return [tuple(jnp.asarray(a) if dtype is None or a.dtype != np.float32
                  or a.ndim == 2 else jnp.asarray(a).astype(dtype)
                  for a in entry) for entry in pools]


def _hold_pools(tpools, jpools, scheme, bf16=False):
    for tentry, jentry in zip(tpools, jpools):
        if scheme is None:
            for t, j in zip(tentry, jentry):
                got = t.float().numpy()
                want = np.asarray(j.astype(jnp.float32))
                tol = 2.0 ** -7 * max(1.0, float(np.abs(want).max())) \
                    if bf16 else POOL_TOL
                np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
            continue
        tk, tv, tks, tvs = tentry
        jk, jv, jks, jvs = jentry
        for codes, scale, jcodes, jscale in ((tk, tks, jk, jks),
                                             (tv, tvs, jv, jvs)):
            got = tkv.dequantize_kv(codes, scale, scheme).numpy()
            want = np.asarray(jkv.dequantize_kv(jcodes, jscale, scheme))
            np.testing.assert_allclose(scale.numpy(), np.asarray(jscale),
                                       rtol=POOL_TOL, atol=POOL_TOL)
            # one code step of the row's scale: a row whose k or v sits
            # at a rounding tie may round the other way in one package
            step = np.asarray(jscale)[..., None, None] * \
                (1.0 if scheme == "int8" else 2.0 ** -3 * 448.0)
            assert np.all(np.abs(got - want) <= step + POOL_TOL)
            off = int((codes.numpy() != np.asarray(jcodes)).sum())
            assert off <= codes.numel() // 1000, off


def _drive_steps(model, jax_model, scheme, tdtype=None, jdtype=None):
    """Two prompts through the chunk step (chunks of 8 at offsets 0, 8
    and 16), then three decode steps over a bucket of 4 (two idle slots
    on the garbage block): each step's logits from both packages.
    Returns [(port logits, JAX logits)] and both pools."""
    cfg = model.config
    nb, bs, C, B = 24, 4, 8, 4
    nbs = cfg.max_position_embeddings // bs
    pools0 = _pools(cfg, nb, bs, scheme)
    tpools, jpools = _to_torch(pools0, tdtype), _to_jax(pools0, jdtype)
    tchunk = make_chunked_prefill_step(model, scheme, fused=False)
    tdecode = make_paged_decode_step(model, scheme, fused=False)
    jchunk = jax_chunk_step(jax_model, fused=False, kv_cache_dtype=scheme)
    jdecode = jax_decode_step(jax_model, fused=False, kv_cache_dtype=scheme)
    prompts = _prompts((19, 11), seed=5)
    tables = np.zeros((B, nbs), np.int32)
    tables[0, :8] = np.arange(1, 9)
    tables[1, :8] = np.arange(9, 17)
    out = []
    for b, prompt in enumerate(prompts):
        for start in range(0, len(prompt), C):
            part = prompt[start:start + C]
            ids = np.zeros((1, C), np.int32)
            ids[0, :len(part)] = part
            bt = tables[b:b + 1]
            begin = np.asarray([start], np.int32)
            jl, jpools = jchunk(jnp.asarray(ids), jpools, jnp.asarray(bt),
                                jnp.asarray(begin),
                                jnp.int32(len(part) - 1))
            tl = tchunk(ids, tpools, bt, begin, len(part) - 1)
            out.append((tl, jl))
    lengths = np.asarray([len(p) for p in prompts] + [0, 0], np.int32)
    tok = np.asarray([[7], [9], [0], [0]], np.int32)
    for _ in range(3):
        jl, jpools = jdecode(jnp.asarray(tok), jpools, jnp.asarray(tables),
                             jnp.asarray(lengths))
        tl = tdecode(tok, tpools, tables, lengths)
        out.append((tl, jl))
        tok = np.array(jnp.argmax(jl, axis=-1), np.int32)[:, None]
        tok[2:] = 0
        lengths = lengths + np.asarray([1, 1, 0, 0], np.int32)
    return out, tpools, jpools


class TestUnfusedSteps:
    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_steps_match_jax(self, models, scheme):
        (jax_model, _), (model, _) = models["jax"], models["torch"]
        out, tpools, jpools = _drive_steps(model, jax_model, scheme)
        tol = STEP_TOL[scheme]
        for tl, jl in out:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=tol, atol=tol)
        _hold_pools(tpools, jpools, scheme)

    def test_bf16_pool_steps_match_jax(self, bf16_models):
        jax_model, model = bf16_models
        out, tpools, jpools = _drive_steps(model, jax_model, None,
                                           torch.bfloat16, jnp.bfloat16)
        for tl, jl in out:
            want = np.asarray(jl, np.float32)
            tol = BF16_REL * max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(tl.float().numpy(), want, rtol=0,
                                       atol=tol)
        _hold_pools(tpools, jpools, None, bf16=True)

    def test_gathered_attention_heads_share_their_kv_head(self, models):
        """GQA without a repeated copy: each query head reads the kv head
        of the reference's ``jnp.repeat`` (head h, kv head h // rep)."""
        g = torch.Generator().manual_seed(0)
        B, T, H, KVH, D, nb, bs = 2, 3, 4, 2, 8, 6, 4
        q = torch.randn((B, T, H, D), generator=g)
        k = torch.randn((nb, bs, KVH, D), generator=g)
        v = torch.randn((nb, bs, KVH, D), generator=g)
        bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
        pos = torch.tensor([2, 5], dtype=torch.int32)
        got = tllama.gathered_attention(
            q, tllama.PagedKVCache(k, v, bt, fused=False), pos)
        kb = k[bt.long()].reshape(B, -1, KVH, D).repeat_interleave(2, 2)
        vb = v[bt.long()].reshape(B, -1, KVH, D).repeat_interleave(2, 2)
        s = torch.einsum("bthd,bshd->bhts", q, kb) / D ** 0.5
        qp = pos[:, None] + torch.arange(T)
        mask = torch.arange(kb.shape[1])[None, None, :] <= qp[:, :, None]
        s = s.masked_fill(~mask[:, None], -1e30)
        want = torch.einsum("bhts,bshd->bthd", torch.softmax(s, -1), vb)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the engine against the JAX fused_kernels=False engine
# ---------------------------------------------------------------------------

def _config(cls, **kw):
    kw.setdefault("max_batch_size", 4)
    kw.setdefault("block_size", 4)
    kw.setdefault("num_blocks", 64)
    kw.setdefault("chunk_tokens", 8)
    return cls(fused_kernels=False, **kw)


def _serve(eng, prompts, kws, max_new_tokens=6):
    reqs = [eng.submit(p, max_new_tokens=max_new_tokens, **kw)
            for p, kw in zip(prompts, kws)]
    eng.run_until_complete()
    eng.pool.check_leaks()
    return [[int(t) for t in r.generated] for r in reqs], \
        [r.finish_reason for r in reqs]


SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.9)


class TestUnfusedEngine:
    @pytest.mark.parametrize("scheme", SCHEMES)
    def test_greedy_tokens_equal_jax(self, models, scheme):
        prompts = _prompts((5, 9, 17, 12, 30), seed=1)
        kws = [{}] * len(prompts)
        (jax_model, _), (model, _) = models["jax"], models["torch"]
        want = _serve(JaxEngine(jax_model, _config(
            JaxServingConfig, kv_cache_dtype=scheme)), prompts, kws)
        eng = Engine(model, _config(ServingConfig, kv_cache_dtype=scheme))
        assert _serve(eng, prompts, kws) == want
        assert eng._decode_step.retraces == eng._prefill_step.retraces == 0

    def test_sampled_tokens_equal_jax(self, models):
        prompts = _prompts((6, 13, 9, 21), seed=2)
        kws = [dict(SAMPLED, seed=100 + i) if i % 2 == 0 else {}
               for i in range(len(prompts))]
        (jax_model, _), (model, _) = models["jax"], models["torch"]
        want = _serve(JaxEngine(jax_model, _config(JaxServingConfig)),
                      prompts, kws, 8)
        eng = Engine(model, _config(ServingConfig))
        assert _serve(eng, prompts, kws, 8) == want
        assert eng.sampled_decode_cache_size() == 1

    def test_preemption_and_prefix_cache_equal_jax(self, models):
        """A pool of 12 blocks forces preemption; the shared prefix is
        served from the cache."""
        shared = _prompts((12,), seed=3)[0]
        prompts = [np.concatenate([shared, t])
                   for t in _prompts((3, 6, 5), seed=4)]
        kws = [{}] * len(prompts)
        (jax_model, _), (model, _) = models["jax"], models["torch"]
        want = _serve(JaxEngine(jax_model, _config(
            JaxServingConfig, num_blocks=12)), prompts, kws, 10)
        eng = Engine(model, _config(ServingConfig, num_blocks=12))
        assert _serve(eng, prompts, kws, 10) == want
        c = eng.stats()["counters"]
        assert c["prefix_cache_hits"] > 0

    @pytest.mark.parametrize("draft", ["random", "self"])
    def test_speculative_tokens_equal_jax(self, models, draft):
        prompts = _prompts((5, 11, 8), seed=6)
        out = {}
        for pkg, eng_cls, cfg_cls, spec_cls in (
                ("jax", JaxEngine, JaxServingConfig, JaxSpeculativeConfig),
                ("torch", Engine, ServingConfig, SpeculativeConfig)):
            target, d = models[pkg]
            spec = spec_cls(draft_model=d if draft == "random" else target,
                            num_draft_tokens=3)
            eng = eng_cls(target, _config(cfg_cls, speculative=spec))
            kws = [dict(SAMPLED, seed=7)] + [{}] * (len(prompts) - 1)
            out[pkg] = (_serve(eng, prompts, kws, 8),
                        eng.stats()["counters"]["spec_tokens_accepted"])
        assert out["torch"] == out["jax"]


# ---------------------------------------------------------------------------
# fused against unfused in the port
# ---------------------------------------------------------------------------

class TestFusedAgainstUnfused:
    def test_token_parity_and_zero_retraces(self, models):
        _, (model, _) = models["jax"], models["torch"]
        prompts = _prompts((3, 9, 6), seed=0)
        outs = {}
        for fused in (True, False):
            eng = Engine(model, ServingConfig(
                max_batch_size=4, block_size=8, num_blocks=64,
                fused_kernels=fused))
            outs[fused] = _serve(eng, prompts, [{}] * 3, 8)
            assert eng._decode_step.retraces == 0
            assert eng._prefill_step.retraces == 0
        assert outs[True] == outs[False]

    def test_steps_reach_distinct_code(self, models, monkeypatch):
        """The unfused steps call none of the fused kernels' wrappers,
        the fused ones never the gathered attention, and their logits
        agree within 1e-4."""
        _, (model, _) = models["jax"], models["torch"]
        calls = []
        for name in ("fused_paged_decode", "chunked_attention",
                     "fused_norm_linear_group", "rms_scale",
                     "gathered_attention"):
            fn = getattr(tllama, name)
            monkeypatch.setattr(tllama, name, lambda *a, _f=fn, _n=name,
                                **k: (calls.append(_n), _f(*a, **k))[1])
        cfg = model.config
        pools = {f: _to_torch(_pools(cfg, 8, 4, None)) for f in (True, False)}
        bt = np.zeros((2, 32), np.int32)
        bt[0, :2], bt[1, :2] = (1, 2), (3, 4)
        logits, seen = {}, {}
        for fused in (True, False):
            calls.clear()
            chunk = make_chunked_prefill_step(model, fused=fused)
            for b in range(2):
                ids = np.arange(1, 9, dtype=np.int32)[None] + b
                chunk(ids, pools[fused], bt[b:b + 1],
                      np.zeros((1,), np.int32), 7)
            decode = make_paged_decode_step(model, fused=fused)
            logits[fused] = decode(np.asarray([[5], [6]], np.int32),
                                   pools[fused], bt,
                                   np.asarray([8, 8], np.int32))
            seen[fused] = set(calls)
        assert seen[False] == {"gathered_attention"}
        assert seen[True] == {"fused_paged_decode", "chunked_attention",
                              "fused_norm_linear_group", "rms_scale"}
        torch.testing.assert_close(logits[True], logits[False],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
