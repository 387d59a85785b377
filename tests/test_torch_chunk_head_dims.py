"""The chunked prefill at head_dims other than 64 and 128, on the CPU.

On the card the bf16 chunk runs on wgmma instances of 64, 128 and 256
columns that take every head_dim D that is a multiple of 8 up to 256,
over bf16, int8 and fp8 pools: the columns D..W-1 of q, K and V are
zeros in shared memory (TMA fills them from tensor maps whose innermost
extent is D; the copy producers zero-fill them) and the store skips them
(``csrc/chunked_prefill.cu``).  Here: the route, instance and launch
name for the shapes of ``test_torch_c1.ATTN_SHAPES`` over each kind of
pool (meta tensors), the flags each launch hands the C entry (a fake
binding), the padded instances' arithmetic (the plain chunk over q and
pools zero-padded to the instance's width, at the true D's scale, equals
the unpadded one), the plain chunk at Phi-2's, Phi-3's and Gemma's
head_dims against the JAX Pallas kernel in interpret mode, and a tiny
Llama of head_dim 96 served by the port's ``Engine`` against the JAX
``Engine``.

Tolerances: the padded arithmetic within 1e-6 (f32; the zero columns add
exact zeros, but a sum over more terms may round in another order);
against the JAX kernel 1e-5 (f32, that of ``tests/test_torch_kernels.py``
and ``tests/test_torch_quant_serving.py``); the engines' greedy tokens
and counters identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels.chunked_prefill import fused_chunked_attention
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.kernels import _build, launches
from paddle_tpu_torch.kernels import chunked_prefill as cp
from paddle_tpu_torch.kernels import kv_quant
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.serving import Engine, ServingConfig
from test_torch_c1 import ATTN_SHAPES
from torch_operands import chunk_operands

PAD_TOL = 1e-6
JAX_TOL = 1e-5
SCHEMES = [None, "int8", "fp8"]
# hidden 192 over 2 q heads and 2 kv heads: head_dim 96, Phi-3-mini's
D96 = dict(hidden_size=192, num_attention_heads=2, num_key_value_heads=2)
COUNTERS = ("requests_completed", "preemptions", "prefix_cache_hits",
            "prefix_cache_misses", "prefill_chunks", "decode_iterations",
            "tokens_generated")


@pytest.fixture(autouse=True)
def _int_cost_estimates(monkeypatch):
    """The JAX kernels pass float flop counts to ``pl.CostEstimate``,
    which newer JAX releases refuse; round them for the duration of a
    test so the Pallas kernel still runs in interpret mode (as
    ``tests/test_torch_kernels.py`` does).  Nothing of its math is
    touched."""
    from jax.experimental import pallas as pl

    orig = pl.CostEstimate
    monkeypatch.setattr(pl, "CostEstimate", lambda **kw: orig(
        **{k: int(v) for k, v in kw.items()}))


def _width(D):
    """The wgmma instance of a bf16 chunk at head_dim D; None: the
    general instance."""
    return None if D % 8 else next(w for w in (64, 128, 256) if D <= w)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def _pools(nb, bs, KVH, D, scheme):
    """Meta pools of ``scheme`` and their scales (None for bf16)."""
    if scheme is None:
        return _meta(nb, bs, KVH, D), _meta(nb, bs, KVH, D), None, None
    codes = [_meta(nb, bs, KVH, D, dtype=torch.int8) for _ in range(2)]
    return (*codes, *(_meta(nb, bs, dtype=torch.float32) for _ in range(2)))


# ------------------------------------------------------------ the routes
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("tag,H,KVH,D,bs,fast", ATTN_SHAPES,
                         ids=[s[0] for s in ATTN_SHAPES])
def test_route_instance_and_name(tag, H, KVH, D, bs, fast, scheme):
    # every head_dim that is a multiple of 8 on the instance of 64, 128 or
    # 256 columns that holds it, over every pool; the tiny model's 20 on
    # the general instance, counted as such
    q = _meta(1, 256, H, D)
    k, v, ks, vs = _pools(40, bs, KVH, D, scheme)
    scales = () if scheme is None else (ks, vs)
    assert cp.wgmma_width(q, k, v, scales) == _width(D)
    W = _width(D)
    producer = ("tma" if bs in (8, 16, 32, 64) else "copy") \
        if scheme is None else f"codes{8 if D % 16 else 16}"
    assert cp.instance(q, k, v, scales, scheme) == (
        f"maxd{128 if D <= 128 else 256}" if W is None
        else f"w{W}_{producer}")
    f32 = _meta(1, 256, H, D, dtype=torch.float32)
    assert cp.wgmma_width(f32, k.float() if scheme is None else k, v,
                          scales) is None


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("D,bs", [(20, 12), (32, 16), (72, 12), (80, 16),
                                  (96, 12), (96, 16), (100, 16), (136, 16),
                                  (132, 12), (160, 12), (256, 12),
                                  (256, 16)])
def test_each_launch_hands_the_c_entry_its_route(monkeypatch, D, bs,
                                                 scheme):
    # one launch through a fake binding over meta tensors: the wgmma and
    # copy flags the C entry gets, the head_dim and scale it gets (the
    # true D's), and the counter the launch adds to
    calls = []

    def bind(lib, fn, argtypes):
        if fn == "chunked_prefill_smem_bytes":
            return lambda *a: 1024
        return lambda *a: calls.append(a) or 0

    monkeypatch.setattr(_build, "bind", bind)
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    q = _meta(2, 40, 8, D)
    k, v, ks, vs = _pools(9, bs, 2, D, scheme)
    launches.reset()
    out = cp.chunked_attention(
        q, k, v, torch.zeros(2, 4, dtype=torch.int32, device="meta"),
        torch.zeros(2, dtype=torch.int32, device="meta"), ks, vs, scheme)
    (args,) = calls
    wgmma = _width(D) is not None
    copy = wgmma and scheme is None and bs not in (8, 16, 32)
    assert args[-3:-1] == (int(wgmma), int(copy))
    assert args[12] == D and args[16] == pytest.approx(D ** -0.5)
    base = cp.KERNEL if wgmma else cp.GENERAL
    name = kv_quant.counter_name(base, scheme)
    assert launches.snapshot() == {name: 1}
    # the instance, tallied beside the name: the width and the producer
    if not wgmma:
        inst = f"maxd{128 if D <= 128 else 256}"
    elif scheme is not None:
        inst = f"w{_width(D)}_codes{8 if D % 16 else 16}"
    else:
        inst = f"w{_width(D)}_{'copy' if copy else 'tma'}"
    assert launches.by_instance() == {f"{name}@{inst}": 1}
    assert out.shape == q.shape


# ----------------------------------------------- the padded arithmetic
def _padded_case(D, scheme, seed):
    """f32 q, the pools (codes and scales of ``scheme``, else f32 rows)
    and table of a chunk over a poisoned block 0, at head_dim D."""
    q, kp, vp, bt, pos = (torch.from_numpy(a) for a in chunk_operands(
        B=2, T=7, KVH=2, rep=3, D=D, bs=12, nbs=4, seed=seed))
    if scheme is None:
        return q, kp, vp, bt, pos, None, None
    (kc, ks), (vc, vs) = (kv_quant.quantize_kv(x, scheme) for x in (kp, vp))
    return q, kc, vc, bt, pos, ks, vs


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("D", [16, 72, 80, 96, 136, 160, 256])
def test_zero_padded_columns_change_nothing(D, scheme):
    # what the padded instances compute: q and the pools (bf16 rows or
    # codes) with zero columns up to the instance's width W, at the true
    # D's scale, give the unpadded output in their first D columns and
    # zeros past them (the columns the kernel does not store)
    W = _width(D)
    q, k, v, bt, pos, ks, vs = _padded_case(D, scheme, D)
    want = cp.chunked_attention_plain(q, k, v, bt, pos, ks, vs, scheme)
    pad = [torch.nn.functional.pad(x, (0, W - D)) for x in (q, k, v)]
    got = cp.chunked_attention_plain(*pad, bt, pos, ks, vs, scheme,
                                     scale=D ** -0.5)
    torch.testing.assert_close(got[..., :D], want, rtol=PAD_TOL,
                               atol=PAD_TOL)
    assert not got[..., D:].any()


# ------------------------------------------------ against the JAX kernel
@pytest.mark.parametrize("scheme", [None, "int8"])
@pytest.mark.parametrize("rep", [1, 7])
@pytest.mark.parametrize("bs", [12, 16])
@pytest.mark.parametrize("D", [80, 96, 256])
def test_plain_chunk_matches_jax_kernel(D, bs, rep, scheme):
    # the JAX chunk through its Pallas kernel (_pallas_chunked) in
    # interpret mode, pages of 12 and 16, GQA rep 1 and 7, chunk starts
    # mid-page, over the poisoned block 0
    q, kp, vp, bt, pos = chunk_operands(B=2, T=5, KVH=1, rep=rep, D=D,
                                        bs=bs, nbs=3, seed=D + bs + rep)
    pos = np.array([0, bs + 3], np.int32)
    kw = {}
    if scheme is not None:
        (kp, ks), (vp, vs) = (kv_quant.quantize_kv(torch.from_numpy(x),
                                                   scheme)
                              for x in (kp, vp))
        kp, vp, ks, vs = (x.numpy() for x in (kp, vp, ks, vs))
        kw = dict(k_scale=ks, v_scale=vs, kv_cache_dtype=scheme)
    ops = [q, kp, vp, bt, pos]
    got = cp.chunked_attention(
        *[torch.from_numpy(np.asarray(a)) for a in ops],
        **{k: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()}).numpy()
    want = fused_chunked_attention(
        *[jnp.asarray(a) for a in ops], use_pallas=True, interpret=True,
        **{k: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for k, a in kw.items()})
    np.testing.assert_allclose(got, np.asarray(want), rtol=JAX_TOL,
                               atol=JAX_TOL)


# --------------------------------------------- a model of head_dim 96
def _prompts():
    rng = np.random.RandomState(5)
    prefix = rng.randint(1, 256, size=26)
    return [np.concatenate([prefix, rng.randint(1, 256, size=5)]),
            rng.randint(1, 256, size=13), rng.randint(1, 256, size=30),
            np.concatenate([prefix, rng.randint(1, 256, size=9)])]


def _serve(engine, prompts):
    """The last prompt shares the first's 26-token prefix and is
    submitted once that prefix is registered."""
    reqs = [engine.submit(p, max_new_tokens=8) for p in prompts[:-1]]
    while not reqs[0].generated:
        engine.step()
    reqs.append(engine.submit(prompts[-1], max_new_tokens=8))
    engine.run_until_complete()
    engine.pool.check_leaks()
    counters = engine.stats()["counters"]
    return ([[int(x) for x in r.generated] for r in reqs],
            {k: counters[k] for k in COUNTERS})


@pytest.mark.parametrize("block_size", [12, 16])
def test_head_dim_96_engine_matches_jax(block_size):
    # the shape the 128-column wgmma chunk takes on the card (head_dim 96,
    # pages of 12 by its copy producer, of 16 by TMA boxes), in f32 here:
    # the port's Engine against the JAX Engine, prefix cache on
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**D96))
    jax_model.eval()
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    model = from_jax_state_dict(named, LlamaConfig.tiny(**D96),
                                device="cpu")
    assert model.config.head_dim == 96
    out = []
    for m, engine_cls, config_cls in ((jax_model, JaxEngine,
                                       JaxServingConfig),
                                      (model, Engine, ServingConfig)):
        engine = engine_cls(m, config_cls(
            max_batch_size=4, block_size=block_size, chunk_tokens=16,
            num_blocks=40, fused_kernels=True))
        out.append(_serve(engine, _prompts()))
    (jtok, jctr), (tok, ctr) = out
    assert tok == jtok and ctr == jctr
    assert ctr["requests_completed"] == 4
    assert ctr["prefix_cache_hits"] > 0
