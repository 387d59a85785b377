"""The paged decode at head_dims other than 64 and 128, on the CPU.

On the card the bf16 decode runs ``paged_decode_hopper`` at every
head_dim D that is a multiple of 8 up to 256, over bf16, int8 and fp8
pools: D = 64 and 128 on instances of D columns, every other D on the
padded instance of 64, 128 or 256 columns, whose lanes past D load
nothing, hold q = 0 and store nothing, and whose rotation takes the half
of each dim (``csrc/paged_attention.cu``).  Here: the route, instance
and launch name for the shapes of ``test_torch_c1.ATTN_SHAPES`` over
each kind of pool (meta tensors), the flags each launch hands the C
entry (a fake binding), the padded instances' arithmetic (the plain
decode over q rotated at the true D and pools zero-padded to the
instance's width, at the true D's scale, equals the unpadded one), the
plain decode at Phi-2's 80, at 88 (a lane's 8 dims straddle the halves
of the rotation), Phi-3's 96 and Gemma's 256 against the JAX Pallas
kernel in interpret mode, and a tiny Llama of head_dim 96 served from
int8 and fp8 pools by the port's ``Engine`` against the JAX ``Engine``.

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
from paddle_tpu.kernels.paged_attention import (fused_paged_decode as
                                                jax_fused_paged_decode)
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.kernels import _build, kv_quant, launches
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels.rope import rotate_half
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.serving import Engine, ServingConfig
from test_torch_c1 import ATTN_SHAPES
from torch_operands import decode_operands

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
    """The columns of the Hopper decode instance of a bf16 head_dim D;
    None: the general instance."""
    return None if D % 8 else next(w for w in (64, 128, 256) if D <= w)


def _instance(D):
    W = _width(D)
    if W is None:
        return None
    return f"w{W}" if D == W and W in (64, 128) else f"w{W}_pad"


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
    # every head_dim that is a multiple of 8 on the Hopper instance of 64,
    # 128 or 256 columns that holds it, over every pool; the tiny model's
    # 20 on the general instance, counted as such; f32 the general one
    # under the plain name
    q = _meta(8, H, D)
    k, v, _, _ = _pools(40, bs, KVH, D, scheme)
    hopper = pa.hopper_path(q, k, v, H // KVH)
    assert hopper == (_width(D) is not None) == fast
    if hopper:
        assert pa.hopper_width(D) == _width(D)
    assert pa.instance(q, hopper) == _instance(D)
    name = kv_quant.counter_name(pa.KERNEL if hopper else pa.GENERAL, scheme)
    assert pa.counter_name(q, hopper, scheme) == name
    f32 = _meta(8, H, D, dtype=torch.float32)
    pool32 = k.float() if scheme is None else k
    assert not pa.hopper_path(f32, pool32, pool32, H // KVH)
    assert pa.counter_name(f32, False, scheme) == \
        kv_quant.counter_name(pa.KERNEL, scheme)


@pytest.mark.parametrize("D", [8, 72, 88, 96, 104, 120, 136, 200, 256])
def test_widths_are_the_smallest_that_hold_d(D):
    W = pa.hopper_width(D)
    assert W in (64, 128, 256) and D <= W and (W == 64 or D > W // 2)


@pytest.mark.parametrize("D", [258, 264, 512])
def test_head_dim_above_256_takes_the_general_instance(D):
    q, pool = _meta(2, 4, D), _meta(9, 16, 2, D)
    assert not pa.hopper_path(q, pool, pool, 2)


def _fake_decode(monkeypatch):
    """A fake binding of paged_decode over meta tensors: the C entry's
    arguments of each call (nothing is launched)."""
    calls = []

    def bind(lib, fn, argtypes):
        if fn == "paged_decode_smem_bytes":
            return lambda *a: 1024
        return lambda *a: calls.append(a) or 0

    monkeypatch.setattr(_build, "bind", bind)
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(_build, "sm_count", lambda d: 132)
    monkeypatch.setattr(pa, "_tickets", lambda d, n: torch.empty(
        n, dtype=torch.int32, device="meta"))
    return calls


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("rep", [1, 7])
@pytest.mark.parametrize("D,bs", [(20, 12), (32, 16), (64, 16), (80, 16),
                                  (88, 12), (96, 12), (96, 16), (100, 16),
                                  (128, 12), (136, 16), (160, 12),
                                  (256, 12), (256, 16)])
def test_each_launch_hands_the_c_entry_its_route(monkeypatch, D, bs, rep,
                                                 scheme):
    # one launch through a fake binding over meta tensors: the head_dim,
    # the instance's columns W, its REP and sub-groups and the page
    # division the C entry gets, the scale of the true D, and the counter
    # and instance the launch adds to
    calls = _fake_decode(monkeypatch)
    B, KVH, nbs = 2, 2, 4
    q = _meta(B, KVH * rep, D)
    k, v, ks, vs = _pools(9, bs, KVH, D, scheme)
    cs = torch.empty(B, D // 2, device="meta")
    launches.reset()
    out = pa.paged_decode_attention(
        q, cs, cs, k, v, torch.zeros(B, nbs, dtype=torch.int32,
                                     device="meta"),
        torch.zeros(B, dtype=torch.int32, device="meta"), 1, ks, vs, scheme)
    (args,) = calls
    W = _width(D)
    REP, groups = pa.hopper_group(rep) if W else (0, 1)
    magic, shift = pa.div_magic(bs) if W else (0, 0)
    assert args[17] == D and args[18] == bs
    assert args[21] == pytest.approx(D ** -0.5)
    assert args[-6:-1] == (W or 0, REP, groups, magic, shift)
    assert (args[12] is not None) == (W is not None)     # the tickets
    name = kv_quant.counter_name(pa.KERNEL if W else pa.GENERAL, scheme)
    assert launches.snapshot() == {name: 1}
    assert launches.by_instance() == (
        {f"{name}@{_instance(D)}": 1} if W else {})
    assert out.shape == q.shape


# ----------------------------------------------- the padded arithmetic
def _padded_case(D, scheme, seed, bs=12, rep=3):
    """f32 q, its RoPE rows, the pools (codes and scales of ``scheme``,
    else f32 rows), table and frontiers of a decode step over a poisoned
    block 0, at head_dim D."""
    q, _, _, kp, vp, bt, pos, cos, sin = (
        torch.from_numpy(a) for a in decode_operands(
            B=2, KVH=2, rep=rep, D=D, bs=bs, nbs=4, seed=seed))
    c, s = cos[pos.long()], sin[pos.long()]
    if scheme is None:
        return q[:, 0], c, s, kp, vp, bt, pos, None, None
    (kc, ks), (vc, vs) = (kv_quant.quantize_kv(x, scheme) for x in (kp, vp))
    return q[:, 0], c, s, kc, vc, bt, pos, ks, vs


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("D", [16, 40, 72, 80, 88, 96, 136, 160, 200, 256])
def test_zero_padded_columns_change_nothing(D, scheme):
    # what the padded instances compute: q rotated at the true D (its
    # halves), then q and the pools (bf16 rows or codes) with zero
    # columns up to the instance's width W, at the true D's scale, give
    # the unpadded output in their first D columns and zeros past them
    # (the columns the kernel does not store)
    W = _width(D)
    q, c, s, k, v, bt, pos, ks, vs = _padded_case(D, scheme, D)
    want = pa.paged_decode_attention_plain(q, c, s, k, v, bt, pos, 2, ks,
                                           vs, scheme)
    B, H = q.shape[:2]
    q_rot = rotate_half(q, c[:, None, :], s[:, None, :])
    pad = [torch.nn.functional.pad(x, (0, W - D)) for x in (q_rot, k, v)]
    ones = torch.ones(B, W // 2)
    got = pa.paged_decode_attention_plain(pad[0], ones, ones * 0, *pad[1:],
                                          bt, pos, 2, ks, vs, scheme,
                                          scale=D ** -0.5)
    torch.testing.assert_close(got[..., :D], want, rtol=PAD_TOL,
                               atol=PAD_TOL)
    assert not got[..., D:].any()


# ------------------------------------------------ against the JAX kernel
@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("bs,KVH,rep", [(12, 1, 7), (16, 2, 1)])
@pytest.mark.parametrize("D", [80, 88, 96, 256])
def test_plain_decode_matches_jax_kernel(D, bs, KVH, rep, scheme):
    # the JAX decode through its Pallas kernel (_pallas_partials) in
    # interpret mode: pages of 12 (7 q heads over 1 kv head) and of 16
    # (no GQA), frontiers that straddle pages, over the poisoned block 0;
    # the returned pools (and scales) bit for bit
    ops = decode_operands(B=2, KVH=KVH, rep=rep, D=D, bs=bs, nbs=4,
                          seed=D + bs + rep)
    kw, jkw = {}, {}
    if scheme is not None:
        (kc, ks), (vc, vs) = (kv_quant.quantize_kv(torch.from_numpy(x),
                                                   scheme)
                              for x in ops[3:5])
        ops[3:5] = [kc.numpy(), vc.numpy()]
        kw = dict(k_scale=ks, v_scale=vs, kv_cache_dtype=scheme)
        jkw = dict(k_scale=jnp.asarray(ks.numpy()),
                   v_scale=jnp.asarray(vs.numpy()), kv_cache_dtype=scheme)
    got = pa.fused_paged_decode(*[torch.from_numpy(a) for a in ops],
                                num_splits=2, **kw)
    want = jax_fused_paged_decode(*[jnp.asarray(a) for a in ops],
                                  num_splits=2, use_pallas=True,
                                  interpret=True, **jkw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=JAX_TOL, atol=JAX_TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------- a model of head_dim 96
def _prompts():
    rng = np.random.RandomState(6)
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
@pytest.mark.parametrize("scheme", ["int8", "fp8"])
def test_head_dim_96_quantized_engine_matches_jax(scheme, block_size):
    # the shape the padded 128-column decode takes on the card (head_dim
    # 96) over int8 and fp8 pools of pages of 12 and 16, in f32 here: the
    # port's Engine against the JAX Engine, prefix cache on
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
            num_blocks=40, fused_kernels=True, kv_cache_dtype=scheme))
        out.append(_serve(engine, _prompts()))
    (jtok, jctr), (tok, ctr) = out
    assert tok == jtok and ctr == jctr
    assert ctr["requests_completed"] == 4
    assert ctr["prefix_cache_hits"] > 0
