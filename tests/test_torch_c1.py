"""The shapes the fast bf16 kernels are not built for, on the CPU: the
port's ``Engine`` against the JAX ``Engine`` on a tiny f32 Llama with
Qwen2-style grouped heads (7 query heads over 1 kv head: rep 7, head_dim
20) and pages of 12 tokens, dense and MoE (whose serving layer folds its
input RMSNorm into its q/k/v group); the route of each kernel family
(which CUDA kernel a shape takes) on those shapes and on the Llama-3-8B
and Mixtral shapes, which keep the fast kernels; the plain row scale
against the JAX ``rms_scale``; the plain combine with gates in the
tokens' dtype against the JAX combine kernel in interpret mode.

On the CPU the wrappers run their plain versions; the routes are pure
functions of the operands' shapes, dtypes and addresses (meta tensors
stand in for the card's).  Tolerances: greedy tokens and scheduling
counters identical; the row scale within 4 f32 ulps (the two sum in
other orders); combine within one bf16 ulp of each output (bit for bit
where every choice has weight 1); the fold bit for bit in f32.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kernels import moe_dispatch as jmoe
from paddle_tpu.kernels.fused_norm_linear import rms_scale as jax_rms_scale
from paddle_tpu.models import LlamaConfig as JaxLlamaConfig
from paddle_tpu.models import LlamaForCausalLM as JaxLlamaForCausalLM
from paddle_tpu.serving import Engine as JaxEngine
from paddle_tpu.serving import ServingConfig as JaxServingConfig
from paddle_tpu_torch.convert import from_jax_state_dict
from paddle_tpu_torch.kernels import chunked_prefill as cp
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_norm_linear as fnl
from paddle_tpu_torch.kernels import moe_dispatch as tmoe
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.kernels import rms_norm
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.serving import Engine, ServingConfig
from torch_operands import moe_routing

# the tiny C1 model: rep 7, head_dim 20, N and K = 4 (mod 8)
C1 = dict(hidden_size=140, num_attention_heads=7, num_key_value_heads=1,
          intermediate_size=92)
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=2.0)
COUNTERS = ("requests_completed", "preemptions", "prefix_cache_hits",
            "prefix_cache_misses", "prefill_chunks", "decode_iterations",
            "tokens_generated")


def _models(**opts):
    paddle.seed(0)
    jax_model = JaxLlamaForCausalLM(JaxLlamaConfig.tiny(**C1, **opts))
    jax_model.eval()
    named = {k: np.asarray(v.numpy())
             for k, v in jax_model.state_dict().items()}
    return jax_model, from_jax_state_dict(
        named, LlamaConfig.tiny(**C1, **opts), device="cpu")


def _prompts():
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, 256, size=26)
    return [np.concatenate([prefix, rng.randint(1, 256, size=5)]),
            rng.randint(1, 256, size=13), rng.randint(1, 256, size=3),
            rng.randint(1, 256, size=30),
            np.concatenate([prefix, rng.randint(1, 256, size=9)])]


def _serve(engine, prompts):
    """The last prompt shares the first's 26-token prefix (two pages of
    12) and is submitted once that prefix is registered."""
    reqs = [engine.submit(p, max_new_tokens=10) for p in prompts[:-1]]
    while not reqs[0].generated:
        engine.step()
    reqs.append(engine.submit(prompts[-1], max_new_tokens=10))
    engine.run_until_complete()
    engine.pool.check_leaks()
    counters = engine.stats()["counters"]
    return ([[int(x) for x in r.generated] for r in reqs],
            {k: counters[k] for k in COUNTERS})


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("config", [
    dict(num_blocks=48), dict(num_blocks=48, enable_prefix_cache=False),
    dict(num_blocks=6)], ids=["prefix-cache", "no-prefix-cache",
                              "preemption"])
def test_engine_matches_jax(moe, config):
    # pages of 12 tokens, rep 7, head_dim 20: every general instance's
    # shape on the card (the MoE model at the dropless factor E / K)
    models = _models(**(MOE if moe else {}))
    out = []
    for m, engine_cls, config_cls in ((models[0], JaxEngine,
                                       JaxServingConfig),
                                      (models[1], Engine, ServingConfig)):
        engine = engine_cls(m, config_cls(
            max_batch_size=4, block_size=12, chunk_tokens=16,
            fused_kernels=True, **config))
        out.append(_serve(engine, _prompts()))
    (jtok, jctr), (tok, ctr) = out
    assert tok == jtok and ctr == jctr
    assert ctr["requests_completed"] == 5
    assert (ctr["preemptions"] > 0) == (config["num_blocks"] == 6)
    assert (ctr["prefix_cache_hits"] > 0) == \
        config.get("enable_prefix_cache", True)


def test_moe_fold_is_the_unfused_layer_in_f32():
    # the MoE layer's q/k/v through rms_scale and one fused_norm_linear
    # group give the bits of rms_norm then the three products, in f32
    model = _models(**MOE)[1]
    layer = model.model.layers[0]
    x = torch.from_numpy(np.random.RandomState(3).randn(2, 9, 140)
                         .astype(np.float32))
    ln, attn = layer.input_layernorm, layer.self_attn
    folded = fnl.fused_norm_linear_group(
        x, fnl.rms_scale(x, ln.eps), ln.weight,
        [p.weight for p in (attn.q_proj, attn.k_proj, attn.v_proj)],
        ["none"] * 3)
    normed = rms_norm.rms_norm_plain(x, ln.weight, ln.eps)
    with torch.no_grad():
        for got, proj in zip(folded, (attn.q_proj, attn.k_proj,
                                      attn.v_proj)):
            assert torch.equal(got, proj(normed))


# ------------------------------------------------------------ the routes
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


# (tag, H, KVH, D, block size, whether the Hopper paged decode takes it:
# any rep and block size at every head_dim that is a multiple of 8 up to
# 256)
ATTN_SHAPES = [
    ("llama3_8b", 32, 8, 128, 16, True), ("mixtral", 32, 8, 128, 16, True),
    ("tiny_rep2_d64", 4, 2, 64, 8, True),
    ("qwen2_7b_pages12", 28, 4, 128, 12, True),
    ("qwen2_7b_pages16", 28, 4, 128, 16, True),     # rep 7
    ("tiny_c1", 7, 1, 20, 12, False), ("phi2", 32, 32, 80, 16, True),
    ("phi3_mini", 32, 32, 96, 16, True),
    ("gemma_7b", 16, 16, 256, 16, True), ("gemma_2b", 8, 1, 256, 12, True)]


@pytest.mark.parametrize("tag,H,KVH,D,bs,fast", ATTN_SHAPES,
                         ids=[s[0] for s in ATTN_SHAPES])
def test_decode_route(tag, H, KVH, D, bs, fast):
    # the Hopper kernel: every D that is a multiple of 8 up to 256 (on
    # instances of 64, 128 or 256 columns), any rep (sub-groups of 1, 2
    # or 4 q heads a block) and page size; every other bf16 shape the
    # general instance, under its name
    q, pool = _meta(8, H, D), _meta(40, bs, KVH, D)
    assert pa.hopper_path(q, pool, pool, H // KVH) == fast
    want = "paged_decode" if fast else "paged_decode_general"
    assert pa.counter_name(q, fast, None) == want
    assert pa.counter_name(q, fast, "int8") == want + "_int8"


@pytest.mark.parametrize("tag,H,KVH,D,bs,fast", ATTN_SHAPES,
                         ids=[s[0] for s in ATTN_SHAPES])
def test_chunk_route(tag, H, KVH, D, bs, fast):
    # the wgmma kernel: any D that is a multiple of 8 up to 256 over pools
    # of any page size and rep; bf16 pages of 8, 16, 32 or a multiple of
    # 64 load as TMA boxes, others by its copy producer (code pools:
    # their own producer); the tiny model's 20 the general instance
    q, pool = _meta(1, 256, H, D), _meta(40, bs, KVH, D)
    wgmma = D % 8 == 0
    assert (cp.wgmma_width(q, pool, pool) is not None) == wgmma
    assert cp.copy_producer(bs) == (bs not in (8, 16, 32))
    codes, scale = _meta(40, bs, KVH, D, dtype=torch.int8), \
        _meta(40, bs, dtype=torch.float32)
    assert (cp.wgmma_width(q, codes, codes, (scale, scale))
            is not None) == wgmma
    assert not cp.copy_producer(bs, "fp8")
    assert wgmma == (fast or tag != "tiny_c1")


@pytest.mark.parametrize("tag,H,KVH,D,bs,fast", ATTN_SHAPES,
                         ids=[s[0] for s in ATTN_SHAPES])
def test_flash_route(tag, H, KVH, D, bs, fast):
    # training's attention with strides TMA takes (the model's
    # [B, T, H, D] views): every kernel on the wgmma kernels at every
    # head_dim that is a multiple of 8 (Phi's 80 and 96, Gemma's 256);
    # the general ones else (D 20); f32 always the general ones, under
    # the plain names
    q = _meta(1, 64, H, D).transpose(1, 2)
    k = _meta(1, 64, KVH, D).transpose(1, 2)
    for kernel in (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV):
        assert fa.general_route(q, k, kernel) == (D % 8 != 0)
        assert fa._launch_name(kernel, q, k) == (
            kernel + "_general" if D % 8 else kernel)
    assert fa.general_route(q, k, fa.BWD_DKV) == (tag == "tiny_c1")
    f32 = [x.float() for x in (q, k)]
    for kernel in (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV):
        assert fa.general_route(*f32, kernel)
        assert fa._launch_name(kernel, *f32) == kernel


@pytest.mark.parametrize("D", [257, 384])
def test_head_dim_above_256_raises_before_launching(monkeypatch, D):
    # the general chunk and flash instances go to head_dim 256 (Gemma's);
    # wider raises before any binding or launch, with the limit
    monkeypatch.setattr(cp._build, "bind", _no_binding)
    q, pool = _meta(1, 8, 2, D), _meta(4, 12, 1, D)
    table = torch.zeros(1, 4, dtype=torch.int32, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="at most 256"):
        cp.chunked_attention(q, pool, pool, table, pos)
    with pytest.raises(ValueError, match="at most 256"):
        fa.general_route(q.transpose(1, 2), pool[:1].transpose(1, 2),
                         fa.FWD)


def _no_binding(*args, **kwargs):
    raise AssertionError("bound a kernel")


@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("K,Ns,fast", [
    (4096, (4096, 1024, 1024), True),      # Llama-3-8B's q/k/v
    (4096, (14336, 14336), True),          # its gate/up
    (3584, (3584, 512, 512), True),        # Qwen2-7B's q/k/v
    (140, (140, 20, 20), False),           # the tiny C1 model's
    (140, (92, 92), False),
    (3588, (3588, 516, 516), False),       # N and K = 4 (mod 8)
    (4100, (4096,), None)])                # K = 4 (mod 8) alone
def test_fused_norm_linear_route(M, K, Ns, fast):
    # the Hopper kernels: N a multiple of 8, K too above 8 rows, aligned
    # operands; K = 4 (mod 8) at most 8 rows still takes the skinny one
    x, nw = _meta(M, K), _meta(K)
    if fast is None:
        fast = M <= fnl.SKINNY_MAX_ROWS
    assert all(fnl.hopper_ok(x, nw, _meta(K, n)) == fast for n in Ns)


# --------------------------------------------- the row scale and combine
@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
@pytest.mark.parametrize("shape", [(8, 4096), (3, 5, 140), (7, 64)])
def test_rms_scale_matches_jax(shape, dtype):
    x = (np.random.RandomState(sum(shape)).randn(*shape) * 3).astype(dtype)
    xt = torch.from_numpy(x.astype(np.float32))
    if dtype != np.float32:
        xt = xt.bfloat16()
    got = rms_norm.rms_scale(xt, 1e-5)
    want = np.asarray(jax_rms_scale(jnp.asarray(x), 1e-5))
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert fnl.rms_scale is rms_norm.rms_scale
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=4)


@pytest.mark.parametrize("case", ["random", "unique", "clamped"])
def test_combine_with_bf16_gates_matches_jax(case):
    # the model passes the gates in the tokens' dtype; the kernel reads
    # them as given, which is their exact f32 value
    T, M, E, C = 64, 128, 4, 16
    rng = np.random.RandomState(2)
    eo = rng.randn(E, C, M).astype(np.float32).astype(ml_dtypes.bfloat16)
    eidx, sidx, w = moe_routing(case, T, E, C, 2, seed=4)
    wb = w.astype(ml_dtypes.bfloat16)
    want = jmoe.moe_combine(jnp.asarray(eo), jnp.asarray(eidx),
                            jnp.asarray(sidx), jnp.asarray(wb),
                            jmoe.DEFAULT_BT, jmoe.DEFAULT_BC, True)
    to_t = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)
    got = tmoe.combine_plain(to_t(eo), torch.from_numpy(eidx),
                             torch.from_numpy(sidx), to_t(wb))
    assert torch.equal(got, tmoe.combine_plain(
        to_t(eo), torch.from_numpy(eidx), torch.from_numpy(sidx),
        to_t(wb).float()))
    g, w_ = (np.asarray(x, np.float32) for x in (got.float(), want))
    if case == "unique":
        np.testing.assert_array_equal(g, w_)
    else:
        mag = np.maximum(np.abs(g), np.abs(w_))
        ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
        assert np.all(np.abs(g - w_) <= ulp)


@pytest.mark.parametrize("M", [8, 256])
def test_group_splits_by_route_before_the_launch(monkeypatch, M):
    # a group whose third weight the Hopper kernels do not take (N = 20):
    # one launch of the skinny or wgmma entry for the first two, one of
    # the general entry for the third, each with its own widths, counted
    # under its own name (meta tensors through a fake binding)
    from paddle_tpu_torch.kernels import _build, launches

    calls = []
    monkeypatch.setattr(_build, "bind", lambda lib, fn, argtypes: (
        lambda *a: calls.append((fn, a)) or 0))
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    K = 64
    x, nw, rs = _meta(M, K), _meta(K), _meta(M, 1, dtype=torch.float32)
    ws = [_meta(K, 128), _meta(K, 64), _meta(K, 20)]
    launches.reset()
    outs = fnl.fused_norm_linear_group(x, rs, nw, ws,
                                       ["silu", "none", "silu"])
    assert [o.shape for o in outs] == [(M, 128), (M, 64), (M, 20)]
    (fast, fast_args), (general, general_args) = calls
    assert fast == "fused_norm_linear_group"
    assert general == "fused_norm_linear_general"
    # widths of the three slots, the silu mask, the count, M and K
    assert fast_args[9:15] == (128, 64, 128, 1, 2, M) and fast_args[15] == K
    assert general_args[9:16] == (20, 20, 20, 1, 1, M, K)
    assert general_args[16] == _build.DTYPE_CODES["torch.bfloat16"]
    assert launches.snapshot() == {fnl.kernel_name(M): 1, fnl.GENERAL: 1}
