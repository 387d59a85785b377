"""The Python side of the port's Hopper (wgmma + TMA) kernels, on the CPU:
the grouped fused_norm_linear against the JAX package and against its
single-weight calls and the groups it refuses, the strides the
FlashAttention forward's and dK/dV's tensor maps take, the block sizes
the bf16 chunked-prefill kernel loads by TMA (and those its copy
producer takes), fused_linear at widths that are
not a multiple of 8 against the JAX kernel, and the route between
fused_linear's two bf16 instances (``tma_ok``).

On the CPU the wrappers run their plain PyTorch versions; the JAX
functions run their XLA fallback or their Pallas kernel in interpret
mode.  f32 tolerance 1e-5 (the two frameworks sum in different orders).
The CUDA kernels are held against the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py; the pure-Python plans of
the skinny fused_norm_linear (its K split), of the paged decode (its
splits, which kernel takes the operands, its GQA sub-groups and its
page division) and of the MoE dispatch (its persistent blocks,
``dispatch_plan``) are held here case by case, and the paged decode's,
the chunk's, the MoE dispatch's and the KV write's wrappers shown to
refuse what their kernels do not take before any launch and to pass
their arguments to the C entry (a fake binding over meta tensors).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused_linear import fused_linear as jax_fused_linear
from paddle_tpu.kernels.fused_norm_linear import (fused_norm_linear as
                                                  jax_fused_norm_linear)
from paddle_tpu_torch.kernels import _build, chunked_prefill as cp
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import fused_linear as fl
from paddle_tpu_torch.kernels import fused_norm_linear as fnl
from paddle_tpu_torch.kernels import kv_quant as kvq
from paddle_tpu_torch.kernels import launches
from paddle_tpu_torch.kernels import moe_dispatch as md
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.tools import dispatch_parts
from paddle_tpu_torch.tools import fused_linear_parts as fl_parts
from paddle_tpu_torch.tools import kv_write_parts
from paddle_tpu_torch.tools import ring_stress

TOL = 1e-5


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------- fused_norm_linear
@pytest.mark.parametrize("acts", [["none"], ["none"] * 3, ["silu", "none"],
                                  ["none", "silu", "silu"]])
@pytest.mark.parametrize("lead", [(1,), (3,), (4,), (8,), (2, 10)])
def test_group_matches_jax_and_single_calls(lead, acts):
    # at most 8 rows the card runs the group as one skinny launch, above
    # as one tiled launch; on the CPU both are the plain single calls
    rng = np.random.RandomState(len(acts) + len(lead))
    K = 24
    x = rng.randn(*lead, K).astype(np.float32)
    nw = rng.randn(K).astype(np.float32)
    ws = [rng.randn(K, 8 * (i + 1)).astype(np.float32)
          for i in range(len(acts))]
    rs = fnl.rms_scale(t(x), 1e-5)
    before = launches.snapshot()
    outs = fnl.fused_norm_linear_group(t(x), rs, t(nw), [t(w) for w in ws],
                                       acts)
    assert launches.snapshot() == before      # a CPU tensor launches nothing
    assert len(outs) == len(ws)
    for out, w, act in zip(outs, ws, acts):
        assert out.shape == (*lead, w.shape[1])
        assert torch.equal(out, fnl.fused_norm_linear(t(x), rs, t(nw), t(w),
                                                      act))
        close(out.numpy().reshape(-1, w.shape[1]), jax_fused_norm_linear(
            jnp.asarray(x.reshape(-1, K)),
            jnp.asarray(rs.numpy().reshape(-1, 1)), jnp.asarray(nw),
            jnp.asarray(w), act, use_pallas=False))


@pytest.mark.parametrize("n,acts", [
    (2, ["none"]), (2, ["none", "gelu"]), (0, []), (4, ["none"] * 4)])
def test_group_rejects_what_it_does_not_take(n, acts):
    # activations one a weight, none or silu; 1 to MAX_GROUP weights
    assert fnl.MAX_GROUP == 3
    x = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="fused_norm_linear_group"):
        fnl.fused_norm_linear_group(x, torch.ones(4, 1), torch.ones(8),
                                    [torch.zeros(8, 8)] * n, acts)


@pytest.mark.parametrize("K,plan", [
    (4096, (4, 1024)),    # Llama's hidden: 4 ranks of 1024 rows
    (1000, (1, 1024)), (64, (1, 64)), (24, (1, 64)),
    (1100, (2, 576)),     # 550 rows a rank, rounded up to whole k-tiles
    (3000, (3, 1024)), (8192, (8, 1024)),
    (14336, (8, 1792))])  # the down projection's K: the cluster is full
def test_skinny_plan(K, plan):
    splits, rows = fnl.skinny_plan(K)
    assert (splits, rows) == plan
    assert rows % fnl.SKINNY_BK == 0 and splits * rows >= K
    assert (splits - 1) * rows < K          # every rank has rows of w
    assert fnl.skinny_smem_bytes(rows) <= fnl.SMEM_OPT_IN


def test_skinny_smem_bytes():
    # 4 stages of 8 KB, 8 rows of 1032 bf16, the 64 x 8 f32 tile, 8
    # barriers, 1 KB of alignment: four blocks fit a SM's 228 KB
    assert fnl.skinny_smem_bytes(1024) == 1024 + 32768 + 16512 + 2048 + 64
    assert 4 * (fnl.skinny_smem_bytes(1024) + 1024) <= 228 * 1024


@pytest.mark.parametrize("variant,fences,syncs", [
    ("as_is", 2, 2), ("fence_only", 2, 0), ("syncwarp_only", 0, 2),
    ("neither", 0, 0)])
def test_ring_stress_variants(variant, fences, syncs):
    # the stress script's copies of csrc/fused_norm_linear.cu take the
    # fence and/or the __syncwarp out of both kernels' stage releases
    # and change nothing else
    src = (ring_stress._build.CSRC / "fused_norm_linear.cu").read_text()
    out = ring_stress.variant_source(src, ring_stress.VARIANTS[variant])
    releases = [i for i, ln in enumerate(out.split("\n"))
                if "mbar_arrive(&empty[" in ln and "lane == 0" in ln]
    assert len(releases) == 2
    before = [ln.strip() for i in releases
              for ln in out.split("\n")[i - 2:i]]
    assert before.count(ring_stress.FENCE) == fences
    assert before.count(ring_stress.SYNC) == syncs
    assert len(src.split("\n")) - len(out.split("\n")) == \
        4 - fences - syncs


@pytest.mark.parametrize("variant,changed", [
    ("as_is", 0), ("no_store", 1), ("no_epilogue", 1), ("no_products", 2)])
def test_fused_linear_parts_variants(variant, changed):
    # the timing script's copies of csrc/fused_linear.cu change only the
    # lines they name, each found once in the source
    src = (_build.CSRC / "fused_linear.cu").read_text()
    out = fl_parts.variant_source(src, fl_parts.VARIANTS[variant])
    a, b = src.split("\n"), out.split("\n")
    assert len(a) == len(b)
    assert sum(x != y for x, y in zip(a, b)) == changed


@pytest.mark.parametrize("tool,variant,changed", [
    (dispatch_parts, "as_is", 0), (dispatch_parts, "no_index", 1),
    (dispatch_parts, "no_rows", 2), (dispatch_parts, "slot_order", 1),
    (dispatch_parts, "no_stream", 1), (kv_write_parts, "as_is", 0),
    (kv_write_parts, "no_max", 1), (kv_write_parts, "no_div", 1),
    (kv_write_parts, "no_encode", 1)])
def test_parts_tools_variants(tool, variant, changed):
    # the MoE dispatch's and the KV write's timing copies change only the
    # lines they name, each found once in the source
    src = (_build.CSRC / f"{tool.LIB}.cu").read_text()
    out = fl_parts.variant_source(src, tool.VARIANTS[variant])
    a, b = src.split("\n"), out.split("\n")
    assert len(a) == len(b)
    assert sum(x != y for x, y in zip(a, b)) == changed


def test_fused_linear_parts_refuses_a_missing_line():
    with pytest.raises(RuntimeError, match="found 0 times"):
        fl_parts.variant_source("no such line", (("tma_store_2d(", ""),))


# ------------------------------------------------------- flash attention
def _view(B, H, T, D, layout, pad=0):
    """A [B, H, T, D] view in the given memory order; ``pad`` extra
    elements at the end of each row of D."""
    bf = torch.bfloat16
    if layout == "bhtd":
        return torch.zeros(B, H, T, D + pad, dtype=bf)[..., :D]
    return torch.zeros(B, T, H, D + pad, dtype=bf)[..., :D].transpose(1, 2)


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("D", [64, 128])
def test_tma_strides_of_dense_views(layout, D):
    q = _view(2, 4, 33, D, layout)
    assert fa.tma_strides(q) == list(q.stride()[:3])


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
@pytest.mark.parametrize("pad", [1, 3, 4])
def test_tma_strides_refuse_what_tma_cannot_take(layout, pad):
    # rows of D + pad bf16 are not a multiple of 16 bytes apart
    q = _view(2, 4, 33, 64, layout, pad)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.tma_strides(q)


def test_tma_strides_take_rows_padded_to_16_bytes():
    q = _view(1, 2, 5, 64, "bhtd", pad=8)
    assert fa.tma_strides(q) == [q.numel(), 5 * 72, 72]


@pytest.mark.parametrize("shape", [(1, 4, 33, 64), (2, 1, 33, 64),
                                   (1, 1, 1, 128)])
def test_strides_of_unit_axes_never_matter(shape):
    # an axis of extent 1 gets the view's element count (a multiple of
    # D), whatever stride PyTorch gave it
    q = torch.zeros(shape).bfloat16()
    odd = q.as_strided(shape, [7 if n == 1 else s
                               for n, s in zip(shape, q.stride())])
    want = [q.numel() if n == 1 else s
            for n, s in zip(shape[:3], q.stride()[:3])]
    assert fa._strides(odd) == want
    assert fa.tma_strides(odd) == want


def _bwd_inputs(D, layout):
    q, do = _view(1, 4, 33, D, layout), _view(1, 4, 33, D, layout)
    k = _view(1, 2, 40, D, layout)
    lse, delta = torch.zeros(1, 4, 33), torch.zeros(1, 4, 33)
    return q, k, k.clone(), do, lse, delta


@pytest.mark.parametrize("layout", ["bhtd", "bthd"])
def test_backward_checks_tma_strides(monkeypatch, layout):
    # dK/dV loads q, dO, k and v by TMA: the backward's operands go
    # through tma_strides in the route (here on the CPU, the device check
    # left out), and strides TMA cannot take go to the general kernels
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    ops = fa._bwd_operands(*_bwd_inputs(64, layout))
    assert fa.tma_strides(ops[0]) == fa._strides(ops[0])
    assert ops[3].stride() == ops[0].stride()     # dO takes q's strides
    for kernel in (fa.BWD_DQ, fa.BWD_DKV):
        assert not fa.general_route(ops[0], ops[1], kernel)
        assert fa._launch_name(kernel, ops[0], ops[1]) == kernel
    # rows of 68 bf16 (136 bytes) are not a multiple of 16 bytes apart:
    # the general instances take them, under their own counters
    ops = fa._bwd_operands(*_bwd_inputs(68, layout))
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa.tma_strides(ops[0])
    for kernel in (fa.BWD_DQ, fa.BWD_DKV):
        assert fa.general_route(ops[0], ops[1], kernel)
        assert fa._launch_name(kernel, ops[0], ops[1]) == kernel + "_general"
    # f32 always takes them, under the plain names; head_dim 256 takes
    # dQ's, dK/dV's (and the forward's) wgmma instances of 256 columns,
    # above 256 nothing
    f32 = [x.float() for x in ops[:2]]
    assert fa.general_route(*f32, fa.BWD_DQ)
    assert fa._launch_name(fa.BWD_DQ, *f32) == fa.BWD_DQ
    gemma = _view(1, 2, 8, 256, layout)
    assert not fa.general_route(gemma, gemma, fa.BWD_DKV)
    assert fa._launch_name(fa.BWD_DKV, gemma, gemma) == fa.BWD_DKV
    assert fa.wgmma_width(gemma, gemma, fa.BWD_DKV) == 256
    assert fa.wgmma_width(gemma, gemma, fa.BWD_DQ) == 256
    assert fa._launch_name(fa.BWD_DQ, gemma, gemma) == fa.BWD_DQ
    wide = _view(1, 2, 8, 384, layout)
    with pytest.raises(ValueError, match="at most 256"):
        fa.general_route(wide, wide, fa.BWD_DQ)


# ------------------------------------------------------- chunked prefill
@pytest.mark.parametrize("bs,ok", [
    (8, True), (16, True), (32, True), (64, True), (128, True), (192, True),
    (1, False), (4, False), (12, False), (24, False), (96, False)])
def test_chunk_wgmma_block_sizes(bs, ok):
    # the wgmma kernel takes bf16 pools of every page size: whole TMA
    # boxes of 8 to 64 rows of one page a key tile (ok), every other
    # size by its copy producer; code pools by their own producer
    assert cp.tma_block_size_ok(bs) == ok
    assert cp.copy_producer(bs) == (not ok)
    assert not cp.copy_producer(bs, "int8")
    q = torch.empty(1, 4, 8, 128, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(3, bs, 2, 128, dtype=torch.bfloat16, device="meta")
    assert cp.wgmma_width(q, pool, pool) == 128


@pytest.mark.parametrize("bs,D,tma", [(12, 64, 0), (16, 64, 1),
                                      (16, 80, 1), (96, 128, 0),
                                      (12, 96, 0), (16, 256, 1),
                                      (16, 100, 1)])
def test_chunk_refuses_block_sizes_before_launching(monkeypatch, bs, D,
                                                    tma):
    # a bf16 call over bf16 pools goes to the wgmma kernel at any head_dim
    # that is a multiple of 8, by TMA boxes where the page size is whole
    # boxes, else by its copy producer; another head_dim (100) goes to the
    # general instance, counted as chunked_prefill_general.  Chosen
    # before the launch: both flags reach the C entry (here on meta
    # tensors, which take the kernel path, through a fake binding)
    wgmma = int(D % 8 == 0)
    assert cp.tma_block_size_ok(bs) == bool(tma)
    copy = int(wgmma and not tma)
    calls = []

    def bind(lib, fn, argtypes):
        if fn == "chunked_prefill_smem_bytes":
            return lambda *a: 1024
        return lambda *a: calls.append(a) or 0

    monkeypatch.setattr(_build, "bind", bind)
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    q = torch.empty(1, 4, 8, D, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(3, bs, 2, D, dtype=torch.bfloat16, device="meta")
    assert (cp.wgmma_width(q, pool, pool) is not None) == bool(wgmma)
    launches.reset()
    cp.chunked_attention(q, pool, pool,
                         torch.zeros(1, 2, dtype=torch.int32, device="meta"),
                         torch.zeros(1, dtype=torch.int32, device="meta"))
    (args,) = calls
    assert args[-3:-1] == (wgmma, copy)
    assert launches.snapshot() == {
        cp.KERNEL if wgmma else cp.GENERAL: 1}


# ----------------------------------------------------------- fused_linear
@pytest.mark.parametrize("K", [3, 5, 12, 37])
@pytest.mark.parametrize("act", ["relu", "gelu"])
def test_fused_linear_any_k_matches_jax(K, act):
    # K % 8 != 0 runs on the card too (predicated loads there); the JAX
    # kernel in interpret mode takes a K its tile covers whole
    rng = np.random.RandomState(K)
    x = rng.randn(32, K).astype(np.float32)
    w = (rng.randn(K, 24) / np.sqrt(K)).astype(np.float32)
    b = rng.randn(24).astype(np.float32)
    got = fl.fused_linear(t(x), t(w.T.copy()), t(b), act)
    want = jax_fused_linear(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                            activation=act, bm=32, bn=24, bk=K,
                            interpret=True)
    close(got.numpy(), np.asarray(want))


# The route between fused_linear's two bf16 instances, decided from the
# operands before any launch: the wgmma instance where TMA's tensor maps
# take x [M, K], w [N, K] and out [M, N] (K and N multiples of 8, bases
# 16-byte aligned), the predicated instance for every other bf16 call.
@pytest.mark.parametrize("M,K,N,want", [
    (16384, 768, 3072, True),     # BERT-base's FFN
    (16384, 768, 768, True),      # its MLM transform
    (1, 72, 3080, True),          # K % 64 != 0, N % 128 != 0
    (130, 776, 8, True),
    (16384, 771, 3072, False),    # K % 8 != 0
    (32, 3, 24, False),
    (32, 5, 24, False),
    (4, 0, 8, False),             # K = 0: no map of extent 0
    (130, 72, 1, False),          # N % 8 != 0: the output's row stride
    (130, 72, 130, False),
    (37, 40, 13, False)])
def test_fused_linear_tma_route_by_shape(M, K, N, want):
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    w = torch.zeros(N, K, dtype=torch.bfloat16)
    assert fl.tma_ok(x, w) is want


@pytest.mark.parametrize("which", ["x", "w"])
def test_fused_linear_tma_route_by_alignment(which):
    # a view 2 bytes past a 16-byte boundary takes the predicated
    # instance, the same operands aligned the wgmma one
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    w = torch.zeros(32, 64, dtype=torch.bfloat16)
    assert fl.tma_ok(x, w)
    t = x if which == "x" else w
    buf = torch.zeros(t.numel() + 8, dtype=torch.bfloat16)
    view = buf[1:t.numel() + 1].view(t.shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    assert not fl.tma_ok(*((view, w) if which == "x" else (x, view)))


def test_fused_linear_tma_route_by_dtype():
    # f32 has its own kernel: never the bf16 wgmma instance
    assert not fl.tma_ok(torch.zeros(64, 64), torch.zeros(32, 64))


@pytest.mark.parametrize("K,N,dtype,flag", [
    (768, 3072, torch.bfloat16, 1), (771, 3072, torch.bfloat16, 0),
    (768, 130, torch.bfloat16, 0), (768, 3072, torch.float32, 0)])
def test_fused_linear_passes_the_route_to_the_launch(monkeypatch, K, N,
                                                     dtype, flag):
    # the C entry gets tma_ok's answer as its tma argument, before the
    # launch (meta tensors stand in for CUDA ones: nothing is computed)
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "bind", lambda *a, **k: entry)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    launches.reset()
    x = torch.empty(64, K, dtype=dtype, device="meta")
    w = torch.empty(N, K, dtype=dtype, device="meta")
    out = fl.fused_linear(x, w, None, "gelu")
    assert out.shape == (64, N) and launches.snapshot() == {fl.KERNEL: 1}
    (args,) = calls
    assert args[4:9] == (64, N, K, fl.ACTIVATIONS["gelu"],
                         _build.dtype_code(x))
    assert args[9] == flag


# ---------------------------------------------------------- paged decode
@pytest.mark.parametrize("B,KVH,nbs,bs,splits", [
    (8, 8, 512, 16, 7),     # the serving path: 3 blocks a SM
    (1, 8, 512, 16, 50),    # one sequence: 50 of its 128 chunks' worth
    (1, 2, 512, 16, 64),    # capped at MAX_SPLITS
    (64, 8, 512, 16, 1),    # a wide batch fills the card alone
    (8, 8, 8, 16, 2),       # a short table: no more splits than chunks
    (2, 2, 4, 4, 1)])       # the tests' tiny tables: one chunk
def test_decode_plan(B, KVH, nbs, bs, splits):
    assert pa.decode_plan(B, KVH, nbs, bs, 132) == splits


@pytest.mark.parametrize("B,KVH,D,scheme,splits", [
    (8, 32, 96, None, 6),      # Phi-3-mini: about 10 blocks a SM
    (8, 16, 256, None, 11),    # Gemma-7B
    (8, 32, 96, "int8", 2),    # code pools: 3 blocks a SM
    (8, 8, 128, None, 7)])     # D = 128: its own instance, 3 a SM
def test_padded_bf16_decode_plan(monkeypatch, B, KVH, D, scheme, splits):
    # the splits a launch hands the C entry: a padded instance over bf16
    # pools aims at PADDED_BF16_BLOCKS_PER_SM blocks a SM
    calls = _fake_decode(monkeypatch)
    q = torch.empty(B, KVH, D, dtype=torch.bfloat16, device="meta")
    dt = torch.bfloat16 if scheme is None else torch.int8
    pool = torch.empty(600, 16, KVH, D, dtype=dt, device="meta")
    sc = None if scheme is None else torch.empty(600, 16, device="meta")
    cs = torch.empty(B, D // 2, device="meta")
    pa.paged_decode_attention(
        q, cs, cs, pool, pool,
        torch.zeros(B, 512, dtype=torch.int32, device="meta"),
        torch.zeros(B, dtype=torch.int32, device="meta"), 1, sc, sc, scheme)
    (args,) = calls
    assert args[20] == splits


@pytest.mark.parametrize("dtype,rep,D,bs,want", [
    (torch.bfloat16, 4, 128, 16, True), (torch.bfloat16, 1, 64, 8, True),
    (torch.bfloat16, 8, 128, 32, True),     # two sub-groups of 4
    (torch.float32, 4, 128, 16, False),     # f32 keeps the general kernel
    # any rep and page size at every D that is a multiple of 8 up to 256;
    # another D the general one
    (torch.bfloat16, 3, 128, 16, True),     # padded to 4 heads a block
    (torch.bfloat16, 4, 96, 16, True),      # the padded 128 columns
    (torch.bfloat16, 4, 100, 16, False),    # not a multiple of 8
    (torch.bfloat16, 4, 128, 12, True)])    # not a power of two
def test_hopper_path(dtype, rep, D, bs, want):
    q = torch.zeros(2, 2 * rep, D, dtype=dtype)
    pool = torch.zeros(3, bs, 2, D, dtype=dtype)
    assert pa.hopper_path(q, pool, pool, rep) == want
    general = "paged_decode_general" if dtype == torch.bfloat16 and not want \
        else "paged_decode"
    assert pa.counter_name(q, want, None) == general
    assert pa.counter_name(q, want, "fp8") == general + "_fp8"


@pytest.mark.parametrize("rep,REP,groups", [
    (1, 1, 1), (2, 2, 1), (3, 4, 1), (4, 4, 1), (5, 4, 2), (6, 4, 2),
    (7, 4, 2), (8, 4, 2), (9, 4, 3), (12, 4, 3), (16, 4, 4), (17, 4, 5),
    (32, 4, 8)])
def test_hopper_group(rep, REP, groups):
    # the smallest instance that holds a sub-group, sub-groups of at most
    # 4 heads, none of them empty
    assert pa.hopper_group(rep) == (REP, groups)
    per = -(-rep // groups)
    assert per <= REP and (groups - 1) * per < rep


@pytest.mark.parametrize("bs", [1, 2, 3, 4, 5, 7, 12, 16, 24, 48, 96, 100,
                                1000, 4095])
def test_div_magic_finds_every_page(bs):
    # the kernel's (umulhi(n, magic) + n) >> shift, in 32-bit unsigned
    # arithmetic, against n // bs over every key of a 2^16-key table and
    # keys up to 2^31 - 1; a power of two takes the shift alone
    magic, shift = pa.div_magic(bs)
    assert (magic == 0) == (bs & (bs - 1) == 0)
    rng = np.random.RandomState(bs)
    n = np.concatenate([np.arange(1 << 16), rng.randint(0, 2 ** 31, 4096),
                        [2 ** 31 - 1]]).astype(np.uint64)
    hi = (n * np.uint64(magic)) >> np.uint64(32)
    assert (hi + n < 2 ** 32).all()
    got = ((hi + n) >> np.uint64(shift)) if magic else n >> np.uint64(shift)
    np.testing.assert_array_equal(got, n // np.uint64(bs))


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


@pytest.mark.parametrize("rep,bs", [(4, 16), (7, 12), (3, 16), (16, 12),
                                    (1, 48), (8, 4)])
def test_decode_passes_group_and_division_before_launching(monkeypatch, rep,
                                                           bs):
    # the true rep, the instance's REP, the sub-groups and the page
    # division (magic 0 and the shift for a power of two) reach the C
    # entry; the splits fill the card with B * KVH * groups blocks a split
    calls = _fake_decode(monkeypatch)
    B, KVH, D, nbs = 8, 4, 128, 40
    q = torch.empty(B, KVH * rep, D, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(60, bs, KVH, D, dtype=torch.bfloat16, device="meta")
    cs = torch.empty(B, D // 2, device="meta")
    launches.reset()
    pa.paged_decode_attention(
        q, cs, cs, pool, pool,
        torch.zeros(B, nbs, dtype=torch.int32, device="meta"),
        torch.zeros(B, dtype=torch.int32, device="meta"), 1)
    (args,) = calls
    REP, groups = pa.hopper_group(rep)
    magic, shift = pa.div_magic(bs)
    assert args[16] == rep and args[18] == bs
    assert args[20] == pa.decode_plan(B, KVH, nbs, bs, 132, groups)
    assert args[-5:-1] == (REP, groups, magic, shift)
    assert args[-6] == 128            # the instance's columns
    assert args[12] is not None       # the tickets
    assert launches.snapshot() == {pa.KERNEL: 1}
    assert launches.by_instance() == {f"{pa.KERNEL}@w128": 1}


def test_decode_general_instance_gets_no_group(monkeypatch):
    # head_dim 100 (not a multiple of 8): the general instance, REP 0,
    # width 0, no tickets
    calls = _fake_decode(monkeypatch)
    q = torch.empty(2, 14, 100, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(9, 12, 2, 100, dtype=torch.bfloat16, device="meta")
    cs = torch.empty(2, 50, device="meta")
    launches.reset()
    pa.paged_decode_attention(
        q, cs, cs, pool, pool,
        torch.zeros(2, 4, dtype=torch.int32, device="meta"),
        torch.zeros(2, dtype=torch.int32, device="meta"), 1)
    (args,) = calls
    assert args[-5] == 0 and args[-6] == 0 and args[12] is None
    assert launches.snapshot() == {pa.GENERAL: 1}


def test_hopper_path_refuses_unaligned_pools():
    # a pool view that starts 8 bytes into its storage: the kernel's
    # 16-byte row loads cannot take it
    q = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    flat = torch.zeros(3 * 16 * 2 * 128 + 4, dtype=torch.bfloat16)
    pool = flat[4:].view(3, 16, 2, 128)
    assert pool.data_ptr() % 16 == 8
    assert not pa.hopper_path(q, pool, pool, 4)   # the general instance
    aligned = flat[:-4].view(3, 16, 2, 128)
    assert pa.hopper_path(q, aligned, aligned, 4)


# ------------------------------------------------------------ MoE dispatch
@pytest.mark.parametrize("slots,n,M,plan", [
    (64, 16, 4096, (64, 1)),         # decode: a slot a block
    (2048, 512, 4096, (256, 8)),     # prefill chunk: 2 blocks a SM, 256
    (32768, 8192, 4096, (256, 128)),  # training
    (8192, 8192, 4096, (256, 32)),   # dropping: the choices cap the blocks
    (100, 16, 4096, (64, 2)),        # a power of two below the slots
    (1, 16, 4096, (1, 1)),
    (64, 0, 4096, (64, 1)),          # no choices: all rows zero
    (64, 16, 64, (16, 4)),           # narrow rows: fewer blocks
    (64, 16, 1, (1, 64)),
    (64, 1 << 20, 8, (1, 64)),       # many choices: one block reads them
    (2_000_000, 16, 4096, (1024, 1954)),  # MAX_SLOTS: more blocks
    (0, 16, 4096, (0, 0)),           # nothing to write: no launch
    (64, 16, 0, (0, 0))])
def test_dispatch_plan(slots, n, M, plan):
    blocks, per = md.dispatch_plan(slots, n, M, 132)
    assert (blocks, per) == plan
    if blocks:
        # a power of two; block b owns the slots b, b + blocks, ...: at
        # least one each, all of them covered, and a block's counts fit
        # its shared memory
        assert blocks & (blocks - 1) == 0
        assert blocks <= slots <= blocks * per
        assert -(-slots // blocks) == per     # block 0's slots
        assert per <= md.MAX_SLOTS


def _fake_entry(monkeypatch):
    """A stand-in for the C entry that records its arguments: meta
    tensors take the kernel path and nothing is computed."""
    calls = []

    def entry(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "bind", lambda *a, **k: entry)
    monkeypatch.setattr(_build, "stream_ptr", lambda t: None)
    monkeypatch.setattr(_build, "sm_count", lambda d: 132)
    launches.reset()
    return calls


@pytest.mark.parametrize("wdtype,M,vec", [
    (torch.bfloat16, 4096, 1), (torch.float32, 4096, 1),
    (torch.bfloat16, 100, 0)])      # 200-byte rows: the scalar instance
def test_dispatch_passes_its_plan_to_the_launch(monkeypatch, wdtype, M, vec):
    # weights reach the kernel as given (no cast launch); the plan and
    # the vector flag reach the C entry; one launch counted
    calls = _fake_entry(monkeypatch)
    T, K, E, C = 256, 2, 8, 64
    tok = torch.empty(T, M, dtype=torch.bfloat16, device="meta")
    idx = torch.empty(T, K, dtype=torch.int32, device="meta")
    w = torch.empty(T, K, dtype=wdtype, device="meta")
    out = md.moe_dispatch(tok, idx, idx, w, E, C)
    assert out.shape == (E, C, M) and out.dtype == torch.bfloat16
    assert launches.snapshot() == {md.DISPATCH: 1}
    (args,) = calls
    assert args[5:] == (T, K, M, E, C, 1, int(wdtype == torch.float32), vec,
                        *md.dispatch_plan(E * C, T * K, M, 132), None)


def test_dispatch_launches_nothing_for_empty_buffers(monkeypatch):
    calls = _fake_entry(monkeypatch)
    tok = torch.empty(4, 64, dtype=torch.bfloat16, device="meta")
    idx = torch.empty(4, 2, dtype=torch.int32, device="meta")
    w = torch.empty(4, 2, device="meta")
    assert md.moe_dispatch(tok, idx, idx, w, 8, 0).shape == (8, 0, 64)
    assert calls == [] and launches.snapshot() == {}


@pytest.mark.parametrize("bad,err", [
    ("int64 indices", TypeError), ("f16 weights", TypeError),
    ("f16 tokens", TypeError), ("short weights", ValueError)])
def test_dispatch_refuses_before_any_launch(monkeypatch, bad, err):
    calls = _fake_entry(monkeypatch)
    ops = dict(tok=torch.empty(8, 64, dtype=torch.bfloat16, device="meta"),
               idx=torch.empty(8, 2, dtype=torch.int32, device="meta"),
               w=torch.empty(8, 2, device="meta"))
    if bad == "int64 indices":
        ops["idx"] = ops["idx"].long()
    elif bad == "f16 weights":
        ops["w"] = ops["w"].half()
    elif bad == "f16 tokens":
        ops["tok"] = ops["tok"].half()
    else:
        ops["w"] = ops["w"][:4]
    with pytest.raises(err):
        md.moe_dispatch(ops["tok"], ops["idx"], ops["idx"], ops["w"], 8, 4)
    assert calls == [] and launches.snapshot() == {}


# ---------------------------------------------------------------- KV write
def _write_ops(form, pool, T=1, D=128, dtype=torch.bfloat16):
    """Meta operands of kv_write: (k_pool, v_pool, k, v, block_table,
    positions) and its keywords, for a decode step (``form`` "decode":
    c/s rows) or a prefill chunk ("chunk": a write mask) over pools of
    the rows' dtype (``pool`` None) or int8 codes of ``pool``."""
    B, KVH, nb, bs, nbs = 8, 8, 40, 16, 5

    def m(*shape, dt=dtype):
        return torch.empty(*shape, dtype=dt, device="meta")

    pdt = dtype if pool is None else torch.int8
    ops = [m(nb, bs, KVH, D, dt=pdt), m(nb, bs, KVH, D, dt=pdt),
           m(B, T, KVH, D), m(B, T, KVH, D), m(B, nbs, dt=torch.int32),
           m(B, dt=torch.int32)]
    kw = dict(scheme=pool)
    if pool is not None:
        kw.update(k_scale=m(nb, bs, dt=torch.float32),
                  v_scale=m(nb, bs, dt=torch.float32))
    if form == "decode":
        kw.update(c=m(B, D // 2), s=m(B, D // 2))
    else:
        kw.update(write_mask=m(B, T, dt=torch.bool))
    return ops, kw


@pytest.mark.parametrize("form,T", [("decode", 1), ("chunk", 256)])
@pytest.mark.parametrize("pool", [None, "int8", "fp8"])
@pytest.mark.parametrize("D,vec", [(128, 1), (72, 0)])
def test_kv_write_passes_its_operands_to_the_launch(monkeypatch, form, T,
                                                    pool, D, vec):
    # one launch; the shapes, the dtype codes (rows, c/s, pool scheme),
    # the c/s and mask pointers (absent in the other form) and the vector
    # flag (D / 2 a multiple of 8 bf16 elements) reach the C entry
    calls = _fake_entry(monkeypatch)
    ops, kw = _write_ops(form, pool, T, D)
    kvq.kv_write(*ops, **kw)
    assert launches.snapshot() == {kvq.KERNEL: 1}
    (args,) = calls
    decode = form == "decode"
    assert (args[2] is None, args[3] is None, args[6] is None) == \
        (not decode, not decode, decode)
    assert (args[9] is None) == (pool is None)
    assert args[11:21] == (8, T, 8, D, 16, 5, 1, int(decode),
                           kvq.KV_DTYPE_CODES[pool], vec)


@pytest.mark.parametrize("bad", [
    "c without s", "rotation of a chunk", "c rows", "int64 positions",
    "int64 table", "f32 pools for bf16 rows", "no scales", "mask shape",
    "odd head_dim", "v shape"])
def test_kv_write_refuses_before_any_launch(monkeypatch, bad):
    calls = _fake_entry(monkeypatch)
    form = "chunk" if bad in ("rotation of a chunk", "mask shape") \
        else "decode"
    ops, kw = _write_ops(form, "int8" if bad == "no scales" else None,
                         T=4 if form == "chunk" else 1,
                         D=7 if bad == "odd head_dim" else 128)
    if bad == "c without s":
        kw.pop("s")
    elif bad == "rotation of a chunk":
        kw.update(c=torch.empty(8, 64, dtype=torch.bfloat16, device="meta"),
                  s=torch.empty(8, 64, dtype=torch.bfloat16, device="meta"))
    elif bad == "c rows":
        kw["c"] = kw["s"] = torch.empty(8, 32, dtype=torch.bfloat16,
                                        device="meta")
    elif bad == "int64 positions":
        ops[5] = ops[5].long()
    elif bad == "int64 table":
        ops[4] = ops[4].long()
    elif bad == "f32 pools for bf16 rows":
        ops[0], ops[1] = ops[0].float(), ops[1].float()
    elif bad == "no scales":
        kw.pop("k_scale")
    elif bad == "mask shape":
        kw["write_mask"] = kw["write_mask"][:, :2]
    elif bad == "v shape":
        ops[3] = ops[3][:4]
    with pytest.raises(ValueError, match="kv_write"):
        kvq.kv_write(*ops, **kw)
    assert calls == [] and launches.snapshot() == {}
