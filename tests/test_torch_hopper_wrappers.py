"""The Python side of the port's Hopper (wgmma + TMA) kernels, on the CPU:
the grouped fused_norm_linear against the JAX package and against its
single-weight calls and the groups it refuses, the strides the
FlashAttention forward's and dK/dV's tensor maps take, the block sizes
the bf16 chunked-prefill kernel takes, fused_linear at widths that are
not a multiple of 8 against the JAX kernel, and the route between
fused_linear's two bf16 instances (``tma_ok``).

On the CPU the wrappers run their plain PyTorch versions; the JAX
functions run their XLA fallback or their Pallas kernel in interpret
mode.  f32 tolerance 1e-5 (the two frameworks sum in different orders).
The CUDA kernels are held against the plain versions on the card in
tests/test_torch_cuda.py and chip_smoke.py; the pure-Python plans of
the skinny fused_norm_linear (its K split) and of the paged decode
(its splits, which kernel takes the operands) are held here case by
case.
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
from paddle_tpu_torch.kernels import launches
from paddle_tpu_torch.kernels import paged_attention as pa
from paddle_tpu_torch.tools import fused_linear_parts as fl_parts
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
    # through tma_strides (here on the CPU, the device check left out)
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    ops = fa._bwd_operands(*_bwd_inputs(64, layout))
    assert fa.tma_strides(ops[0]) == fa._strides(ops[0])
    assert ops[3].stride() == ops[0].stride()     # dO takes q's strides
    # rows of 68 bf16 (136 bytes) are not a multiple of 16 bytes apart
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        fa._bwd_operands(*_bwd_inputs(68, layout))


# ------------------------------------------------------- chunked prefill
@pytest.mark.parametrize("bs,ok", [
    (8, True), (16, True), (32, True), (64, True), (128, True), (192, True),
    (1, False), (4, False), (12, False), (24, False), (96, False)])
def test_chunk_wgmma_block_sizes(bs, ok):
    # bf16 pools: whole TMA boxes of 8 to 64 rows of one page a key tile
    assert cp.wgmma_block_size_ok(bs) == ok


def test_chunk_refuses_block_sizes_before_launching(monkeypatch):
    # a bf16 call over bf16 pools of a block size the kernel does not
    # take raises
    # ValueError before anything is bound or launched (here on a meta
    # tensor, which takes the kernel path)
    monkeypatch.setattr(_build, "bind", lambda *a, **k: pytest.fail("bound"))
    q = torch.empty(1, 4, 8, 64, dtype=torch.bfloat16, device="meta")
    pool = torch.empty(3, 12, 2, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="of block sizes 8, 16, 32"):
        cp.chunked_attention(q, pool, pool,
                             torch.zeros(1, 2, dtype=torch.int32,
                                         device="meta"),
                             torch.zeros(1, dtype=torch.int32, device="meta"))


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


@pytest.mark.parametrize("dtype,rep,D,bs,want", [
    (torch.bfloat16, 4, 128, 16, True), (torch.bfloat16, 1, 64, 8, True),
    (torch.bfloat16, 8, 128, 32, True),
    (torch.float32, 4, 128, 16, False),     # f32 keeps the general kernel
    # bf16 outside the Hopper kernel's shapes is refused, not rerouted
    (torch.bfloat16, 3, 128, 16, ValueError),
    (torch.bfloat16, 4, 96, 16, ValueError),
    (torch.bfloat16, 4, 128, 12, ValueError)])   # not a power of two
def test_hopper_path(dtype, rep, D, bs, want):
    q = torch.zeros(2, 2 * rep, D, dtype=dtype)
    pool = torch.zeros(3, bs, 2, D, dtype=dtype)
    if want is ValueError:
        with pytest.raises(ValueError, match="bf16 kernel takes"):
            pa.hopper_path(q, pool, pool, rep)
    else:
        assert pa.hopper_path(q, pool, pool, rep) == want


def test_hopper_path_refuses_unaligned_pools():
    # a pool view that starts 8 bytes into its storage: the kernel's
    # 16-byte row loads cannot take it
    q = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    flat = torch.zeros(3 * 16 * 2 * 128 + 4, dtype=torch.bfloat16)
    pool = flat[4:].view(3, 16, 2, 128)
    assert pool.data_ptr() % 16 == 8
    with pytest.raises(ValueError, match="16-byte aligned"):
        pa.hopper_path(q, pool, pool, 4)
