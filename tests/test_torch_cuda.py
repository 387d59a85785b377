"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest sets JAX up.)  Tolerances:
f32 1e-4 (same cast points, sums in another order); bf16 one rounding
of the largest output, except FlashAttention in bf16 (see
``_hold_bf16_attention``); the KV write (a decode step's, with the k
rotation, and a prefill chunk's, into f32, bf16, int8 and fp8 pools)
bit-identical, but for the garbage row that several padded tokens
share, which must hold one of them; MoE dispatch bit-identical in every
form (one contributor a slot, or several summed in ascending order),
two runs the same bits, one kernel a call; combine bit-identical where
every slot has one choice of weight 1, else 1e-6 in f32 and one bf16
ulp of each output;
fused_linear f32 1e-4, bf16 one bf16 ulp (2^-7) of the largest output
(both instances, the wgmma one's bits the same over 100 launches),
its backward (plain PyTorch on both devices) 1e-5 of the largest entry;
the tiny static BERT's losses 1e-4; the Hopper paged decode, the wgmma
chunked prefill and the skinny fused_norm_linear group one bf16 rounding
of the largest output, two runs bit-identical; the wgmma dQ and dK/dV
by ``_hold_bf16_attention``'s rule, two runs bit-identical; the wgmma
dK/dV and chunk at head_dims 72 to 256 (``TestCudaWgmmaHeadDims``,
``TestCudaChunkHeadDims``) by the same rules, the columns past head_dim
left untouched and a neighbouring kv head's Inf unread.  The general
bf16 instances (GQA rep 7, pages of 12 tokens, head_dim 20 and 100, N
and K = 4 mod 8, unaligned operands: ``TestCudaGeneral`` and the former
refusals) by the same rules, each under its own counter;
rms_norm one rounding of the largest output and rms_scale 4 f32 ulps
(``TestCudaNorms``); combine with gates in the tokens' dtype and in f32
bit-identical to the plain version in every form
(``TestCudaCombineForms``); a tiny bf16 decode step's exact launches
(``TestCudaStepLaunches``); the engine's three steps as CUDA graph
replays bit-identical to their eager functions, out and in the pools,
with the same launches counted, and a rebound pool a retrace
(``TestCudaGraphSteps``).
The Llama-3-8B, Mixtral, Qwen2-7B-width and BERT-base shapes are held
in chip_smoke.py.
"""
import ctypes
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import (_build, chunked_prefill, fused_linear,
                                      fused_norm_linear, kv_quant, launches,
                                      moe_dispatch, paged_attention,
                                      rms_norm, rope)
from paddle_tpu_torch.kernels import flash_attention as fa
from torch_operands import (chunk_operands, decode_operands, moe_routing,
                            running_slots)

TOL = 1e-4


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
class TestCudaKernels:

    def test_rms_norm(self, cuda_device):
        x = torch.randn(37, 96, device=cuda_device)
        w = torch.randn(96, device=cuda_device)
        close(rms_norm.rms_norm(x, w, 1e-5).cpu(),
              rms_norm.rms_norm_plain(x, w, 1e-5).cpu())

    @pytest.mark.parametrize("M", [1, 8, 9, 70])
    @pytest.mark.parametrize("act", ["none", "silu"])
    def test_fused_norm_linear(self, cuda_device, M, act):
        # K = 1000 splits the skinny kernel along K; N = 136 leaves a
        # ragged column strip and tile
        x = torch.randn(M, 1000, device=cuda_device)
        nw = torch.randn(1000, device=cuda_device)
        w = torch.randn(1000, 136, device=cuda_device)
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        close(fused_norm_linear.fused_norm_linear(x, rs, nw, w, act).cpu(),
              fused_norm_linear.fused_norm_linear_plain(x, rs, nw, w,
                                                        act).cpu())

    @pytest.mark.parametrize("M", [3, 8, 70, 256])
    def test_fused_norm_linear_bf16(self, cuda_device, M):
        # bf16 products are exact in f32: only the order of the f32 sums
        # differs, which moves an output by at most one bf16 rounding
        x = torch.randn(M, 1000, device=cuda_device).bfloat16()
        nw = torch.randn(1000, device=cuda_device).bfloat16()
        w = (torch.randn(1000, 136, device=cuda_device) / 32).bfloat16()
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        got = fused_norm_linear.fused_norm_linear(x, rs, nw, w, "silu")
        want = fused_norm_linear.fused_norm_linear_plain(x, rs, nw, w, "silu")
        assert float((got.float() - want.float()).abs().max()) <= \
            float(want.float().abs().max()) / 128

    @pytest.mark.parametrize("K", [64, 1000, 4096])
    @pytest.mark.parametrize("N", [136, 1024, 4096])
    @pytest.mark.parametrize("M", [9, 70, 256, 1000])
    def test_fused_norm_linear_tiled_bf16(self, cuda_device, M, N, K):
        # the wgmma kernel: ragged M, N and K tiles from TMA's zero fill
        # (K = 64 is fewer k-tiles than ring stages); twice, bit for bit.
        # These shapes fill fewer than 132 SMs with 256-wide tiles, so
        # they take 128-wide ones; the cases below take 256-wide ones
        self._hold_tiled(cuda_device, M, N, K)

    @pytest.mark.parametrize("M,N,K", [(1000, 14336, 1000),
                                       (300, 14328, 64), (600, 8192, 4096)])
    def test_fused_norm_linear_tiled_wide_bf16(self, cuda_device, M, N, K):
        self._hold_tiled(cuda_device, M, N, K)

    @staticmethod
    def _hold_tiled(cuda_device, M, N, K):
        g = torch.Generator(device=cuda_device).manual_seed(M + N + K)
        x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
        nw = (1 + 0.1 * torch.randn(K, generator=g,
                                    device=cuda_device)).bfloat16()
        w = (torch.randn(K, N, generator=g, device=cuda_device)
             / K ** 0.5).bfloat16()
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        act = "silu" if (M + N + K // 8) % 2 else "none"
        launches.reset()
        got = fused_norm_linear.fused_norm_linear(x, rs, nw, w, act)
        again = fused_norm_linear.fused_norm_linear(x, rs, nw, w, act)
        assert launches.snapshot() == {"fused_norm_linear_tiled": 2}
        want = fused_norm_linear.fused_norm_linear_plain(x, rs, nw, w, act)
        assert torch.equal(got, again)
        assert float((got.float() - want.float()).abs().max()) <= \
            float(want.float().abs().max()) / 128

    @pytest.mark.parametrize("M", [4, 70, 256])
    def test_fused_norm_linear_group(self, cuda_device, M):
        # one launch for q/k/v-like and gate/up-like groups (the skinny
        # kernel at most 8 rows, the tiled one above), each output
        # bit-identical to its single-weight call
        g = torch.Generator(device=cuda_device).manual_seed(M)
        K = 512
        x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
        nw = torch.randn(K, generator=g, device=cuda_device).bfloat16()
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        for ns, acts in (([512, 128, 136], ["none"] * 3),
                         ([1000, 1000], ["silu", "none"]), ([264], ["silu"])):
            ws = [(torch.randn(K, n, generator=g, device=cuda_device)
                   / 32).bfloat16() for n in ns]
            launches.reset()
            outs = fused_norm_linear.fused_norm_linear_group(x, rs, nw, ws,
                                                             acts)
            counts = launches.snapshot()
            singles = [fused_norm_linear.fused_norm_linear(x, rs, nw, w, a)
                       for w, a in zip(ws, acts)]
            assert counts == {fused_norm_linear.kernel_name(M): 1}
            for got, want in zip(outs, singles):
                assert torch.equal(got, want)

    def test_fused_norm_linear_rejects_unaligned_widths(self, cuda_device):
        x = torch.randn(4, 64, device=cuda_device)
        with pytest.raises(ValueError, match="16 bytes"):
            fused_norm_linear.fused_norm_linear(
                x, fused_norm_linear.rms_scale(x, 1e-5),
                torch.ones(64, device=cuda_device),
                torch.ones(64, 30, device=cuda_device))

    @pytest.mark.parametrize("num_splits", [1, 2, 4])
    def test_paged_decode(self, cuda_device, num_splits):
        args = [t(a).to(cuda_device) for a in decode_operands(nbs=8)]
        got, _, _ = paged_attention.fused_paged_decode(
            *args, num_splits=num_splits)
        cpu = [t(a) for a in decode_operands(nbs=8)]
        want, _, _ = paged_attention.fused_paged_decode(
            *cpu, num_splits=num_splits)
        close(got.cpu(), want)

    def test_chunked_prefill(self, cuda_device):
        args = chunk_operands(T=40, D=16, seed=3)
        got = chunked_prefill.chunked_attention(
            *[t(a).to(cuda_device) for a in args])
        close(got.cpu(), chunked_prefill.chunked_attention(
            *[t(a) for a in args]))

    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("T", [40, 256])
    def test_chunked_prefill_bf16(self, cuda_device, D, T):
        # 40 rows per head leave a ragged 64-row tile; the chunk starts
        # mid-page, past a poisoned garbage block 0
        args = chunk_operands(B=2, T=T, KVH=2, rep=4, D=D, bs=16,
                              nbs=24, seed=4)
        args[4] = np.array([0, 37], np.int32)
        q, kp, vp = (t(a).bfloat16() for a in args[:3])
        ops = [q, kp, vp, t(args[3]), t(args[4])]
        got = chunked_prefill.chunked_attention(
            *[o.to(cuda_device) for o in ops]).cpu().float()
        want = chunked_prefill.chunked_attention(*ops).float()
        assert float((got - want).abs().max()) <= \
            float(want.abs().max()) / 128


def _quantized(k_pool, v_pool, scheme):
    """CPU (codes, codes, scales, scales) of float pools (plain codec)."""
    (kc, ks), (vc, vs) = (kv_quant.quantize_kv(t(p), scheme)
                          for p in (k_pool, v_pool))
    return kc, vc, ks, vs


@pytest.mark.cuda
class TestCudaQuantizedKernels:

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("scheme", ["int8", "fp8"])
    @pytest.mark.parametrize("N", [8, 256])
    def test_quantize_scatter_is_bit_identical(self, cuda_device, scheme,
                                               dtype, N):
        # the quantized KV write of N tokens of one sequence (a chunk,
        # no rotation) into distinct rows: rows of very different sizes
        # and a zero row
        g = torch.Generator().manual_seed(N)
        new = [(torch.randn(1, N, 8, 128, generator=g)
                * torch.logspace(-3, 3, N)[None, :, None, None]).to(dtype)
               for _ in range(2)]
        new[0][0, 3] = 0
        bs = 16
        nbs = -(-N // bs)
        nb = nbs + 3
        bt = (1 + torch.randperm(nb - 1, generator=g)[:nbs]).int()[None]
        pos = torch.zeros(1, dtype=torch.int32)
        pools = [torch.zeros(nb, bs, 8, 128, dtype=torch.int8)
                 for _ in range(2)] + [torch.ones(nb, bs) for _ in range(2)]
        want = [x.clone() for x in pools]
        kv_quant.kv_write(*want[:2], *new, bt, pos, k_scale=want[2],
                          v_scale=want[3], scheme=scheme)
        got = [x.to(cuda_device) for x in pools]
        launches.reset()
        kv_quant.kv_write(*got[:2], *[x.to(cuda_device) for x in new],
                          bt.to(cuda_device), pos.to(cuda_device),
                          k_scale=got[2], v_scale=got[3], scheme=scheme)
        assert launches.snapshot() == {kv_quant.KERNEL: 1}
        for a, b in zip(got, want):
            assert torch.equal(a.cpu(), b)

    @pytest.mark.parametrize("num_splits", [1, 4])
    @pytest.mark.parametrize("scheme", ["int8", "fp8"])
    def test_paged_decode(self, cuda_device, scheme, num_splits):
        ops = _quantized_ops(decode_operands(nbs=8), scheme)
        dev = [o.to(cuda_device) for o in ops]    # before the in-place write
        kw = dict(num_splits=num_splits, kv_cache_dtype=scheme)
        want = paged_attention.fused_paged_decode(
            *ops[:9], k_scale=ops[9], v_scale=ops[10], **kw)
        launches.reset()
        got = paged_attention.fused_paged_decode(
            *dev[:9], k_scale=dev[9], v_scale=dev[10], **kw)
        assert launches.snapshot() == {kv_quant.KERNEL: 1,
                                       f"paged_decode_{scheme}": 1}
        close(got[0].cpu(), want[0])
        for a, b in zip(got[1:], want[1:]):
            assert torch.equal(a.cpu(), b)

    @pytest.mark.parametrize("scheme", ["int8", "fp8"])
    def test_chunked_prefill(self, cuda_device, scheme):
        args = chunk_operands(T=40, D=16, seed=3)
        kc, vc, ks, vs = _quantized(args[1], args[2], scheme)
        ops = [t(args[0]), kc, vc, t(args[3]), t(args[4]), ks, vs]
        got = chunked_prefill.chunked_attention(
            *[o.to(cuda_device) for o in ops], scheme)
        close(got.cpu(), chunked_prefill.chunked_attention(*ops, scheme))

    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("scheme", ["int8", "fp8"])
    def test_chunked_prefill_bf16(self, cuda_device, scheme, D):
        # the tensor-core kernel stages codes and applies the scales per
        # key; against the plain version on the same bf16 q and codes it
        # keeps the unquantized kernel's rule (one rounding of the
        # largest output): its only extra rounding is P * v_scale in bf16
        args = chunk_operands(B=2, T=40, KVH=2, rep=4, D=D, bs=16, nbs=24,
                              seed=4)
        args[4] = np.array([0, 37], np.int32)
        kc, vc, ks, vs = _quantized(args[1], args[2], scheme)
        ops = [t(args[0]).bfloat16(), kc, vc, t(args[3]), t(args[4]), ks,
               vs]
        launches.reset()
        got = chunked_prefill.chunked_attention(
            *[o.to(cuda_device) for o in ops], scheme).cpu().float()
        assert launches.snapshot() == {f"chunked_prefill_{scheme}": 1}
        want = chunked_prefill.chunked_attention(*ops, scheme).float()
        assert float((got - want).abs().max()) <= \
            float(want.abs().max()) / 128


def _quantized_ops(args, scheme):
    """decode_operands with quantized pools, in fused_paged_decode's
    order, then the two scales."""
    kc, vc, ks, vs = _quantized(args[3], args[4], scheme)
    ops = [t(a) for a in args]
    ops[3:5] = [kc, vc]
    return ops + [ks, vs]


def _bf16_decode_operands(B, KVH, rep, D, nbs, positions, scheme, seed,
                          bs=16):
    """bf16 q and pools (codes and scales for a quantized ``scheme``) on
    the CPU, as paged_decode_attention takes them: bs = 16 unless given, a
    poisoned block 0 that only an idle slot (frontier 0, its table all 0)
    reads, the other sequences on distinct shuffled blocks."""
    g = torch.Generator().manual_seed(seed)
    H = KVH * rep
    nb = 1 + B * nbs
    kp = torch.randn(nb, bs, KVH, D, generator=g).bfloat16()
    vp = torch.randn(nb, bs, KVH, D, generator=g).bfloat16()
    kp[0], vp[0] = 1e3, -1e3
    bt = (1 + torch.randperm(B * nbs, generator=g)).int().reshape(B, nbs)
    pos = torch.tensor(positions, dtype=torch.int32)
    bt[pos == 0] = 0
    ang = torch.rand(B, D // 2, generator=g) * 6
    ks = vs = None
    if scheme is not None:
        (kp, ks), (vp, vs) = (kv_quant.quantize_kv(p, scheme)
                              for p in (kp, vp))
    q = torch.randn(B, H, D, generator=g).bfloat16()
    return (q, ang.cos(), ang.sin(), kp, vp, bt, pos,
            paged_attention._default_splits(nbs), ks, vs, scheme)


def _hold_decode(ops, cuda_device, kernel=paged_attention.KERNEL,
                 instance=None, heads=None):
    """The Hopper decode kernel (or ``kernel``, the general instance) on
    ``ops`` twice (the same bits), one launch each (on ``instance`` where
    it is given), against the plain version on the CPU: one bf16 rounding
    of the largest output (the two differ in the order of f32 sums and
    the kernel's exp2); with ``heads`` only those q heads are held, and
    they must be finite."""
    dev = [None if o is None or isinstance(o, (int, str)) else
           o.to(cuda_device) for o in ops]
    dev[7], dev[10] = ops[7], ops[10]
    launches.reset()
    got = paged_attention.paged_decode_attention(*dev)
    again = paged_attention.paged_decode_attention(*dev)
    name = kv_quant.counter_name(kernel, ops[10])
    assert launches.snapshot() == {name: 2}
    if instance is not None:
        assert launches.by_instance() == {f"{name}@{instance}": 2}
    heads = slice(None) if heads is None else heads
    got, again = got[:, heads], again[:, heads]
    assert torch.equal(got, again)
    assert bool(torch.isfinite(got).all())
    want = paged_attention.paged_decode_attention_plain(*ops)[:, heads]
    want = want.float()
    assert float((got.cpu().float() - want).abs().max()) <= \
        float(want.abs().max()) / 128
    return got.cpu()


@pytest.mark.cuda
class TestCudaHopperDecode:
    """paged_decode_hopper (bf16 q over bf16, int8 and fp8 pools)."""

    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    def test_frontiers(self, cuda_device, scheme):
        # 0, a page edge and its neighbour, a 64-key chunk edge +- 1 and
        # the table's last key (nbs * bs - 1 = 127)
        positions = [0, 15, 16, 63, 64, 65, 100, 127]
        ops = _bf16_decode_operands(8, 2, 4, 128, 8, positions, scheme, 1)
        assert paged_attention.hopper_path(ops[0], ops[3], ops[4], 4)
        out = _hold_decode(ops, cuda_device)
        assert float(out[1:].float().abs().max()) < 50.0   # no poison

    @pytest.mark.parametrize("B", [1, 3, 8])
    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("rep", [1, 4, 8])
    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    def test_shapes_and_idle_slot(self, cuda_device, scheme, rep, D, B):
        # slot 0 idle on the poisoned block 0; the others up to 4 chunks
        positions = [0, 255, 130, 64, 31, 200, 77, 1][:B]
        ops = _bf16_decode_operands(B, 2, rep, D, 16, positions, scheme,
                                    rep * D + B)
        _hold_decode(ops, cuda_device)

    @pytest.mark.parametrize("rep,D,bs", [(3, 128, 16), (4, 100, 16),
                                          (4, 128, 12)])
    def test_refuses_shapes_it_does_not_take(self, cuda_device, rep, D, bs):
        # the Hopper kernel takes any rep (3 padded to 4 heads a block)
        # and page size (12: the division by the page size) at every D
        # that is a multiple of 8; bf16 at another D is the general
        # instance's, under its own counter; each agrees with the plain
        # version
        g = torch.Generator().manual_seed(rep * D + bs)
        q = torch.randn(2, 2 * rep, D, generator=g).bfloat16()
        pool = torch.randn(5, bs, 2, D, generator=g).bfloat16()
        ang = torch.rand(2, D // 2, generator=g)
        ops = [q, ang.cos(), ang.sin(), pool, pool.clone(),
               torch.tensor([[1, 2], [3, 4]], dtype=torch.int32),
               torch.tensor([5, 20], dtype=torch.int32), 1, None, None, None]
        hopper = D % 8 == 0
        assert paged_attention.hopper_path(q, pool, pool, rep) == hopper
        _hold_decode(ops, cuda_device, paged_attention.KERNEL if hopper
                     else paged_attention.GENERAL)

    def test_long_context_uses_many_blocks(self, cuda_device):
        # one sequence at the end of an 8192-key table: 128 chunks over
        # decode_plan's splits
        ops = _bf16_decode_operands(1, 8, 4, 128, 512, [8191], "fp8", 7)
        _hold_decode(ops, cuda_device)

    @pytest.mark.parametrize("bs", [4, 12, 24, 48])
    @pytest.mark.parametrize("rep", [3, 5, 6, 7, 16])
    @pytest.mark.parametrize("scheme", [None, "fp8"])
    def test_any_rep_and_page_size(self, cuda_device, scheme, rep, bs):
        # padded groups (3 in 4, 5 to 7 in 8), two sub-groups of 8 (16),
        # pages found by division; frontiers at page and chunk edges, an
        # idle slot on the poisoned block 0
        positions = [0, bs - 1, bs, 63, 64, 6 * bs + 5]
        ops = _bf16_decode_operands(6, 2, rep, 128, 10, positions, scheme,
                                    rep * bs)
        assert paged_attention.hopper_path(ops[0], ops[3], ops[4], rep)
        out = _hold_decode(ops, cuda_device)
        assert float(out[1:].float().abs().max()) < 50.0   # no poison

    @pytest.mark.parametrize("rep", [4, 7])
    @pytest.mark.parametrize("scheme", [None, "int8"])
    def test_pages_of_12_give_the_bits_of_16(self, cuda_device, scheme, rep):
        # the same keys in pages of 12 and of 16, tables of 48 keys each:
        # the same splits, so the same bits
        g = torch.Generator().manual_seed(rep)
        q = torch.randn(3, 2 * rep, 64, generator=g).bfloat16()
        ang = torch.rand(3, 32, generator=g) * 6
        pos = torch.tensor([5, 30, 47], dtype=torch.int32)
        got = []
        for bs in (12, 16):
            (k, ks), (v, vs), bt = _paged_keys(bs, 64, scheme)
            got.append(_hold_decode([q, ang.cos(), ang.sin(), k, v, bt, pos,
                                     1, ks, vs, scheme], cuda_device))
        assert torch.equal(*got)


@pytest.mark.cuda
class TestCudaHopperDecodeHeadDims:
    """paged_decode_hopper at head_dims other than 64 and 128: the padded
    instances of 128 columns (80, 88: a lane's dims straddle the halves
    of the rotation, 96) and 256 (160, 256: one key a load, 4 a step),
    over bf16, int8 and fp8 pools, pages of 12 (the division) and 16,
    rep 1, 2, 7 (sub-groups of 4 and 3) and 8 (Gemma-2B's 8 q heads over
    1 kv head)."""

    @pytest.mark.parametrize("bs", [12, 16])
    @pytest.mark.parametrize("rep", [1, 2, 7, 8])
    @pytest.mark.parametrize("D", [80, 88, 96, 160, 256])
    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    def test_shapes(self, cuda_device, scheme, D, rep, bs):
        # slot 0 idle on the poisoned block 0; page and 64-key chunk
        # edges; then kv head 1 poisoned in every page (bf16 +Inf keys
        # and -Inf values, fp8 NaN codes, int8 codes of 127): kv head 0's
        # q heads, whose lanes past D sit over kv head 1's columns, stay
        # finite and agree with the plain version
        positions = [0, bs - 1, 63, 64, 6 * bs + 5]
        ops = list(_bf16_decode_operands(5, 2, rep, D, 8, positions, scheme,
                                         D + rep + bs, bs=bs))
        assert paged_attention.hopper_path(ops[0], ops[3], ops[4], rep)
        W = 128 if D <= 128 else 256
        out = _hold_decode(ops, cuda_device, instance=f"w{W}_pad")
        assert float(out[1:].float().abs().max()) < 50.0   # no poison
        if scheme is None:
            ops[3], ops[4] = ops[3].clone(), ops[4].clone()
            ops[3][:, :, 1], ops[4][:, :, 1] = float("inf"), float("-inf")
        else:
            ops[3], ops[4] = ops[3].clone(), ops[4].clone()
            code = 0x7F if scheme == "fp8" else 127
            ops[3][:, :, 1], ops[4][:, :, 1] = code, code
        _hold_decode(ops, cuda_device, instance=f"w{W}_pad",
                     heads=slice(0, rep))


def _paged_keys(bs, D, scheme=None, B=3, n=48, KVH=2):
    """((k, k_scale), (v, v_scale), table): B sequences' n keys each in
    pools of pages of ``bs`` (block 1 + b * n / bs + p holds sequence b's
    keys p * bs ..., block 0 zeros), as codes of ``scheme`` with their
    row scales or bf16 (scales None): the same keys and codes, row for
    row, whatever ``bs``."""
    g = torch.Generator().manual_seed(n + D)
    pools = []
    for _ in range(2):
        keys = torch.randn(B * n, KVH, D, generator=g).bfloat16()
        pool = torch.cat([torch.zeros(bs, KVH, D, dtype=torch.bfloat16),
                          keys]).reshape(-1, bs, KVH, D)
        pools.append((pool, None) if scheme is None
                     else kv_quant.quantize_kv(pool, scheme))
    table = (1 + torch.arange(B * n // bs, dtype=torch.int32)).reshape(
        B, n // bs)
    return (*pools, table)


def _bf16_chunk_operands(B, T, KVH, rep, D, bs, positions, scheme, seed):
    """bf16 q and pools (codes and scales for a quantized ``scheme``) on
    the CPU, as chunked_attention takes them: a poisoned block 0 that
    every table entry past a sequence's pages points at, as the engine
    leaves them, the sequences' pages on distinct shuffled blocks."""
    g = torch.Generator().manual_seed(seed)
    H = KVH * rep
    pages = [(p + T + bs - 1) // bs for p in positions]
    nbs = max(pages) + 1
    nb = 1 + sum(pages)
    kp = torch.randn(nb, bs, KVH, D, generator=g).bfloat16()
    vp = torch.randn(nb, bs, KVH, D, generator=g).bfloat16()
    kp[0], vp[0] = 1e3, -1e3
    perm = (1 + torch.randperm(nb - 1, generator=g)).int()
    bt = torch.zeros(B, nbs, dtype=torch.int32)
    at = 0
    for b, n in enumerate(pages):
        bt[b, :n] = perm[at:at + n]
        at += n
    ks = vs = None
    if scheme is not None:
        (kp, ks), (vp, vs) = (kv_quant.quantize_kv(x, scheme)
                              for x in (kp, vp))
    q = torch.randn(B, T, H, D, generator=g).bfloat16()
    return (q, kp, vp, bt, torch.tensor(positions, dtype=torch.int32), ks,
            vs, scheme)


def _hold_chunk(ops, cuda_device, kernel=chunked_prefill.KERNEL):
    """The wgmma chunk kernel (or ``kernel``, the general instance) on
    ``ops`` twice (the same bits), one launch each, against the plain
    version on the CPU: one bf16 rounding of the largest output (the two
    differ in the order of f32 sums, exp2 and the rounding of P to
    bf16)."""
    dev = [o.to(cuda_device) if isinstance(o, torch.Tensor) else o
           for o in ops]
    launches.reset()
    got = chunked_prefill.chunked_attention(*dev)
    again = chunked_prefill.chunked_attention(*dev)
    assert launches.snapshot() == {kv_quant.counter_name(kernel, ops[7]): 2}
    assert torch.equal(got, again)
    want = chunked_prefill.chunked_attention_plain(*ops).float()
    got = got.cpu().float()
    assert float((got - want).abs().max()) <= float(want.abs().max()) / 128
    return got


@pytest.mark.cuda
class TestCudaHopperChunk:
    """chunked_prefill_wgmma (bf16 q over bf16, int8 and fp8 pools)."""

    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    def test_frontiers(self, cuda_device, scheme):
        # starts at 0, mid-page, a page edge +- 1 and a 64-key tile edge
        # +- 1, past the poisoned block 0
        positions = [0, 37, 15, 16, 17, 63, 64, 65]
        ops = _bf16_chunk_operands(8, 40, 2, 4, 128, 16, positions, scheme,
                                   1)
        got = _hold_chunk(ops, cuda_device)
        assert float(got.abs().max()) < 50.0      # no poison

    @pytest.mark.parametrize("B", [1, 3])
    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("rep", [1, 2, 4, 8])
    @pytest.mark.parametrize("T", [1, 40, 256, 257])
    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    def test_shapes(self, cuda_device, scheme, T, rep, D, B):
        positions = [0, 130, 57][:B]
        ops = _bf16_chunk_operands(B, T, 2, rep, D, 16, positions, scheme,
                                   T + rep + D + B)
        _hold_chunk(ops, cuda_device)

    @pytest.mark.parametrize("rep,bs", [(3, 16), (5, 32), (16, 8), (4, 64),
                                        (4, 128)])
    def test_any_group_and_block_sizes(self, cuda_device, rep, bs):
        # groups that do not divide the 64-row tile, pages of 8 to 128
        # keys (several a key tile, or several key tiles a page)
        for scheme in (None, "fp8"):
            ops = _bf16_chunk_operands(2, 70, 1, rep, 64, bs, [0, 91],
                                       scheme, rep * bs)
            _hold_chunk(ops, cuda_device)

    @pytest.mark.parametrize("bs", [1, 4, 12, 96])
    @pytest.mark.parametrize("scheme", ["int8", "fp8"])
    def test_code_pools_take_any_block_size(self, cuda_device, scheme, bs):
        ops = _bf16_chunk_operands(2, 40, 2, 4, 128, bs, [0, 37], scheme,
                                   bs)
        _hold_chunk(ops, cuda_device)

    @pytest.mark.parametrize("bs", [1, 4, 12, 96])
    def test_refuses_block_sizes(self, cuda_device, bs):
        # bf16 pages that are not whole TMA boxes of 8 to 64 rows are
        # loaded by the wgmma kernel's copy producer (no longer refused),
        # and agree with the plain version
        ops = _bf16_chunk_operands(1, 8, 2, 4, 64, bs, [3], None, bs)
        assert chunked_prefill.wgmma_width(ops[0], ops[1], ops[2])
        assert chunked_prefill.copy_producer(bs)
        _hold_chunk(ops, cuda_device)

    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("rep", [1, 4, 7])
    @pytest.mark.parametrize("bs", [4, 12, 24, 96])
    def test_copy_producer(self, cuda_device, bs, rep, D):
        # the copy producer at chunk starts on and off page and tile
        # edges, several key tiles, keys past the last one zero-filled
        ops = _bf16_chunk_operands(3, 70, 2, rep, D, bs, [0, 37, 130], None,
                                   bs + rep + D)
        assert chunked_prefill.copy_producer(bs)
        got = _hold_chunk(ops, cuda_device)
        assert float(got.abs().max()) < 50.0      # no poison

    @pytest.mark.parametrize("rep", [4, 7])
    def test_pages_of_12_give_the_bits_of_16(self, cuda_device, rep):
        # the same keys in pages of 12 (copy producer) and of 16 (TMA
        # boxes), tables of 48 keys each: the same bits
        g = torch.Generator().manual_seed(rep)
        q = torch.randn(3, 20, 2 * rep, 128, generator=g).bfloat16()
        pos = torch.tensor([0, 11, 28], dtype=torch.int32)
        got = []
        for bs in (12, 16):
            (k, _), (v, _), bt = _paged_keys(bs, 128)
            got.append(_hold_chunk([q, k, v, bt, pos, None, None, None],
                                   cuda_device))
        assert torch.equal(*got)

    @pytest.mark.parametrize("scheme", [None, "int8"])
    def test_ring_reuse_gives_the_same_bits(self, cuda_device, scheme):
        # the served shape (a 256-token chunk at 768, 8 kv heads, rep 4,
        # D = 128), 100 launches: every output equal to the first's bits
        # (a stage refilled under its readers would show as a change)
        ops = _bf16_chunk_operands(1, 256, 8, 4, 128, 16, [768], scheme, 9)
        dev = [o.to(cuda_device) if isinstance(o, torch.Tensor) else o
               for o in ops]
        first = _hold_chunk(ops, cuda_device)
        outs = [chunked_prefill.chunked_attention(*dev) for _ in range(100)]
        assert sum(not torch.equal(o.cpu().float(), first)
                   for o in outs) == 0

    def test_refuses_unaligned_pools(self, cuda_device):
        # a pool view that starts 8 bytes into its storage: the wgmma
        # kernel's 16-byte loads cannot take it, so the general instance
        # does, one launch, and agrees with the plain version
        ops = _bf16_chunk_operands(1, 8, 2, 4, 64, 16, [3], None, 2)
        flat = torch.zeros(ops[1].numel() + 4, dtype=torch.bfloat16,
                           device=cuda_device)
        pool = flat[4:].view(ops[1].shape)
        pool.copy_(ops[1])
        dev = [o.to(cuda_device) for o in ops[:5]]
        launches.reset()
        got = chunked_prefill.chunked_attention(dev[0], pool, *dev[2:])
        assert launches.snapshot() == {chunked_prefill.GENERAL: 1}
        want = chunked_prefill.chunked_attention_plain(*ops[:5]).float()
        assert float((got.cpu().float() - want).abs().max()) <= \
            float(want.abs().max()) / 128


@pytest.mark.cuda
class TestCudaChunkHeadDims:
    """chunked_prefill_wgmma at head_dims other than 64 and 128: the
    instances of 128 columns (72, 80, 96) and 256 (136, 160, 256: 32-key
    tiles), over bf16 pools (TMA boxes at pages of 16, the copy producer
    at pages of 12) and int8 and fp8 pools (16-code chunks, 8-code ones
    at D % 16 == 8)."""

    @pytest.mark.parametrize("bs", [12, 16])
    @pytest.mark.parametrize("rep", [1, 7])
    @pytest.mark.parametrize("D", [72, 80, 96, 136, 160, 256])
    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    def test_shapes(self, cuda_device, scheme, D, rep, bs):
        ops = _bf16_chunk_operands(2, 40, 2, rep, D, bs, [0, 37], scheme,
                                   D + rep + bs)
        scales = () if scheme is None else (ops[5], ops[6])
        assert chunked_prefill.wgmma_width(ops[0], ops[1], ops[2],
                                           scales) == (128 if D <= 128
                                                       else 256)
        got = _hold_chunk(ops, cuda_device)
        assert float(got.abs().max()) < 50.0      # no poison

    @pytest.mark.parametrize("D", [96, 256])
    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    def test_frontiers(self, cuda_device, scheme, D):
        # starts at 0, mid-page, a page edge +- 1 and 32- and 64-key tile
        # edges +- 1, past the poisoned block 0
        positions = [0, 37, 15, 16, 31, 32, 33, 63, 64, 65]
        ops = _bf16_chunk_operands(10, 40, 2, 4, D, 16, positions, scheme,
                                   D)
        got = _hold_chunk(ops, cuda_device)
        assert float(got.abs().max()) < 50.0

    @pytest.mark.parametrize("bs", [12, 16])
    def test_neighbouring_kv_head_is_not_read(self, cuda_device, bs):
        # kv head 1 holds +Inf keys and -Inf values in every page: the
        # query heads of kv head 0 (head_dim 96, the 128-column instance,
        # whose 64-column boxes reach 32 columns past D) stay finite and
        # agree with the plain version, two runs the same bits
        ops = list(_bf16_chunk_operands(2, 40, 2, 3, 96, bs, [0, 37], None,
                                        bs))
        ops[1][:, :, 1], ops[2][:, :, 1] = float("inf"), float("-inf")
        dev = [o.to(cuda_device) if isinstance(o, torch.Tensor) else o
               for o in ops]
        launches.reset()
        got = chunked_prefill.chunked_attention(*dev)
        again = chunked_prefill.chunked_attention(*dev)
        assert launches.snapshot() == {chunked_prefill.KERNEL: 2}
        assert torch.equal(got[:, :, :3], again[:, :, :3])
        mine = got[:, :, :3].cpu().float()
        want = chunked_prefill.chunked_attention_plain(*ops)[:, :, :3] \
            .float()
        assert bool(torch.isfinite(mine).all())
        assert float((mine - want).abs().max()) <= \
            float(want.abs().max()) / 128

    @pytest.mark.parametrize("D,bs", [(96, 12), (256, 12), (96, 16)])
    def test_ring_reuse_gives_the_same_bits(self, cuda_device, D, bs):
        # a 256-token chunk at 768 over Phi-3's and Gemma's heads, 100
        # launches: every output equal to the first's bits
        ops = _bf16_chunk_operands(1, 256, 4, 2, D, bs, [768], None, D)
        dev = [o.to(cuda_device) if isinstance(o, torch.Tensor) else o
               for o in ops]
        first = _hold_chunk(ops, cuda_device)
        outs = [chunked_prefill.chunked_attention(*dev) for _ in range(100)]
        assert sum(not torch.equal(o.cpu().float(), first)
                   for o in outs) == 0


def _hold_dkv(q, k, v, do, causal, plain_on):
    """fa_bwd_dkv_wgmma twice on the kernel forward's O and LSE (the same
    bits, one launch each), dK and dV against the f32 plain version of
    the same bf16 inputs by the rule of ``_hold_bf16_attention``; the
    plain versions run on ``plain_on``."""
    scale = 1 / math.sqrt(q.shape[-1])
    o, lse = fa._fwd_kernel(q, k, v, causal, scale, True)
    ops = fa._bwd_operands(q, k, v, do, lse, fa._delta(o, do))
    launches.reset()
    got = fa._dkv_kernel(*ops, causal, scale)
    again = fa._dkv_kernel(*ops, causal, scale)
    assert launches.snapshot() == {fa.BWD_DKV: 2}
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert got[0].stride() == ops[1].stride()
    x = [t.to(plain_on) for t in (q, k, v, do, o, lse)]
    plain = fa.flash_bwd_plain(*x[:3], x[4], x[5], x[3], causal, scale)[1:]
    f = [t.float() for t in x[:5]]
    ref = fa.flash_bwd_plain(*f[:3], f[4], x[5], f[3], causal, scale)[1:]
    for a, b, r in zip(got, plain, ref):
        _hold_bf16_attention(a.to(plain_on), b, r)


@pytest.mark.cuda
class TestCudaHopperDkv:
    """fa_bwd_dkv_wgmma: dK and dV of bf16 attention."""

    @pytest.mark.parametrize("layout", ["bhtd", "bthd"])
    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("H,KVH,Tq,Tk", [
        (4, 4, 1, 2), (4, 1, 100, 100), (8, 1, 1000, 1000),
        (4, 1, 100, 333), (8, 2, 200, 1000), (2, 2, 1, 257)])
    def test_shapes(self, cuda_device, H, KVH, Tq, Tk, causal, D, layout):
        # ragged T, Tq < Tk, GQA groups 1, 4 and 8, the model's
        # [B, T, H, D] views.  One query takes two keys or more: over a
        # single key P = 1 and dP - delta cancels, so dK is exactly 0 and
        # only the f32 roundoff of that difference is left to compare
        ops = _attn_inputs(2, H, KVH, Tq, Tk, D, torch.bfloat16,
                           cuda_device, seed=Tq + Tk + D)
        if layout == "bthd":
            ops = [x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in ops]
        _hold_dkv(*ops, causal, "cpu")

    def test_llama_layer(self, cuda_device):
        # one kv group of Llama-3-8B's training layer: T = 8192, 4 query
        # heads over 1 kv head, D = 128, causal, [B, T, H, D] views (the
        # plain versions on the card: [4, 8192, 8192] f32 scores)
        ops = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in
               _attn_inputs(1, 4, 1, 8192, 8192, 128, torch.bfloat16,
                            cuda_device, seed=8192)]
        _hold_dkv(*ops, True, cuda_device)

    def test_refuses_strides_tma_cannot_take(self, cuda_device):
        # rows of 68 bf16 (136 bytes apart) have no tensor map: the
        # general instances take the backward, under their own counters,
        # and agree with the plain version
        ops = _attn_inputs(1, 2, 1, 20, 20, 68, torch.bfloat16, cuda_device)
        _hold_general_attention(*ops, True)


def _hold_dq(q, k, v, do, causal, plain_on):
    """fa_bwd_dq_wgmma twice on the kernel forward's O and LSE (the same
    bits, one launch each), dQ against the f32 plain version of the same
    bf16 inputs by the rule of ``_hold_bf16_attention``; the plain
    versions run on ``plain_on``."""
    scale = 1 / math.sqrt(q.shape[-1])
    o, lse = fa._fwd_kernel(q, k, v, causal, scale, True)
    ops = fa._bwd_operands(q, k, v, do, lse, fa._delta(o, do))
    launches.reset()
    got = fa._dq_kernel(*ops, causal, scale)
    again = fa._dq_kernel(*ops, causal, scale)
    assert launches.snapshot() == {fa.BWD_DQ: 2}
    assert torch.equal(got, again)
    assert got.stride() == ops[0].stride()
    x = [t.to(plain_on) for t in (q, k, v, do, o, lse)]
    plain = fa.flash_bwd_plain(*x[:3], x[4], x[5], x[3], causal, scale)[0]
    f = [t.float() for t in x[:5]]
    ref = fa.flash_bwd_plain(*f[:3], f[4], x[5], f[3], causal, scale)[0]
    _hold_bf16_attention(got.to(plain_on), plain, ref)


@pytest.mark.cuda
class TestCudaHopperDq:
    """fa_bwd_dq_wgmma: dQ of bf16 attention."""

    @pytest.mark.parametrize("layout", ["bhtd", "bthd"])
    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("H,KVH,Tq,Tk", [
        (4, 4, 1, 2), (4, 1, 100, 100), (8, 1, 1000, 1000),
        (4, 1, 100, 333), (8, 2, 200, 1000), (2, 2, 1, 257)])
    def test_shapes(self, cuda_device, H, KVH, Tq, Tk, causal, D, layout):
        # ragged T (query tiles of 128, key tiles of 64), Tq < Tk (the
        # causal diagonal moved by Tk - Tq), GQA groups 1, 4 and 8, the
        # model's [B, T, H, D] views.  One query takes two keys or more:
        # over a single key dP - delta cancels and dQ is exactly 0
        ops = _attn_inputs(2, H, KVH, Tq, Tk, D, torch.bfloat16,
                           cuda_device, seed=Tq + Tk + D)
        if layout == "bthd":
            ops = [x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in ops]
        _hold_dq(*ops, causal, "cpu")

    def test_llama_layer(self, cuda_device):
        # one kv group of Llama-3-8B's training layer: T = 8192, 4 query
        # heads over 1 kv head, D = 128, causal, [B, T, H, D] views (the
        # plain versions on the card: [4, 8192, 8192] f32 scores)
        ops = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in
               _attn_inputs(1, 4, 1, 8192, 8192, 128, torch.bfloat16,
                            cuda_device, seed=8192)]
        _hold_dq(*ops, True, cuda_device)


def _hold_fwd(q, k, v, causal):
    """fa_fwd_wgmma with and without the LSE: O and LSE twice, bit for
    bit, one launch each, O in q's memory order, against the f32 plain
    version of the same bf16 inputs by the rule of
    ``_hold_bf16_attention`` (the plain versions on the CPU)."""
    scale = 1 / math.sqrt(q.shape[-1])
    launches.reset()
    o, lse = fa._fwd_kernel(q, k, v, causal, scale, True)
    o2, lse2 = fa._fwd_kernel(q, k, v, causal, scale, True)
    o3, _ = fa._fwd_kernel(q, k, v, causal, scale, False)
    assert launches.snapshot() == {fa.FWD_LSE: 2, fa.FWD: 1}
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    assert torch.equal(o, o3) and o.stride() == q.stride()
    x = [t.cpu() for t in (q, k, v)]
    plain, _ = fa.flash_fwd_plain(*x, causal, scale)
    ro, rlse = fa.flash_fwd_plain(*[t.float() for t in x], causal, scale)
    _hold_bf16_attention(o.cpu(), plain, ro)
    close(lse.cpu(), rlse)


@pytest.mark.cuda
class TestCudaWgmmaHeadDims:
    """The bf16 forward, dQ and dK/dV at head_dims other than 64 and 128,
    on the wgmma instances of 64 (D = 32), 128 (72, and 80 and 96: Phi-2's,
    Phi-3's) and 256 columns (160, and Gemma's 256), TMA filling the
    columns past D with zeros."""

    @pytest.mark.parametrize("layout", ["bhtd", "bthd"])
    @pytest.mark.parametrize("D", [32, 80, 96, 160, 256])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("H,KVH,Tq,Tk", [
        (4, 4, 1, 2), (8, 1, 130, 130), (4, 1, 100, 333), (8, 2, 200, 1000),
        (2, 2, 1, 257), (7, 1, 150, 150)])
    def test_shapes(self, cuda_device, H, KVH, Tq, Tk, causal, D, layout):
        # ragged T, Tq < Tk, Gemma-2B's 8 q heads over 1 kv head, GQA rep
        # 7, the model's [B, T, H, D] views; each kernel's instance from
        # its route, launched under the plain names
        ops = _attn_inputs(2, H, KVH, Tq, Tk, D, torch.bfloat16,
                           cuda_device, seed=Tq + Tk + D)
        if layout == "bthd":
            ops = [x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in ops]
        want = 64 if D <= 64 else 128 if D <= 128 else 256
        for kernel in (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV):
            assert fa.wgmma_width(ops[0], ops[1], kernel) == want
        _hold_fwd(*ops[:3], causal)
        _hold_dq(*ops, causal, "cpu")
        _hold_dkv(*ops, causal, "cpu")

    @pytest.mark.parametrize("D", [72, 80, 96, 160, 200])
    def test_dkv_leaves_columns_past_head_dim(self, cuda_device, D):
        # dK and dV written into views of rows as wide as the instance
        # (the k, v and outputs' row stride W, their columns D..W-1 the
        # next head's in the model's layout), those columns holding
        # sentinels: the kernel stores the first D columns, the bits of a
        # dense launch, and leaves the sentinels
        W = 128 if D <= 128 else 256
        q, k, v, do = _attn_inputs(1, 4, 2, 150, 150, D, torch.bfloat16,
                                   cuda_device, seed=D)
        scale = D ** -0.5
        o, lse = fa._fwd_kernel(q, k, v, True, scale, True)
        ops = fa._bwd_operands(q, k, v, do, lse, fa._delta(o, do))
        want = fa._dkv_kernel(*ops, True, scale)

        def wide(x, fill):
            buf = torch.full((*x.shape[:3], W), fill, dtype=x.dtype,
                             device=x.device)
            buf[..., :D] = x
            return buf

        kw, vw = wide(ops[1], 0.0), wide(ops[2], 0.0)
        dkw = wide(torch.full_like(ops[1], 3.0), 3.0)
        dvw = wide(torch.full_like(ops[1], -5.0), -5.0)
        kv = [x[..., :D] for x in (kw, vw, dkw, dvw)]
        assert fa.wgmma_width(ops[0], kv[0], fa.BWD_DKV) == W
        fn = _build.bind(fa.SOURCE, "flash_bwd_dkv",
                         [ctypes.c_void_p] * 8 + fa._ARGS)
        p = _build.ptr
        _build.check(fn(p(ops[0]), p(kv[0]), p(kv[1]), p(ops[3]),
                        p(ops[4]), p(ops[5]), p(kv[2]), p(kv[3]),
                        *fa._common_args(ops[0], kv[0], True, scale,
                                         fa.BWD_DKV)), fa.SOURCE)
        torch.cuda.synchronize()
        assert torch.equal(kv[2], want[0]) and torch.equal(kv[3], want[1])
        assert bool((dkw[..., D:] == 3.0).all())
        assert bool((dvw[..., D:] == -5.0).all())

    @pytest.mark.parametrize("D", [80, 96])
    def test_heads_side_by_side(self, cuda_device, D):
        # the model's [B, T, H, D] tensors, each head's D columns beside
        # the next head's: a store past column D would land in the next
        # head's columns.  Every head's O and dQ against the plain
        # version, through autograd, three runs the same bits
        ops = _attn_inputs(2, 8, 2, 300, 300, D, torch.bfloat16,
                           cuda_device, seed=D)
        views = [x.transpose(1, 2).contiguous().transpose(1, 2)
                 for x in ops]
        launches.reset()
        runs = [_grads(*views, True) for _ in range(3)]
        assert launches.snapshot() == {
            fa.FWD_LSE: 3, fa.BWD_DQ: 3, fa.BWD_DKV: 3}
        assert all(torch.equal(a, b) for run in runs[1:]
                   for a, b in zip(runs[0], run))
        got = runs[0]
        assert got[0].transpose(1, 2).is_contiguous()
        x = [t.cpu() for t in ops]
        plain = _grads(*x, True)
        ref = _grads(*[t.float() for t in x], True)
        for h in range(8):
            for a, b, r in zip(got[:2], plain[:2], ref[:2]):
                _hold_bf16_attention(a[:, h].cpu(), b[:, h], r[:, h])
        for h in range(2):
            for a, b, r in zip(got[2:], plain[2:], ref[2:]):
                _hold_bf16_attention(a[:, h].cpu(), b[:, h], r[:, h])


@pytest.mark.cuda
class TestCudaSkinnyGroup:
    """norm_linear_skinny_mma: one launch a group at M <= 8, each output
    bit-identical to its single call, within one bf16 rounding of the
    plain version."""

    @pytest.mark.parametrize("K", [64, 1000, 3000, 4096])
    @pytest.mark.parametrize("M", [1, 3, 8])
    def test_group_matches_single_calls(self, cuda_device, M, K):
        # K = 64 and 1000: one rank; 3000: a cluster of 3; 4096: of 4
        g = torch.Generator(device=cuda_device).manual_seed(M * K)
        x = (3 * torch.randn(M, K, generator=g, device=cuda_device)
             ).bfloat16()
        nw = (1 + 0.1 * torch.randn(K, generator=g, device=cuda_device)
              ).bfloat16()
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        # q/k/v-like and gate/up-like widths (with a ragged strip)
        for ns, acts in (([1024, 256, 256], ["none"] * 3),
                         ([2056, 2056], ["silu", "none"])):
            ws = [(torch.randn(K, n, generator=g, device=cuda_device)
                   / K ** 0.5).bfloat16() for n in ns]
            launches.reset()
            outs = fused_norm_linear.fused_norm_linear_group(x, rs, nw, ws,
                                                             acts)
            assert launches.snapshot() == {"fused_norm_linear_skinny": 1}
            again = fused_norm_linear.fused_norm_linear_group(x, rs, nw, ws,
                                                              acts)
            for o, a2, w, act in zip(outs, again, ws, acts):
                assert torch.equal(o, a2)
                assert torch.equal(o, fused_norm_linear.fused_norm_linear(
                    x, rs, nw, w, act))
                want = fused_norm_linear.fused_norm_linear_plain(x, rs, nw,
                                                                 w, act)
                assert float((o.float() - want.float()).abs().max()) <= \
                    float(want.float().abs().max()) / 128

    def test_ring_reuse_gives_the_same_bits(self, cuda_device):
        # Llama-3-8B's gate/up at M = 8, 100 times: every rank's w rows
        # pass through the TMA ring four times, the reuse the proxy fence
        # guards
        g = torch.Generator(device=cuda_device).manual_seed(0)
        x = torch.randn(8, 4096, generator=g, device=cuda_device).bfloat16()
        nw = torch.ones(4096, device=cuda_device).bfloat16()
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        ws = [(torch.randn(4096, 14336, generator=g, device=cuda_device)
               / 64).bfloat16() for _ in range(2)]
        first = fused_norm_linear.fused_norm_linear_group(
            x, rs, nw, ws, ["silu", "none"])
        for _ in range(100):
            outs = fused_norm_linear.fused_norm_linear_group(
                x, rs, nw, ws, ["silu", "none"])
            assert all(torch.equal(a, b) for a, b in zip(outs, first))


@pytest.mark.cuda
class TestCudaTiledGroup:
    """norm_linear_wgmma: the same TMA ring reuse as the skinny kernel's,
    at a prefill chunk's rows."""

    def test_ring_reuse_gives_the_same_bits(self, cuda_device):
        # Llama-3-8B's gate/up at M = 256, 100 times: 64 k-tiles pass
        # through each block's 4-stage ring
        g = torch.Generator(device=cuda_device).manual_seed(1)
        x = torch.randn(256, 4096, generator=g,
                        device=cuda_device).bfloat16()
        nw = torch.ones(4096, device=cuda_device).bfloat16()
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        ws = [(torch.randn(4096, 14336, generator=g, device=cuda_device)
               / 64).bfloat16() for _ in range(2)]
        first = fused_norm_linear.fused_norm_linear_group(
            x, rs, nw, ws, ["silu", "none"])
        for _ in range(100):
            outs = fused_norm_linear.fused_norm_linear_group(
                x, rs, nw, ws, ["silu", "none"])
            assert all(torch.equal(a, b) for a, b in zip(outs, first))


@pytest.mark.cuda
class TestCudaEngine:
    def test_tiny_engine_tokens_match_cpu(self, cuda_device):
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.serving import Engine, ServingConfig

        cfg = LlamaConfig.tiny()
        cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
        gpu = LlamaForCausalLM(cfg, device=cuda_device, seed=None)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 256, size=n) for n in (5, 19, 33)]
        outs = []
        for model in (cpu, gpu):
            eng = Engine(model, ServingConfig(max_batch_size=2, block_size=8,
                                              num_blocks=16, chunk_tokens=16))
            launches.reset()
            outs.append(eng.generate(prompts, max_new_tokens=6))
            eng.pool.check_leaks()
        counts = launches.snapshot()
        for name in ("rms_norm", "fused_norm_linear_skinny",
                     "fused_norm_linear_tiled", "paged_decode",
                     "chunked_prefill", kv_quant.KERNEL):
            assert counts.get(name, 0) > 0, name
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("scheme", ["int8", "fp8"])
    def test_tiny_quantized_engine_tokens_match_cpu(self, cuda_device,
                                                    scheme):
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.serving import Engine, ServingConfig

        cfg = LlamaConfig.tiny()
        cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
        gpu = LlamaForCausalLM(cfg, device=cuda_device, seed=None)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 256, size=n) for n in (5, 19, 33)]
        outs = []
        for model in (cpu, gpu):
            eng = Engine(model, ServingConfig(
                max_batch_size=2, block_size=8, num_blocks=16,
                chunk_tokens=16, kv_cache_dtype=scheme, weight_dtype="int8"))
            launches.reset()
            outs.append(eng.generate(prompts, max_new_tokens=6))
            eng.pool.check_leaks()
        counts = launches.snapshot()
        for name in (f"paged_decode_{scheme}", f"chunked_prefill_{scheme}",
                     kv_quant.KERNEL):
            assert counts.get(name, 0) > 0, name
        assert "paged_decode" not in counts
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)

    def test_tiny_sampled_engine_tokens_match_cpu(self, cuda_device):
        """A bucket of sampled and greedy requests, one streamed: the
        tokens on the card equal the CPU's (the sampler's keys are
        integer arithmetic; a token could differ only at a perturbed
        top-2 margin of a rounding, which these seeds do not meet)."""
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.serving import Engine, ServingConfig

        cfg = LlamaConfig.tiny()
        cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
        gpu = LlamaForCausalLM(cfg, device=cuda_device, seed=None)
        gpu.load_state_dict(cpu.state_dict())
        rng = np.random.RandomState(0)
        prompts = [rng.randint(1, 256, size=n) for n in (5, 19, 33, 8)]
        kws = [dict(temperature=0.8, top_k=50, top_p=0.95, seed=1),
               {}, dict(temperature=1.0, seed=2), {}]
        outs = []
        for model in (cpu, gpu):
            eng = Engine(model, ServingConfig(max_batch_size=4, block_size=8,
                                              num_blocks=16, chunk_tokens=16))
            streamed = []
            reqs = [eng.submit(p, max_new_tokens=6, **kw)
                    for p, kw in zip(prompts, kws)]
            reqs.append(eng.submit(prompts[0], max_new_tokens=6,
                                   on_token=streamed.append, **kws[2]))
            eng.run_until_complete()
            eng.pool.check_leaks()
            assert streamed == reqs[-1].generated
            outs.append([r.generated for r in reqs])
        assert outs[1] == outs[0]

    def test_sampler_matches_cpu(self, cuda_device):
        from paddle_tpu_torch.serving.sampling import prng_key, sample_at

        g = torch.Generator().manual_seed(0)
        logits = torch.randn((6, 4096), generator=g) * 4
        temps = t(np.array([0.0, 0.8, 1.0, 0.7, 0.8, 1.3], np.float32))
        top_ks = t(np.array([0, 0, 50, 0, 50, 1000]))
        top_ps = t(np.array([1.0, 1.0, 1.0, 0.9, 0.95, 0.8], np.float32))
        keys = t(np.stack([prng_key(s) for s in range(6)]))
        cpu = (logits, temps, top_ks, top_ps, keys)
        gpu = tuple(a.to(cuda_device) for a in cpu)
        for c in range(16):
            ctr = torch.full((6,), c)
            np.testing.assert_array_equal(
                sample_at(*gpu, ctr.to(cuda_device)).cpu(),
                sample_at(*cpu, ctr))


def _attn_inputs(B, H, KVH, Tq, Tk, D, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype).to(device)
            for shape in ((B, H, Tq, D), (B, KVH, Tk, D), (B, KVH, Tk, D),
                          (B, H, Tq, D))]


def _grads(q, k, v, do, causal):
    q, k, v = (x.detach().clone().requires_grad_() for x in (q, k, v))
    o = fa.flash_attention_bhtd(q, k, v, causal)
    o.backward(do)
    return [o.detach(), q.grad, k.grad, v.grad]


def _hold_bf16_attention(got, plain, ref):
    """A bf16 kernel output against the f32 plain version ``ref`` of the
    same (bf16-valued) inputs: its error may be twice the bf16 plain
    version's own error (which rounds only the output) plus one bf16
    rounding (2^-9) of the largest output, for the kernel's rounding of
    P and dS to bf16 ahead of the second product, which over a few tens
    of keys does not average out."""
    err = float((got.float() - ref).abs().max())
    bound = 2 * float((plain.float() - ref).abs().max()) \
        + float(ref.abs().max()) * 2.0 ** -9
    assert err <= bound, (err, bound)


ATTN_SHAPES = [  # B, H, KVH, Tq, Tk
    (2, 4, 2, 37, 37), (1, 4, 1, 20, 45), (1, 8, 2, 130, 130),
    (1, 2, 1, 200, 333)]


@pytest.mark.cuda
class TestCudaTrainingKernels:

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("offset", [0, 7])
    def test_rope(self, cuda_device, dtype, offset):
        g = torch.Generator().manual_seed(offset)
        x = torch.randn(2, 37, 4, 64, generator=g).to(dtype)
        ang = torch.randn(50, 32, generator=g)
        cos, sin = ang.cos().to(dtype), ang.sin().to(dtype)
        gy = torch.randn(x.shape, generator=g).to(dtype)
        outs = []
        for dev in ("cpu", cuda_device):
            xd = x.detach().to(dev).requires_grad_()
            y = rope.fused_rope(xd, cos.to(dev), sin.to(dev), offset)
            y.backward(gy.to(dev))
            outs.append((y.detach().cpu().float(), xd.grad.cpu().float()))
        # f32: sums in another order; bf16: the same f32 arithmetic and
        # one rounding, up to a contracted multiply-add
        tol = 1e-4 if dtype == torch.float32 else 2.0 ** -7
        for got, want in zip(outs[1], outs[0]):
            close(got, want, tol)

    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("B,H,KVH,Tq,Tk", ATTN_SHAPES)
    def test_flash_attention_f32(self, cuda_device, B, H, KVH, Tq, Tk,
                                 causal):
        ops = _attn_inputs(B, H, KVH, Tq, Tk, 64, torch.float32, "cpu")
        want = _grads(*ops, causal)
        launches.reset()
        got = _grads(*[x.to(cuda_device) for x in ops], causal)
        assert launches.snapshot() == {fa.FWD_LSE: 1, fa.BWD_DQ: 1,
                                       fa.BWD_DKV: 1}
        for a, b in zip(got, want):
            close(a.cpu(), b)
        with torch.no_grad():
            o = fa.flash_attention_bhtd(*[x.to(cuda_device)
                                          for x in ops[:3]], causal)
        assert launches.snapshot()[fa.FWD] == 1
        close(o.cpu(), want[0])

    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("B,H,KVH,Tq,Tk", ATTN_SHAPES)
    def test_flash_attention_bf16(self, cuda_device, B, H, KVH, Tq, Tk,
                                  causal, D):
        ops = _attn_inputs(B, H, KVH, Tq, Tk, D, torch.bfloat16,
                           cuda_device, seed=D)
        got = _grads(*ops, causal)
        scale = 1 / math.sqrt(D)
        # the plain version on the same bf16 inputs, and in f32
        o, lse = fa.flash_fwd_plain(*ops[:3], causal, scale)
        plain = [o, *fa.flash_bwd_plain(*ops[:3], o, lse, ops[3], causal,
                                        scale)]
        f = [x.float() for x in ops]
        ro, rlse = fa.flash_fwd_plain(*f[:3], causal, scale)
        ref = [ro, *fa.flash_bwd_plain(*f[:3], ro, rlse, f[3], causal,
                                       scale)]
        for a, b, r in zip(got, plain, ref):
            _hold_bf16_attention(a, b, r)

    @pytest.mark.parametrize("layout", ["bhtd", "bthd"])
    @pytest.mark.parametrize("D", [64, 128])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("H,KVH,Tq,Tk", [
        (4, 4, 1, 1), (4, 1, 100, 100), (8, 2, 1000, 1000), (4, 1, 100, 333),
        (2, 2, 1, 257)])
    def test_flash_attention_forward(self, cuda_device, H, KVH, Tq, Tk,
                                     causal, D, layout):
        # the wgmma forward: ragged T, Tq < Tk, GQA groups 1 and 4, the
        # model's [B, T, H, D] views; O and LSE, twice, bit for bit
        ops = _attn_inputs(2, H, KVH, Tq, Tk, D, torch.bfloat16,
                           cuda_device, seed=Tq + D)[:3]
        if layout == "bthd":
            ops = [x.transpose(1, 2).contiguous().transpose(1, 2)
                   for x in ops]
        scale = 1 / math.sqrt(D)
        launches.reset()
        o, lse = fa._fwd_kernel(*ops, causal, scale, True)
        o2, lse2 = fa._fwd_kernel(*ops, causal, scale, True)
        o3, _ = fa._fwd_kernel(*ops, causal, scale, False)
        assert launches.snapshot() == {fa.FWD_LSE: 2, fa.FWD: 1}
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        assert torch.equal(o, o3) and o.stride() == ops[0].stride()
        plain, _ = fa.flash_fwd_plain(*ops, causal, scale)
        ro, rlse = fa.flash_fwd_plain(*[x.float() for x in ops], causal,
                                      scale)
        _hold_bf16_attention(o, plain, ro)
        close(lse.cpu(), rlse.cpu())

    def test_flash_attention_tma_strides(self, cuda_device):
        # a view whose time stride is not a multiple of 16 bytes has no
        # tensor map: the wrapper copies it to a dense layout first
        base = torch.randn(1, 2, 40, 68, device=cuda_device).bfloat16()
        q = base[..., :64]
        assert fa._kernel_view(q).stride()[2] == 64
        k = torch.randn(1, 1, 40, 64, device=cuda_device).bfloat16()
        with torch.no_grad():
            got = fa.flash_attention_bhtd(q, k, k, causal=True)
        assert torch.equal(got, fa.flash_attention_bhtd(
            q.contiguous(), k, k, causal=True))

    def test_flash_attention_bthd_views(self, cuda_device):
        # the model's [B, T, H, D] layout goes in as strided views and
        # comes out in the same memory order, no copy
        ops = _attn_inputs(1, 8, 2, 70, 70, 128, torch.bfloat16,
                           cuda_device, seed=5)
        q, k, v, do = (x.transpose(1, 2).contiguous() for x in ops)
        out = fa.flash_attention_bthd(q, k, v, causal=True)
        assert out.is_contiguous()
        with torch.no_grad():
            want = fa.flash_attention_bhtd(*ops[:3], causal=True)
        assert torch.equal(out.transpose(1, 2), want)


@pytest.mark.cuda
class TestCudaTraining:
    def test_tiny_training_matches_cpu(self, cuda_device):
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.optimizer import AdamW

        cfg = LlamaConfig.tiny(fused_lm_loss=True, lm_loss_chunk=32)
        cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
        gpu = LlamaForCausalLM(cfg, device=cuda_device, seed=None)
        gpu.load_state_dict(cpu.state_dict())
        tokens = torch.from_numpy(
            np.random.RandomState(0).randint(0, 256, (2, 40)))
        losses, L = [], cfg.num_hidden_layers
        for model in (cpu, gpu):
            opt = AdamW(1e-3, parameters=model.parameters())
            x = tokens.to(model.device)
            out = []
            for _ in range(5):
                launches.reset()
                loss, _ = model(x, labels=x)
                loss.backward()
                opt.step()
                opt.clear_grad()
                out.append(float(loss.detach()))
            losses.append(out)
        assert launches.snapshot() == {
            "rms_norm": 2 * L + 1, "rope": 4 * L, fa.FWD_LSE: L,
            fa.BWD_DQ: L, fa.BWD_DKV: L}
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4,
                                   atol=1e-4)
        assert losses[1][-1] < losses[1][0]

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_adamw_rule_matches_cpu(self, cuda_device, dtype):
        # the rule's multiply-adds round once and its divisions are
        # correctly rounded on both devices, so the moments are identical;
        # CUDA's f32 square root is one ulp off in a few elements, which
        # the decayed parameter minus the update can double: f32
        # parameters agree to 2 ulps, bf16 ones exactly
        from paddle_tpu_torch.optimizer import adamw_rule

        rng = np.random.RandomState(5)
        p = t((rng.randn(256, 96) * 0.02).astype(np.float32)).to(dtype)
        g = t((rng.randn(256, 96) * 0.01).astype(np.float32)).to(dtype)
        m = t((rng.randn(256, 96) * 1e-3).astype(np.float32))
        v = t((rng.rand(256, 96) * 1e-5).astype(np.float32))
        out = []
        for dev in ("cpu", cuda_device):
            # copies: the rule updates p, m and v in place
            ps, ms, vs = (x.to(dev, copy=True) for x in (p, m, v))
            new = adamw_rule(ps, ms, vs, g.to(dev), 1e-3, 0.9, 0.999, 1e-8,
                             3, 0.01)
            out.append([x.cpu() for x in (new, ms, vs)])
        (p_cpu, m_cpu, v_cpu), (p_gpu, m_gpu, v_gpu) = out
        assert torch.equal(m_cpu, m_gpu) and torch.equal(v_cpu, v_gpu)
        if dtype == torch.bfloat16:
            assert torch.equal(p_cpu, p_gpu)
        else:
            np.testing.assert_array_max_ulp(p_cpu.numpy(), p_gpu.numpy(),
                                            maxulp=2)


def _moe_hold(got, want, exact):
    """Bit-identical, or within 1e-6 (f32) / one ulp of each output
    (bf16)."""
    f32 = got.dtype == torch.float32
    got, want = got.cpu().float(), want.cpu().float()
    if exact:
        assert torch.equal(got, want)
        return
    if f32:
        close(got, want, 1e-6)
        return
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert bool(((got - want).abs() <= ulp).all())


@pytest.mark.cuda
class TestCudaMoE:
    E, C, T = 8, 64, 256

    def _case(self, case, dtype, M, dev):
        rng = np.random.RandomState(6)
        tok = t(rng.randn(self.T, M).astype(np.float32)).to(dev, dtype)
        eo = t(rng.randn(self.E, self.C, M).astype(np.float32)).to(dev, dtype)
        eidx, sidx, w = (t(x).to(dev) for x in moe_routing(
            case, self.T, self.E, self.C, seed=7))
        return tok, eo, eidx, sidx, w

    @pytest.mark.parametrize("M", [4096, 100])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("case", ["random", "unique", "clamped"])
    def test_kernels_match_plain(self, cuda_device, case, dtype, M):
        # M = 100 bf16 rows are not 16-byte multiples: the scalar path
        tok, eo, eidx, sidx, w = self._case(case, dtype, M, cuda_device)
        w = w.to(dtype) if case == "unique" else w
        launches.reset()
        d = moe_dispatch.moe_dispatch(tok, eidx, sidx, w, self.E, self.C)
        c = moe_dispatch.moe_combine(eo, eidx, sidx, w)
        torch.cuda.synchronize()
        assert launches.snapshot() == {"moe_dispatch": 1, "moe_combine": 1}
        cpu = [x.cpu() for x in (tok, eo, eidx, sidx, w)]
        _moe_hold(d, moe_dispatch.dispatch_plain(
            cpu[0], *cpu[2:], self.E, self.C), case == "unique")
        _moe_hold(c, moe_dispatch.combine_plain(*cpu[1:]), case == "unique")
        # slots no choice names (with a nonzero weight) are exact zeros
        keep = (cpu[3] < self.C) & (cpu[4] != 0)
        named = torch.zeros(self.E, self.C, dtype=torch.bool)
        named[cpu[2][keep].long(), cpu[3][keep].long()] = True
        assert (~named).any()
        assert not d.cpu()[~named].any()

    def test_autograd_matches_cpu(self, cuda_device):
        grads = []
        for dev in ("cpu", cuda_device):
            tok, eo, eidx, sidx, wc = self._case("random", torch.float32,
                                                 256, dev)
            wd = torch.rand(wc.shape, generator=torch.Generator()
                            .manual_seed(8)).to(dev)
            tok, wd, wc = (x.clone().requires_grad_() for x in (tok, wd, wc))
            d = moe_dispatch.moe_dispatch(tok, eidx, sidx, wd, self.E, self.C)
            out = moe_dispatch.moe_combine(d * eo, eidx, sidx, wc)
            (out * out).sum().backward()
            grads.append([x.grad.cpu() for x in (tok, wd, wc)])
        for got, want in zip(grads[1], grads[0]):
            close(got, want, 1e-5 * float(want.abs().max()))

    def test_rejects_what_it_does_not_take(self, cuda_device):
        tok, eo, eidx, sidx, w = self._case("unique", torch.bfloat16, 64,
                                            cuda_device)
        launches.reset()
        with pytest.raises(TypeError, match="int32"):
            moe_dispatch.moe_dispatch(tok, eidx.long(), sidx, w, self.E,
                                      self.C)
        with pytest.raises(TypeError, match="int32"):
            moe_dispatch.moe_combine(eo, eidx, sidx.long(), w)
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            moe_dispatch.moe_dispatch(tok.half(), eidx, sidx, w, self.E,
                                      self.C)
        with pytest.raises(TypeError, match="weights"):
            moe_dispatch.moe_combine(eo, eidx, sidx, w.half())
        assert launches.snapshot() == {}

    def test_tiny_moe_training_matches_cpu(self, cuda_device):
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.optimizer import AdamW

        cfg = LlamaConfig.tiny(moe_num_experts=4, fused_lm_loss=True,
                               lm_loss_chunk=32)
        cpu = LlamaForCausalLM(cfg, device="cpu", seed=0)
        gpu = LlamaForCausalLM(cfg, device=cuda_device, seed=None)
        gpu.load_state_dict(cpu.state_dict())
        tokens = torch.from_numpy(
            np.random.RandomState(0).randint(0, 256, (2, 40)))
        losses, L = [], cfg.num_hidden_layers
        for model in (cpu, gpu):
            opt = AdamW(1e-3, parameters=model.parameters())
            x = tokens.to(model.device)
            out = []
            for _ in range(5):
                launches.reset()
                loss, _ = model(x, labels=x)
                loss.backward()
                opt.step()
                opt.clear_grad()
                out.append(float(loss.detach()))
            losses.append(out)
        assert launches.snapshot() == {
            "rms_norm": 2 * L + 1, "rope": 4 * L, fa.FWD_LSE: L,
            fa.BWD_DQ: L, fa.BWD_DKV: L, "moe_dispatch": 2 * L,
            "moe_combine": 2 * L}
        np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4,
                                   atol=1e-4)
        assert losses[1][-1] < losses[1][0]


@pytest.mark.cuda
class TestCudaFusedLinear:
    @staticmethod
    def _operands(M, K, N, bias, dtype, lead=()):
        g = torch.Generator().manual_seed(M * 7 + N)
        x = torch.randn(*lead, M, K, generator=g).to(dtype)
        w = (torch.randn(N, K, generator=g) / K ** 0.5).to(dtype)
        b = torch.randn(N, generator=g).to(dtype) if bias else None
        return x, w, b

    # aligned tiles, ragged M and N (odd N: scalar stores), one row
    @pytest.mark.parametrize("M,K,N,bias", [
        (256, 64, 128, True), (37, 40, 13, False), (130, 96, 130, True),
        (1, 8, 3, True)])
    @pytest.mark.parametrize("act", sorted(fused_linear.ACTIVATIONS))
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_kernel_matches_plain(self, cuda_device, M, K, N, bias, act,
                                  dtype):
        x, w, b = self._operands(M, K, N, bias, dtype)
        want = fused_linear.fused_linear_plain(x, w, b, act).float()
        launches.reset()
        got = fused_linear.fused_linear(
            x.to(cuda_device), w.to(cuda_device),
            None if b is None else b.to(cuda_device), act)
        assert launches.snapshot() == {fused_linear.KERNEL: 1}
        assert got.dtype == dtype and got.shape == (M, N)
        if dtype == torch.float32:
            close(got.cpu(), want)
        else:
            assert float((got.cpu().float() - want).abs().max()) <= \
                float(want.abs().max()) * 2.0 ** -7

    def test_leading_dims_and_zero_rows(self, cuda_device):
        x, w, b = (a.to(cuda_device) for a in self._operands(
            5, 64, 48, True, torch.float32, lead=(3,)))
        out = fused_linear.fused_linear(x, w, b, "gelu")
        assert out.shape == (3, 5, 48)
        close(out.cpu(), fused_linear.fused_linear(x.cpu(), w.cpu(), b.cpu(),
                                                   "gelu"))
        launches.reset()
        empty = fused_linear.fused_linear(x[:0], w, b, "gelu")
        assert empty.shape == (0, 5, 48) and launches.snapshot() == {}

    def test_strided_weight_and_bias(self, cuda_device):
        # w as the transpose of an [in, out] tensor, b a strided slice
        x, w, b = (a.to(cuda_device) for a in self._operands(
            9, 64, 48, True, torch.float32))
        wt = w.t().contiguous().t()
        bs = torch.stack([b, -b], 1)[:, 0]
        assert not wt.is_contiguous() and not bs.is_contiguous()
        close(fused_linear.fused_linear(x, wt, bs, "relu").cpu(),
              fused_linear.fused_linear_plain(x.cpu(), w.cpu(), b.cpu(),
                                              "relu"))

    @pytest.mark.parametrize("act", ["gelu", "silu", "none"])
    def test_backward_matches_cpu(self, cuda_device, act):
        x, w, b = self._operands(70, 64, 40, True, torch.float32)
        cot = torch.randn(70, 40, generator=torch.Generator().manual_seed(1))
        grads = []
        for dev in ("cpu", cuda_device):
            ts = [a.detach().to(dev).requires_grad_() for a in (x, w, b)]
            (fused_linear.fused_linear(*ts, act) * cot.to(dev)).sum() \
                .backward()
            grads.append([a.grad.cpu() for a in ts])
        for got, want in zip(grads[1], grads[0]):
            close(got, want, 1e-5 * float(want.abs().max()))

    @pytest.mark.parametrize("K", [3, 5, 771])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_any_k(self, cuda_device, K, dtype):
        # K % 8 != 0 takes the predicated loads; twice, bit for bit
        x, w, b = self._operands(130, K, 72, True, dtype)
        want = fused_linear.fused_linear_plain(x, w, b, "relu").float()
        xd, wd, bd = (a.to(cuda_device) for a in (x, w, b))
        launches.reset()
        got = fused_linear.fused_linear(xd, wd, bd, "relu")
        assert torch.equal(got, fused_linear.fused_linear(xd, wd, bd,
                                                          "relu"))
        assert launches.snapshot() == {fused_linear.KERNEL: 2}
        tol = TOL if dtype == torch.float32 else 2.0 ** -7
        assert float((got.cpu().float() - want).abs().max()) <= \
            tol * max(1.0, float(want.abs().max()))

    def test_unaligned_rows(self, cuda_device):
        # K % 8 == 0, but x starts 2 bytes past a 16-byte boundary
        x, w, _ = self._operands(33, 64, 40, False, torch.bfloat16)
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
        xs = buf[1:].view(33, 64)
        xs.copy_(x)
        assert xs.is_contiguous() and xs.data_ptr() % 16
        got = fused_linear.fused_linear(xs, w.to(cuda_device), None)
        want = fused_linear.fused_linear_plain(x, w, None, "none").float()
        assert float((got.cpu().float() - want).abs().max()) <= \
            float(want.abs().max()) * 2.0 ** -7

    @pytest.mark.parametrize("K", [72, 776])
    @pytest.mark.parametrize("N", [1, 72, 3080, 768])
    @pytest.mark.parametrize("M", [1, 130, 16384])
    def test_shapes_past_the_tile(self, cuda_device, M, N, K):
        # M and N that are no multiple of the 128 x 256 tile, K of 64-deep
        # k-tiles and a part; N % 8 == 0 takes the wgmma instance (its
        # output by TMA), N = 1 the predicated one; the plain version on
        # the card
        g = torch.Generator(device=cuda_device).manual_seed(M + N + K)
        x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
        w = (torch.randn(N, K, generator=g, device=cuda_device)
             / K ** 0.5).bfloat16()
        b = torch.randn(N, generator=g, device=cuda_device).bfloat16()
        assert fused_linear.tma_ok(x, w) == (N % 8 == 0)
        launches.reset()
        got = fused_linear.fused_linear(x, w, b, "gelu")
        assert launches.snapshot() == {fused_linear.KERNEL: 1}
        want = fused_linear.fused_linear_plain(x, w, b, "gelu").float()
        assert float((got.float() - want).abs().max()) <= \
            float(want.abs().max()) * 2.0 ** -7

    def test_misaligned_base_takes_the_predicated_instance(self,
                                                           cuda_device):
        # K and N are multiples of 8, but x starts 2 bytes past a 16-byte
        # boundary: no tensor map takes it, so the route (chosen before
        # the launch) is the predicated instance, with the same result
        x, w, b = self._operands(300, 768, 1024, True, torch.bfloat16)
        xd, wd, bd = (a.to(cuda_device) for a in (x, w, b))
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)
        xs = buf[1:].view(300, 768)
        xs.copy_(xd)
        assert fused_linear.tma_ok(xd, wd)
        assert not fused_linear.tma_ok(xs, wd)
        want = fused_linear.fused_linear_plain(x, w, b, "gelu").float()
        for xin in (xd, xs):
            got = fused_linear.fused_linear(xin, wd, bd, "gelu")
            assert float((got.cpu().float() - want).abs().max()) <= \
                float(want.abs().max()) * 2.0 ** -7

    def test_ring_reuse_gives_the_same_bits(self, cuda_device):
        # BERT-base's FFN shape, 100 launches: every stage of the TMA ring
        # and every staging buffer of the TMA stores is reused many times
        g = torch.Generator(device=cuda_device).manual_seed(3)
        x = torch.randn(16384, 768, generator=g, device=cuda_device).bfloat16()
        w = (torch.randn(3072, 768, generator=g, device=cuda_device)
             / 768 ** 0.5).bfloat16()
        b = torch.randn(3072, generator=g, device=cuda_device).bfloat16()
        assert fused_linear.tma_ok(x, w)
        launches.reset()
        first = fused_linear.fused_linear(x, w, b, "gelu")
        differ = sum(not torch.equal(first, fused_linear.fused_linear(
            x, w, b, "gelu")) for _ in range(100))
        assert differ == 0
        assert launches.snapshot() == {fused_linear.KERNEL: 101}

    def test_rejects_what_it_does_not_take(self, cuda_device):
        # K = 12 runs (any K does); other dtypes and shapes raise
        x, w, b = self._operands(4, 12, 8, True, torch.float32)
        want = fused_linear.fused_linear_plain(x, w, b, "gelu")
        launches.reset()
        close(fused_linear.fused_linear(x.to(cuda_device), w.to(cuda_device),
                                        b.to(cuda_device), "gelu").cpu(),
              want)
        assert launches.snapshot() == {fused_linear.KERNEL: 1}
        launches.reset()
        x, w, b = (a.to(cuda_device) for a in self._operands(
            4, 16, 8, True, torch.float16))
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            fused_linear.fused_linear(x, w, b, "gelu")
        with pytest.raises(ValueError, match="do not fit"):
            fused_linear.fused_linear(x.float(), w.float(), b, "gelu")
        assert launches.snapshot() == {}


def _tiny_static_bert(device, state, steps=5):
    """BertConfig.tiny() (f32, dropout 0) with the weights ``state``,
    recorded as a static Program, AdamW.minimize, then the build
    strategy: the losses of ``steps`` steps on one batch and the
    launches of each step."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    cfg = BertConfig.tiny(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    model = BertForPretraining(cfg, device=device, seed=None)
    model.load_state_dict(state)
    rng = np.random.RandomState(0)
    feed = {"ids": rng.randint(0, 256, (2, 32)),
            "labels": np.where(rng.rand(2, 32) < 0.15,
                               rng.randint(0, 256, (2, 32)), -100)}
    static.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            ids = static.data("ids", [2, 32], "int64")
            labels = static.data("labels", [2, 32], "int64")
            loss, _, _ = model(ids, masked_lm_labels=labels)
            AdamW(1e-3, parameters=model.named_parameters()).minimize(loss)
        static.apply_build_strategy(main, keep=[loss.name])
    finally:
        static.disable_static()
    exe = static.Executor(device)
    losses, counts = [], []
    for _ in range(steps):
        launches.reset()
        losses.append(float(exe.run(main, feed=feed, fetch_list=[loss])[0]))
        counts.append(launches.snapshot())
    return losses, counts


def _fc_program(device, w, b):
    """``static.nn.fc(x [None, 3], 5, activation="relu")`` with the
    weights w [5, 3] and b [5], fused by the build strategy."""
    from paddle_tpu_torch import static

    static.enable_static()
    try:
        main = static.Program()
        with static.program_guard(main):
            x = static.data("x", [None, 3], "float32")
            y = static.nn.fc(x, 5, weight_attr=w, bias_attr=b,
                             activation="relu", device=device)
        static.apply_build_strategy(main, keep=[y.name])
    finally:
        static.disable_static()
    return main, y


@pytest.mark.cuda
class TestCudaStatic:
    def test_fused_fc_with_k_3_matches_cpu(self, cuda_device):
        # the fused linear -> relu pair with K = 3 runs on the card
        from paddle_tpu_torch import static

        rng = np.random.RandomState(0)
        feed = {"x": rng.randn(7, 3).astype(np.float32)}
        w, b = rng.randn(5, 3).astype(np.float32), rng.randn(5).astype(
            np.float32)
        outs = []
        for device in ("cpu", cuda_device):
            main, y = _fc_program(device, w, b)
            assert [op.type for op in main.global_block().ops] == \
                ["fused_linear"]
            launches.reset()
            outs.append(static.Executor(device).run(main, feed=feed,
                                                    fetch_list=[y])[0])
            want = {fused_linear.KERNEL: 1} if device != "cpu" else {}
            assert launches.snapshot() == want
        close(outs[1], outs[0])

    def test_tiny_static_bert_matches_cpu(self, cuda_device):
        from paddle_tpu_torch.models import BertConfig, BertForPretraining

        state = BertForPretraining(BertConfig.tiny(), device="cpu",
                                   seed=0).state_dict()
        cpu_losses, cpu_counts = _tiny_static_bert("cpu", state)
        losses, counts = _tiny_static_bert(cuda_device, state)
        assert cpu_counts == [{}] * 5
        assert counts == [{fused_linear.KERNEL: 3}] * 5
        np.testing.assert_allclose(losses, cpu_losses, rtol=1e-4, atol=1e-4)
        assert losses[-1] < losses[0]


def _kernels_of(fn, traces=3):
    """(result, {kernel name: launches}) of ``fn()`` in a torch.profiler
    trace: every kernel and memset the call ran on the device.  The
    launch counters are set to 0 before the call, so they read the
    traced call's.  A trace that holds no device event at all missed
    them (the card's tracer now and then drops a whole trace): the call
    is traced again, up to ``traces`` times."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(traces):
        torch.cuda.synchronize()
        launches.reset()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.self_device_time_total > 0}
        if kernels:
            break
    return out, kernels


# (tokens, capacity) of each form of the dispatch, at 8 experts, top-2
DISPATCH_FORMS = {"decode": (8, 8), "chunk": (256, 256),
                  "training": (512, 512), "dropping": (512, 64),
                  "backward": (512, 64), "several": (256, 16)}


def _dispatch_case(form, dtype, M, dev):
    """(tokens, eidx, sidx, weights, E, C) of one dispatch form: the
    model's forward (running-count slots, weight 1 in the tokens' dtype,
    dropped past C), the backward's (slots clamped to C - 1, the dropped
    choices at weight 0, f32), or random slots named by several choices
    of nonzero f32 weight ("several")."""
    T, C = DISPATCH_FORMS[form]
    E = 8
    rng = np.random.RandomState(T + C + M)
    eidx = np.stack([rng.choice(E, 2, replace=False)
                     for _ in range(T)]).astype(np.int32)
    sidx = running_slots(eidx, E)
    w = np.ones((T, 2), np.float32)
    if form == "backward":
        w = (rng.rand(T, 2) + 0.25) * (sidx < C)
        sidx = np.minimum(sidx, C - 1)
    elif form == "several":
        sidx = rng.randint(0, C + 2, (T, 2))
        w = rng.rand(T, 2) + 0.25
    tok = t(rng.randn(T, M).astype(np.float32)).to(dev, dtype)
    w = t(w.astype(np.float32)).to(dev)
    if form not in ("backward", "several"):
        w = w.to(dtype)
    return (tok, t(eidx).to(dev), t(sidx.astype(np.int32)).to(dev), w, E, C)


@pytest.mark.cuda
class TestCudaDispatchForms:
    @pytest.mark.parametrize("M", [4096, 100])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("form", list(DISPATCH_FORMS))
    def test_one_kernel_the_plain_bits_twice(self, cuda_device, form,
                                             dtype, M):
        # M = 100: rows that are not a multiple of 16 bytes in bf16 (the
        # scalar instance); f32 rows of 400 bytes take the vector one
        ops = _dispatch_case(form, dtype, M, cuda_device)
        if form == "several":
            named = np.bincount((ops[1] * ops[4] + ops[2]).reshape(-1)
                                .cpu().numpy())
            assert named.max() >= 3
        got, kernels = _kernels_of(lambda: moe_dispatch.moe_dispatch(*ops))
        again = moe_dispatch.moe_dispatch(*ops)
        assert launches.snapshot() == {"moe_dispatch": 2}
        assert list(kernels.values()) == [1] and \
            "moe_dispatch_kernel" in next(iter(kernels))
        assert torch.equal(got, again)
        cpu = [x.cpu() if isinstance(x, torch.Tensor) else x for x in ops]
        assert torch.equal(got.cpu(), moe_dispatch.dispatch_plain(*cpu))


def _write_case(form, pool, dev):
    """kv_write operands of one form ("decode": a step of 4 sequences,
    k unrotated with its RoPE rows, at page edges and past the table's
    width; "chunk": 40 tokens of 4 sequences across page edges, padded
    tails masked, some of them past the table's width) over f32, bf16,
    int8 or fp8 pools, on ``dev``; and the masked tokens' (b, t)."""
    dtype = torch.float32 if pool == "f32" else torch.bfloat16
    scheme = pool if pool in ("int8", "fp8") else None
    B, KVH, D, bs, nbs = 4, 8, 128, 16, 6
    T = 1 if form == "decode" else 40
    nb = 1 + B * nbs
    g = torch.Generator().manual_seed(len(form) + len(pool))
    k, v = ((torch.randn(B, T, KVH, D, generator=g)
             * torch.logspace(-2, 2, B * T).view(B, T, 1, 1)).to(dtype)
            for _ in range(2))
    k[1, 0] = 0
    bt = (1 + torch.randperm(nb - 1, generator=g)).view(B, nbs).int()
    kw = dict(scheme=scheme)
    masked = []
    if form == "decode":
        pos = torch.tensor([15, 16, 17, 96], dtype=torch.int32)
        ang = pos[:, None].double() * 0.37 ** torch.arange(D // 2)
        kw.update(c=ang.cos().to(dtype), s=ang.sin().to(dtype))
    else:
        pos = torch.tensor([0, 15, 31, 60], dtype=torch.int32)
        mask = torch.ones(B, T, dtype=torch.bool)
        mask[1, 35:] = False
        mask[3, 30:] = False            # positions 90..99, past 96 too
        masked = [(b, j) for b in range(B) for j in range(T)
                  if not mask[b, j]]
        kw["write_mask"] = mask
    if scheme is None:
        pools = [torch.randn(nb, bs, KVH, D, generator=g).to(dtype)
                 for _ in range(2)]
    else:
        pools = [torch.zeros(nb, bs, KVH, D, dtype=torch.int8)
                 for _ in range(2)]
        kw.update(k_scale=torch.ones(nb, bs), v_scale=torch.ones(nb, bs))
    ops = [*pools, k, v, bt, pos]
    move = (lambda x: x.to(dev)) if dev != "cpu" else (lambda x: x.clone())
    return [move(x) for x in ops], {
        key: move(x) if isinstance(x, torch.Tensor) else x
        for key, x in kw.items()}, masked


@pytest.mark.cuda
class TestCudaKVWrite:
    @pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "fp8"])
    @pytest.mark.parametrize("form", ["decode", "chunk"])
    def test_bit_identical_to_plain(self, cuda_device, form, pool):
        ops, kw, masked = _write_case(form, pool, "cpu")
        kv_quant.kv_write(*ops, **kw)
        dops, dkw, _ = _write_case(form, pool, cuda_device)
        _, kernels = _kernels_of(lambda: kv_quant.kv_write(*dops, **dkw))
        assert launches.snapshot() == {kv_quant.KERNEL: 1}
        assert list(kernels.values()) == [1]
        quant = kw["scheme"] is not None
        got = [x.cpu() for x in dops[:2]]
        want = ops[:2]
        if quant:
            got += [dkw["k_scale"].cpu(), dkw["v_scale"].cpu()]
            want += [kw["k_scale"], kw["v_scale"]]
        for side, (a, b) in enumerate(zip(got, want)):
            # every row but the garbage block's row 0 bit for bit
            assert torch.equal(a.flatten(0, 1)[1:], b.flatten(0, 1)[1:])
            if not masked:
                assert torch.equal(a.flatten(0, 1)[0], b.flatten(0, 1)[0])
        for side in range(2):
            # row 0 holds one of the padded tokens that share it (with
            # its own scale), as the plain version's does
            new = ops[2 + side]
            cands = [new[b, j] for b, j in masked]
            if quant:
                cands = [kv_quant.quantize_kv(x, kw["scheme"]) for x in cands]
                row = (got[side][0, 0], got[2 + side][0, 0])
                assert any(torch.equal(row[0], c) and torch.equal(row[1], s)
                           for c, s in cands) or not masked
            else:
                assert any(torch.equal(got[side][0, 0], c)
                           for c in cands) or not masked


def _hold_general_attention(q, k, v, do, causal):
    """The attention kernels on bf16 ``q, k, v`` [B, H, T, D]: the
    forward with and without the LSE, dQ and dK/dV, each one launch under
    the counter of its own route (``_general`` on a general instance:
    where head_dim is not a multiple of 8 or the strides have no tensor
    map), two runs the same bits, each output by the rule of
    ``_hold_bf16_attention`` against the f32 plain version of the same
    inputs."""
    scale = 1 / math.sqrt(q.shape[-1])
    launches.reset()
    o, lse = fa._fwd_kernel(q, k, v, causal, scale, True)
    o2, _ = fa._fwd_kernel(q, k, v, causal, scale, False)
    ops = fa._bwd_operands(q, k, v, do, lse, fa._delta(o, do))
    grads = fa._bwd_kernels(*ops, causal, scale)
    again = fa._bwd_kernels(*ops, causal, scale)
    name = {n: fa._launch_name(n, q, k)
            for n in (fa.FWD_LSE, fa.FWD, fa.BWD_DQ, fa.BWD_DKV)}
    assert launches.snapshot() == {name[fa.FWD_LSE]: 1, name[fa.FWD]: 1,
                                   name[fa.BWD_DQ]: 2, name[fa.BWD_DKV]: 2}
    assert torch.equal(o, o2)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    x = [t.cpu() for t in (q, k, v, do)]
    f = [t.float() for t in x]
    o_plain = fa.flash_fwd_plain(*x[:3], causal, scale)[0]
    o_ref, lse_ref = fa.flash_fwd_plain(*f[:3], causal, scale)
    _hold_bf16_attention(o.cpu(), o_plain, o_ref)
    close(lse.cpu(), lse_ref, 1e-3)
    plain = fa.flash_bwd_plain(*x[:3], o.cpu(), lse.cpu(), x[3], causal,
                               scale)
    ref = fa.flash_bwd_plain(*f[:3], o.cpu().float(), lse.cpu(), f[3],
                             causal, scale)
    for a, b, r in zip(grads, plain, ref):
        _hold_bf16_attention(a.cpu(), b, r)


@pytest.mark.cuda
class TestCudaGeneral:
    """The general bf16 instances: the shapes the fast kernels are not
    built for (the decode at head_dim 20, 92, 100 and 132; every kernel
    at 20 and 100, and at 132 and 204 on the instances of head_dim up to
    256; N and K = 4 mod 8), each against its plain version; and
    the shapes they took before the fast kernels took them (GQA rep 7,
    pages of 12 tokens, as Qwen2-7B's heads or
    ServingConfig(block_size=12) give them; the decode, the chunk and
    attention at Phi-3's and Gemma's head_dims)."""

    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    @pytest.mark.parametrize("rep,D,bs", [(7, 128, 12), (7, 20, 16),
                                          (3, 100, 12), (4, 92, 64),
                                          (1, 128, 100), (2, 132, 12)])
    def test_paged_decode(self, cuda_device, scheme, rep, D, bs):
        # slot 0 idle on the poisoned block 0; page and table edges; every
        # D that is a multiple of 8 takes the Hopper kernel at any rep and
        # page size, the others (20, 92, 100, 132) the general instance
        positions = [0, bs - 1, bs, 3 * bs + 1, 8 * bs - 1]
        ops = _bf16_decode_operands(5, 2, rep, D, 8, positions, scheme,
                                    rep * D + bs, bs=bs)
        hopper = D % 8 == 0
        assert paged_attention.hopper_path(ops[0], ops[3], ops[4],
                                           rep) == hopper
        out = _hold_decode(ops, cuda_device, paged_attention.KERNEL if hopper
                           else paged_attention.GENERAL)
        assert float(out[1:].float().abs().max()) < 50.0   # no poison

    @pytest.mark.parametrize("D", [128, 100])
    def test_paged_decode_bf16_tables(self, cuda_device, D):
        # the model's bf16 RoPE rows are read as given, the same as their
        # f32 values (the Hopper kernel at rep 7 and pages of 12, the
        # general one at D 100)
        kernel = paged_attention.KERNEL if D == 128 \
            else paged_attention.GENERAL
        ops = list(_bf16_decode_operands(3, 4, 7, D, 6, [0, 40, 71],
                                         None, 11, bs=12))
        ops[1], ops[2] = ops[1].bfloat16(), ops[2].bfloat16()
        got = _hold_decode(ops, cuda_device, kernel)
        ops[1], ops[2] = ops[1].float(), ops[2].float()
        assert torch.equal(got, _hold_decode(ops, cuda_device, kernel))

    @pytest.mark.parametrize("scheme", [None, "int8", "fp8"])
    @pytest.mark.parametrize("T,rep,D,bs", [(40, 7, 128, 12), (257, 7, 20, 12),
                                            (70, 3, 80, 16), (1, 4, 96, 8),
                                            (40, 2, 128, 96),
                                            (40, 2, 256, 12),
                                            (129, 1, 256, 16),
                                            (40, 2, 132, 12),
                                            (70, 1, 204, 16)])
    def test_chunked_prefill(self, cuda_device, scheme, T, rep, D, bs):
        # head_dim 20 takes the general instance of head_dim up to 128
        # over every pool, 132 and 204 that of head_dim up to 256; 80, 96,
        # 128 and 256 the wgmma kernel's instances of 128 and 256 columns
        # over every pool and page size (pages of 12 or 96 by its copy
        # producer)
        ops = _bf16_chunk_operands(2, T, 2, rep, D, bs, [0, 37], scheme,
                                   T + rep + D + bs)
        scales = () if scheme is None else (ops[5], ops[6])
        wgmma = chunked_prefill.wgmma_width(ops[0], ops[1], ops[2],
                                            scales) is not None
        assert wgmma == (D % 8 == 0)
        if not wgmma:
            assert chunked_prefill.instance(ops[0], ops[1], ops[2], scales,
                                            scheme) == \
                f"maxd{128 if D <= 128 else 256}"
        got = _hold_chunk(ops, cuda_device, chunked_prefill.KERNEL if wgmma
                          else chunked_prefill.GENERAL)
        assert float(got.abs().max()) < 50.0      # no poison

    @pytest.mark.parametrize("D", [20, 80, 96, 100, 132, 204, 256])
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("B,H,KVH,Tq,Tk", [(2, 7, 1, 37, 37),
                                               (1, 4, 2, 100, 130)])
    def test_flash_attention(self, cuda_device, B, H, KVH, Tq, Tk, causal,
                             D):
        # every kernel on its general instance at 20 and 100 (head_dim up
        # to 128) and 132 and 204 (up to 256), on its wgmma instance at
        # 80, 96 (128 columns) and 256
        ops = _attn_inputs(B, H, KVH, Tq, Tk, D, torch.bfloat16, cuda_device,
                           seed=Tq + D)
        for kernel in (fa.FWD, fa.BWD_DQ, fa.BWD_DKV):
            assert fa.general_route(ops[0], ops[1], kernel) == (D % 8 != 0)
            assert fa.instance(ops[0], ops[1], kernel) == (
                f"w{128 if D <= 128 else 256}" if D % 8 == 0
                else f"maxd{128 if D <= 128 else 256}")
        _hold_general_attention(*ops, causal)

    def test_flash_attention_autograd_bthd(self, cuda_device):
        # the model's [B, T, H, D] views through autograd, D = 20
        ops = _attn_inputs(1, 7, 1, 50, 50, 20, torch.bfloat16, cuda_device)
        views = [x.transpose(1, 2).contiguous().transpose(1, 2)
                 for x in ops]
        launches.reset()
        got = _grads(*views, True)
        assert launches.snapshot() == {
            fa.FWD_LSE + fa.GENERAL: 1, fa.BWD_DQ + fa.GENERAL: 1,
            fa.BWD_DKV + fa.GENERAL: 1}
        want = _grads(*[x.cpu().float() for x in ops], True)
        plain = _grads(*[x.cpu() for x in ops], True)
        for a, b, r in zip(got, plain, want):
            _hold_bf16_attention(a.cpu(), b, r)

    @pytest.mark.parametrize("M", [1, 8, 9, 70, 256])
    @pytest.mark.parametrize("K", [140, 1028])
    def test_fused_norm_linear(self, cuda_device, M, K):
        # N and K = 4 mod 8: one launch of the general kernel for a
        # q/k/v-like group, each output its single call's bits and one
        # bf16 rounding of the plain version's largest output
        g = torch.Generator(device=cuda_device).manual_seed(M + K)
        x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
        nw = (1 + 0.1 * torch.randn(K, generator=g,
                                    device=cuda_device)).bfloat16()
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        ws = [(torch.randn(K, n, generator=g, device=cuda_device)
               / K ** 0.5).bfloat16() for n in (140, 20, 20)]
        acts = ["none", "silu", "none"]
        assert not any(fused_norm_linear.hopper_ok(x, nw, w) for w in ws)
        launches.reset()
        outs = fused_norm_linear.fused_norm_linear_group(x, rs, nw, ws, acts)
        assert launches.snapshot() == {fused_norm_linear.GENERAL: 1}
        for w, a, got in zip(ws, acts, outs):
            assert torch.equal(got, fused_norm_linear.fused_norm_linear(
                x, rs, nw, w, a))
            want = fused_norm_linear.fused_norm_linear_plain(x, rs, nw, w, a)
            assert float((got.float() - want.float()).abs().max()) <= \
                float(want.float().abs().max()) / 128

    @pytest.mark.parametrize("M", [4, 256])
    def test_fused_norm_linear_mixed_group(self, cuda_device, M):
        # an unaligned weight beside aligned ones: the Hopper launch for
        # the aligned two, the general one for the third, each output its
        # single call's bits
        g = torch.Generator(device=cuda_device).manual_seed(M)
        K = 512
        x = torch.randn(M, K, generator=g, device=cuda_device).bfloat16()
        nw = torch.randn(K, generator=g, device=cuda_device).bfloat16()
        rs = fused_norm_linear.rms_scale(x, 1e-5)
        flat = (torch.randn(K * 128 + 4, generator=g, device=cuda_device)
                / 32).bfloat16()
        ws = [(torch.randn(K, 256, generator=g, device=cuda_device)
               / 32).bfloat16(), flat[4:].view(K, 128),
              (torch.randn(K, 128, generator=g, device=cuda_device)
               / 32).bfloat16()]
        launches.reset()
        outs = fused_norm_linear.fused_norm_linear_group(x, rs, nw, ws,
                                                         ["none"] * 3)
        assert launches.snapshot() == {
            fused_norm_linear.kernel_name(M): 1, fused_norm_linear.GENERAL: 1}
        for w, got in zip(ws, outs):
            assert torch.equal(got, fused_norm_linear.fused_norm_linear(
                x, rs, nw, w))


NORM_SHAPES = [((8, 4096), torch.bfloat16), ((256, 4096), torch.bfloat16),
               ((8192, 4096), torch.bfloat16), ((37, 64), torch.float32),
               ((5, 8192), torch.bfloat16), ((3, 70000), torch.bfloat16),
               ((9, 4100), torch.bfloat16), ((6, 1000), torch.float32)]


@pytest.mark.cuda
class TestCudaNorms:
    """rms_norm and rms_scale (csrc/rms_norm.cu): a decode step's and a
    prefill chunk's rows, the training step's, the tiny configs' f32 d =
    64, rows wider than the registers hold, rows that are not 16 bytes'
    worth (d = 4100 bf16, 1000 f32 are; an offset view is not aligned).
    rms_scale within 4 f32 ulps of the plain version (another order of
    the f32 sum); rms_norm within one rounding of the largest output."""

    @staticmethod
    def _x(shape, dtype, dev, offset):
        g = torch.Generator(device=dev).manual_seed(shape[-1] + offset)
        n = math.prod(shape)
        flat = torch.randn(n + offset, generator=g, device=dev) * 3
        return flat.to(dtype)[offset:].view(shape)

    @pytest.mark.parametrize("offset", [0, 1])
    @pytest.mark.parametrize("shape,dtype", NORM_SHAPES)
    def test_rms_scale(self, cuda_device, shape, dtype, offset):
        x = self._x(shape, dtype, cuda_device, offset)
        launches.reset()
        got = rms_norm.rms_scale(x, 1e-5)
        assert launches.snapshot() == {"rms_scale": 1}
        assert got.shape == (*shape[:-1], 1) and got.dtype == torch.float32
        assert fused_norm_linear.rms_scale is rms_norm.rms_scale
        want = rms_norm.rms_scale_plain(x, 1e-5)
        np.testing.assert_array_max_ulp(got.cpu().numpy(),
                                        want.cpu().numpy(), maxulp=4)

    @pytest.mark.parametrize("offset", [0, 1])
    @pytest.mark.parametrize("shape,dtype", NORM_SHAPES)
    def test_rms_norm(self, cuda_device, shape, dtype, offset):
        x = self._x(shape, dtype, cuda_device, offset)
        w = (1 + 0.1 * torch.randn(shape[-1], device=cuda_device)).to(dtype)
        launches.reset()
        got = rms_norm.rms_norm(x, w, 1e-5)
        again = rms_norm.rms_norm(x, w, 1e-5)
        assert launches.snapshot() == {"rms_norm": 2}
        assert torch.equal(got, again)
        want = rms_norm.rms_norm_plain(x, w, 1e-5)
        tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        assert float((got.float() - want.float()).abs().max()) <= \
            float(want.float().abs().max()) * tol


COMBINE_FORMS = {"decode": (8, 8), "chunk": (256, 256),
                 "training": (512, 512), "dropping": (512, 64)}


@pytest.mark.cuda
class TestCudaCombineForms:
    @pytest.mark.parametrize("M", [4096, 100])
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("form", list(COMBINE_FORMS))
    def test_gates_as_given_the_plain_bits(self, cuda_device, form, dtype,
                                           M):
        # the model's routing at each form's capacity, random gates in the
        # tokens' dtype (as the model passes them) and in f32: one launch
        # each, the plain version's bits (two choices: one f32 product
        # each, one sum), and the tokens'-dtype gates give the bits of
        # their f32 cast
        T, C = COMBINE_FORMS[form]
        E = 8
        rng = np.random.RandomState(T + C + M)
        eidx = np.stack([rng.choice(E, 2, replace=False)
                         for _ in range(T)]).astype(np.int32)
        sidx = running_slots(eidx, E)
        gate = rng.rand(T, 2).astype(np.float32) + 0.25
        eo = t(rng.randn(E, C, M).astype(np.float32)).to(cuda_device, dtype)
        idx = [t(eidx).to(cuda_device), t(sidx).to(cuda_device)]
        g_dt = t(gate).to(cuda_device, dtype)
        launches.reset()
        got = moe_dispatch.moe_combine(eo, *idx, g_dt)
        got_f32 = moe_dispatch.moe_combine(eo, *idx, g_dt.float())
        assert launches.snapshot() == {"moe_combine": 2}
        assert torch.equal(got, got_f32)
        want = moe_dispatch.combine_plain(eo.cpu(), *[x.cpu() for x in idx],
                                          g_dt.cpu())
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
class TestCudaStepLaunches:
    @pytest.mark.parametrize("moe", [False, True])
    def test_tiny_decode_step(self, cuda_device, moe):
        # every decode step of a bf16 tiny model (D = 64, rep 2: the fast
        # kernels' shapes): per layer one rms_scale and one skinny
        # fused_norm_linear group in front of q/k/v (the MoE layer's
        # too), one KV write, one paged decode; a dense layer a second
        # rms_scale and group for gate/up, a MoE layer rms_norm, dispatch
        # and combine; and the final norm.  Nothing else is a kernel
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.serving import Engine, ServingConfig

        extra = dict(moe_num_experts=4, moe_top_k=2,
                     moe_capacity_factor=2.0) if moe else {}
        cfg = LlamaConfig.tiny(dtype="bfloat16", hidden_size=128,
                               num_attention_heads=2, num_key_value_heads=1,
                               **extra)
        model = LlamaForCausalLM(cfg, device=cuda_device, seed=0)
        eng = Engine(model, ServingConfig(max_batch_size=2, block_size=16,
                                          num_blocks=16, chunk_tokens=16))
        steps, decode = [], eng._decode_step

        def counted(*args, **kwargs):
            before = launches.snapshot()
            out = decode(*args, **kwargs)
            after = launches.snapshot()
            steps.append({k: n - before.get(k, 0) for k, n in after.items()
                          if n != before.get(k, 0)})
            return out

        eng._decode_step = counted
        rng = np.random.RandomState(0)
        eng.generate([rng.randint(1, 256, size=n) for n in (5, 19)],
                     max_new_tokens=4)
        L = cfg.num_hidden_layers
        want = {"rms_scale": L, "fused_norm_linear_skinny": L,
                kv_quant.KERNEL: L, "paged_decode": L, "rms_norm": 1}
        if moe:
            want.update({"rms_norm": L + 1, "moe_dispatch": L,
                         "moe_combine": L})
        else:
            want.update({"rms_scale": 2 * L,
                         "fused_norm_linear_skinny": 2 * L})
        assert len(steps) >= 3
        assert all(step == want for step in steps), (steps, want)


STEPS = ("decode_step", "prefill_step", "sampled_decode_step")


def _copied(a):
    """A copy of a step argument as the engine handed it: numpy and
    tensors copied, the pools (a list) kept as they are."""
    if isinstance(a, np.ndarray):
        return a.copy()
    if isinstance(a, torch.Tensor):
        return a.clone()
    return a


def _recorded_steps(cuda_device):
    """A tiny bf16 engine that served greedy and sampled requests, and
    the arguments of the last call of each of its three steps."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, ServingConfig

    cfg = LlamaConfig.tiny(dtype="bfloat16", hidden_size=128,
                           num_attention_heads=2, num_key_value_heads=1)
    model = LlamaForCausalLM(cfg, device=cuda_device, seed=0)
    eng = Engine(model, ServingConfig(max_batch_size=2, block_size=16,
                                      num_blocks=16, chunk_tokens=16))
    calls = {}
    for name in STEPS:
        def spy(*args, name=name, step=eng._steps[name]):
            calls[name] = tuple(_copied(a) for a in args)
            return step(*args)
        setattr(eng, f"_{name}", spy)
    rng = np.random.RandomState(0)
    eng.submit(rng.randint(1, 256, size=21), max_new_tokens=4)
    eng.submit(rng.randint(1, 256, size=5), max_new_tokens=4,
               temperature=0.8, top_k=20, seed=3)
    eng.run_until_complete()
    return eng, calls


def _on_device(args, dev):
    return [torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
            else a for a in args]


SLOT_STATE = ("_temps", "_top_ks", "_top_ps", "_keys", "_counters")


def _bound(eng, args):
    """A recorded step's arguments as the step binds them: the sampled
    step's per-slot sampling tensors are the engine's own (bound by
    address, as the pools are), so the recorded values go back into
    them; a decode or prefill step's arguments as they are."""
    if len(args) != 4 + len(SLOT_STATE):
        return args
    own = [getattr(eng, n) for n in SLOT_STATE]
    for t, a in zip(own, args[4:]):
        t.copy_(a)
    return (*args[:4], *own)


def _replay_against_eager(eng, name, args, dev):
    """(replay's output, eager output, replay's launches, eager's
    launches, pools equal after both) of step ``name`` on ``args``: the
    replay over the engine's pools, the eager function over a copy of
    them as they were."""
    step, args = eng._steps[name], _bound(eng, args)
    pools = args[1]
    before = [tuple(x.clone() for x in e) for e in pools]
    mark = launches.mark()
    got = step(*args).clone()
    graph_launches = launches.since(mark)
    copies = [tuple(x.clone() for x in e) for e in before]
    mark = launches.mark()
    want = step.eager(*_on_device(args[:1], dev), copies,
                      *_on_device(args[2:], dev))
    torch.cuda.synchronize()
    pools_equal = all(torch.equal(x, y) for e, c in zip(pools, copies)
                      for x, y in zip(e, c))
    return got, want, graph_launches, launches.since(mark), pools_equal


@pytest.mark.cuda
class TestCudaGraphSteps:
    """The engine's steps as CUDA graph replays against their eager
    functions (``GraphStep.eager``) on the inputs one real call had:
    the same bits out and in the pools, the same launches counted."""

    def test_replay_matches_eager_bits_and_launches(self, cuda_device):
        eng, calls = _recorded_steps(cuda_device)
        assert (eng.decode_cache_size(), eng.prefill_cache_size(),
                eng.sampled_decode_cache_size()) == (1, 1, 1)
        for name in STEPS:
            got, want, graph_launches, eager_launches, pools_equal = \
                _replay_against_eager(eng, name, calls[name], cuda_device)
            assert eager_launches == graph_launches, name
            assert graph_launches[0], name
            assert torch.equal(got, want), name
            assert pools_equal, name
        assert [eng._steps[n].compiles for n in STEPS] == [1, 1, 1]

    def test_an_outgrown_ticket_buffer_stays_with_its_graphs(
            self, cuda_device):
        """An engine of more slots than the capture stream's paged-decode
        tickets hold (one per sequence, kv head and sub-group), made
        while a smaller engine lives, grows that buffer.  The smaller
        engine's decode graph still counts its tickets in the buffer it
        was captured with: after the capture stream has allocated and
        filled tensors of that buffer's size, its replay equals its
        eager function."""
        from paddle_tpu_torch.jit import graphs
        from paddle_tpu_torch.kernels import paged_attention
        from paddle_tpu_torch.serving import Engine, ServingConfig

        eng, calls = _recorded_steps(cuda_device)
        device = torch.device("cuda", torch.cuda.current_device())
        stream = graphs._capture_streams[device]
        key = (device, stream.cuda_stream)
        n = paged_attention._ticket_buffers[key].numel()
        big = Engine(eng.model, ServingConfig(
            max_batch_size=n + 16, block_size=16, num_blocks=16,
            chunk_tokens=16))
        big.generate([np.arange(1, 6)], max_new_tokens=3)
        assert paged_attention._ticket_buffers[key].numel() > n
        with torch.cuda.stream(stream):
            junk = [torch.full((n,), 7, dtype=torch.int32,
                               device=cuda_device) for _ in range(8)]
        torch.cuda.synchronize()
        got, want, _, _, pools_equal = _replay_against_eager(
            eng, "decode_step", calls["decode_step"], cuda_device)
        assert torch.equal(got, want)
        assert pools_equal
        assert eng.decode_cache_size() == big.decode_cache_size() == 1
        del junk

    @pytest.mark.parametrize("strict", [True, False])
    def test_a_rebound_pool_is_a_retrace(self, cuda_device, strict):
        from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
        from paddle_tpu_torch.observability import RetraceError
        from paddle_tpu_torch.serving import Engine, ServingConfig

        model = LlamaForCausalLM(LlamaConfig.tiny(), device=cuda_device,
                                 seed=0)
        rng = np.random.RandomState(1)
        first = [rng.randint(1, 256, size=n) for n in (9, 4)]
        second = [rng.randint(1, 256, size=n) for n in (14, 6)]
        engines = [Engine(model, ServingConfig(
            max_batch_size=2, block_size=8, num_blocks=16, chunk_tokens=16,
            strict_no_retrace=s)) for s in (strict, True)]
        outs = [[e.generate(p, max_new_tokens=4) for e in engines]
                for p in (first,)]
        eng = engines[0]
        eng.pool.layers = [tuple(x.clone() for x in e)
                           for e in eng.pool.layers]
        if strict:
            with pytest.raises(RetraceError, match="serving::prefill_step"):
                eng.generate(second, max_new_tokens=4)
            return
        outs.append([e.generate(second, max_new_tokens=4) for e in engines])
        for got, want in outs:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
        assert (eng.decode_cache_size(), eng.prefill_cache_size()) == (2, 2)
        assert eng._decode_step.retraces == eng._prefill_step.retraces == 1


# the speculative steps, each with the position of its pools (its per-slot
# sampling state, where it binds it, follows three places later)
SPEC_STEPS = {"draft_prefill_step": 1, "draft_propose_step": 1,
              "spec_verify_step": 3}


def _recorded_spec_steps(cuda_device):
    """A tiny bf16 engine with a 1-layer draft proposing 3 tokens that
    served a greedy and a sampled request, and the arguments of the last
    call of each of its three speculative steps."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (Engine, ServingConfig,
                                          SpeculativeConfig)

    cfg = LlamaConfig.tiny(dtype="bfloat16", hidden_size=128,
                           num_attention_heads=2, num_key_value_heads=1)
    model = LlamaForCausalLM(cfg, device=cuda_device, seed=0)
    draft = LlamaForCausalLM(LlamaConfig.tiny(
        dtype="bfloat16", hidden_size=128, num_attention_heads=2,
        num_key_value_heads=1, num_hidden_layers=1), device=cuda_device,
        seed=1)
    eng = Engine(model, ServingConfig(
        max_batch_size=2, block_size=16, num_blocks=16, chunk_tokens=16,
        speculative=SpeculativeConfig(draft, num_draft_tokens=3)))
    calls = {}
    for name in SPEC_STEPS:
        def spy(*args, name=name, step=eng._steps[name]):
            calls[name] = tuple(_copied(a) for a in args)
            return step(*args)
        setattr(eng, f"_{name}", spy)
    rng = np.random.RandomState(0)
    eng.submit(rng.randint(1, 256, size=21), max_new_tokens=8)
    eng.submit(rng.randint(1, 256, size=5), max_new_tokens=8,
               temperature=0.8, top_k=20, seed=3)
    eng.run_until_complete()
    eng.pool.check_leaks()
    return eng, calls


@pytest.mark.cuda
class TestCudaSpecGraphSteps:
    """The draft's prefill chunk, the draft's proposals and the verify as
    CUDA graph replays against their eager functions on the inputs of
    their last real call: the same bits out and in the pools, the same
    launches counted."""

    def test_replay_matches_eager_bits_and_launches(self, cuda_device):
        eng, calls = _recorded_spec_steps(cuda_device)
        assert eng.spec_cache_sizes() == {
            "draft_prefill": 1, "draft_propose": 1, "spec_verify": 1}
        for name, at in SPEC_STEPS.items():
            step, args = eng._steps[name], list(calls[name])
            if name != "draft_prefill_step":
                # the bound sampling state: the engine's own tensors,
                # holding the recorded values
                own = [getattr(eng, n) for n in SLOT_STATE]
                for t, a in zip(own, args[at + 3:]):
                    t.copy_(a)
                args[at + 3:] = own
            pools = args[at]
            before = [tuple(x.clone() for x in e) for e in pools]
            mark = launches.mark()
            out = step(*args)
            got = [t.clone() for t in (out if isinstance(out, tuple)
                                       else (out,))]
            graph_launches = launches.since(mark)
            copies = [tuple(x.clone() for x in e) for e in before]
            eager_args = _on_device(args, cuda_device)
            eager_args[at] = copies
            mark = launches.mark()
            want = step.eager(*eager_args)
            want = want if isinstance(want, tuple) else (want,)
            torch.cuda.synchronize()
            assert launches.since(mark) == graph_launches, name
            assert graph_launches[0], name
            assert all(torch.equal(a, b) for a, b in zip(got, want)), name
            assert all(torch.equal(x, y) for e, c in zip(pools, copies)
                       for x, y in zip(e, c)), name
        assert [eng._steps[n].compiles for n in SPEC_STEPS] == [1, 1, 1]
