"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs an NVIDIA GPU and skips without one; the
file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the repository's conftest sets JAX up.)  Tolerances:
f32 1e-4 (same cast points, sums in another order); bf16 one rounding
of the largest output.  The Llama-3-8B shapes are held in
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import (chunked_prefill, fused_norm_linear,
                                      launches, paged_attention, rms_norm)
from torch_operands import chunk_operands, decode_operands

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
                     "chunked_prefill"):
            assert counts.get(name, 0) > 0, name
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
