#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; one card

Phases, each of which must pass (nothing is caught):
  1. build every kernel from paddle_tpu_torch/csrc (one nvcc per source,
     in parallel) and print the build time and each kernel's registers;
  2. kernels: each CUDA kernel of the serving path against its plain
     PyTorch version at Llama-3-8B shapes in bf16, with its stated
     tolerance, its time, the plain version's time, one library call's
     time (a yardstick the port never calls) and its bound on the card
     (the JSON line adds the bound's share of the time and the factor
     by which the kernel loses to the library call); rms_scale, the
     row scale of the fused_norm_linear groups, at 8 and 256 rows;
     the paged-decode and chunked-prefill kernels also on int8 and fp8
     KV pools; the KV write (row lookup, a decode step's k rotation,
     quantization) at a decode step's and a chunk's rows into f32, bf16,
     int8 and fp8 pools, bit-identical, timed into fp8 and bf16 pools;
     the fused_norm_linear groups (skinny and tiled) launched RING_STRESS
     times each, every output equal to the first run's bit for bit;
  3. training kernels: RMSNorm, RoPE (forward and backward) and
     FlashAttention (forward, forward with LSE, dQ, dK/dV) at the
     training path's shapes (T = 8192, hidden 4096, 32 q / 8 kv heads,
     head_dim 128, bf16, causal), with the same numbers; the attention
     kernels run twice (dQ ATTN_STRESS more times), the bits compared;
  4. tiny: LlamaConfig.tiny() in f32, the same seeded weights served on
     cuda (kernels) and on cpu (plain versions), from f32, int8 and fp8
     KV pools and from fp8 pools with int8 weights: greedy tokens must be
     identical over 6 requests with a shared prefix and forced
     preemption (a differing token is excused only when the CPU logits'
     top-2 margin there is below the f32 tolerance);
  5. tiny training: the same f32 weights trained 5 AdamW steps on cuda
     and on cpu: losses within the f32 tolerance, exact launch counts;
  6. main serving: Llama-3-8B width in bf16 (random weights from a seed)
     behind serving.Engine: 8 requests, prompts of 128..1024 tokens, two
     of them sharing a 512-token prefix, 32 new tokens each; then the
     same from fp8 KV pools, from int8 KV pools and from fp8 pools with
     int8 weights, each pool the bf16 pool's bytes, with the greedy
     token's log-probability drift against the bf16 pool;
  6s. main sampled serving: phase 6's model, requests, submit order and
     pool, served twice on fresh engines, with requests 0, 2, 4 and 6
     sampled (temperature 0.8, top-k 50, top-p 0.95, seed 1000 + i) and
     request 5 streamed through serving.sse_stream: the greedy
     requests' tokens equal phase 6's bit for bit, every request has
     its 32 tokens, the SSE frames decode to request 5's tokens, its
     summary and [DONE], both runs give the same sampled tokens, and
     phase 6's launch counts hold; one sampled decode step is profiled,
     and the sampler alone beside it;
  6g. CUDA graphs: phase 6's model behind an engine that serves 4 of
     its requests (2 sampled), then one greedy; each of the three
     captured steps (decode, prefill chunk, sampled decode) replayed on
     the inputs of its last real call and run eagerly on a copy of the
     pools: outputs and pools equal bit for bit, the same launches
     counted; a second engine captures and counts its own graphs and
     gives the same tokens; a rebound pool raises RetraceError under
     strict_no_retrace and is one counted retrace a step without it,
     the tokens after it those of an engine whose pool stayed put;
  6o. overload control: phase 6's model behind fresh engines whose
     graphs were captured at start-up, with the metrics registry on:
     (a) the degradation ladder (watermarks 0.5 / 0.3) under a seeded
     burst of 12 prompts of 256-640 tokens into a pool of 0.8 of their
     blocks climbs one level a tick to pause_admissions or above,
     preempts, unwinds to 0 when idle, and every request has the tokens
     of an engine at the default watermarks; (b) a decode attempt
     stalled 0.6 s against a 0.25 s floor: one stall, one retry,
     DEGRADED then SERVING, phase 6's tokens, the retried replay's
     launches counted twice; (c) a failed prefill attempt absorbed, two
     quarantining the engine (EngineQuarantined; submit and step refused
     until revive(), then the stranded request finishes), a poisoned
     request "error" beside unaffected ones; (d) requests of 1024
     tokens with a 5 ms deadline shed at submit beside phase 6's request
     4 with a 10 s deadline, and the watchdog's chunk and decode EWMAs
     at least phase 6's profiled kernel times (it times the device);
     (e) a full queue: a higher-priority arrival sheds the youngest
     lower-priority request and is admitted first; (f) the registry's
     Prometheus lines of the overload and compile metrics;
  6sp. speculative decoding: phase 6's model, requests and pages behind
     engines with SpeculativeConfig(draft, 4), a pool sized for both
     models' layers and the K+1 horizon: (a) a Llama-3.2-3B-width draft
     (llama32_3b_config, random weights, seed 1), greedy: tokens held to
     phase 6's by the top-2 margin at a first difference (at most
     SPEC_MARGIN_ULPS bf16 ulps), one graph each of the draft's prefill,
     the propose and the verify, a second batch adding none and no
     retrace, exact launch counts, no leak; the accept rate, tokens/s,
     TTFT, TPOT and iterations beside phase 6's, each graph profiled
     three times and the sampler's share of the propose and the verify;
     (b) the target as its own draft: tokens by the margin rule, and
     every proposal the target rejects within SPEC_MARGIN_ULPS bf16 ulps
     of the token it takes in a fresh prefill's logits; (c) requests 0,
     2, 4 and 6 sampled as in 6s with the 3B draft, served twice: the
     same tokens, the greedy ones (a)'s; (d) LlamaConfig.tiny in f32
     with a 1-layer draft (seed 123) on cuda and on cpu, greedy and
     sampled: the same tokens and counters; (e) the kernels at the
     path's new shapes against their plain versions, timed as phase 2
     times them: fused_norm_linear over Llama-3.2-3B's projections at
     8 rows and Llama-3-8B's at the verify's 40, the paged decode at 24
     q over 8 kv heads, the chunk and the KV write over 8 sequences of 5
     tokens at staggered frontiers;
  7. main training: Llama-3-8B width, 8 of its 32 layers, bf16, one
     [1, 8192] batch, AdamW(1e-4): 2 warm-up and 5 timed steps, one
     profiled step and one eval forward without grad; finite, falling
     losses and exact launch counts per step.
Mixture of experts (Mixtral-8x7B's shape, mixtral_config):
  2m. MoE kernels: dispatch and combine against their plain versions at
     hidden 4096, 8 experts, top-2, bf16, at a decode step's, a prefill
     chunk's and a training batch's shapes, a dropping capacity and the
     duplicate-slot form a backward pass feeds dispatch; dispatch (one
     launch a call) DISPATCH_STRESS more times at the decode shape, the
     bits compared, and the choices its index stage re-reads at the
     training shape;
  4m. tiny MoE: LlamaConfig.tiny with 4 experts, top-2, capacity factor
     2.0 (dropless), served on cuda and cpu from f32 and fp8 pools as in
     phase 4, and trained 5 AdamW steps on both as in phase 5;
  6m. main MoE serving: Mixtral width, 16 of its 32 layers, bf16, behind
     serving.Engine with phase 6's 8 requests, dropless routing (capacity
     factor 4.0 = E / K, as Mixtral routes);
  7m. main MoE training: Mixtral width, 2 layers, one [1, 4096] batch,
     as phase 7.
The shapes the fast kernels once refused (fault C1 of ROADMAP.md):
  2c. C1 kernels: the Hopper paged decode (bf16, int8 and fp8 pools) and
     the wgmma chunked prefill (its copy producer) at Qwen2-7B's heads
     (28 q over 4 kv heads, rep 7, head_dim 128) over pages of 12
     tokens; pages of 12 and of 16 holding the same keys give the same
     bits through both, and the copy producer RING_STRESS more times
     the first run's bits; the Hopper paged decode on its padded
     instances at Phi-2's head_dim 80 (32 heads), Phi-3-mini's 96 (32
     heads, pages of 16 and of 12) and Gemma-7B's 256 (16 heads) over
     bf16, int8 and fp8 pools, and the general paged decode at head_dim
     100 and 132; the wgmma chunked prefill at Phi-3-mini's and
     Gemma-7B's head_dims over bf16, int8 and fp8 pools, the copy
     producer at 96 over pages of 12 RING_STRESS more times, the bits
     compared, and the general chunk at head_dim 100 and 132 (its
     instances of head_dim up to 128 and 256);
     FlashAttention at head_dim 80, 96 and 256 (all four kernels on their
     wgmma instances of 128 and 256 columns, dK/dV ATTN_STRESS more
     times) and at 100 and 132 (all four on the general instances of
     head_dim up to 128 and 256), T = 2048,
     causal, each run twice for the same bits; the
     general fused_norm_linear q/k/v group at N and K = 4 mod 8 (8 and
     256 rows); each against its plain version, one launch under its own
     counter, SDPA beside the attention rows;
  4c. tiny C1: LlamaConfig.tiny in bf16 with hidden 140, 7 q heads over
     1 kv head (head_dim 20), intermediate 92, with hidden 512, 2 q
     heads over 1 kv head (head_dim 256), and with hidden 264, 2 q heads
     over 1 kv head (head_dim 132), pages of 12 (the head_dim-256 model
     also from bf16, int8 and fp8 pools of 8-token pages): each served
     on cuda and cpu (tokens as in phase 4, the margin BF16_MARGIN), one
     training step on both held against the same step in f32, an eval
     forward; every general instance must launch (the head_dim-20
     model's, and those of head_dim up to 256, the head_dim-132
     model's), and the 256-column wgmma attention kernels and chunked
     prefill, by each producer, and the padded 256-column paged decode
     over every pool (the head_dim-256 model's);
  6c. main C1 serving: Qwen2-7B's widths (qwen2_7b_config), 4 of its 28
     layers, bf16, pages of 12, phase 6's 8 requests: the Hopper paged
     decode and the wgmma chunked prefill in every step, no general
     instance;
  6p. main Phi-3-mini serving: Phi-3-mini's widths (phi3_mini_config: 32
     heads of 96), all 32 layers, bf16, pages of 16, phase 6's 8
     requests, from a bf16 pool, then from int8 and fp8 pools of its
     bytes with the greedy log-prob drift: every decode step launches
     the paged decode on its padded 128-column instance once a layer,
     every chunk the 128-column wgmma chunk, exact counts, no general
     instance;
  7c. main training at another head_dim: Phi-3-mini's widths
     (phi3_mini_config: 32 heads of 96, hidden 3072), 8 of its 32
     layers, one [1, 4096] batch, as phase 7: a step launches the
     forward with LSE, dQ and dK/dV on their 128-column wgmma instances,
     exactly once a layer, the eval forward the wgmma forward, and no
     general instance of any kernel.
Static graph (BERT-base, Google's published bert_config.json):
  2s. static kernels: fused_linear against its plain version at
     BERT-base's shapes (M = 32 x 512 tokens, hidden 768, FFN 3072),
     bf16: the FFN's gelu with bias, the MLM transform (then
     RING_STRESS more launches, the bits compared), each other
     activation, no bias, a ragged M and N (N odd, and N % 8 == 0), a
     ragged K (771), and f32,
     each line naming the instance the route (fused_linear.tma_ok)
     took: the wgmma one (TMA) or the predicated one; its backward's
     dx, dw and db against autograd through the plain version;
  4s. tiny static: BertConfig.tiny() in f32, dropout 0, recorded as a
     static Program, AdamW.minimize, then the build strategy (which
     fuses linear -> gelu into fused_linear), run from the same seeded
     weights on cuda and on cpu for 5 steps: losses within the f32
     tolerance, exactly 3 fused_linear launches a step on cuda; then
     static.nn.fc(x [None, 3], 5, "relu") fused to one fused_linear of
     K = 3, cuda against cpu;
  7s. main static training: BERT-base at full width and depth, bf16,
     dropout 0.1 from an explicit generator, one [32, 512] batch (15 %
     of the positions MLM labels, padded sequences masked), AdamW(1e-4,
     weight decay 0.01 but not on biases and norms), recorded, minimized
     and fused as in 4s: 2 warm-up, 5 timed and one profiled step; 13
     fused_linear ops in the Program and 13 launches a step; it runs
     last.
The sampler (serving/sampling.py: torch ops, no kernel of its own):
  2d. sample_at over random f32 logits [8, 128256] with greedy lanes and
     lanes of temperature, top-k and top-p each on and off, at 64 token
     counters of seeded keys: the tokens on the card equal the CPU's,
     one for one (on a mismatch the perturbed top-2 margin is printed).
The launch counts of phases 4c, 6, 6s, 6o, 6sp, 6c, 6p, 7, 7c, 6m, 7m and 7s,
reset just before each run and read just after it, show that each path went
through every kernel of its own (and the Llama-3-8B, Mixtral, Qwen2-7B,
Phi-3-mini and BERT phases through no general instance); a kernel of
the JSON line that its path launched no time fails the run.  Kernels
with several compiled instances (the paged decode, the chunked prefill
and the attention: widths, producers) are counted by instance too, and
such a row reports the launches of its own instance (its "instance"
key).  Each serving run (4, 4m, 4c, 6 and its quantized runs, 6s, 6sp,
6c, 6p, 6m) serves through CUDA graphs of its steps (the main runs capture
them before their timed run, as a server does at start-up, on inputs
that address only the garbage block); it asserts one graph of the
decode step, one of the prefill step and one (6s) or none of the
sampled decode step after its run, and prints each graph's capture
seconds.  Each main run also prints its decode step's and prefill
chunk's host-clock time, the time between CUDA events around one
replay, and the kernel time and count of three profiles
(torch.profiler).

Prints the card's name and power limit, then one JSON line of the
kernels' numbers, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Exits non-zero, printing no result, without a CUDA device.
"""
from __future__ import annotations

import contextlib
import gc
import hashlib
import itertools
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak, same source
F32_FLOPS = 67e12              # f32 outside the tensor cores, same source
F32_TOL = 1e-4                 # f32 logit / loss tolerance of the tiny phases
MAIN_LAYERS = 32               # depth of the main serving phase (full: 32)
TRAIN_LAYERS = 8               # depth of the main training phase (of 32)
TRAIN_T = 8192                 # its sequence: Llama-3's pretraining context
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
MOE_LAYERS = 16                # depth of the main MoE serving phase (of 32)
MOE_TRAIN_LAYERS = 2           # depth of the main MoE training phase
C1_LAYERS = 4                  # depth of the Qwen2-7B-width phase (of 28)
PHI3_LAYERS = 8                # depth of the Phi-3-mini-width training
PHI3_T = 4096                  # phase (of 32) and its sequence: Phi-3-mini-
                               # 4k's context
MOE_TRAIN_T = 4096             # its sequence: the dropless [E, C, M]
                               # buffers grow with T (C = T at factor 4)
MOE_HID = 4096                 # the MoE kernel phase: Mixtral's hidden,
MOE_KERNEL_CASES = (           # and (tag, T, C, skew, main phase) cases
    ("decode", 8, 8, 0.0, "moe_serve"), ("chunk", 256, 256, 0.0, "moe_serve"),
    ("train", 4096, 4096, 0.0, "moe_train"),
    ("drop", 4096, 1024, 1.5, "moe_train"))
BERT_B, BERT_T = 32, 512       # the static phase's batch: BERT's sequence
BERT_LAYERS = 12               # its depth (full: 12)
BERT_WARMUP, BERT_STEPS = 2, 5
RING_STRESS = 2000             # launches of each fused_norm_linear group
                               # and of fused_linear at the MLM shape
DISPATCH_STRESS = 2000         # more launches of the MoE dispatch's decode
                               # form, compared bit for bit
ATTN_STRESS = 20               # runs of the attention backward's dQ
                               # compared bit for bit (its TMA rings' reuse)
SLEEP_CYCLES = 50_000_000      # ~30 ms at the H100's clock: time to enqueue
COLD_BYTES = 100e6             # twice the H100's 50 MB L2: what the other
                               # copies of an L2-cold timing move between
                               # two uses of one


def mixtral_config(**overrides):
    """Mixtral-8x7B's shape from Mistral AI's published config.json
    (mistralai/Mixtral-8x7B-v0.1): vocab 32000, hidden 4096, expert FFN
    14336, 32 layers, 32 q / 8 kv heads (head_dim 128), rope_theta 1e6,
    rms_norm_eps 1e-5, max_position 32768, 8 experts, top-2, no shared
    expert.  Mixtral drops no token: capacity factor E / K = 4.0 makes
    C = T, and each token names two different experts, so no expert
    receives more than C choices."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaConfig

    return dataclasses.replace(LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1e6,
        moe_num_experts=8, moe_top_k=2, moe_capacity_factor=4.0),
        **overrides)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters=20, warmup=3) -> float:
    """Device time of one ``fn()``: CUDA events around ``iters`` calls.
    A sleep kernel holds the stream while the host enqueues them, so the
    launches run back to back and the host's Python time between them
    (which would otherwise be what is measured for small kernels) stays
    out of the number."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_ms_rotating(fns, iters=40) -> float:
    """``time_ms`` of calls that take turns: ``fns[i % len(fns)]``, each
    on its own copy of the operands, so that a call finds its operands
    evicted from the L2 by the others' (``cold_copies``)."""
    for fn in fns:
        fn()
    calls = itertools.cycle(fns)
    return time_ms(lambda: next(calls)(), iters=iters, warmup=0)


def cold_copies(nbytes: float) -> int:
    """Copies of a call's operands (``nbytes``) to rotate over so that
    the others' bytes between two uses of one copy are at least
    COLD_BYTES."""
    return 1 + math.ceil(COLD_BYTES / nbytes)


def bound_ms(nbytes: float, flops: float, peak: float = BF16_FLOPS):
    """The least time for the work: its bytes over the memory rate or its
    operations over ``peak`` (the rate of the type they run in),
    whichever is longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_tol(ref: torch.Tensor) -> float:
    """Two bf16 ulps of the largest output: the kernels keep the plain
    version's cast points and differ only in the order of f32 sums,
    which can move a rounded output by an ulp."""
    return float(ref.float().abs().max()) / 64.0


def check_close(name, got, ref, tol):
    err = float((got.float() - ref.float()).abs().max())
    ok = math.isfinite(err) and err <= tol
    print(f"  {name}: max_abs_err {err:.3e} (tolerance {tol:.3e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol})")
    return err


# ---------------------------------------------------------------- phase 1
def phase_build():
    from paddle_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    took = _build.build_all()
    print(f"[build] {len(took)} of {len(_build.sources())} kernel sources "
          f"compiled in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    for name in _build.sources():
        log = _build._lib_path(name).with_suffix(".log").read_text()
        regs = [ln.split("Used ")[1].split(",")[0]
                for ln in log.splitlines() if "Used " in ln]
        spills = sum("0 bytes spill stores" not in ln
                     for ln in log.splitlines() if "spill stores" in ln)
        print(f"  {name}.cu: {len(regs)} kernels, {', '.join(regs)}; "
              f"{spills} with spills")
        if name in REDESIGNED:
            for kernel, used, spill in ptxas_kernels(log):
                if any(k in kernel for k in REDESIGNED[name]):
                    print(f"    {kernel}: {used}; {spill}")
                known = [v for k, v in KNOWN_SPILLS.items() if k in kernel]
                if any(k in kernel for k in NO_SPILL) and \
                        "0 bytes spill stores, 0 bytes spill loads" not in \
                        spill and spill not in known:
                    raise AssertionError(f"{kernel} spills: {spill}")


# the kernels whose -Xptxas -v lines phase 1 prints one by one
REDESIGNED = {"paged_attention": ("hopper",),
              "rms_norm": ("rms_rows",),
              "fused_norm_linear": ("skinny_mma", "wgmma"),
              "chunked_prefill": ("wgmma",),
              "flash_attention": ("wgmma",),
              "fused_linear": ("wgmma",),
              "moe_dispatch": ("dispatch_kernel", "combine_kernel"),
              "kv_quant": ("kv_write",)}


# kernels whose registers must hold their work: a spill fails phase 1
NO_SPILL = ("fa_fwd_wgmma", "fa_bwd_dq_wgmma", "fa_bwd_dkv_wgmma",
            "chunked_prefill_wgmma", "paged_decode_hopper")
# but for these, no larger than it was: the paged decode's instances of
# 128 columns and 4 heads over pages found by division (Q = 0, 1, 2; not
# POW2, FULL or PAD), whose instructions predate the padded instances
KNOWN_SPILLS = {
    f"paged_decode_hopperILi{q}ELi128ELi4ELb0ELb0ELb0E":
        "16 bytes stack frame, 16 bytes spill stores, 32 bytes spill loads"
    for q in range(3)}


def ptxas_kernels(log):
    """[(mangled name, "Used ... registers", "... spill stores ...")] of
    an nvcc -Xptxas -v log, one per compiled kernel."""
    out, name, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = ln.split("'")[1]
        elif "spill stores" in ln:
            spill = ln.split("ptxas info    :")[-1].strip()
        elif "Used " in ln and name:
            out.append((name, ln.split("Used ")[1].split(",")[0] + " used",
                        spill))
            name = None
    return out


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev):
    """Each kernel against its plain version at the main path's 8B
    shapes, bf16; the attention kernels also on int8 and fp8 KV pools.
    Returns {entry name: numbers} for the JSON line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (chunked_prefill, kv_quant,
                                          paged_attention, rms_norm, rope)

    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    H, KVH, D, HID, FFN, eps = 32, 8, 128, 4096, 14336, 1e-5
    entries = {}
    print("[kernels] Llama-3-8B shapes, bf16", flush=True)

    # rms_norm: the final norm over a decode bucket [8, 4096]
    x = randn(8, HID) * 3
    w = (1 + 0.1 * randn(HID, dtype=torch.float32)).to(bf)
    got, ref = rms_norm.rms_norm(x, w, eps), rms_norm.rms_norm_plain(x, w, eps)
    err = check_close("rms_norm [8, 4096]", got, ref, bf16_tol(ref))
    nbytes = 2 * x.numel() * 2 + w.numel() * 2
    entries["rms_norm"] = dict(
        replaces="paddle_tpu/kernels/rms_norm.py:33",
        source="paddle_tpu_torch/csrc/rms_norm.cu", max_abs_err=err,
        ms=time_ms(lambda: rms_norm.rms_norm(x, w, eps)),
        plain_ms=time_ms(lambda: rms_norm.rms_norm_plain(x, w, eps)),
        library_ms=time_ms(lambda: F.rms_norm(x, (HID,), w, eps)),
        bound=bound_ms(nbytes, 4.0 * x.numel(), F32_FLOPS),
        work="one [8, 4096] row block")

    # rms_scale: the f32 row scale in front of every fused_norm_linear
    # group, at a decode step's 8 rows and a prefill chunk's 256; the
    # library yardstick is F.rms_norm (the same reduction, writing the
    # normalized rows)
    for M, tag in ((8, ""), (256, "_chunk")):
        x = randn(M, HID) * 3
        got, ref = rms_norm.rms_scale(x, eps), rms_norm.rms_scale_plain(x, eps)
        err = check_close(f"rms_scale [{M}, {HID}]", got, ref,
                          float(ref.abs().max()) * 2.0 ** -21)
        entries["rms_scale" + tag] = dict(
            counter=rms_norm.SCALE,
            replaces="paddle_tpu/kernels/fused_norm_linear.py:45",
            source="paddle_tpu_torch/csrc/rms_norm.cu", max_abs_err=err,
            ms=time_ms(lambda: rms_norm.rms_scale(x, eps)),
            plain_ms=time_ms(lambda: rms_norm.rms_scale_plain(x, eps)),
            library_ms=time_ms(lambda: F.rms_norm(x, (HID,), w, eps)),
            bound=bound_ms(2 * x.numel() + 4 * M, 2.0 * x.numel(),
                           F32_FLOPS),
            work=f"the row scale of [{M}, {HID}] (XLA glue in the "
                 "reference)")

    # fused_norm_linear: the 5 projections of one layer (q, k, v, gate
    # with silu, up), skinny at decode M = 8 and tiled at prefill M = 256,
    # one launch for q/k/v and one for gate/up, as the model calls them
    # (fused_norm_linear_group); each run twice and compared bit for
    # bit, then RING_STRESS times
    for M, name in ((8, "fused_norm_linear_skinny"),
                    (256, "fused_norm_linear_tiled")):
        entries[name] = fnl_entry(g, name, M, HID, H, KVH, D, FFN,
                                  stress=RING_STRESS)

    # paged decode: B=8 at frontiers spread over 128..1055, bs=16,
    # table width 512 (max_model_len 8192), 4 splits
    B, bs, nbs = 8, 16, 512
    positions = torch.tensor([130, 260, 390, 520, 650, 780, 910, 1055],
                             dtype=torch.int32, device=dev)
    per_seq = [(int(p) + bs) // bs for p in positions]
    nb = 1 + sum(per_seq)
    perm = (1 + torch.randperm(nb - 1, generator=g, device=dev)).int()
    bt = torch.zeros((B, nbs), dtype=torch.int32, device=dev)
    off = 0
    for b, n in enumerate(per_seq):
        bt[b, :n] = perm[off:off + n]
        off += n
    k_pool, v_pool = randn(nb, bs, KVH, D), randn(nb, bs, KVH, D)
    cos, sin = _rope_tables(D, 8192, 500000.0, dev)
    pos_l = positions.long()
    c, s = cos[pos_l].to(bf), sin[pos_l].to(bf)
    q = randn(B, H, D)
    splits = paged_attention._default_splits(nbs)
    dkeys = float((positions + 1).sum())
    Lmax = int(positions.max()) + 1
    q_rot = rope.rotate_half(
        q.float(), c[:, None, :].float(),
        s[:, None, :].float()).to(bf)[:, :, None, :]
    mask = (torch.arange(Lmax, device=dev)[None, :]
            <= positions[:, None])[:, None, None, :]
    # chunked prefill: one 256-token chunk starting at 768 (the last
    # chunk of a 1024-token prompt)
    T, start = 256, 768
    ctx = start + T
    n = ctx // bs
    bt1 = torch.zeros((1, nbs), dtype=torch.int32, device=dev)
    bt1[0, :n] = 1 + torch.randperm(nb - 1, generator=g, device=dev)[:n].int()
    pos1 = torch.tensor([start], dtype=torch.int32, device=dev)
    qc = randn(1, T, H, D)
    ckeys = float(sum(start + t + 1 for t in range(T)))
    cmask = (torch.arange(ctx, device=dev)[None, :]
             <= start + torch.arange(T, device=dev)[:, None])[None, None]
    qt = qc.transpose(1, 2).contiguous()

    # both on bf16 pools (rows 3, 4) and on the same K/V quantized per
    # row to int8 and to fp8 codes (rows 3q, 4q); the library yardstick
    # is SDPA on K/V already gathered (and dequantized)
    for scheme in (None, "int8", "fp8"):
        if scheme is None:
            kp, vp, ks, vs, kd, vd = k_pool, v_pool, None, None, k_pool, \
                v_pool
        else:
            (kp, ks), (vp, vs) = (kv_quant.quantize_kv(p, scheme)
                                  for p in (k_pool, v_pool))
            kd, vd = (kv_quant.dequantize_kv(x, sc, scheme).to(bf)
                      for x, sc in ((kp, ks), (vp, vs)))
        # bytes of one token's K (or V) row: bf16, or 1 byte an element
        # and the row's f32 scale
        row = 2 * KVH * D if scheme is None else KVH * D + 4
        extra = "" if scheme is None else f", {scheme} pools"
        path = "serve" if scheme is None else "quant"

        args = (q, c, s, kp, vp, bt, positions, splits, ks, vs, scheme)
        name = kv_quant.counter_name(paged_attention.KERNEL, scheme)
        got = paged_attention.paged_decode_attention(*args)
        again = paged_attention.paged_decode_attention(*args)
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two runs differ")
        ref = paged_attention.paged_decode_attention_plain(*args)
        err = check_close(f"{name} B={B} nbs={nbs} (two runs bit-identical)",
                          got, ref, bf16_tol(ref))
        kg, vg = _gathered(kd, bt, Lmax), _gathered(vd, bt, Lmax)

        def sdpa(kg, vg):
            return F.scaled_dot_product_attention(q_rot, kg, vg,
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        # L2-cold: each layer of a serving step reads its own pools, so
        # the kernel and SDPA are also timed over rotating copies of
        # their operands (pools, tables and scales) that together exceed
        # the L2 twice over
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in (kp, vp, bt) + tuple(args[8:10])
                         if t is not None)
        cold = [(*args[:3], *(None if t is None else t.clone()
                              for t in (kp, vp, bt)), positions, splits,
                 *(None if t is None else t.clone() for t in (ks, vs)),
                 scheme) for _ in range(cold_copies(pool_bytes))]
        gathered = [(kg.clone(), vg.clone()) for _ in
                    range(cold_copies(2 * kg.numel() * kg.element_size()))]
        entries[name] = dict(
            path=path, instance=paged_attention.instance(q, True),
            replaces="paddle_tpu/kernels/paged_attention.py:102",
            source="paddle_tpu_torch/csrc/paged_attention.cu",
            max_abs_err=err,
            ms=time_ms_rotating([
                lambda a=a: paged_attention.paged_decode_attention(*a)
                for a in cold]),
            hot_ms=time_ms(
                lambda: paged_attention.paged_decode_attention(*args)),
            plain_ms=time_ms(
                lambda: paged_attention.paged_decode_attention_plain(*args),
                iters=5),
            library_ms=time_ms_rotating([lambda kv=kv: sdpa(*kv)
                                         for kv in gathered]),
            library_hot_ms=time_ms(lambda: sdpa(kg, vg)),
            bound=bound_ms(2 * dkeys * row + 2 * 2 * B * H * D
                           + 4 * B * (nbs + 1 + D), 4.0 * dkeys * H * D),
            work=f"one layer's decode step, B={B}, {int(dkeys)} context "
                 f"keys{extra}, L2-cold over {len(cold)} copies (library "
                 f"over {len(gathered)})")
        del cold, gathered

        cargs = (qc, kp, vp, bt1, pos1, ks, vs, scheme)
        name = kv_quant.counter_name(chunked_prefill.KERNEL, scheme)
        got = chunked_prefill.chunked_attention(*cargs)
        again = chunked_prefill.chunked_attention(*cargs)
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two runs differ")
        ref = chunked_prefill.chunked_attention_plain(*cargs)
        err = check_close(f"{name} T={T} start={start} (two runs "
                          "bit-identical)", got, ref, bf16_tol(ref))
        kg, vg = _gathered(kd, bt1, ctx), _gathered(vd, bt1, ctx)

        def chunk_sdpa(q, kg, vg):
            return F.scaled_dot_product_attention(q, kg, vg, attn_mask=cmask,
                                                  enable_gqa=True)

        # L2-cold, as the decode: each of a served chunk's 32 layers reads
        # its own pools, so the kernel (q, pools, table, scales) and SDPA
        # (q, gathered K/V) are timed over rotating copies of their
        # operands too
        chunk_bytes = sum(t.numel() * t.element_size()
                          for t in (qc, kp, vp, bt1, ks, vs)
                          if t is not None)
        cold = [tuple(x.clone() if isinstance(x, torch.Tensor) and
                      x is not pos1 else x for x in cargs)
                for _ in range(cold_copies(chunk_bytes))]
        gathered = [(qt.clone(), kg.clone(), vg.clone()) for _ in range(
            cold_copies(2 * (qt.numel() + 2 * kg.numel())))]
        entries[name] = dict(
            path=path, instance=chunked_prefill.instance(
                qc, kp, vp, () if ks is None else (ks, vs), scheme),
            replaces="paddle_tpu/kernels/chunked_prefill.py:51",
            source="paddle_tpu_torch/csrc/chunked_prefill.cu",
            max_abs_err=err,
            ms=time_ms_rotating([
                lambda a=a: chunked_prefill.chunked_attention(*a)
                for a in cold]),
            hot_ms=time_ms(lambda: chunked_prefill.chunked_attention(*cargs)),
            plain_ms=time_ms(
                lambda: chunked_prefill.chunked_attention_plain(*cargs),
                iters=5),
            library_ms=time_ms_rotating([lambda a=a: chunk_sdpa(*a)
                                         for a in gathered]),
            library_hot_ms=time_ms(lambda: chunk_sdpa(qt, kg, vg)),
            bound=bound_ms(2 * ctx * row + 2 * 2 * T * H * D
                           + 4 * (nbs + 1), 4.0 * ckeys * H * D),
            work=f"one layer's prefill chunk, T={T}, context {ctx}{extra}, "
                 f"L2-cold over {len(cold)} copies (library over "
                 f"{len(gathered)})")
        del kg, vg, cold, gathered
    entries.update(write_entries(g, nb, bt, positions, c, s, bt1, pos1, T))
    print_entries(entries)
    return entries


def fnl_entry(g, name, M, HID, H, KVH, D, FFN, stress=0, eps=1e-5,
              **extra):
    """fused_norm_linear over the 5 projections of one layer of these
    widths (q, k, v, gate with silu, up), one launch for q/k/v and one
    for gate/up as the model calls them (``fused_norm_linear_group``) at
    M rows: every launch under the counter ``name``, two runs bit for
    bit, then ``stress`` more launches of each group, every bit
    compared; each output against its plain version within two bf16
    ulps; timed beside the plain version and torch.matmul x5.  Returns
    its entry (``extra`` adds to it)."""
    from paddle_tpu_torch.kernels import fused_norm_linear as fnl
    from paddle_tpu_torch.kernels import launches

    bf, dev = torch.bfloat16, g.device

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    projs = [(H * D, "none"), (KVH * D, "none"), (KVH * D, "none"),
             (FFN, "silu"), (FFN, "none")]
    groups = ((0, 1, 2), (3, 4))
    ws = [randn(HID, n, std=HID ** -0.5) for n, _ in projs]
    nw = (1 + 0.1 * randn(HID, dtype=torch.float32)).to(bf)
    x = randn(M, HID) * 3
    rs = fnl.rms_scale(x, eps)

    def run_kernel():
        return [o for grp in groups for o in fnl.fused_norm_linear_group(
            x, rs, nw, [ws[i] for i in grp], [projs[i][1] for i in grp])]

    errs = []
    launches.reset()
    got_all, again = run_kernel(), run_kernel()
    if launches.snapshot() != {name: 2 * len(groups)}:
        raise AssertionError(f"{name}: launches {launches.snapshot()}, "
                             f"not {len(groups)} a run")
    if not all(torch.equal(a, b) for a, b in zip(got_all, again)):
        raise AssertionError(f"{name}: two runs differ")
    if stress:
        # a refill of a TMA ring stage under its readers gives a wrong
        # sum now and then, not a hang: many launches, every bit compared
        bad = torch.zeros((len(projs),), dtype=torch.int64, device=dev)
        for _ in range(stress):
            bad += torch.stack([(a != b).any()
                                for a, b in zip(run_kernel(), got_all)])
        bad = bad.tolist()
        print(f"  {name}: {stress} launches of each group, outputs "
              f"that differ from the first run's: {bad}", flush=True)
        if any(bad):
            raise AssertionError(f"{name}: the ring stress found {bad}")
    for (n, act), wt, got in zip(projs, ws, got_all):
        ref = fnl.fused_norm_linear_plain(x, rs, nw, wt, act)
        errs.append(check_close(f"{name} [{M}, {HID}] x [{HID}, {n}] "
                                f"{act}", got, ref, bf16_tol(ref)))
    del got_all, again
    xn = (x.float() * rs).to(bf) * nw

    def run_plain():
        for (_, act), wt in zip(projs, ws):
            fnl.fused_norm_linear_plain(x, rs, nw, wt, act)

    def run_library():
        for wt in ws:
            torch.matmul(xn, wt)

    N_all = sum(n for n, _ in projs)
    # x, nw and rs read once, each w once, each output written once
    nbytes = 2 * (M * HID + HID + HID * N_all + M * N_all) + M * 4
    return dict(
        replaces="paddle_tpu/kernels/fused_norm_linear.py:60",
        source="paddle_tpu_torch/csrc/fused_norm_linear.cu",
        max_abs_err=max(errs), ms=time_ms(run_kernel, iters=10),
        plain_ms=time_ms(run_plain, iters=10),
        library_ms=time_ms(run_library, iters=10),
        bound=bound_ms(nbytes, 2.0 * M * HID * N_all),
        work=f"q,k,v,gate,up of one layer at M={M}, hidden {HID}", **extra)


def _gathered(pool, bt, n_keys):
    """[B, KVH, n_keys, D] contiguous K or V of the first n_keys pages
    of ``bt``: the library yardstick's input."""
    B, nbs = bt.shape
    bs, KVH, D = pool.shape[1:]
    return pool[bt.long()].reshape(B, nbs * bs, KVH, D)[:, :n_keys] \
        .transpose(1, 2).contiguous()


# (entry, form, pools, main phase) of the KV write's timed cases
WRITE_CASES = (("kv_write", "decode", "fp8", "quant"),
               ("kv_write_chunk", "chunk", "fp8", "quant"),
               ("kv_write_bf16", "decode", "bf16", "serve"),
               ("kv_write_chunk_bf16", "chunk", "bf16", "serve"))


def _write_operands(g, form, pool, nb, bt, positions, c, s, bt1, pos1, T,
                    KVH=8, D=128):
    """(args, keywords, masked tokens) of kv_quant.kv_write for one layer:
    a decode step of phase 2's 8 sequences (k unrotated, with the RoPE
    rows c/s at their positions) or phase 2's 256-token chunk at 768
    (its last 16 tokens masked, as a padded tail), into fresh pools of
    phase 2's size of ``pool`` ("f32", "bf16", "int8" or "fp8")."""
    from paddle_tpu_torch.kernels import kv_quant

    dev = g.device
    dtype = torch.float32 if pool == "f32" else torch.bfloat16
    scheme = pool if pool in ("int8", "fp8") else None
    bs = 16
    table, pos, n = (bt, positions, 1) if form == "decode" else \
        (bt1, pos1, T)
    B = table.shape[0]
    k, v = ((torch.randn((B, n, KVH, D), generator=g, device=dev)
             * torch.logspace(-2, 2, B * n, device=dev).view(B, n, 1, 1))
            .to(dtype) for _ in range(2))
    kw = dict(scheme=scheme)
    masked = []
    if form == "decode":
        kw.update(c=c.to(dtype), s=s.to(dtype))
    else:
        mask = torch.ones((B, n), dtype=torch.bool, device=dev)
        mask[:, n - 16:] = False
        kw["write_mask"] = mask
        masked = [(0, j) for j in range(n - 16, n)]
    if scheme is None:
        pools = [torch.zeros((nb, bs, KVH, D), dtype=dtype, device=dev)
                 for _ in range(2)]
    else:
        pools = [torch.zeros((nb, bs, KVH, D), dtype=torch.int8,
                             device=dev) for _ in range(2)]
        kw.update(k_scale=torch.ones((nb, bs), device=dev),
                  v_scale=torch.ones((nb, bs), device=dev))
    return [*pools, k, v, table, pos], kw, masked


def hold_write(name, ops, kw, want_ops, want_kw, masked):
    """The kernel's pools (and scales) against the plain version's: every
    row bit for bit but the garbage block's row 0, which several masked
    tokens share: it must hold one of them (codes with their scale)."""
    from paddle_tpu_torch.kernels import kv_quant

    scheme = kw["scheme"]
    got, want = list(ops[:2]), list(want_ops[:2])
    if scheme is not None:
        got += [kw["k_scale"], kw["v_scale"]]
        want += [want_kw["k_scale"], want_kw["v_scale"]]
    same = all(torch.equal(a.flatten(0, 1)[1:], b.flatten(0, 1)[1:])
               for a, b in zip(got, want))
    for side in range(2):
        cands = [ops[2 + side][b, j] for b, j in masked] or \
            [want[side][0, 0]]
        if scheme is None:
            same &= any(torch.equal(got[side][0, 0], x) for x in cands)
        else:
            if masked:
                cands = [kv_quant.quantize_kv(x, scheme) for x in cands]
            else:
                cands = [(want[side][0, 0], want[2 + side][0, 0])]
            same &= any(torch.equal(got[side][0, 0], x) and
                        torch.equal(got[2 + side][0, 0], sc)
                        for x, sc in cands)
    print(f"  {name}: {'bit-identical' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError(f"{name}: the kernel's pools differ from the "
                             "plain version's")


def write_entries(g, nb, bt, positions, c, s, bt1, pos1, T):
    """The KV write (kv_quant.kv_write, one launch a layer) at a decode
    step's shapes (8 sequences, k rotated in the kernel) and a prefill
    chunk's (256 tokens, a masked tail) of one Llama-3-8B layer, into
    f32, bf16, int8 and fp8 pools: bit-identical to its plain version in
    each; timed into fp8 and bf16 pools, the row lookup and the
    rotation included."""
    from paddle_tpu_torch.kernels import kv_quant

    entries = {}
    for form in ("decode", "chunk"):
        for pool in ("f32", "bf16", "int8", "fp8"):
            ops, kw, masked = _write_operands(g, form, pool, nb, bt,
                                              positions, c, s, bt1, pos1, T)
            want_ops = [x.clone() for x in ops]
            want_kw = {k: x.clone() if isinstance(x, torch.Tensor) else x
                       for k, x in kw.items()}
            kv_quant.kv_write(*ops, **kw)
            kv_quant.kv_write_plain(*want_ops, **want_kw)
            hold_write(f"kv_write, {form} rows {list(ops[2].shape)} into "
                       f"{pool} pools", ops, kw, want_ops, want_kw, masked)
    for name, form, pool, path in WRITE_CASES:
        ops, kw, masked = _write_operands(g, form, pool, nb, bt, positions,
                                          c, s, bt1, pos1, T)
        entries[name] = write_entry(form, pool, path, ops, kw, masked)
    return entries


def write_entry(form, pool, path, ops, kw, masked):
    """The KV write's entry: kv_quant.kv_write on ``ops``/``kw`` (the
    decode or chunk form, ``masked`` tokens of a chunk masked) timed
    beside its plain version, with its bound."""
    from paddle_tpu_torch.kernels import kv_quant

    B, n, KVH, D = ops[2].shape
    N, E = B * n, KVH * D
    code = 1 if kw["scheme"] else 2
    # the rows the write leaves: one a kept token, and one for all the
    # masked tokens (the garbage row holds one of them); the block
    # table's entries the kept tokens look up, one a page
    rows = N - len(masked) + bool(masked)
    table, pos = ops[4].tolist(), ops[5].tolist()
    bs = ops[0].shape[1]
    gone = set(masked)
    pages = len({(b, min((pos[b] + j) // bs, len(table[b]) - 1))
                 for b in range(B) for j in range(n) if (b, j) not in gone})
    # each of those rows' new elements read once (bf16) and written once
    # (a code or bf16) with its scale, the table entries, positions, c/s
    # rows and mask read once
    nbytes = 2 * rows * E * (2 + code) + pages * 4 + B * 4 + \
        (2 * 2 * B * D // 2 if form == "decode" else N) + \
        (2 * 4 * rows if kw["scheme"] else 0)
    flops = (2 * 3.0 * rows * E if kw["scheme"] else 0) + \
        (3.0 * N * E if form == "decode" else 0)
    return dict(
        path=path, counter=kv_quant.KERNEL,
        replaces=("paddle_tpu/kernels/paged_attention.py:"
                  + ("80" if kw["scheme"] else "66")) if form == "decode"
        else "paddle_tpu/models/llama.py:"
        + ("390" if kw["scheme"] else "367"),
        source="paddle_tpu_torch/csrc/kv_quant.cu", max_abs_err=0.0,
        ms=time_ms(lambda: kv_quant.kv_write(*ops, **kw)),
        plain_ms=time_ms(lambda: kv_quant.kv_write_plain(*ops, **kw),
                         iters=5),
        library_ms=None,
        bound=bound_ms(nbytes, flops, F32_FLOPS),
        work=f"k and v rows [{B}, {n}, {KVH}, {D}] of one layer, "
             f"{pool} pools, {pages} table entries, "
             + ("k rotated" if form == "decode"
                else f"{len(masked)} tokens masked"))


def print_entries(entries):
    for name, e in entries.items():
        lib = "none" if e["library_ms"] is None \
            else f"{e['library_ms']:.4f} ms (kernel " \
                 f"{e['ms'] / e['library_ms']:.2f}x)"
        if "hot_ms" in e:
            lib += f"; L2-hot: kernel {e['hot_ms']:.4f} ms, library " \
                   f"{e['library_hot_ms']:.4f} ms"
        print(f"  {name}: {e['ms']:.4f} ms ({e['work']}), plain "
              f"{e['plain_ms']:.4f} ms, library {lib}, bound "
              f"{e['bound'][0]:.4f} ms by {e['bound'][1]} "
              f"({e['bound'][0] / e['ms']:.1%} of it)", flush=True)


def _rope_tables(head_dim, max_pos, theta, dev):
    from paddle_tpu_torch.models.llama import precompute_rope

    return precompute_rope(head_dim, max_pos, theta, device=dev)


# ---------------------------------------------------------------- phase 3
def hold_bf16_attention(name, got, plain, ref, cancels=False):
    """A bf16 FlashAttention output against the f32 plain version ``ref``
    of the same bf16-valued inputs.  The kernels round P and dS to bf16
    for the second product, as FlashAttention-2 does on tensor cores,
    where the plain version (as the TPU kernels) keeps them in f32; so
    the kernel may be off the f32 result by twice what the bf16 plain
    version is (which rounds only its output), plus one bf16 rounding
    (2^-9) of the largest output for the rounded P and dS.

    The rule holds again for each row (a query's output or dQ, a key's
    dK or dV: the last axis), so that the small late rows are held to
    their own size, not to the largest row's: twice the bf16 plain
    version's error in that row, plus one bf16 unit roundoff (2^-8) of
    the row's largest output, the size of the error that the rounded P
    or dS entries of the row add (each off by up to 2^-8 of itself, in
    a sum the size of the row).  A dQ row (``cancels``) is a sum of
    dS entries that add up to zero, so it is smaller than its terms and
    their roundings: it gets one bf16 ulp (2^-7) of its largest output
    instead.  A row's largest output counts as at least 2^-8 of the
    tensor's, for rows whose exact value cancels (the first query's dQ,
    where dP - delta = 0): their error is the f32 roundoff of the terms
    that cancel, not a fraction of what is left.  For dQ, dK and dV,
    ``plain`` and ``ref`` take the kernel forward's O and LSE."""
    diff = (got.float() - ref).abs()
    pdiff = (plain.float() - ref).abs()
    err, plain_err = float(diff.max()), float(pdiff.max())
    top = float(ref.abs().max())
    tol = 2 * plain_err + top * 2.0 ** -9
    row_tol = 2 * pdiff.amax(-1) \
        + ref.abs().amax(-1).clamp_min(top * 2.0 ** -8) \
        * 2.0 ** (-7 if cancels else -8)
    row_ratio = float((diff.amax(-1) / row_tol).max())
    ok = math.isfinite(err) and err <= tol and row_ratio <= 1.0
    print(f"  {name}: max_abs_err {err:.3e} vs the f32 plain version "
          f"(bf16 plain version {plain_err:.3e}; tolerance {tol:.3e}); "
          f"largest row error / row tolerance {row_ratio:.3f} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version ({err} > {tol} or a row at "
                             f"{row_ratio} of its tolerance)")
    return err


def phase_train_kernels(dev):
    """RoPE and FlashAttention at the training path's shapes: one layer
    of Llama-3-8B at T = 8192 (B = 1, 32 q / 8 kv heads, head_dim 128),
    bf16, causal, q/k/v in the model's [B, T, H, D] memory order.  The
    plain attention versions hold [heads, T, T] f32 score matrices, so
    they run (and are timed) a quarter of the heads at a time: 8 q heads
    over their 2 kv heads, four times."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa
    from paddle_tpu_torch.kernels import rms_norm, rope

    g = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    B, T, H, KVH, D, HID, eps = 1, TRAIN_T, 32, 8, 128, 4096, 1e-5

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    entries = {}
    print(f"[train kernels] Llama-3-8B width, T={T}, bf16, causal",
          flush=True)

    # rms_norm: one norm of the training path, [1, T, 4096] rows (its
    # launches are the training phase's "rms_norm" count)
    x = (3 * randn(B, T, HID).float()).to(bf)
    w = (1 + 0.1 * randn(HID).float()).to(bf)
    got, ref = rms_norm.rms_norm(x, w, eps), rms_norm.rms_norm_plain(x, w, eps)
    err = check_close(f"rms_norm [1, {T}, {HID}]", got, ref, bf16_tol(ref))
    entries["rms_norm_train"] = dict(
        counter="rms_norm", replaces="paddle_tpu/kernels/rms_norm.py:33",
        source="paddle_tpu_torch/csrc/rms_norm.cu", max_abs_err=err,
        ms=time_ms(lambda: rms_norm.rms_norm(x, w, eps)),
        plain_ms=time_ms(lambda: rms_norm.rms_norm_plain(x, w, eps)),
        library_ms=time_ms(lambda: F.rms_norm(x, (HID,), w, eps)),
        bound=bound_ms(2 * 2 * x.numel() + 2 * w.numel(), 4.0 * x.numel(),
                       F32_FLOPS),
        work=f"one norm of a layer [1, {T}, {HID}]")
    del x, w, got, ref

    # rope: q of one layer with the 8B tables (theta 5e5) in bf16; the
    # backward is the same kernel at the negated angle
    cos, sin = (t.to(bf) for t in _rope_tables(D, T, 500000.0, dev))
    x, gy = randn(B, T, H, D), randn(B, T, H, D)
    got, ref = rope.fused_rope(x, cos, sin), rope.rope_plain(x, cos, sin)
    err = check_close(f"rope [1, {T}, {H}, {D}]", got, ref, bf16_tol(ref))
    xg = x.clone().requires_grad_()
    rope.fused_rope(xg, cos, sin).backward(gy)
    ref = rope.rope_plain(gy, cos, -sin)
    err = max(err, check_close("rope backward (-sin)", xg.grad, ref,
                               bf16_tol(ref)))
    entries["rope"] = dict(
        replaces="paddle_tpu/kernels/rope.py:32",
        source="paddle_tpu_torch/csrc/rope.cu", max_abs_err=err,
        ms=time_ms(lambda: rope.fused_rope(x, cos, sin)),
        plain_ms=time_ms(lambda: rope.rope_plain(x, cos, sin), iters=5),
        library_ms=None,
        bound=bound_ms(2 * 2 * x.numel() + 2 * 2 * cos.numel(),
                       3.0 * x.numel(), F32_FLOPS),
        work=f"q of one layer [1, {T}, {H}, {D}]")
    del x, gy, xg, got, ref

    q, k, v, do = (t.transpose(1, 2) for t in (
        randn(B, T, H, D), randn(B, T, KVH, D), randn(B, T, KVH, D),
        randn(B, T, H, D)))
    scale = D ** -0.5
    o_nolse, _ = fa._fwd_kernel(q, k, v, True, scale, False)
    o, lse = fa._fwd_kernel(q, k, v, True, scale, True)
    o2, lse2 = fa._fwd_kernel(q, k, v, True, scale, True)
    if not (torch.equal(o, o2) and torch.equal(lse, lse2)):
        raise AssertionError("flash_attention_fwd_lse: two runs differ")
    del o2, lse2
    ops = fa._bwd_operands(q, k, v, do, lse, fa._delta(o, do))
    # the dQ kernel's K/V ring is freed without a proxy fence (the
    # tensor cores are its only readers): ATTN_STRESS runs, every bit
    # compared
    dq = fa._dq_kernel(*ops, True, scale)
    bad = sum(not torch.equal(dq, fa._dq_kernel(*ops, True, scale))
              for _ in range(ATTN_STRESS))
    print(f"  flash_attention_bwd_dq: {ATTN_STRESS} more runs, {bad} "
          "differ from the first", flush=True)
    if bad:
        raise AssertionError("flash_attention_bwd_dq: runs differ")
    dk, dv = fa._dkv_kernel(*ops, True, scale)
    dk2, dv2 = fa._dkv_kernel(*ops, True, scale)
    if not (torch.equal(dk, dk2) and torch.equal(dv, dv2)):
        raise AssertionError("flash_attention_bwd_dkv: two runs differ")
    del dk2, dv2
    torch.cuda.synchronize()
    if not torch.equal(o_nolse, o):
        raise AssertionError("flash_attention_fwd and _fwd_lse differ")
    got = dict(o=o, lse=lse, dq=dq, dk=dk, dv=dv)
    G = 4
    hq, hk = H // G, KVH // G
    parts = [(slice(j * hq, (j + 1) * hq), slice(j * hk, (j + 1) * hk))
             for j in range(G)]
    err = dict.fromkeys(got, 0.0)
    for qs, ks in parts:
        # the backward's plain versions take the kernel forward's O and
        # LSE, the backward kernels' own inputs: each kernel is held on
        # the inputs it was given, and delta = rowsum(dO * O) is the same
        # in all three
        ins = (q[:, qs], k[:, ks], v[:, ks], do[:, qs])
        ko, klse = o[:, qs], lse[:, qs]
        po, plse = fa.flash_fwd_plain(*ins[:3], True, scale)
        plain = dict(o=po, lse=plse, **dict(zip(
            ("dq", "dk", "dv"),
            fa.flash_bwd_plain(*ins[:3], ko, klse, ins[3], True, scale))))
        f = [t.float() for t in ins]
        ro, rlse = fa.flash_fwd_plain(*f[:3], True, scale)
        ref = dict(o=ro, lse=rlse, **dict(zip(
            ("dq", "dk", "dv"),
            fa.flash_bwd_plain(*f[:3], ko.float(), klse, f[3], True,
                               scale))))
        for n in got:
            sl = ks if n in ("dk", "dv") else qs
            part = got[n][:, sl]
            if n == "lse":   # f32 rows from the same products: f32 tolerance
                e = check_close(f"lse heads {sl.start}..{sl.stop - 1}",
                                part, ref[n], F32_TOL)
            else:
                e = hold_bf16_attention(f"{n} heads {sl.start}..{sl.stop - 1}",
                                        part, plain[n], ref[n], n == "dq")
            err[n] = max(err[n], e)
        del plain, ref, f, po, plse, ro, rlse, ko, klse

    def plain_fwd():
        for qs, ks in parts:
            fa.flash_fwd_plain(q[:, qs], k[:, ks], v[:, ks], True, scale)

    def plain_bwd():
        for qs, ks in parts:
            fa.flash_bwd_plain(q[:, qs], k[:, ks], v[:, ks], o[:, qs],
                               lse[:, qs], do[:, qs], True, scale)

    def sdpa(*args):
        return F.scaled_dot_product_attention(*args, is_causal=True,
                                              enable_gqa=True)

    plain_fwd_ms = time_ms(plain_fwd, iters=2, warmup=1)
    plain_bwd_ms = time_ms(plain_bwd, iters=2, warmup=1)
    with torch.no_grad():
        sdpa_ms = time_ms(lambda: sdpa(q, k, v), iters=10)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    sdpa_grad_ms = time_ms(lambda: sdpa(qg, kg, vg), iters=10)
    sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
        sdpa(qg, kg, vg), (qg, kg, vg), do), iters=10) - sdpa_grad_ms

    pairs = T * (T + 1) / 2        # causal (query, key) pairs of one head
    prod = 2.0 * pairs * D * H     # flops of one [T, T] x D product, all heads
    q_bytes, kv_bytes, row_bytes = 2 * B * T * H * D, 2 * B * T * KVH * D, \
        4 * B * H * T
    where = "paddle_tpu/kernels/flash_attention.py"
    src = "paddle_tpu_torch/csrc/flash_attention.cu"
    work = f"one layer, B=1, T={T}, 32/8 heads, D=128, causal"
    inst = fa.instance(q, k, fa.BWD_DKV)   # every kernel's, phase 7's
    entries[fa.FWD] = dict(
        instance=inst, replaces=f"{where}:54", source=src,
        max_abs_err=err["o"],
        ms=time_ms(lambda: fa._fwd_kernel(q, k, v, True, scale, False),
                   iters=10),
        plain_ms=plain_fwd_ms, library_ms=sdpa_ms,
        bound=bound_ms(2 * q_bytes + 2 * kv_bytes, 2 * prod), work=work)
    entries[fa.FWD_LSE] = dict(
        instance=inst, replaces=f"{where}:97", source=src,
        max_abs_err=max(err["o"], err["lse"]),
        ms=time_ms(lambda: fa._fwd_kernel(q, k, v, True, scale, True),
                   iters=10),
        plain_ms=plain_fwd_ms, library_ms=sdpa_grad_ms,
        bound=bound_ms(2 * q_bytes + 2 * kv_bytes + row_bytes, 2 * prod),
        work=work)
    entries[fa.BWD_DQ] = dict(
        instance=inst, replaces=f"{where}:113", source=src,
        max_abs_err=err["dq"],
        ms=time_ms(lambda: fa._dq_kernel(*ops, True, scale), iters=10),
        plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
        bound=bound_ms(3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
                       3 * prod), work=work)
    entries[fa.BWD_DKV] = dict(
        instance=inst, replaces=f"{where}:151", source=src,
        max_abs_err=max(err["dk"], err["dv"]),
        ms=time_ms(lambda: fa._dkv_kernel(*ops, True, scale), iters=10),
        plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
        bound=bound_ms(2 * q_bytes + 4 * kv_bytes + 2 * row_bytes,
                       4 * prod), work=work)
    print("  plain attention timed 8 q heads at a time (4 calls); plain "
          "backward = dQ, dK and dV together; library: SDPA forward "
          "(without and with grad) and its backward as (fwd+bwd) - fwd, "
          "dQ, dK and dV together")
    print_entries(entries)
    return entries


# --------------------------------------------------------------- phase 2m
def _moe_routing(g, T, E, K, skew=0.0):
    """(eidx, sidx, gate) [T, K] as LlamaMoEMLP routes T bf16 tokens,
    from random router logits (``skew`` added to expert 0's)."""
    from paddle_tpu_torch.models.llama import route_top_k

    logits = torch.randn((T, E), generator=g, device=g.device)
    logits[:, 0] += skew
    return route_top_k(logits, K, torch.bfloat16)


def check_exact(name, got, ref):
    same = torch.equal(got, ref)
    print(f"  {name}: {'bit-identical' if same else 'FAIL'}", flush=True)
    if not same:
        raise AssertionError(f"{name}: the kernel differs from its plain "
                             "version")
    return 0.0


def phase_moe_kernels(dev):
    """MoE dispatch and combine at Mixtral-8x7B's widths (hidden 4096, 8
    experts, top-2), bf16, against their plain versions: at a decode
    step's 8 tokens, a prefill chunk's 256 and a training batch's 4096,
    each at the dropless capacity C = T, then 4096 tokens at C = 1024
    with a skewed routing, so that choices are dropped, and the form a
    backward pass feeds dispatch there (slots clamped to C - 1, dropped
    choices at weight 0, so slot C - 1 of a full expert is named by many).
    Dispatch with weight 1 and unique slots, and the backward form, must
    be bit-identical (each output is one f32 product, or none, rounded
    once, in both versions); combine must be within one bf16 ulp of its
    largest output (both sum the same two f32 products and round once,
    so it is bit-identical unless a sum's order changes)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import moe_dispatch as md

    g = torch.Generator(device=dev).manual_seed(3)
    bf = torch.bfloat16
    HID, E, K = MOE_HID, 8, 2
    src, where = "paddle_tpu_torch/csrc/moe_dispatch.cu", \
        "paddle_tpu/kernels/moe_dispatch.py"
    entries = {}
    print("[moe kernels] Mixtral-8x7B widths (hidden 4096, 8 experts, "
          "top-2), bf16", flush=True)
    for tag, T, C, skew, path in MOE_KERNEL_CASES:
        eidx, sidx, gate = _moe_routing(g, T, E, K, skew)
        tok = torch.randn((T, HID), generator=g, device=dev).to(bf)
        eo = torch.randn((E, C, HID), generator=g, device=dev).to(bf)
        ones = torch.ones_like(gate)
        kept = sidx < C
        n_kept, n_rows = int(kept.sum()), int(kept.any(1).sum())
        if (tag == "drop") == (n_kept == T * K):
            raise AssertionError(f"moe {tag}: {T * K - n_kept} dropped")
        work = f"T={T}, C={C}, {T * K - n_kept} of {T * K} choices dropped"
        got = md.moe_dispatch(tok, eidx, sidx, ones, E, C)
        err = check_exact(f"moe_dispatch {work}", got,
                          md.dispatch_plain(tok, eidx, sidx, ones, E, C))
        blocks, per = md.dispatch_plan(E * C, T * K, HID,
                                       torch.cuda.get_device_properties(
                                           dev).multi_processor_count)
        print(f"    one launch of {blocks} blocks of {per} slots", flush=True)
        if tag == "decode":
            # the bits of DISPATCH_STRESS more launches against the first
            same = sum(torch.equal(md.moe_dispatch(tok, eidx, sidx, ones, E,
                                                   C), got)
                       for _ in range(DISPATCH_STRESS))
            print(f"    {same} of {DISPATCH_STRESS} more launches "
                  "bit-identical to the first", flush=True)
            if same != DISPATCH_STRESS:
                raise AssertionError("moe_dispatch: launches differ")
        if tag == "train":
            # every block re-reads all T * K choices (eidx, sidx and a
            # bf16 weight); the index stage's time alone is the no_rows
            # variant of python -m paddle_tpu_torch.tools.dispatch_parts
            print(f"    index stage: {blocks} blocks re-read "
                  f"{blocks * T * K * 10 / 1e6:.1f} MB of choices from the "
                  "L2", flush=True)
        flat = eidx.long() * C + sidx.long().clamp(max=C - 1)
        rows = tok.repeat_interleave(K, 0)[kept.reshape(-1)]
        dst = flat.reshape(-1)[kept.reshape(-1)]
        idx_bytes = 12 * T * K          # eidx, sidx, weights
        entries[f"moe_dispatch_{tag}"] = dict(
            path=path, counter=md.DISPATCH, replaces=f"{where}:53",
            source=src, max_abs_err=err,
            ms=time_ms(lambda: md.moe_dispatch(tok, eidx, sidx, ones, E, C)),
            plain_ms=time_ms(lambda: md.dispatch_plain(tok, eidx, sidx, ones,
                                                       E, C), iters=5),
            # the yardstick: index_add_ of the routed (weight-1) rows into
            # a zeroed buffer
            library_ms=time_ms(lambda: torch.zeros(
                (E * C, HID), dtype=bf, device=dev).index_add_(0, dst, rows)),
            bound=bound_ms(2 * HID * (n_rows + E * C) + idx_bytes,
                           2.0 * n_kept * HID, F32_FLOPS),
            work=work)
        ref = md.combine_plain(eo, eidx, sidx, gate)
        top = float(ref.float().abs().max())
        err = check_close(f"moe_combine {work}",
                          md.moe_combine(eo, eidx, sidx, gate), ref,
                          2.0 ** (math.floor(math.log2(top)) - 7))
        wv = (gate * kept).to(bf)
        table = eo.view(E * C, HID)
        entries[f"moe_combine_{tag}"] = dict(
            path=path, counter=md.COMBINE, replaces=f"{where}:83",
            source=src, max_abs_err=err,
            ms=time_ms(lambda: md.moe_combine(eo, eidx, sidx, gate)),
            plain_ms=time_ms(lambda: md.combine_plain(eo, eidx, sidx, gate),
                             iters=5),
            library_ms=time_ms(lambda: F.embedding_bag(
                flat, table, mode="sum", per_sample_weights=wv)),
            bound=bound_ms(2 * HID * (n_kept + T) + idx_bytes,
                           2.0 * n_kept * HID, F32_FLOPS),
            work=work)
        if tag != "drop":
            continue
        # combine's backward: a dispatch of the [T, M] cotangent with the
        # slots clamped and the dropped choices' weights zeroed
        safe, wz = sidx.clamp(max=C - 1), gate * kept
        busiest = int(torch.bincount(flat.reshape(-1)).max())
        work = f"T={T}, C={C}, clamped slots, up to {busiest} choices a slot"
        err = check_exact(f"moe_dispatch (backward form) {work}",
                          md.moe_dispatch(tok, eidx, safe, wz, E, C),
                          md.dispatch_plain(tok, eidx, safe, wz, E, C))
        pre = (rows.float() * gate.reshape(-1, 1)[kept.reshape(-1)]
               .float()).to(bf)
        entries["moe_dispatch_backward"] = dict(
            path=path, counter=md.DISPATCH, replaces=f"{where}:53",
            source=src, max_abs_err=err,
            ms=time_ms(lambda: md.moe_dispatch(tok, eidx, safe, wz, E, C)),
            plain_ms=time_ms(lambda: md.dispatch_plain(tok, eidx, safe, wz,
                                                       E, C), iters=5),
            library_ms=time_ms(lambda: torch.zeros(
                (E * C, HID), dtype=bf, device=dev).index_add_(0, dst, pre)),
            bound=bound_ms(2 * HID * (n_rows + E * C) + idx_bytes,
                           2.0 * n_kept * HID, F32_FLOPS),
            work=work)
    print("  library: index_add_ of the routed rows, pre-weighted, into a "
          "zeroed buffer (dispatch); F.embedding_bag(mode='sum', "
          "per_sample_weights) over the [E*C, M] table (combine)")
    print_entries(entries)
    return entries


# --------------------------------------------------------------- phase 2c
C1_BS = 12                     # the C1 phases' pages: not a power of two
C1_FLASH_T = 2048              # phase 2c's attention: T, and its (head_dim,
C1_FLASH = (                   # heads, the main phase whose launches of the
    (80, 32, "train_phi3"),    # same instance a row reports): Phi-2's and
    (96, 32, "train_phi3"),    # Phi-3-mini's on the 128-column wgmma
    (256, 16, "c1_tiny"),      # kernels (phase 7c), Gemma-7B's on the
    (100, 32, "c1_tiny"),      # 256-column ones (4c's head_dim-256 model),
    (132, 16, "c1_tiny"))      # 100 and 132 on the general instances of
                               # head_dim up to 128 and 256 (4c's
                               # head_dim-20 and head_dim-132 models)
C1_FNL_K = 3588                # phase 2c's fused_norm_linear: K and the
C1_FNL_N = (3588, 516, 516)    # q/k/v widths, each = 4 (mod 8)
C1_FRONTIERS = (130, 260, 390, 520, 650, 780, 910, 1055)   # phase 2's


def qwen2_7b_config(**overrides):
    """Qwen2-7B's widths from its published config.json (Qwen/Qwen2-7B):
    vocab 152064, hidden 3584, intermediate 18944, 28 layers, 28 q / 4 kv
    heads (head_dim 128, GQA rep 7), rope_theta 1e6, rms_norm_eps 1e-6,
    max_position 32768, untied embeddings; without its q/k/v biases,
    which the port's Llama has no place for."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaConfig

    return dataclasses.replace(LlamaConfig(
        vocab_size=152064, hidden_size=3584, intermediate_size=18944,
        num_hidden_layers=28, num_attention_heads=28, num_key_value_heads=4,
        max_position_embeddings=32768, rms_norm_eps=1e-6, rope_theta=1e6),
        **overrides)


def phi3_mini_config(**overrides):
    """Phi-3-mini's widths from its published config.json
    (microsoft/Phi-3-mini-4k-instruct): vocab 32064, hidden 3072,
    intermediate 8192, 32 layers, 32 q / 32 kv heads (head_dim 96, no
    GQA), rope_theta 1e4, rms_norm_eps 1e-5, max_position 4096, untied
    embeddings; its fused qkv_proj and gate_up_proj as the Llama's
    separate q/k/v and gate/up projections (the same products).  Its
    2047-token sliding window is not modelled: attention is causal over
    every position."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaConfig

    return dataclasses.replace(LlamaConfig(
        vocab_size=32064, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=32,
        max_position_embeddings=4096, rms_norm_eps=1e-5, rope_theta=1e4),
        **overrides)


# (tag, H, KVH, D, page size, max_position, rope_theta) of the attention
# shapes of phase 2c: Phi-2's (microsoft/phi-2 config.json: 32 heads of
# 80, no GQA, 2048 positions; its partial rotary not modelled) and
# Phi-3-mini's (microsoft/Phi-3-mini-4k-instruct config.json: 32 heads of
# 96, no GQA, 4096 positions: the padded 128-column decode and the
# 128-column wgmma chunk) and Gemma-7B's (google/gemma-7b config.json: 16
# heads of 256, 8192 positions: the 256-column decode and chunk); head_dim
# 100 and 132 (no model's) keep the general decode and chunk held
C1_QWEN2 = ("qwen2", 28, 4, 128, C1_BS, 32768, 1e6)
C1_PHI2 = ("phi2", 32, 32, 80, 16, 2048, 1e4)
C1_PHI3 = ("phi3", 32, 32, 96, 16, 4096, 1e4)
C1_PHI3_12 = ("phi3_pages12", 32, 32, 96, C1_BS, 4096, 1e4)
C1_GEMMA = ("gemma7b", 16, 16, 256, 16, 8192, 1e4)
C1_D100 = ("d100", 32, 32, 100, 16, 4096, 1e4)   # the general chunk's
C1_D132 = ("d132", 16, 16, 132, 16, 4096, 1e4)   # instances of 128, 256


def _one_launch(name, fn, instance=None):
    """``fn()``, which must launch kernel ``name`` once (on ``instance``
    where it is given) and nothing else."""
    from paddle_tpu_torch.kernels import launches

    launches.reset()
    out = fn()
    if launches.snapshot() != {name: 1} or instance is not None and \
            launches.by_instance() != {f"{name}@{instance}": 1}:
        raise AssertionError(f"{name}: launches {launches.snapshot()} "
                             f"{launches.by_instance()}")
    return out


def phase_counts():
    """A main phase's launch counts: each kernel's, and each instance's
    as ``name@instance`` (``launches.by_instance``), so that a row of the
    JSON line reports the launches of its own instance.  An older package
    without the instance tally, whose step ``tools/turns`` times through
    this script, gives only the kernels'."""
    from paddle_tpu_torch.kernels import launches

    return {**launches.snapshot(),
            **getattr(launches, "by_instance", dict)()}


def _attn_operands(g, dev, shape, T=1, start=None):
    """A decode step's (T = 1: 8 sequences at C1_FRONTIERS) or a prefill
    chunk's (T tokens at ``start``, or of each sequence at each start of a
    list) operands at ``shape`` (C1_QWEN2 ...):
    a dict of q, its RoPE rows (decode), bf16 pools over shuffled pages
    of the shape's size, the table at the engine's width for the shape's
    max_position, the positions, and what the library yardstick needs."""
    _, H, KVH, D, bs, max_pos, theta = shape
    bf = torch.bfloat16

    def randn(*s):
        return torch.randn(s, generator=g, device=dev).to(bf)

    nbs = -(-max_pos // bs)
    starts = [start] if isinstance(start, int) else start
    ends = [p + 1 for p in C1_FRONTIERS] if start is None else \
        [s + T for s in starts]
    B = len(ends)
    per_seq = [-(-e // bs) for e in ends]
    nb = 1 + sum(per_seq)
    perm = (1 + torch.randperm(nb - 1, generator=g, device=dev)).int()
    bt = torch.zeros((B, nbs), dtype=torch.int32, device=dev)
    off = 0
    for b, n in enumerate(per_seq):
        bt[b, :n] = perm[off:off + n]
        off += n
    ops = dict(k=randn(nb, bs, KVH, D), v=randn(nb, bs, KVH, D), bt=bt,
               nbs=nbs, ends=ends, shape=shape)
    if start is None:
        from paddle_tpu_torch.kernels import rope

        pos = torch.tensor(C1_FRONTIERS, dtype=torch.int32, device=dev)
        cos, sin = _rope_tables(D, max_pos, theta, dev)
        ops["c"], ops["s"] = cos[pos.long()].to(bf), sin[pos.long()].to(bf)
        ops["q"] = randn(B, H, D)
        ops["q_sdpa"] = rope.rotate_half(
            ops["q"].float(), ops["c"][:, None, :].float(),
            ops["s"][:, None, :].float()).to(bf)[:, :, None, :]
        L = max(ends)
        ops["mask"] = (torch.arange(L, device=dev)[None, :]
                       <= pos[:, None])[:, None, None, :]
    else:
        pos = torch.tensor(starts, dtype=torch.int32, device=dev)
        ops["q"] = randn(B, T, H, D)
        ops["q_sdpa"] = ops["q"].transpose(1, 2).contiguous()
        # [B, 1, T, L]: key j is seen by token t of sequence b where
        # j <= starts[b] + t
        ops["mask"] = (torch.arange(max(ends), device=dev)[None, None, :]
                       <= (pos[:, None] + torch.arange(T, device=dev))
                       [:, :, None])[:, None]
    ops["pos"] = pos
    return ops


def _same_keys(bs_pair, n_keys, B, KVH, D, g, dev):
    """Pools of ``B`` sequences' ``n_keys`` keys each, the same keys in
    pages of each size of ``bs_pair`` (block 1 + b * n_keys / bs + p
    holds sequence b's keys p * bs ..., block 0 zeros), with their
    tables: {bs: (k_pool, v_pool, table)}."""
    keys = [torch.randn((B * n_keys, KVH, D), generator=g, device=dev)
            .bfloat16() for _ in range(2)]
    out = {}
    for bs in bs_pair:
        zero = torch.zeros((bs, KVH, D), dtype=torch.bfloat16, device=dev)
        k, v = (torch.cat([zero, x]).reshape(-1, bs, KVH, D) for x in keys)
        out[bs] = (k, v, (1 + torch.arange(
            B * n_keys // bs, dtype=torch.int32, device=dev)).reshape(B, -1))
    return out


def _decode_entry(ops, scheme, name, path, splits):
    """Paged decode over ``ops`` (``_attn_operands``, quantized to
    ``scheme``): one launch under ``name``, two runs bit-identical, the
    plain version within two bf16 ulps; timed L2-cold over rotating
    copies of the pools and table (SDPA over copies of the gathered,
    dequantized K/V) and hot.  Returns its entry."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import kv_quant, paged_attention

    tag, H, KVH, D, bs = ops["shape"][:5]
    if scheme is None:
        kp, vp, ks, vs, kd, vd = ops["k"], ops["v"], None, None, ops["k"], \
            ops["v"]
    else:
        (kp, ks), (vp, vs) = (kv_quant.quantize_kv(ops[x], scheme)
                              for x in "kv")
        kd, vd = (kv_quant.dequantize_kv(x, sc, scheme).to(torch.bfloat16)
                  for x, sc in ((kp, ks), (vp, vs)))
    args = (ops["q"], ops["c"], ops["s"], kp, vp, ops["bt"], ops["pos"], 1,
            ks, vs, scheme)
    inst = paged_attention.instance(ops["q"], paged_attention.hopper_path(
        ops["q"], kp, vp, H // KVH))
    got = _one_launch(name, lambda: paged_attention.paged_decode_attention(
        *args), inst)
    if not torch.equal(got, paged_attention.paged_decode_attention(*args)):
        raise AssertionError(f"{name}: two runs differ")
    ref = paged_attention.paged_decode_attention_plain(*args)
    B, nbs = ops["bt"].shape
    err = check_close(f"{name} {tag} B={B} {H}/{KVH} heads D={D} bs={bs} "
                      f"nbs={nbs}{'' if scheme is None else ' ' + scheme}"
                      f"{'' if inst is None else ' on the instance ' + inst}"
                      f" (two runs bit-identical)", got, ref, bf16_tol(ref))
    L = max(ops["ends"])
    kg, vg = _gathered(kd, ops["bt"], L), _gathered(vd, ops["bt"], L)

    def sdpa(kg, vg):
        return F.scaled_dot_product_attention(
            ops["q_sdpa"], kg, vg, attn_mask=ops["mask"], enable_gqa=True)

    tensors = [t for t in (kp, vp, ops["bt"], ks, vs) if t is not None]
    cold = [(*args[:3], *(None if t is None else t.clone() for t in
                          (kp, vp, ops["bt"])), ops["pos"], 1,
             *(None if t is None else t.clone() for t in (ks, vs)), scheme)
            for _ in range(cold_copies(sum(t.numel() * t.element_size()
                                           for t in tensors)))]
    gathered = [(kg.clone(), vg.clone()) for _ in
                range(cold_copies(2 * kg.numel() * kg.element_size()))]
    dkeys = float(sum(ops["ends"]))
    row = 2 * KVH * D if scheme is None else KVH * D + 4
    out = dict(
        path=path, counter=name, **({} if inst is None else
                                    {"instance": inst}),
        replaces="paddle_tpu/kernels/paged_attention.py:102",
        source="paddle_tpu_torch/csrc/paged_attention.cu", max_abs_err=err,
        ms=time_ms_rotating([
            lambda a=a: paged_attention.paged_decode_attention(*a)
            for a in cold]),
        hot_ms=time_ms(lambda: paged_attention.paged_decode_attention(*args)),
        plain_ms=time_ms(
            lambda: paged_attention.paged_decode_attention_plain(*args),
            iters=5),
        library_ms=time_ms_rotating([lambda kv=kv: sdpa(*kv)
                                     for kv in gathered]),
        library_hot_ms=time_ms(lambda: sdpa(kg, vg)),
        bound=bound_ms(2 * dkeys * row + 2 * 2 * B * H * D
                       + 4 * B * (nbs + 1 + D), 4.0 * dkeys * H * D),
        work=f"one layer's decode step, {tag}: B={B}, {int(dkeys)} keys, "
             f"{H}/{KVH} heads, D={D}, pages of {bs}"
             f"{'' if scheme is None else ', ' + scheme + ' pools'}, "
             f"{splits} splits, L2-cold over {len(cold)} copies (library "
             f"over {len(gathered)})")
    del cold, gathered
    return out


def _chunk_entry(ops, name, path, scheme=None):
    """Chunked prefill over ``ops`` (``_attn_operands`` of a chunk, bf16
    pools, quantized to ``scheme``): one launch under ``name``, two runs
    bit-identical, the plain version within two bf16 ulps; timed L2-cold
    over rotating copies of q, the pools, the table and the scales (SDPA
    over copies of q and the gathered, dequantized K/V) and hot.  Returns
    its entry."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import chunked_prefill, kv_quant

    tag, H, KVH, D, bs = ops["shape"][:5]
    if scheme is None:
        kp, vp, ks, vs, kd, vd = ops["k"], ops["v"], None, None, ops["k"], \
            ops["v"]
    else:
        (kp, ks), (vp, vs) = (kv_quant.quantize_kv(ops[x], scheme)
                              for x in "kv")
        kd, vd = (kv_quant.dequantize_kv(x, sc, scheme).to(torch.bfloat16)
                  for x, sc in ((kp, ks), (vp, vs)))
    args = (ops["q"], kp, vp, ops["bt"], ops["pos"], ks, vs, scheme)
    inst = chunked_prefill.instance(ops["q"], kp, vp,
                                    () if ks is None else (ks, vs), scheme)
    got = _one_launch(name, lambda: chunked_prefill.chunked_attention(*args),
                      inst)
    if not torch.equal(got, chunked_prefill.chunked_attention(*args)):
        raise AssertionError(f"{name}: two runs differ")
    ref = chunked_prefill.chunked_attention_plain(*args)
    B, T = ops["q"].shape[:2]
    starts, ctx = ops["pos"].tolist(), max(ops["ends"])
    start = starts[0] if B == 1 else starts
    err = check_close(f"{name} {tag} T={T} start={start} {H}/{KVH} heads "
                      f"D={D} bs={bs}{'' if scheme is None else ' ' + scheme}"
                      f" on the instance {inst} (two runs bit-identical)",
                      got, ref, bf16_tol(ref))
    kg, vg = _gathered(kd, ops["bt"], ctx), _gathered(vd, ops["bt"], ctx)

    def sdpa(q, kg, vg):
        return F.scaled_dot_product_attention(q, kg, vg,
                                              attn_mask=ops["mask"],
                                              enable_gqa=True)

    tensors = [t for t in (*args[:4], ks, vs) if t is not None]
    cold = [(*(t.clone() for t in args[:4]), ops["pos"],
             *(None if t is None else t.clone() for t in (ks, vs)), scheme)
            for _ in range(cold_copies(sum(t.numel() * t.element_size()
                                           for t in tensors)))]
    gathered = [(ops["q_sdpa"].clone(), kg.clone(), vg.clone()) for _ in
                range(cold_copies(2 * (ops["q"].numel() + 2 * kg.numel())))]
    nbs = ops["nbs"]
    ckeys = float(sum(s + t + 1 for s in starts for t in range(T)))
    row = 2 * KVH * D * 2 if scheme is None else 2 * (KVH * D + 4)
    out = dict(
        path=path, counter=name, instance=inst,
        replaces="paddle_tpu/kernels/chunked_prefill.py:51",
        source="paddle_tpu_torch/csrc/chunked_prefill.cu", max_abs_err=err,
        ms=time_ms_rotating([lambda a=a: chunked_prefill.chunked_attention(*a)
                             for a in cold]),
        hot_ms=time_ms(lambda: chunked_prefill.chunked_attention(*args)),
        plain_ms=time_ms(
            lambda: chunked_prefill.chunked_attention_plain(*args), iters=5),
        library_ms=time_ms_rotating([lambda a=a: sdpa(*a)
                                     for a in gathered]),
        library_hot_ms=time_ms(lambda: sdpa(ops["q_sdpa"], kg, vg)),
        bound=bound_ms(sum(ops["ends"]) * row + 2 * 2 * B * T * H * D
                       + 4 * B * (nbs + 1), 4.0 * ckeys * H * D),
        work=f"one layer's prefill chunk, {tag}: B={B}, T={T}, context "
             f"{ctx if B == 1 else ops['ends']}, "
             f"{H}/{KVH} heads, D={D}, pages of {bs}"
             f"{'' if scheme is None else ', ' + scheme + ' pools'}, "
             f"L2-cold over {len(cold)} copies (library over "
             f"{len(gathered)})")
    del cold, gathered
    return out


def c1_flash_entries(g, dev):
    """Phase 2c's attention rows (C1_FLASH, T = C1_FLASH_T, causal): each
    kernel once under the counter of its route, twice the same bits,
    against its plain version, timed beside SDPA, with its bound from the
    true head_dim's work."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import flash_attention as fa

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    entries = {}
    # FlashAttention at head_dims other than 64 and 128: every kernel on
    # its wgmma instance where D % 8 == 0, on its general one at D = 100
    Tf = C1_FLASH_T
    for Df, Hf, path in C1_FLASH:
        q, k, v, do = (randn(1, Tf, Hf, Df).transpose(1, 2)
                       for _ in range(4))
        scale = Df ** -0.5
        names = [fa._launch_name(n, q, k) for n in (fa.FWD, fa.FWD_LSE,
                                                    fa.BWD_DQ, fa.BWD_DKV)]
        wgmma = Df % 8 == 0
        want = [n if wgmma else n + fa.GENERAL
                for n in (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV)]
        if names != want:
            raise AssertionError(f"D={Df}: routes {names} != {want}")
        inst = fa.instance(q, k, fa.BWD_DKV)
        if any(fa.instance(q, k, n) != inst for n in (fa.FWD, fa.BWD_DQ)):
            raise AssertionError(f"D={Df}: the kernels' instances differ")
        print(f"  attention D={Df}: every kernel on the instance {inst}",
              flush=True)
        o_nolse, _ = _one_launch(names[0], lambda: fa._fwd_kernel(
            q, k, v, True, scale, False), inst)
        o, lse = _one_launch(names[1], lambda: fa._fwd_kernel(
            q, k, v, True, scale, True), inst)
        ops = fa._bwd_operands(q, k, v, do, lse, fa._delta(o, do))
        dq = _one_launch(names[2], lambda: fa._dq_kernel(*ops, True, scale),
                         inst)
        dk, dv = _one_launch(names[3], lambda: fa._dkv_kernel(*ops, True,
                                                              scale), inst)
        o2, lse2 = fa._fwd_kernel(q, k, v, True, scale, True)
        same = [torch.equal(o, o_nolse), torch.equal(o, o2),
                torch.equal(lse, lse2),
                torch.equal(dq, fa._dq_kernel(*ops, True, scale)),
                all(map(torch.equal, (dk, dv),
                        fa._dkv_kernel(*ops, True, scale)))]
        print(f"  attention D={Df}: a second run's O (without and with the "
              f"LSE), LSE, dQ, dK/dV bit-identical: {same}", flush=True)
        if not all(same):
            raise AssertionError(f"flash D={Df}: runs differ")
        if wgmma:
            # dK/dV's ring (Q and dO tiles, lse and delta rows by ld.shared)
            # refilled under its readers would show as other bits
            bad = sum(not all(map(torch.equal, (dk, dv), fa._dkv_kernel(
                *ops, True, scale))) for _ in range(ATTN_STRESS))
            print(f"  {names[3]} D={Df}: {ATTN_STRESS} more runs, {bad} "
                  f"with other bits", flush=True)
            if bad:
                raise AssertionError(f"dK/dV D={Df}: {bad} runs differ")
        del o2, lse2
        x = (q, k, v, do)
        f = [t.float() for t in x]
        po = fa.flash_fwd_plain(*x[:3], True, scale)[0]
        ro, rlse = fa.flash_fwd_plain(*f[:3], True, scale)
        pg = fa.flash_bwd_plain(*x[:3], o, lse, do, True, scale)
        rg = fa.flash_bwd_plain(*f[:3], o.float(), lse, f[3], True, scale)
        err = {"o": hold_bf16_attention(f"{names[0]} D={Df} o", o, po, ro)}
        check_close(f"{names[1]} D={Df} lse", lse, rlse, F32_TOL)
        for key, got_t, p_t, r_t in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                        pg, rg):
            err[key] = hold_bf16_attention(
                f"{names[2] if key == 'dq' else names[3]} D={Df} {key}",
                got_t, p_t, r_t, key == "dq")
        del pg, rg, po, ro

        def sdpa(*a):
            return F.scaled_dot_product_attention(*a, is_causal=True)

        with torch.no_grad():
            sdpa_ms = time_ms(lambda: sdpa(q, k, v), iters=10)
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        sdpa_grad_ms = time_ms(lambda: sdpa(qg, kg, vg), iters=10)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
            sdpa(qg, kg, vg), (qg, kg, vg), do), iters=10) - sdpa_grad_ms
        plain_fwd_ms = time_ms(lambda: fa.flash_fwd_plain(q, k, v, True,
                                                          scale),
                               iters=2, warmup=1)
        plain_bwd_ms = time_ms(lambda: fa.flash_bwd_plain(q, k, v, o, lse,
                                                          do, True, scale),
                               iters=2, warmup=1)
        pairs = Tf * (Tf + 1) / 2
        prod = 2.0 * pairs * Df * Hf
        qb, rb = 2 * Tf * Hf * Df, 4 * Hf * Tf
        tag = f"_d{Df}"
        where = "paddle_tpu/kernels/flash_attention.py"
        src = "paddle_tpu_torch/csrc/flash_attention.cu"
        work = f"B=1, T={Tf}, {Hf} heads, D={Df}, causal"
        for nm, line, key, fn, plain_ms, lib, nbytes, ops_n in (
                (names[0], 54, "o",
                 lambda: fa._fwd_kernel(q, k, v, True, scale, False),
                 plain_fwd_ms, sdpa_ms, 4 * qb, 2 * prod),
                (names[1], 97, "o",
                 lambda: fa._fwd_kernel(q, k, v, True, scale, True),
                 plain_fwd_ms, sdpa_grad_ms, 4 * qb + rb, 2 * prod),
                (names[2], 113, "dq",
                 lambda: fa._dq_kernel(*ops, True, scale), plain_bwd_ms,
                 sdpa_bwd_ms, 5 * qb + 2 * rb, 3 * prod),
                (names[3], 151, "dk",
                 lambda: fa._dkv_kernel(*ops, True, scale), plain_bwd_ms,
                 sdpa_bwd_ms, 6 * qb + 2 * rb, 4 * prod)):
            entries[nm + tag] = dict(
                path=path, counter=nm, instance=inst,
                replaces=f"{where}:{line}",
                source=src,
                max_abs_err=max(err[key], err["dv"]) if key == "dk"
                else err[key],
                ms=time_ms(fn, iters=5), plain_ms=plain_ms, library_ms=lib,
                bound=bound_ms(nbytes, ops_n), work=work)
        del q, k, v, do, o, lse, ops, dq, dk, dv, qg, kg, vg

    return entries


def phase_c1_kernels(dev):
    """Attention at the shapes the general bf16 instances took (fault C1)
    and at those they still take, and the other general instances, each
    against its plain version (the tolerances of phase 2; decode and
    chunk L2-cold with SDPA beside) under its own counter, one launch a
    call:
    - Qwen2-7B's heads (28 q over 4 kv, GQA rep 7, head_dim 128) over
      pages of C1_BS: the Hopper paged decode (bf16, int8 and fp8 pools)
      and the wgmma chunked prefill with its copy producer, which phase
      6c serves; pages of 12 and of 16 holding the same keys give the
      same bits through both, and the copy producer runs RING_STRESS more
      times, every output's bits compared;
    - the Hopper paged decode at Phi-2's head_dim 80 (32 heads, pages of
      16), Phi-3-mini's 96 (32 heads, pages of 16 and of 12) and
      Gemma-7B's 256 (16 heads) over bf16, int8 and fp8 pools, on its
      padded instances of 128 and 256 columns; the general paged decode
      at head_dim 100 (32 heads; bf16, int8 and fp8 pools) and 132 (16
      heads);
    - the wgmma chunked prefill at Phi-3-mini's head_dim 96 (the
      128-column instance) and at Gemma-7B's head_dim 256 (16 heads, the
      256-column one) over bf16, int8 and fp8 pools, its copy producer at
      96 over pages of 12 RING_STRESS more times, the bits compared; the
      general chunked prefill at head_dim 100 and 132;
    - FlashAttention (forward without and with the LSE, dQ, dK/dV) at
      head_dim 80, 96 and 256 (C1_FLASH: every kernel on its wgmma
      instance of 128 or 256 columns, dK/dV ATTN_STRESS more times, the
      bits compared) and at 100 (every kernel on its general instance),
      T = C1_FLASH_T, causal, each kernel twice (the same bits);
    - the fused_norm_linear q/k/v group at N and K = 4 (mod 8), at a
      decode step's 8 rows and a chunk's 256."""
    from paddle_tpu_torch.kernels import chunked_prefill
    from paddle_tpu_torch.kernels import fused_norm_linear as fnl
    from paddle_tpu_torch.kernels import kv_quant, paged_attention

    g = torch.Generator(device=dev).manual_seed(4)
    bf = torch.bfloat16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape, std=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev,
                            dtype=torch.float32) * std).to(dtype)

    entries = {}
    print(f"[c1 kernels] Qwen2-7B heads on pages of {C1_BS} (Hopper decode, "
          f"wgmma chunk); the padded Hopper decode and the wgmma chunk at "
          f"Phi-2's, Phi-3-mini's and Gemma-7B's head_dims, the general "
          f"decode and chunk at 100 and 132, attention at "
          f"{[c[:2] for c in C1_FLASH]}, "
          f"fused_norm_linear at K="
          f"{C1_FNL_K}, N={C1_FNL_N}; bf16", flush=True)

    # Qwen2-7B's heads: the Hopper decode and the wgmma chunk
    ops = _attn_operands(g, dev, C1_QWEN2)
    groups = paged_attention.hopper_group(28 // 4)[1]
    splits = paged_attention.decode_plan(8, 4, ops["nbs"], C1_BS, sms, groups)
    for scheme, path in ((None, "c1_serve"), ("int8", "quant"),
                         ("fp8", "quant")):
        name = kv_quant.counter_name(paged_attention.KERNEL, scheme)
        entries[name + "_qwen2"] = _decode_entry(ops, scheme, name, path,
                                                 splits)
    ops = _attn_operands(g, dev, C1_QWEN2, T=256, start=768)
    if not chunked_prefill.copy_producer(C1_BS):
        raise AssertionError("pages of 12: not the copy producer")
    entries["chunked_prefill_qwen2"] = _chunk_entry(
        ops, chunked_prefill.KERNEL, "c1_serve")
    args = (ops["q"], ops["k"], ops["v"], ops["bt"], ops["pos"])
    first = chunked_prefill.chunked_attention(*args)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(RING_STRESS):
        bad += (chunked_prefill.chunked_attention(*args) != first).any()
    print(f"  chunked_prefill (copy producer): {RING_STRESS} launches, "
          f"outputs that differ from the first run's: {int(bad)}",
          flush=True)
    if int(bad):
        raise AssertionError(f"copy producer: the ring stress found {bad}")
    del ops, args, first

    # the same keys in pages of 12 (division, copy producer) and of 16
    # (shift, TMA boxes), tables of 1056 keys each: the same bits
    H, KVH, D = C1_QWEN2[1:4]
    pools = _same_keys((12, 16), 1056, 8, KVH, D, g, dev)
    dec = _attn_operands(g, dev, C1_QWEN2)
    q = randn(1, 256, H, D)
    outs = {}
    for bs, (k, v, bt) in pools.items():
        outs[bs] = (
            _one_launch(paged_attention.KERNEL,
                        lambda: paged_attention.paged_decode_attention(
                            dec["q"], dec["c"], dec["s"], k, v, bt,
                            dec["pos"], 1)),
            _one_launch(chunked_prefill.KERNEL,
                        lambda: chunked_prefill.chunked_attention(
                            q, k, v, bt[:1], torch.tensor(
                                [768], dtype=torch.int32, device=dev))))
    same = [torch.equal(a, b) for a, b in zip(outs[12], outs[16])]
    print(f"  pages of 12 and of 16 holding the same 1056 keys a sequence: "
          f"decode ({paged_attention.decode_plan(8, KVH, 88, 12, sms, 1)} "
          f"and {paged_attention.decode_plan(8, KVH, 66, 16, sms, 1)} "
          f"splits) and chunk bit-identical: {same}", flush=True)
    if not all(same):
        raise AssertionError(f"pages of 12 and 16 differ: {same}")
    del pools, dec, q, outs

    # the Hopper decode at Phi-2's head_dim 80, Phi-3-mini's 96 (pages of
    # 16 and of 12) and Gemma-7B's 256 over bf16, int8 and fp8 pools: the
    # padded instances of 128 and 256 columns; their launches are those of
    # the same instance on a main path: 128 columns Phi-3-mini's serving
    # (phase 6p, every pool), 256 the head_dim-256 tiny model (phase 4c)
    for shape, path in ((C1_PHI2, "phi3_serve"), (C1_PHI3, "phi3_serve"),
                        (C1_PHI3_12, "phi3_serve"), (C1_GEMMA, "c1_tiny")):
        ops = _attn_operands(g, dev, shape)
        H, KVH, bs = shape[1], shape[2], shape[4]
        for scheme in (None, "int8", "fp8"):
            splits = paged_attention.decode_plan(
                8, KVH, ops["nbs"], bs, sms, paged_attention.hopper_group(
                    H // KVH)[1], paged_attention.blocks_per_sm(ops["q"],
                                                                scheme))
            name = kv_quant.counter_name(paged_attention.KERNEL, scheme)
            entries[f"{name}_{shape[0]}"] = _decode_entry(ops, scheme, name,
                                                          path, splits)
    # the general decode at head_dim 100 (32 heads; every pool) and 132
    # (16 heads): the head_dims that are not a multiple of 8, 4c's
    for shape in (C1_D100, C1_D132):
        ops = _attn_operands(g, dev, shape)
        splits = paged_attention.general_plan(8, shape[2], ops["nbs"], sms)
        for scheme in (None, "int8", "fp8")[:3 if shape is C1_D100 else 1]:
            name = kv_quant.counter_name(paged_attention.GENERAL, scheme)
            e = _decode_entry(ops, scheme, name, "c1_tiny", splits)
            if scheme is None:
                entries[f"{name}_{shape[0]}"] = e
    # the wgmma chunk at Phi-3-mini's head_dim 96 (the 128-column
    # instance) and Gemma-7B's 256 (the 256-column one) over bf16, int8
    # and fp8 pools; their launches are those of the same instance on a
    # main path: at 96 Llama-3-8B's serving (phase 6, the bf16 pool's TMA
    # boxes, and its quantized pools), at 256 the head_dim-256 tiny model
    # (phase 4c, every pool); the general chunk at 100 and 132 (the
    # instances of head_dim up to 128 and 256: 4c's head_dim-20 and
    # head_dim-132 models)
    for shape, paths in ((C1_PHI3, ("serve", "quant", "quant")),
                         (C1_GEMMA, ("c1_tiny",) * 3)):
        ops = _attn_operands(g, dev, shape, T=256, start=768)
        for scheme, path in zip((None, "int8", "fp8"), paths):
            name = kv_quant.counter_name(chunked_prefill.KERNEL, scheme)
            entries[f"{name}_{shape[0]}"] = _chunk_entry(ops, name, path,
                                                         scheme)
    for shape in (C1_D100, C1_D132):
        ops = _attn_operands(g, dev, shape, T=256, start=768)
        entries[f"{chunked_prefill.GENERAL}_{shape[0]}"] = _chunk_entry(
            ops, chunked_prefill.GENERAL, "c1_tiny")
    # the copy producer at head_dim 96 (pages of 12): RING_STRESS more
    # launches, the bits compared
    ops = _attn_operands(g, dev, C1_PHI3_12, T=256, start=768)
    args = (ops["q"], ops["k"], ops["v"], ops["bt"], ops["pos"])
    first = _one_launch(chunked_prefill.KERNEL,
                        lambda: chunked_prefill.chunked_attention(*args))
    ref = chunked_prefill.chunked_attention_plain(*args)
    check_close("chunked_prefill phi3 D=96 pages of 12 (copy producer)",
                first, ref, bf16_tol(ref))
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for _ in range(RING_STRESS):
        bad += (chunked_prefill.chunked_attention(*args) != first).any()
    print(f"  chunked_prefill D=96 (copy producer, pages of 12): "
          f"{RING_STRESS} launches, outputs that differ from the first "
          f"run's: {int(bad)}", flush=True)
    if int(bad):
        raise AssertionError(f"copy producer D=96: the ring stress found "
                             f"{bad}")
    del ops, args, first, ref

    entries.update(c1_flash_entries(g, dev))

    # fused_norm_linear: a q/k/v group at N and K = 4 (mod 8)
    K = C1_FNL_K
    ws = [randn(K, n, std=K ** -0.5) for n in C1_FNL_N]
    nw = (1 + 0.1 * randn(K, dtype=torch.float32)).to(bf)
    for M, tag in ((8, ""), (256, "_chunk")):
        x = randn(M, K) * 3
        rs = fnl.rms_scale(x, 1e-6)

        def run_kernel():
            return fnl.fused_norm_linear_group(x, rs, nw, ws,
                                               ["none"] * len(ws))

        got = _one_launch(fnl.GENERAL, run_kernel)
        if not all(torch.equal(a, b) for a, b in zip(got, run_kernel())):
            raise AssertionError("fused_norm_linear_general: runs differ")
        errs = []
        for n, w, o in zip(C1_FNL_N, ws, got):
            ref = fnl.fused_norm_linear_plain(x, rs, nw, w)
            errs.append(check_close(f"{fnl.GENERAL} [{M}, {K}] x [{K}, {n}]",
                                    o, ref, bf16_tol(ref)))
        xn = (x.float() * rs).to(bf) * nw
        N_all = sum(C1_FNL_N)
        entries[fnl.GENERAL + tag] = dict(
            path="c1_tiny", counter=fnl.GENERAL,
            replaces="paddle_tpu/kernels/fused_norm_linear.py:60",
            source="paddle_tpu_torch/csrc/fused_norm_linear.cu",
            max_abs_err=max(errs), ms=time_ms(run_kernel, iters=10),
            plain_ms=time_ms(lambda: [fnl.fused_norm_linear_plain(
                x, rs, nw, w) for w in ws], iters=5),
            library_ms=time_ms(lambda: [torch.matmul(xn, w) for w in ws],
                               iters=10),
            bound=bound_ms(2 * (M * K + K + K * N_all + M * N_all) + 4 * M,
                           2.0 * M * K * N_all),
            work=f"a q/k/v group at M={M}, K={K}, N={C1_FNL_N}")
    print("  library: SDPA over gathered K/V (decode, chunk), SDPA forward "
          "and backward (attention), torch.matmul of the normalized rows "
          "(fused_norm_linear)")
    print_entries(entries)
    return entries


# ---------------------------------------------------------------- phase 4
def _prefix_logits(model, tokens, block_size, chunk, kv_cache_dtype=None):
    """f32 last-token logits of ``tokens`` through a fresh one-sequence
    pool of ``kv_cache_dtype`` (the chunked prefill step, as the engine
    runs it)."""
    from paddle_tpu_torch.models.generation import make_chunked_prefill_step
    from paddle_tpu_torch.serving.cache import BlockKVPool

    cfg, dev = model.config, model.device
    n = -(-len(tokens) // block_size)
    pool = BlockKVPool(cfg.num_hidden_layers, n + 1, block_size,
                       cfg.num_key_value_heads, cfg.head_dim,
                       cfg.torch_dtype, device=dev,
                       kv_cache_dtype=kv_cache_dtype)
    nbs = -(-cfg.max_position_embeddings // block_size)
    bt = torch.zeros((1, nbs), dtype=torch.int32, device=dev)
    bt[0, :n] = torch.arange(1, n + 1, dtype=torch.int32)
    step = make_chunked_prefill_step(model, kv_cache_dtype)
    step = getattr(step, "eager", step)      # a reference: no graph
    toks = np.asarray(tokens, np.int32)
    for start in range(0, len(toks), chunk):
        part = toks[start:start + chunk]
        ids = np.zeros((1, chunk), np.int32)
        ids[0, :len(part)] = part
        last = step(torch.tensor(ids, device=dev), pool.layers, bt,
                    torch.tensor([start], dtype=torch.int32, device=dev),
                    len(part) - 1)
    return last[0].cpu()


# (kv_cache_dtype, weight_dtype) of the tiny serving phase's runs
TINY_RUNS = ((None, None), ("int8", None), ("fp8", None), ("fp8", "int8"))


def phase_tiny(dev):
    """LlamaConfig.tiny() in f32, the same seeded weights served on cuda
    and on cpu, from f32, int8 and fp8 KV pools, and from fp8 pools with
    int8 weights (each engine quantizes its own copy of the weights)."""
    for kv, weights in TINY_RUNS:
        _tiny_run(dev, kv, weights)


TINY_MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=2.0)


def phase_tiny_moe(dev):
    """The tiny config with 4 experts, top-2, capacity factor 2.0 (= E /
    K, dropless, so a request's tokens do not depend on its batch mates
    or on the idle slots): served on cuda and on cpu from f32 and fp8
    pools as in phase 4, then trained as in phase 5."""
    from paddle_tpu_torch.models import LlamaConfig

    for kv in (None, "fp8"):
        _tiny_run(dev, kv, None, LlamaConfig.tiny(**TINY_MOE))
    phase_tiny_train(dev, LlamaConfig.tiny(fused_lm_loss=True,
                                           lm_loss_chunk=32, **TINY_MOE))


def _tiny_run(dev, kv_cache_dtype, weight_dtype, cfg=None, block_size=8,
              tol=F32_TOL):
    """The same seeded weights served on cuda and on cpu: 6 requests, a
    shared prefix and forced preemption (a pool of 19 blocks' worth of
    8-token pages); a differing greedy token is excused only where the
    cpu logits' top-2 margin is below ``tol``."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, ServingConfig

    cfg = cfg or LlamaConfig.tiny()
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    cuda_model = LlamaForCausalLM(cfg, device=dev, seed=None)
    cuda_model.load_state_dict(cpu_model.state_dict())
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, cfg.vocab_size, size=24)
    prompts = [np.concatenate([prefix, rng.randint(1, 256, size=5)]),
               rng.randint(1, 256, size=30), rng.randint(1, 256, size=11),
               np.concatenate([prefix, rng.randint(1, 256, size=9)]),
               rng.randint(1, 256, size=40), rng.randint(1, 256, size=3)]
    outs, stats, graphs = {}, {}, {}
    for name, model in (("cpu", cpu_model), ("cuda", cuda_model)):
        eng = Engine(model, ServingConfig(
            max_batch_size=4, block_size=block_size,
            num_blocks=1 + -(-19 * 8 // block_size), chunk_tokens=16,
            kv_cache_dtype=kv_cache_dtype, weight_dtype=weight_dtype))
        reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
        eng.run_until_complete()
        eng.pool.check_leaks()
        outs[name] = [r.generated for r in reqs]
        stats[name] = eng.stats()["counters"]
        graphs[name] = _graph_sizes(eng, f"tiny {name}", sampled=False)
    c = stats["cuda"]
    moe = f", {cfg.moe_num_experts} experts" if cfg.moe_num_experts else ""
    dt = "f32" if cfg.dtype == "float32" else "bf16"
    print(f"[tiny{moe and ' moe'}] {dt}{moe}, KV {kv_cache_dtype or dt}, "
          f"weights {weight_dtype or dt}, pages of {block_size}, "
          f"{len(prompts)} requests: preemptions {c['preemptions']}, "
          f"prefix-cache hits {c['prefix_cache_hits']}; {graphs['cuda']}",
          flush=True)
    if c["preemptions"] == 0 or c["prefix_cache_hits"] == 0:
        raise AssertionError("the tiny phase must preempt and hit the "
                             f"prefix cache: {c}")
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = torch.topk(_prefix_logits(cpu_model, np.concatenate(
            [prompts[i], a[:j]]), block_size, 16, kv_cache_dtype).float(),
            2).values
        margin = float(top2[0] - top2[1])
        print(f"  request {i}: token {j} differs (cpu {a[j]}, cuda {b[j]}), "
              f"cpu top-2 margin {margin:.3e}")
        if margin >= tol:
            raise AssertionError(f"tiny: request {i} token {j} differs "
                                 f"with margin {margin} >= {tol}")
    print("  cuda tokens == cpu tokens", flush=True)


# ---------------------------------------------------------------- phase 5
def attention_counters(cfg, T):
    """{kernel: counter} of the attention of ``cfg``'s model over a
    [1, T] batch, as the package routes it: ``_launch_name`` of each
    kernel on meta tensors laid out as the model's [B, T, H, D] views
    (``_general`` where a general instance takes the kernel)."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    q, k = (torch.empty(1, T, h, cfg.head_dim, dtype=cfg.torch_dtype,
                        device="meta").transpose(1, 2)
            for h in (cfg.num_attention_heads, cfg.num_key_value_heads))
    return {n: fa._launch_name(n, q, k)
            for n in (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV)}


def train_launches(L, grad=True, moe=False, attn=None):
    """Kernel launches of one training step (``grad``) or one forward
    without grad of an L-layer model: two RMSNorms a layer and the final
    one (forward only: their backward is plain PyTorch); RoPE on q and
    k, forward and backward; one attention forward, dQ and dK/dV, under
    the counters ``attn`` names for them ({kernel: counter}; by default
    the kernels' own names: no general instance); with ``moe``, one
    dispatch and one combine a layer, and in the backward each again as
    the other's gradient."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    a = {n: n for n in (fa.FWD, fa.FWD_LSE, fa.BWD_DQ, fa.BWD_DKV)}
    a.update(attn or {})
    if not grad:
        out = {"rms_norm": 2 * L + 1, "rope": 2 * L, a[fa.FWD]: L}
    else:
        out = {"rms_norm": 2 * L + 1, "rope": 4 * L, a[fa.FWD_LSE]: L,
               a[fa.BWD_DQ]: L, a[fa.BWD_DKV]: L}
    if moe:
        out.update(moe_dispatch=L * (1 + grad), moe_combine=L * (1 + grad))
    return out


def train_step(model, opt, tokens, marks=None):
    """One step; ``marks``, two CUDA events, are recorded after the
    backward and after the optimizer step."""
    loss, _ = model(tokens, labels=tokens)
    loss.backward()
    if marks:
        marks[0].record()
    opt.step()
    opt.clear_grad()
    if marks:
        marks[1].record()
    return float(loss.detach())


def phase_tiny_train(dev, cfg=None):
    """LlamaConfig.tiny() in f32 with the fused chunked loss (or ``cfg``),
    the same seeded weights and batch on cpu (plain versions) and on cuda
    (kernels): 5 AdamW steps, losses within F32_TOL."""
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = cfg or LlamaConfig.tiny(fused_lm_loss=True, lm_loss_chunk=32)
    cpu_model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    cuda_model = LlamaForCausalLM(cfg, device=dev, seed=None)
    cuda_model.load_state_dict(cpu_model.state_dict())
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 40)))
    per_step = train_launches(cfg.num_hidden_layers,
                              moe=cfg.moe_num_experts > 0)
    losses = {}
    for name, model in (("cpu", cpu_model), ("cuda", cuda_model)):
        opt = AdamW(1e-3, parameters=model.parameters())
        x = tokens.to(model.device)
        out = []
        for _ in range(5):
            launches.reset()
            out.append(train_step(model, opt, x))
            counts = launches.snapshot()
            want = per_step if name == "cuda" else {}
            if counts != want:
                raise AssertionError(f"tiny train on {name}: launches "
                                     f"{counts} != {want}")
        losses[name] = out
    diff = float(np.abs(np.subtract(losses["cuda"], losses["cpu"])).max())
    moe = f", {cfg.moe_num_experts} experts" if cfg.moe_num_experts else ""
    print(f"[tiny train] f32{moe}, 5 AdamW steps: cuda losses "
          f"{[round(x, 6) for x in losses['cuda']]}, max |cuda - cpu| "
          f"{diff:.2e} (tolerance {F32_TOL:.0e}); launches a step "
          f"{per_step}", flush=True)
    if not diff <= F32_TOL or not losses["cuda"][-1] < losses["cuda"][0]:
        raise AssertionError(f"tiny train: losses {losses}")


# --------------------------------------------------------------- phase 4c
# the tiny C1 models in bf16: hidden 140 and 7 query heads over 1 kv head
# (rep 7, head_dim 20), intermediate 92 (N and K = 4 mod 8); hidden 512
# and 2 query heads over 1 kv head (head_dim 256, Gemma's width); hidden
# 264 and 2 query heads over 1 kv head (head_dim 132: the general
# attention and chunk instances of head_dim up to 256); each served from
# pages of C1_BS tokens
C1_TINY = dict(dtype="bfloat16", hidden_size=140, num_attention_heads=7,
               num_key_value_heads=1, intermediate_size=92)
C1_TINY_D256 = dict(dtype="bfloat16", hidden_size=512, num_attention_heads=2,
                    num_key_value_heads=1)
C1_TINY_D132 = dict(dtype="bfloat16", hidden_size=264, num_attention_heads=2,
                    num_key_value_heads=1)
# a greedy token of the bf16 tiny model may differ between cuda and cpu
# only where the cpu logits' top-2 margin is below 3 bf16 ulps of logits
# of magnitude 2 to 4 (2^-6 each): the two round at other places
BF16_MARGIN = 3 * 2.0 ** -6
C1_GENERAL = ("fused_norm_linear_general", "paged_decode_general",
              "chunked_prefill_general", "flash_attention_fwd_general",
              "flash_attention_fwd_lse_general",
              "flash_attention_bwd_dq_general",
              "flash_attention_bwd_dkv_general")
# the head_dim-256 model's attention and chunk: the wgmma instances of
# 256 columns, under the kernels' own names
C1_WGMMA_256 = ("flash_attention_fwd", "flash_attention_fwd_lse",
                "flash_attention_bwd_dq", "flash_attention_bwd_dkv",
                "chunked_prefill")
# the instances phase 4c must launch: the general attention and chunk of
# head_dim up to 128 (the head_dim-20 model) and 256 (head_dim 132); at
# head_dim 256 the 256-column attention, the chunk by its copy producer
# (pages of C1_BS), by TMA boxes (pages of 8) and over int8 and fp8 code
# pools (pages of 8), and the padded 256-column decode over every pool
C1_INSTANCES = (
    *(f"{n}_general@maxd{d}" for n in C1_WGMMA_256 for d in (128, 256)),
    *(f"{n}@w256" for n in C1_WGMMA_256[:4]),
    "chunked_prefill@w256_copy", "chunked_prefill@w256_tma",
    "chunked_prefill_int8@w256_codes16", "chunked_prefill_fp8@w256_codes16",
    "paged_decode@w256_pad", "paged_decode_int8@w256_pad",
    "paged_decode_fp8@w256_pad")


def phase_tiny_c1(dev):
    """The tiny C1 models (C1_TINY, C1_TINY_D256, C1_TINY_D132) each
    served on cuda and on cpu from the same seeded weights (tokens as in
    phase 4, the margin BF16_MARGIN), the head_dim-256 one also from
    bf16, int8 and fp8 pools of 8-token pages, then one training step on
    both (with the fused chunked loss): the loss and every gradient held,
    against the same step in f32 on the cpu, to twice the bf16 cpu step's
    error plus one bf16 rounding (2^-9) of the largest entry; then an
    eval forward without grad on cuda.  The launch counts, set to 0
    before and read after, must show every general instance (all of the
    head_dim-20 model's), the 256-column wgmma attention and chunk and
    the padded 256-column decode (the head_dim-256 model's) and each
    instance of C1_INSTANCES.  Returns
    them, with the instances' (``phase_counts``)."""
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaConfig

    launches.reset()
    for kw in (C1_TINY, C1_TINY_D256, C1_TINY_D132):
        cfg = LlamaConfig.tiny(**kw)
        _tiny_run(dev, None, None, cfg, block_size=C1_BS, tol=BF16_MARGIN)
        if kw is C1_TINY_D256:
            for scheme in (None, "int8", "fp8"):
                _tiny_run(dev, scheme, None, cfg, tol=BF16_MARGIN)
        _tiny_c1_train(dev, kw)
    counts = phase_counts()
    print(f"[tiny c1] launches {counts}", flush=True)
    missing = [k for k in C1_GENERAL + C1_WGMMA_256 + C1_INSTANCES
               if not counts.get(k)]
    if missing:
        raise AssertionError(f"tiny c1: no launch of {missing}")
    return counts


def _tiny_c1_train(dev, kw):
    """One training step of the tiny bf16 model of ``kw`` on cuda and cpu
    against the same step in f32 on the cpu (phase_tiny_c1), its
    attention launches a step those its head_dim routes to (head_dim 20:
    every general instance; 256: the wgmma ones), then an eval
    forward."""
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    tcfg = LlamaConfig.tiny(fused_lm_loss=True, lm_loss_chunk=32, **kw)
    f32cfg = LlamaConfig.tiny(fused_lm_loss=True, lm_loss_chunk=32,
                              **{**kw, "dtype": "float32"})
    cpu = LlamaForCausalLM(tcfg, device="cpu", seed=0)
    models = {"cpu": cpu,
              "cuda": LlamaForCausalLM(tcfg, device=dev, seed=None),
              "f32": LlamaForCausalLM(f32cfg, device="cpu", seed=None)}
    models["cuda"].load_state_dict(cpu.state_dict())
    models["f32"].load_state_dict({k: v.float()
                                   for k, v in cpu.state_dict().items()})
    tokens = torch.from_numpy(np.random.RandomState(1).randint(
        0, tcfg.vocab_size, (2, 40)))
    before = launches.snapshot()
    out = {}
    for name, model in models.items():
        loss, _ = model(tokens.to(model.device), labels=tokens.to(
            model.device))
        loss.backward()
        out[name] = {"loss": loss.detach().float().cpu().reshape(1), **{
            n: p.grad.float().cpu() for n, p in model.named_parameters()}}
        if name == "cuda":
            step = {k: n - before.get(k, 0) for k, n in
                    launches.snapshot().items() if n != before.get(k, 0)}
            want = train_launches(tcfg.num_hidden_layers, attn=
                                  attention_counters(tcfg, tokens.shape[1]))
            if step != want:
                raise AssertionError(f"tiny c1 train: launches {step} != "
                                     f"{want}")
            # an eval forward without grad: the forward without the LSE
            with torch.no_grad():
                eval_loss = float(model(tokens.to(dev), labels=tokens.to(
                    dev))[0])
            if not math.isfinite(eval_loss):
                raise AssertionError(f"tiny c1 eval: loss {eval_loss}")
    worst = 0.0
    for key, ref in out["f32"].items():
        err = float((out["cuda"][key] - ref).abs().max())
        cpu_err = float((out["cpu"][key] - ref).abs().max())
        tol = 2 * cpu_err + float(ref.abs().max()) * 2.0 ** -9
        worst = max(worst, err / tol if tol else 0.0)
        if not (math.isfinite(err) and err <= tol):
            raise AssertionError(f"tiny c1 train: {key} off the f32 step by "
                                 f"{err} (bf16 cpu {cpu_err}; tolerance "
                                 f"{tol})")
    print(f"[tiny c1 train] bf16, {tcfg.num_attention_heads} q over "
          f"{tcfg.num_key_value_heads} kv heads, D={tcfg.head_dim}: loss "
          f"cuda {float(out['cuda']['loss']):.5f}, cpu "
          f"{float(out['cpu']['loss']):.5f}, f32 "
          f"{float(out['f32']['loss']):.5f}; the loss and "
          f"{len(out['f32']) - 1} gradients within their tolerances (worst "
          f"at {worst:.3f} of it)", flush=True)


def phase_c1_main(dev):
    """Serving at Qwen2-7B's widths (qwen2_7b_config: 28 q over 4 kv
    heads, rep 7), bf16, 4 of its 28 layers, random weights from seed 0,
    behind serving.Engine with pages of C1_BS tokens and phase 6's 8
    requests: its decode steps take the Hopper paged decode (rep 7 as
    blocks of 4 and 3 heads, pages found by division) and its prefill
    chunks the wgmma chunked prefill (pages of 12 by the copy producer);
    no general instance may launch.  Returns the launch counts."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = qwen2_7b_config(num_hidden_layers=C1_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main c1] Qwen2-7B width, bf16, {cfg.num_hidden_layers} of 28 "
          f"layers, {n_params / 1e9:.3f} B parameters, {cfg.num_attention_heads}"
          f" q over {cfg.num_key_value_heads} kv heads, pages of {C1_BS}, "
          f"random weights (seed 0) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    prompts = _main_prompts(cfg.vocab_size)
    num_blocks = 1 + sum(-(-(len(p) + MAIN_NEW) // C1_BS)
                         for p in prompts) + 8
    out, counts, _ = _serve_main(model, prompts, "main c1",
                                 block_size=C1_BS, num_blocks=num_blocks)
    out["n_params"] = n_params
    general = sorted(k for k in counts if "_general" in k)
    if general:
        raise AssertionError(f"main c1: general instances launched: "
                             f"{general}")
    print(f"  {out['tokens_per_s']:.1f} tokens/s, mean TTFT "
          f"{out['mean_ttft_s']:.3f} s, mean TPOT "
          f"{out['mean_tpot_s'] * 1e3:.1f} ms; peak "
          f"{out['peak_mem_gb']:.1f} GB; counters that ran: "
          f"{sorted(counts)}", flush=True)
    print(f"  {json.dumps(out)}", flush=True)
    return counts


# --------------------------------------------------------------- phase 6p
PHI3_RUNS = (None, "int8", "fp8")   # the KV pools phase 6p serves from


def phase_phi3_main(dev, strict=True):
    """Phase 6p: serving at Phi-3-mini's widths (phi3_mini_config: 32
    heads of 96, hidden 3072, intermediate 8192), all 32 layers (3.8 B
    parameters, 7.6 GB in bf16), random weights from seed 0, behind
    serving.Engine with phase 6's 8 requests over pages of MAIN_BS, from
    a bf16 pool, then from int8 and fp8 pools of the bf16 pool's bytes
    (PHI3_RUNS), each with its greedy log-prob drift against the bf16
    pool as in phase 6's quantized runs.  Each run's launch counts are
    exact (``_serve_main``); with ``strict`` every decode step also
    launches the paged decode on its padded 128-column instance exactly
    once a layer, every prefill chunk the 128-column wgmma chunk, and no
    general instance launches (``tools/turns`` passes ``strict=False``
    for an older package, whose routes set its expected counts).
    Prints the phase's wall time.  Returns the launch counts summed over
    the runs."""
    from paddle_tpu_torch.kernels import chunked_prefill, paged_attention
    from paddle_tpu_torch.kernels.kv_quant import counter_name
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.serving.cache import BlockKVPool

    t_phase = time.perf_counter()
    cfg = phi3_mini_config()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    L, KVH = cfg.num_hidden_layers, cfg.num_key_value_heads
    print(f"[main phi3] Phi-3-mini width, bf16, {L} of 32 layers, "
          f"{n_params / 1e9:.3f} B parameters, {cfg.num_attention_heads} "
          f"heads of {cfg.head_dim}, pages of {MAIN_BS}, random weights "
          f"(seed 0) in {time.perf_counter() - t_phase:.1f} s", flush=True)
    prompts = _main_prompts(cfg.vocab_size)
    blocks = 1 + sum(-(-(len(p) + MAIN_NEW) // MAIN_BS) for p in prompts) + 8
    bf16_block = BlockKVPool.block_bytes_for(L, MAIN_BS, KVH, cfg.head_dim,
                                             cfg.torch_dtype)
    long_prompt = prompts[6]                         # 1024 tokens
    ref = _prefix_logits(model, long_prompt, MAIN_BS, 256)
    tok = int(ref.argmax())
    ref_lp = _logprob(ref, tok)
    total = {}
    for kv in PHI3_RUNS:
        tag = f"main phi3 {kv or 'bf16'}"
        out, counts, eng = _serve_main(model, prompts, tag, kv,
                                       kv_pool_bytes=blocks * bf16_block)
        del eng
        gc.collect()
        out["n_params"] = n_params
        if kv is not None:
            logits = _prefix_logits(model, long_prompt, MAIN_BS, 256, kv)
            out["greedy_logprob_delta"] = abs(_logprob(logits, tok) - ref_lp)
            if not math.isfinite(out["greedy_logprob_delta"]):
                raise AssertionError(f"{tag}: non-finite prefill logits")
        if strict:
            general = sorted(k for k in counts if "_general" in k)
            want = {
                counter_name(paged_attention.KERNEL, kv) + "@w128_pad":
                    L * out["decode_iterations"],
                counter_name(chunked_prefill.KERNEL, kv) + "@w128_" +
                ("tma" if kv is None else "codes16"):
                    L * out["prefill_chunks"]}
            got = {k: counts.get(k, 0) for k in want}
            if general or got != want:
                raise AssertionError(f"{tag}: instances {got} != {want}, "
                                     f"general instances {general}")
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        drift = out.get("greedy_logprob_delta")
        print(f"  {out['tokens_per_s']:.1f} tokens/s, mean TTFT "
              f"{out['mean_ttft_s']:.3f} s, mean TPOT "
              f"{out['mean_tpot_s'] * 1e3:.1f} ms; {out['num_blocks']} "
              f"blocks of {out['block_bytes']} bytes; peak "
              f"{out['peak_mem_gb']:.1f} GB"
              + ("" if drift is None else "; greedy log-prob delta of the "
                 f"1024-token prefill vs the bf16 model {drift:.4e}"),
              flush=True)
        print(f"  {json.dumps(out)}", flush=True)
    print(f"[main phi3] {len(PHI3_RUNS)} runs in "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    return total


# ---------------------------------------------------------------- phase 6
MAIN_BS, MAIN_NEW = 16, 32      # block size, new tokens a request


def _main_prompts(V):
    """The 8 requests of the main serving phases: prompts of 128..1024
    tokens, the first and the last sharing a 512-token prefix."""
    rng = np.random.RandomState(0)
    prefix = rng.randint(1, V, size=512)
    lens = [128, 256, 384, 640, 768, 1024]
    return [np.concatenate([prefix, rng.randint(1, V, size=100)])] + \
        [rng.randint(1, V, size=n) for n in lens] + \
        [np.concatenate([prefix, rng.randint(1, V, size=200)])]


def step_launches(cfg, bs, kv_cache_dtype=None):
    """The launches of one decode step and of one prefill chunk of a
    serving engine over ``cfg``'s model, pages of ``bs`` tokens and a KV
    pool of ``kv_cache_dtype``: ({counter: n}, {counter: n})."""
    from paddle_tpu_torch.kernels import chunked_prefill, paged_attention
    from paddle_tpu_torch.kernels.kv_quant import KERNEL as WRITE
    from paddle_tpu_torch.kernels.kv_quant import counter_name

    L = cfg.num_hidden_layers
    # which kernel of each family the model's shapes take (the wrappers'
    # routes; a *_general one only where the fast kernel is not built for
    # them: the C1 phase's)
    H, KVH, D = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    q = torch.empty((1, 1, H, D), dtype=cfg.torch_dtype, device="meta")
    pool = torch.empty((1, bs, KVH, D), dtype=cfg.torch_dtype, device="meta")
    hopper = paged_attention.hopper_path(q[0], pool, pool, H // KVH)
    wgmma = chunked_prefill.wgmma_width(q, pool, pool) is not None
    fast = all(n % 8 == 0 for n in (cfg.hidden_size, H * D, KVH * D,
                                    cfg.intermediate_size))
    fnl_decode = "fused_norm_linear_skinny" if fast \
        else "fused_norm_linear_general"
    fnl_chunk = "fused_norm_linear_tiled" if fast \
        else "fused_norm_linear_general"
    # the input norm's row scale and one launch for q/k/v in every layer;
    # a dense layer's post-attention row scale and one launch for gate/up,
    # a MoE layer's post-attention rms_norm (dispatch reads the normed
    # rows), one dispatch and one combine; the final norm
    n_fnl = L if cfg.moe_num_experts else 2 * L
    per_decode = {"rms_norm": 1, "rms_scale": n_fnl, fnl_decode: n_fnl}
    per_chunk = {"rms_norm": 1, "rms_scale": n_fnl, fnl_chunk: n_fnl}
    if cfg.moe_num_experts:
        for per in (per_decode, per_chunk):
            per.update(rms_norm=L + 1, moe_dispatch=L, moe_combine=L)
    per_decode[counter_name(paged_attention.KERNEL if hopper
                            else paged_attention.GENERAL, kv_cache_dtype)] = L
    per_chunk[counter_name(chunked_prefill.KERNEL if wgmma
                           else chunked_prefill.GENERAL, kv_cache_dtype)] = L
    # the KV write, one launch a layer into every kind of pool
    per_decode[WRITE] = per_chunk[WRITE] = L
    return per_decode, per_chunk


def _serve_main(model, prompts, tag, kv_cache_dtype=None, weight_dtype=None,
                block_size=MAIN_BS, submit_kwargs=None, stream=None,
                requests=None, **pool_size):
    """One run of the main serving path: the 8 requests through
    ``serving.Engine`` with the launch counts set to 0 just before and
    read just after, held to exact counts, no leak, and the 128-token
    request's first token equal to a fresh prefill's through a pool of
    the same KV dtype.  ``submit_kwargs`` (one dict a request) adds to
    each submit, as phase 6s's sampling; request ``stream`` is served
    through ``serving.sse_stream``, whose frames must decode to exactly
    its tokens, its summary and ``[DONE]``; ``requests`` (a list)
    receives the requests in submit order.  Prints the run's numbers, a
    digest of its tokens (to compare runs of two versions) and one
    profiled decode (greedy and, where one ran, sampled) and prefill
    step, and the sampler's share of the sampled step.  Returns
    (numbers, launch counts, engine)."""
    from types import SimpleNamespace

    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.serving import Engine, ServingConfig

    cfg, V, bs, new = model.config, model.config.vocab_size, block_size, \
        MAIN_NEW
    kws = submit_kwargs or [{}] * len(prompts)
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, ServingConfig(
        max_batch_size=8, block_size=bs, chunk_tokens=256,
        kv_cache_dtype=kv_cache_dtype, weight_dtype=weight_dtype,
        **pool_size))
    captured = _capture_steps(eng)
    # an older package's engine has no graphs (tools/turns runs it)
    graphs = hasattr(eng, "decode_cache_size")
    sampled = any(kws)
    if graphs:
        _warm_graphs(eng, sampled)
    torch.cuda.synchronize()
    late = len(prompts) - 1
    reqs = [None] * len(prompts)

    def submit(i, **extra):
        reqs[i] = eng.submit(prompts[i], max_new_tokens=new, **kws[i],
                             **extra)
        return reqs[i]

    def step():
        more = eng.step()
        # the last prompt shares the first one's 512-token prefix: submit
        # it once that prefix is registered, so it is served from the cache
        if reqs[late] is None and reqs[0].generated:
            submit(late)
            return True
        return more

    def submit_streamed(prompt, **kw):
        # sse_stream's submit: the streamed request, then the ones after
        # it, in the order the other runs submit them
        reqs[stream] = eng.submit(prompt, **kw)
        for i in range(stream + 1, late):
            submit(i)
        return reqs[stream]

    launches.reset()
    t0 = time.perf_counter()
    for i in range(late if stream is None else stream):
        submit(i)
    frames = None
    if stream is not None:
        from paddle_tpu_torch.serving import sse_stream
        frames = list(sse_stream(
            SimpleNamespace(submit=submit_streamed, step=step),
            prompts[stream], max_new_tokens=new, **kws[stream]))
    while step():
        pass
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tally = launches.snapshot(), phase_counts()
    st = eng.stats()
    eng.pool.check_leaks()
    for r in reqs:
        if r.finish_reason != "length" or len(r.generated) != new or \
                not all(0 <= t < V for t in r.generated):
            raise AssertionError(f"{tag} {r.request_id}: {r.finish_reason}, "
                                 f"{len(r.generated)} tokens")
    if requests is not None:
        requests.extend(reqs)
    if frames is not None:
        _check_sse(tag, frames, reqs[stream])
    digest = hashlib.sha1(json.dumps(
        [[int(t) for t in r.generated] for r in reqs]).encode()).hexdigest()
    print(f"  {tag}: {'greedy ' if submit_kwargs is None else ''}tokens "
          f"{digest[:16]}", flush=True)
    ctr = st["counters"]
    L = cfg.num_hidden_layers
    chunks, decodes = ctr["prefill_chunks"], ctr["decode_iterations"]
    per_decode, per_chunk = step_launches(cfg, bs, kv_cache_dtype)
    expect = {k: per_decode.get(k, 0) * decodes + per_chunk.get(k, 0) * chunks
              for k in {**per_decode, **per_chunk}}
    print(f"  launches {counts} over {chunks} prefill chunks and {decodes} "
          f"decode steps; expected per decode step {per_decode}, per "
          f"prefill chunk {per_chunk}", flush=True)
    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts} != {expect}")
    general = sorted(k for k in counts if "_general" in k)
    print(f"  general instances launched: {general or 'none'}", flush=True)
    if graphs:
        print(f"  {_graph_sizes(eng, tag, sampled)}", flush=True)
    # the 128-token request's first token again, through a fresh pool
    ref = _prefix_logits(model, prompts[1], bs, 256, kv_cache_dtype)
    if not torch.isfinite(ref).all() or int(ref.argmax()) != \
            reqs[1].generated[0]:
        raise AssertionError(f"{tag}: the engine's first token disagrees "
                             "with a fresh prefill of the same prompt")
    tok = ctr["tokens_generated"]
    rq = st["requests"].values()
    ttft = [r["ttft_s"] for r in rq]
    tpot = [r["tpot_s"] for r in rq if r["tpot_s"] is not None]
    out = dict(tokens_per_s=tok / wall, wall_s=wall,
               mean_ttft_s=float(np.mean(ttft)),
               mean_tpot_s=float(np.mean(tpot)), tokens=tok,
               prompt_tokens=int(sum(len(p) for p in prompts)),
               greedy_tokens=digest[:16],
               prefix_cache_hits=ctr["prefix_cache_hits"],
               prefill_chunks=chunks, decode_iterations=decodes,
               layers=L, kv_dtype=st["pool"]["kv_dtype"],
               weight_dtype=weight_dtype, num_blocks=eng.num_blocks,
               block_bytes=st["pool"]["block_bytes"],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    if graphs:
        out["graph_capture_s"] = {
            label.split("::")[1]: c["compile_seconds"]
            for label, c in st["compiles"].items() if c["compiles"]}
    for what, unit in (("decode", "slots running"),
                       ("sampled decode", "slots running"),
                       ("prefill", "tokens a chunk")):
        if what not in captured:
            continue
        n, fn, args = captured[what]
        with _slot_state(eng, args) as bound:
            wall, span, dev_ms, top, kernels = _step_profile(fn, bound)
        mid = float(np.median(dev_ms))
        busy = f"busy {mid / wall:.1%}" if mid else "not measured"
        each = ", ".join(f"{ms:.3f} ms in {k}" for ms, k in
                         zip(dev_ms, kernels))
        print(f"  {what} step ({n} {unit}): {wall:.3f} ms on the host's "
              f"clock, {span:.3f} ms between CUDA events; kernels of "
              f"{len(dev_ms)} profiled steps: {each} ({busy})", flush=True)
        for name, ms, count in top:
            print(f"    {ms:8.3f} ms  {count:5d}x  {name[:90]}")
        key = what.replace(" ", "_")
        out[f"{key}_step_host_ms"] = wall
        out[f"{key}_step_span_ms"] = span
        out[f"{key}_step_device_ms"] = dev_ms
        out[f"{key}_step_kernels"] = kernels
        if what == "sampled decode":
            out.update(_sampler_share(model, kv_cache_dtype, args, mid))
    return out, tally, eng


def _main_model(dev):
    """Phase 6's model (Llama-3-8B width, MAIN_LAYERS layers, bf16, seed
    0), its requests and its pool's blocks."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=MAIN_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[main] Llama-3-8B width, bf16, {cfg.num_hidden_layers} of 32 "
          f"layers, random weights (seed 0) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts = _main_prompts(cfg.vocab_size)
    num_blocks = 1 + sum(-(-(len(p) + MAIN_NEW) // MAIN_BS)
                         for p in prompts) + 8
    return model, prompts, num_blocks


def phase_main(dev):
    """Phase 6, then 6s, 6g, 6o and 6sp on the same model.  Returns phase
    6's launch counts and pool size, 6sp's launch counts and its kernel
    rows."""
    model, prompts, num_blocks = _main_model(dev)
    greedy = []
    out, counts, eng = _serve_main(model, prompts, "main",
                                   num_blocks=num_blocks, requests=greedy)
    print(f"  {json.dumps(out)}", flush=True)
    del eng
    gc.collect()
    phase_main_sampled(model, prompts, num_blocks, greedy, out)
    phase_main_graphs(dev, model)
    free()
    phase_main_overload(model, prompts, greedy, out)
    free()
    spec_counts, spec_entries = phase_main_spec(model, prompts, greedy, out)
    return counts, num_blocks, spec_counts, spec_entries


# ---------------------------------------------------------------- phase 6s
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)   # requests 0, 2, 4, 6
STREAMED = 5                    # the request phase 6s serves through SSE


def phase_main_sampled(model, prompts, num_blocks, greedy, main_out):
    """Phase 6s: phase 6's model, requests, submit order and pool, with
    requests 0, 2, 4 and 6 sampled (SAMPLED, seed 1000 + i) and request
    STREAMED streamed through ``sse_stream``; served twice, each time on
    a fresh engine.  Each run is held to phase 6's checks (exact launch
    counts: the sampled step launches phase 6's kernels, its sampler is
    torch ops), its greedy requests' tokens to phase 6's bit for bit, and
    its SSE frames to the streamed request's tokens; the two runs must
    give the same sampled tokens.  Prints the sampled digest, each run's
    numbers beside phase 6's (``main_out``), one profiled sampled decode
    step and the sampler's share of it."""
    kws = [dict(SAMPLED, seed=1000 + i) if i % 2 == 0 else {}
           for i in range(len(prompts))]
    print(f"[main sampled] phase 6's model and requests; requests "
          f"{[i for i, k in enumerate(kws) if k]} sampled ({SAMPLED}, seed "
          f"1000 + i), request {STREAMED} streamed through sse_stream",
          flush=True)
    digests = []
    for attempt in ("first", "second"):
        tag = f"main sampled ({attempt} run)"
        reqs = []
        out, _, eng = _serve_main(model, prompts, tag, submit_kwargs=kws,
                                  stream=STREAMED, requests=reqs,
                                  num_blocks=num_blocks)
        del eng
        gc.collect()
        for i, (r, g) in enumerate(zip(reqs, greedy)):
            if not kws[i] and r.generated != g.generated:
                raise AssertionError(
                    f"{tag}: greedy request {i}'s tokens differ from phase "
                    "6's")
        digest = hashlib.sha1(json.dumps(
            [[int(t) for t in r.generated] for i, r in enumerate(reqs)
             if kws[i]]).encode()).hexdigest()[:16]
        digests.append(digest)
        out["sampled_tokens"] = digest
        print(f"  {tag}: sampled tokens {digest}; greedy requests equal "
              f"phase 6's; {out['tokens_per_s']:.1f} tokens/s (phase 6 "
              f"{main_out['tokens_per_s']:.1f}), mean TTFT "
              f"{out['mean_ttft_s']:.3f} s ({main_out['mean_ttft_s']:.3f}),"
              f" mean TPOT {out['mean_tpot_s'] * 1e3:.1f} ms "
              f"({main_out['mean_tpot_s'] * 1e3:.1f})", flush=True)
        print(f"  {json.dumps(out)}", flush=True)
    if digests[0] != digests[1]:
        raise AssertionError(f"main sampled: the two runs sampled other "
                             f"tokens ({digests})")


# ---------------------------------------------------------------- phase 6g
GRAPH_NEW = 8                   # new tokens a request of phase 6g
GRAPH_STEPS = ("decode_step", "prefill_step", "sampled_decode_step")


def phase_main_graphs(dev, model=None):
    """Phase 6g: the engine's CUDA graphs against their eager functions,
    on phase 6's model (Llama-3-8B width, MAIN_LAYERS layers, bf16;
    built from seed 0 when not given).  An engine serves requests 0-3 of
    phase 6 (0 and 2 sampled as in 6s), then request 1 again (greedy),
    with spies keeping a copy of the arguments of the last call of each
    step.  Each step is replayed on those inputs over the engine's pools
    (the sampled step over its per-slot tensors, ``_slot_state``) and
    run eagerly (``GraphStep.eager``) on a copy of the pools as they
    were: its logits (the sampled step's tokens) and the pools after it
    must be equal bit for bit, and both must count the same launches.
    A second engine captures its own graphs, counts its own compiles and
    gives the first one's tokens; a rebound pool under
    ``strict_no_retrace`` raises RetraceError; without it the engine
    counts one retrace of each step and serves requests 4 and 5 as an
    engine whose pool stayed put does."""
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import RetraceError
    from paddle_tpu_torch.serving import Engine, ServingConfig

    t_phase = time.perf_counter()
    if model is None:
        model = LlamaForCausalLM(LlamaConfig.llama3_8b(
            num_hidden_layers=MAIN_LAYERS), device=dev, seed=0)
    prompts = _main_prompts(model.config.vocab_size)
    first, second = prompts[:4], prompts[4:6]
    kws = [dict(SAMPLED, seed=1000 + i) if i % 2 == 0 else {}
           for i in range(len(first))]
    num_blocks = 1 + sum(-(-(len(p) + GRAPH_NEW) // MAIN_BS)
                         for p in prompts[:6]) + 8
    print(f"[main graphs] phase 6's model, pages of {MAIN_BS}, "
          f"{num_blocks} blocks: requests 0-3 (0 and 2 sampled), then 1 "
          "again", flush=True)

    def engine(**kw):
        return Engine(model, ServingConfig(
            max_batch_size=8, block_size=MAIN_BS, chunk_tokens=256,
            num_blocks=num_blocks, **kw))

    def serve(eng, batch, batch_kws):
        reqs = [eng.submit(p, max_new_tokens=GRAPH_NEW, **kw)
                for p, kw in zip(batch, batch_kws)]
        eng.run_until_complete()
        return [[int(t) for t in r.generated] for r in reqs]

    def first_workload(eng):
        # every step runs: the sampled one while 0 or 2 decode, the
        # greedy one for request 1 served alone
        return serve(eng, first, kws) + serve(eng, prompts[1:2], [{}])

    def compiles(eng):
        return [eng._steps[n].compiles for n in GRAPH_STEPS]

    eng = engine()
    calls = {}
    for name in GRAPH_STEPS:
        # around whatever the engine calls (tools/turns wraps it too)
        def spy(*args, name=name, step=getattr(eng, f"_{name}")):
            calls[name] = _copied(args)
            return step(*args)
        setattr(eng, f"_{name}", spy)
    tokens = first_workload(eng)
    for name in GRAPH_STEPS:
        step, args = eng._steps[name], calls[name]
        pools = args[1]
        before = [tuple(t.clone() for t in e) for e in pools]
        with _slot_state(eng, args) as bound:
            mark = launches.mark()
            got = step(*bound).clone()
            graph_counts = launches.since(mark)
            copies = [tuple(t.clone() for t in e) for e in before]
            mark = launches.mark()
            want = step.eager(*_on_device(bound[:1], dev), copies,
                              *_on_device(bound[2:], dev))
            torch.cuda.synchronize()
            eager_counts = launches.since(mark)
        pools_equal = all(torch.equal(a, b) for e, c in zip(pools, copies)
                          for a, b in zip(e, c))
        n, same = sum(graph_counts[0].values()), torch.equal(got, want)
        print(f"  {name}: replay against eager on {tuple(got.shape)} "
              f"{got.dtype}: {'equal bit for bit' if same else 'DIFFER'}; "
              f"pools after it {'equal' if pools_equal else 'DIFFER'}; {n} "
              f"launches counted by the replay, "
              f"{sum(eager_counts[0].values())} by the eager run",
              flush=True)
        if not same:
            diff = (got.float() - want.float()).abs()
            raise AssertionError(
                f"main graphs: {name}'s replay differs from its eager "
                f"function (max abs {float(diff.max()):.3e} at "
                f"{int(diff.argmax())}, argmax equal "
                f"{torch.equal(got.argmax(-1), want.argmax(-1))})")
        if not pools_equal or graph_counts != eager_counts or n == 0:
            raise AssertionError(f"main graphs: {name}: pools equal "
                                 f"{pools_equal}, launches {graph_counts} "
                                 f"against {eager_counts}")
        for e, b in zip(pools, before):         # the pools as they were
            for a, x in zip(e, b):
                a.copy_(x)
        del before, copies
    if compiles(eng) != [1, 1, 1]:
        raise AssertionError(f"main graphs: compiles {compiles(eng)}")
    capture_s = {n: eng._steps[n].compile_seconds for n in GRAPH_STEPS}

    other = engine()                            # strict_no_retrace
    if first_workload(other) != tokens or compiles(other) != [1, 1, 1] \
            or compiles(eng) != [1, 1, 1]:
        raise AssertionError(f"main graphs: a second engine's tokens or "
                             f"compiles ({compiles(other)}, the first "
                             f"{compiles(eng)}) differ")
    other.pool.layers = [tuple(t.clone() for t in e)
                         for e in other.pool.layers]
    try:
        serve(other, second, [{}, {}])
    except RetraceError as e:
        print(f"  strict_no_retrace, a rebound pool: RetraceError "
              f"({str(e)[:72]}...)", flush=True)
    else:
        raise AssertionError("main graphs: a rebound pool did not raise "
                             "under strict_no_retrace")
    del other
    free()
    counted = engine(strict_no_retrace=False)
    first_workload(counted)
    counted.pool.layers = [tuple(t.clone() for t in e)
                           for e in counted.pool.layers]
    got = serve(counted, second, [{}, {}])
    want = serve(eng, second, [{}, {}])
    retraces = [counted._steps[n].retraces for n in GRAPH_STEPS]
    if got != want or retraces != [1, 1, 0]:
        raise AssertionError(f"main graphs: after a rebound pool, tokens "
                             f"equal {got == want}, retraces {retraces}")
    print(f"  strict_no_retrace=False, a rebound pool: retraces "
          f"{dict(zip(GRAPH_STEPS, retraces))}, requests 4 and 5 as an "
          f"engine whose pool stayed put; a second engine's own compiles "
          f"and tokens; capture seconds "
          + ", ".join(f"{k} {v:.3f}" for k, v in capture_s.items())
          + f"; phase 6g in {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# ---------------------------------------------------------------- phase 6o
OVERLOAD_NEW = 16               # new tokens a request of phase 6o's ladder
WATCHED = dict(watchdog_floor_s=0.25, watchdog_budget_mult=50.0,
               step_max_retries=1, health_recovery_steps=2)
OVERLOAD_METRICS = ("serving_watchdog_stalls_total",
                    "serving_step_retries_total", "serving_requests_shed",
                    "serving_requests_timed_out", "serving_requests_failed",
                    "serving_requests_rejected", "serving_preemptions",
                    "serving_degradation_level", "serving_health_state",
                    "serving_requests_completed", "xla_")


def _overload_engine(model, num_blocks, **kw):
    """A fresh engine on phase 6's model and pages, its prefill and decode
    graphs captured before it serves (as a server does at start-up): its
    first watched calls are replays, latency samples."""
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.serving import Engine, ServingConfig

    kw.setdefault("max_batch_size", 8)
    eng = Engine(model, ServingConfig(block_size=MAIN_BS, chunk_tokens=256,
                                      num_blocks=num_blocks, **kw))
    _warm_graphs(eng, False)
    torch.cuda.synchronize()
    launches.reset()
    eng.overload_calls0 = [eng._steps[n].calls for n in GRAPH_STEPS[:2]]
    return eng


def _overload_checks(tag, eng, want_reasons=None, retried_decodes=0):
    """After a part of phase 6o: one graph of the decode and prefill step
    and none of the sampled one, no retrace, no leak, the finish reasons
    asked for, and the launches counted since the engine was made equal
    to each step's launches times its replays (``calls`` of the guarded
    step: a stalled attempt ran its step and counts, a failed one did
    not run it); ``retried_decodes`` decode replays beyond the decode
    iterations.  Returns the counters."""
    from paddle_tpu_torch.kernels import launches

    torch.cuda.synchronize()
    st = eng.stats()
    ctr = st["counters"]
    sizes = [eng.decode_cache_size(), eng.prefill_cache_size(),
             eng.sampled_decode_cache_size()]
    retraces = [eng._steps[n].retraces for n in GRAPH_STEPS]
    if sizes != [1, 1, 0] or retraces != [0, 0, 0]:
        raise AssertionError(f"{tag}: graphs {sizes}, retraces {retraces}")
    eng.pool.check_leaks()
    if want_reasons is not None:
        got = sorted(r["finish_reason"] for r in st["requests"].values())
        if got != sorted(want_reasons):
            raise AssertionError(f"{tag}: finish reasons {got} != "
                                 f"{sorted(want_reasons)}")
    calls = [eng._steps[n].calls - c0 for n, c0 in
             zip(GRAPH_STEPS[:2], eng.overload_calls0)]
    if calls[0] != ctr["decode_iterations"] + retried_decodes:
        raise AssertionError(f"{tag}: {calls[0]} decode replays over "
                             f"{ctr['decode_iterations']} iterations and "
                             f"{retried_decodes} retries")
    per_decode, per_chunk = step_launches(eng.model.config, MAIN_BS)
    expect = {k: per_decode.get(k, 0) * calls[0]
              + per_chunk.get(k, 0) * calls[1]
              for k in {**per_decode, **per_chunk}}
    counts = launches.snapshot()
    if counts != expect:
        raise AssertionError(f"{tag}: launches {counts} != {expect} "
                             f"({calls[0]} decode, {calls[1]} chunk "
                             "replays)")
    return ctr


def _same_tokens(tag, reqs, want):
    """Each request's tokens against a list of token lists."""
    for r, w in zip(reqs, want):
        if [int(t) for t in r.generated] != [int(t) for t in w]:
            raise AssertionError(f"{tag}: {r.request_id}'s tokens differ "
                                 "from the reference run's")


def phase_main_overload(model, prompts, greedy, main_out):
    """Phase 6o: the overload controller (serving/overload.py) and its
    fault plan (resilience/chaos.py) on phase 6's model (Llama-3-8B
    width, MAIN_LAYERS layers, bf16, pages of MAIN_BS), each part on a
    fresh engine whose graphs were captured before it served, with the
    registry on.  ``greedy`` holds phase 6's requests, ``main_out`` its
    numbers (the profiles of a decode step and a prefill chunk).

    (a) ladder: watermarks 0.5 / 0.3; a seeded burst of 12 prompts of
        256-640 tokens, 16 new tokens each, into a pool of 0.8 of the
        burst's blocks: the ladder climbs one level a tick from 0 to
        pause_admissions or above, preempts, and after the drain idle
        steps bring it (and its gauge) back to 0; every request
        finishes "length" with the tokens of the same burst on an engine
        at the default watermarks;
    (b) stall: the watchdog at a 0.25 s floor, 50x its EWMA, one retry,
        recovery after 2 clean steps; the third decode attempt sleeps
        0.6 s: one stall, one retry, DEGRADED then SERVING, phase 6's
        tokens for requests 1-3, and the retried decode's replay counted
        twice;
    (c) failures: a failed prefill attempt absorbed (phase 6's tokens);
        two in a row quarantine the engine (EngineQuarantined), which
        then refuses submit and step until revive(), after which the
        stranded request finishes with phase 6's tokens; a poisoned
        request finishes "error" beside unaffected others;
    (d) shedding: after one drained request, seven seeded prompts of 640
        tokens and phase 6's request 4 (640 tokens, a 10 s deadline),
        all prefilled in one iteration (a budget of their 24 chunks),
        then decoded together; three of 1024 tokens with a
        5 ms deadline are shed at submit with no tokens; request 4 has
        phase 6's tokens; the health snapshot's chunk and decode EWMAs
        are at least the kernel time of phase 6's profiled chunk and
        decode step (the watchdog times the device, not the launch);
    (e) priority: a full queue of two; an arrival of priority 5 sheds
        the youngest waiting request of priority 0 and is admitted
        first (slot 0);
    (f) the registry's Prometheus lines of the overload and compile
        metrics, and the phase's wall time.
    Every part asserts one graph of each step it ran, no retrace, no
    leak and exact launch counts; nothing is caught but the faults the
    part injects."""
    from paddle_tpu_torch.observability import (get_registry,
                                                prometheus_text, registry)
    from paddle_tpu_torch.resilience import FaultPlan
    from paddle_tpu_torch.resilience.chaos import burst_prompts
    from paddle_tpu_torch.serving import (DEGRADED, LADDER_LEVELS, SERVING,
                                          AdmissionError, EngineQuarantined)

    t_phase = time.perf_counter()
    V = model.config.vocab_size
    phase6 = [r.generated for r in greedy]
    get_registry().clear()
    was_on = registry.enable()
    print(f"[main overload] phase 6's model, pages of {MAIN_BS}: the ladder, "
          "a stall, failures and quarantine, shedding, priorities",
          flush=True)

    # (a) the degradation ladder under a seeded burst
    burst = burst_prompts(seed=18, n=12, min_len=256, max_len=640, vocab=V)
    need = sum(-(-(len(p) + OVERLOAD_NEW) // MAIN_BS) for p in burst)
    nb = 1 + int(0.8 * need)
    runs = {}
    for tag, kw in (("ladder", dict(kv_high_watermark=0.5,
                                    kv_low_watermark=0.3)),
                    ("default watermarks", {})):
        eng = _overload_engine(model, nb, max_queue_len=len(burst), **kw)
        reqs = [eng.submit(p, max_new_tokens=OVERLOAD_NEW) for p in burst]
        t0 = time.perf_counter()
        eng.run_until_complete()
        wall = time.perf_counter() - t0
        ladder = eng.overload.ladder
        transitions = list(ladder.transitions)
        for _ in range(len(LADDER_LEVELS)):
            eng.step()                         # idle ticks unwind it
        ctr = _overload_checks(f"6o(a) {tag}", eng,
                               ["length"] * len(burst))
        runs[tag] = (reqs, transitions, ctr, wall, ladder.level,
                     eng.stats()["gauges"]["degradation_level"])
        del eng
        free()
    reqs, transitions, ctr, wall, level, gauge = runs["ladder"]
    levels = [lvl for _, lvl in transitions]
    if not levels or any(abs(b - a) != 1 for a, b in
                         zip([0] + levels, levels)) or \
            max(levels) < LADDER_LEVELS.index("pause_admissions") or \
            ctr["preemptions"] == 0 or level != 0 or gauge != 0:
        raise AssertionError(f"6o(a): transitions {transitions}, "
                             f"{ctr['preemptions']} preemptions, level "
                             f"{level}, gauge {gauge}")
    if runs["default watermarks"][1]:
        raise AssertionError("6o(a): the default watermarks moved the "
                             "ladder")
    _same_tokens("6o(a)", reqs, [r.generated
                                 for r in runs["default watermarks"][0]])
    print(f"  (a) ladder: burst of {len(burst)} prompts "
          f"({min(map(len, burst))}-{max(map(len, burst))} tokens, "
          f"{OVERLOAD_NEW} new), pool {nb} blocks (0.8 of {need}); "
          f"watermarks 0.5/0.3: {len(transitions)} transitions, levels "
          f"{levels}, {ctr['preemptions']} preemptions, {wall:.2f} s "
          f"(default watermarks: no transition, 0 preemptions "
          f"{runs['default watermarks'][2]['preemptions'] == 0}, "
          f"{runs['default watermarks'][3]:.2f} s); every request "
          "'length' with the default engine's tokens; unwound to 0",
          flush=True)
    del runs, reqs

    nb = 1 + sum(-(-(len(p) + MAIN_NEW) // MAIN_BS) for p in prompts) + 8

    # (b) a stalled decode attempt
    eng = _overload_engine(model, nb, **WATCHED)
    states = []
    eng.metrics.on_health = (lambda code, f=eng.metrics.on_health:
                             (states.append(code), f(code)))
    reqs = [eng.submit(prompts[i], max_new_tokens=MAIN_NEW)
            for i in (1, 2, 3)]
    with FaultPlan(step_delay_s={3: 0.6},
                   step_fault_scope="serving::decode_step") as plan:
        eng.run_until_complete()
    ctr = _overload_checks("6o(b)", eng, ["length"] * 3, retried_decodes=1)
    h = eng.health()
    if plan.injected != [("serving_delay", 3, "serving::decode_step")] or \
            ctr["watchdog_stalls"] != 1 or ctr["step_retries"] != 1 or \
            states != [1, 0] or h["state"] != SERVING or \
            eng.overload.decode_ewma.compile_s is not None:
        raise AssertionError(f"6o(b): injected {plan.injected}, counters "
                             f"{ctr}, health codes {states}, {h}")
    _same_tokens("6o(b)", reqs, [phase6[i] for i in (1, 2, 3)])
    print(f"  (b) stall: {plan.injected}: 1 stall, 1 retry, health "
          f"{DEGRADED} then {SERVING} (codes {states}), decode budget "
          f"{eng.overload.decode_watchdog.budget_s():.3f} s, phase 6's "
          "tokens; the stalled decode's replay counted twice; no capture "
          "observed by the watchdog (graphs captured at start-up)",
          flush=True)
    del eng, reqs
    free()

    # (c) failures, quarantine and revive, a poisoned request
    eng = _overload_engine(model, nb, **WATCHED)
    reqs = [eng.submit(prompts[i], max_new_tokens=MAIN_NEW)
            for i in (1, 2)]
    with FaultPlan(fail_step_at={2},
                   step_fault_scope="serving::prefill_step") as plan:
        eng.run_until_complete()
    absorbed = plan.injected
    _same_tokens("6o(c) absorbed", reqs, [phase6[i] for i in (1, 2)])
    stranded = eng.submit(prompts[3], max_new_tokens=MAIN_NEW)
    try:
        with FaultPlan(fail_step_at={1, 2},
                       step_fault_scope="serving::prefill_step"):
            eng.run_until_complete()
    except EngineQuarantined as e:
        quarantined = str(e)
    else:
        raise AssertionError("6o(c): two failed attempts did not "
                             "quarantine the engine")
    try:
        eng.submit(prompts[1], max_new_tokens=2)
    except AdmissionError:
        pass
    else:
        raise AssertionError("6o(c): a quarantined engine took a request")
    try:
        eng.step()
    except EngineQuarantined:
        pass
    else:
        raise AssertionError("6o(c): a quarantined engine stepped")
    failed = eng.health()
    eng.revive()
    eng.run_until_complete()
    _same_tokens("6o(c) revived", [stranded], [phase6[3]])
    poison = [eng.submit(prompts[i], max_new_tokens=MAIN_NEW,
                         request_id=f"poison-{i}") for i in (1, 4, 2)]
    with FaultPlan(fail_request_ids={"poison-4"}) as plan:
        eng.run_until_complete()
    if [r.finish_reason for r in poison] != ["length", "error", "length"]:
        raise AssertionError(f"6o(c): poisoned finish reasons "
                             f"{[r.finish_reason for r in poison]}")
    _same_tokens("6o(c) poison", [poison[0], poison[2]],
                 [phase6[1], phase6[2]])
    # a retry counted for each failed attempt: 1 absorbed, 2 quarantining
    ctr = _overload_checks("6o(c)", eng, ["length"] * 5 + ["error"])
    if ctr["step_retries"] != 3 or ctr["requests_rejected"] != 1 or \
            failed["state"] != "failed" or \
            absorbed != [("serving_fail", 2, "serving::prefill_step")]:
        raise AssertionError(f"6o(c): counters {ctr}, health {failed}, "
                             f"absorbed {absorbed}")
    print(f"  (c) failures: {absorbed} absorbed with phase 6's tokens; two "
          f"in a row: EngineQuarantined ({quarantined[:60]}...), submit "
          "and step refused, revive() finished the stranded request with "
          "phase 6's tokens; poison-4 'error' beside phase 6's tokens",
          flush=True)
    del eng, reqs, poison, stranded
    free()

    # (d) shedding
    fill = burst_prompts(seed=19, n=7, min_len=640, max_len=640, vocab=V)
    doomed = burst_prompts(seed=20, n=3, min_len=1024, max_len=1024,
                           vocab=V)
    (warm,) = burst_prompts(seed=21, n=1, min_len=256, max_len=256,
                            vocab=V)
    nb = 1 + sum(-(-(len(p) + MAIN_NEW) // MAIN_BS)
                 for p in fill + [prompts[4], warm]) + 8
    # every prompt's 3 chunks in the first iteration: the 8 requests then
    # decode together, their steps as full as phase 6's profiled one
    eng = _overload_engine(model, nb, prefill_token_budget=8 * 3 * 256)
    eng.generate([warm], max_new_tokens=MAIN_NEW)
    reqs = [eng.submit(p, max_new_tokens=MAIN_NEW) for p in fill]
    feasible = eng.submit(prompts[4], max_new_tokens=MAIN_NEW,
                          deadline_s=10.0)
    shed = [eng.submit(p, max_new_tokens=MAIN_NEW, deadline_s=0.005)
            for p in doomed]
    est = eng.overload.estimate_ttft_s(eng, doomed[0])
    eng.run_until_complete()
    ctr = _overload_checks("6o(d)", eng,
                           ["length"] * 9 + ["shed"] * len(doomed))
    if [r.finish_reason for r in shed] != ["shed"] * len(doomed) or \
            any(r.generated for r in shed) or \
            feasible.finish_reason != "length" or \
            ctr["requests_shed"] != len(doomed):
        raise AssertionError(f"6o(d): shed {[r.finish_reason for r in shed]}"
                             f", feasible {feasible.finish_reason}")
    _same_tokens("6o(d)", [feasible], [phase6[4]])
    h = eng.health()
    chunk_ms = max(main_out["prefill_step_device_ms"])
    decode_ms = max(main_out["decode_step_device_ms"])
    print(f"  (d) shedding: {len(doomed)} requests of 1024 tokens with a 5 ms "
          f"deadline shed at submit (estimated TTFT {est:.3f} s), request "
          f"4 (10 s) 'length' with phase 6's tokens; health {h}",
          flush=True)
    print(f"  (d) watchdog EWMAs: chunk {h['ewma_chunk_s'] * 1e3:.3f} ms "
          f"(phase 6's chunk: {chunk_ms:.3f} ms of kernels), decode "
          f"{h['ewma_decode_s'] * 1e3:.3f} ms (phase 6's decode step: "
          f"{decode_ms:.3f} ms of kernels)", flush=True)
    if h["ewma_chunk_s"] * 1e3 < chunk_ms or \
            h["ewma_decode_s"] * 1e3 < decode_ms:
        raise AssertionError("6o(d): a watchdog EWMA is below its step's "
                             "kernel time: it does not time the device")
    ewma = (h["ewma_chunk_s"], h["ewma_decode_s"])
    del eng, reqs, shed, feasible
    free()

    # (e) priorities at a full queue
    eng = _overload_engine(model, nb, max_queue_len=2)
    lo = [eng.submit(prompts[i], max_new_tokens=MAIN_NEW, priority=0)
          for i in (1, 2)]
    hi = eng.submit(prompts[3], max_new_tokens=MAIN_NEW, priority=5)
    if lo[1].finish_reason != "shed" or hi.finish_reason is not None:
        raise AssertionError(f"6o(e): full queue: {lo[1].finish_reason}")
    eng.step()
    slots = (hi.slot, lo[0].slot)
    eng.run_until_complete()
    _overload_checks("6o(e)", eng, ["shed", "length", "length"])
    if slots != (0, 1):
        raise AssertionError(f"6o(e): admitted into slots {slots}")
    _same_tokens("6o(e)", [hi, lo[0]], [phase6[3], phase6[1]])
    print("  (e) priority: a full queue of two; priority 5 shed the "
          "youngest priority-0 request and took slot 0 before the older "
          "one; phase 6's tokens", flush=True)
    del eng, lo, hi
    free()

    # (f) the registry
    registry.enable(was_on)
    lines = [ln for ln in prometheus_text().splitlines()
             if ln.startswith(OVERLOAD_METRICS)]
    print("  (f) registry (Prometheus text, overload and compile metrics):",
          flush=True)
    for ln in lines:
        print(f"    {ln}")
    wall = time.perf_counter() - t_phase
    print(f"  phase 6o in {wall:.1f} s; EWMAs (d): chunk "
          f"{ewma[0] * 1e3:.3f} ms, decode {ewma[1] * 1e3:.3f} ms",
          flush=True)
    main_out["overload_wall_s"] = wall


# ---------------------------------------------------------------- phase 6sp
SPEC_K = 4                      # draft tokens a verify (the engine's default)
# a greedy token of the speculative engine may differ from phase 6's, and
# the target may reject its own proposal (self-draft), only where a fresh
# prefill's logits of the two tokens lie within this many bf16 ulps of
# its top logit: tools/turns reports against 2, and two bf16 paths of one
# model have parted at up to 5.5 (PERF.md, PR 11)
SPEC_MARGIN_ULPS = 8
SPEC_STEPS = ("draft_prefill_step", "draft_propose_step", "spec_verify_step")
# the position of each step's pools; where a step binds the per-slot
# sampling state (the propose and the verify), it follows three later
SPEC_POOLS = {"draft_prefill_step": 1, "draft_propose_step": 1,
              "spec_verify_step": 3}
# (tag, H, KVH, D, page size, table positions, rope_theta) of the draft's
# decode (Llama-3.2-3B's heads, rep 3) and of the verify's chunk
# (Llama-3-8B's), both over tables of the engine's width (Llama-3-8B's
# 8192 positions)
SPEC_DRAFT_ATTN = ("llama32_3b", 24, 8, 128, 16, 8192, 500000.0)
SPEC_VERIFY_ATTN = ("verify", 32, 8, 128, 16, 8192, 500000.0)


def llama32_3b_config(**overrides):
    """Llama-3.2-3B's widths from its published config.json
    (meta-llama/Llama-3.2-3B): vocab 128256, hidden 3072, intermediate
    8192, 28 layers, 24 q / 8 kv heads (head_dim 128, GQA rep 3),
    rope_theta 500000, rms_norm_eps 1e-5, max_position 131072.  Two
    departures: its embeddings are tied and here they are not
    (``tie_word_embeddings`` is not ported, ROADMAP A2; a tied and an
    untied head compute the same product), and its llama3 rope scaling
    is left out (neither package models it, as Phi-3's window)."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaConfig

    return dataclasses.replace(LlamaConfig(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=28, num_attention_heads=24, num_key_value_heads=8,
        max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0), **overrides)


def _merge(a, b, n=1):
    """Launch counts ``a`` plus ``n`` times ``b``."""
    return {k: a.get(k, 0) + n * b.get(k, 0) for k in {**a, **b}}


def spec_launches(tcfg, dcfg, bs, K):
    """(per prefill chunk, per speculative iteration) launches of an
    engine over a target of ``tcfg`` and a draft of ``dcfg``: a chunk is
    the target's and the draft's prefill chunk; an iteration K+1 draft
    decode steps and the verify, a chunk-shaped target forward."""
    _, chunk_t = step_launches(tcfg, bs)
    decode_d, chunk_d = step_launches(dcfg, bs)
    return _merge(chunk_t, chunk_d), _merge(chunk_t, decode_d, K + 1)


def _record_spec_calls(eng, calls):
    """Spies on the engine's speculative steps that keep a copy of the
    arguments of one call of each: the propose and the verify with the
    most slots running, a full 256-token draft prefill chunk."""
    for name in SPEC_STEPS:
        def spy(*args, name=name, step=getattr(eng, f"_{name}")):
            if name == "draft_prefill_step":
                n = eng.chunk_tokens
                keep = name not in calls and int(args[4]) == n - 1
            else:
                n = int((eng._lengths > 0).sum())
                keep = n > calls.get(name, (0,))[0]
            if keep:
                calls[name] = (n, step, _copied(args))
            return step(*args)
        setattr(eng, f"_{name}", spy)


def _warm_spec_graphs(eng):
    """Capture a speculative engine's graphs before a timed run, as
    ``_warm_graphs`` does: the target's and the draft's prefill chunk,
    the propose and the verify, on all-zero host inputs and proposals
    (only the pools' garbage block 0 is addressed)."""
    S, nbs, K = eng.config.max_batch_size, eng.max_blocks_per_seq, \
        eng.spec.num_draft_tokens
    V, dev = eng.model.config.vocab_size, eng.device
    state = [getattr(eng, n) for n in SLOT_STATE]

    def z(*shape):
        return np.zeros(shape, np.int32)

    for name, pools in (("prefill_step", eng._target_pools()),
                        ("draft_prefill_step", eng._draft_pools())):
        eng._steps[name](z(1, eng.chunk_tokens), pools, z(1, nbs), z(1), 0)
    eng._steps["draft_propose_step"](z(S, 1), eng._draft_pools(),
                                     z(S, nbs), z(S), *state)
    eng._steps["spec_verify_step"](
        z(S), torch.zeros((S, K), dtype=torch.int64, device=dev),
        torch.zeros((S, K, V), dtype=torch.float32, device=dev),
        eng._target_pools(), z(S, nbs), z(S), *state)


def _record_verifies(eng, log):
    """A spy on the engine's verify that appends, for each call and each
    running slot, (request, its token count before the call, its K
    proposals, its committed row, its accepted length)."""
    step = eng._spec_verify_step

    def spy(*args):
        out = step(*args)
        committed, accepted = (t.cpu() for t in out)
        props = args[1].cpu()
        for slot, req in enumerate(eng._slots):
            if req is not None and req.state == "running":
                log.append((req, len(req.generated), props[slot].tolist(),
                            committed[slot].tolist(), int(accepted[slot])))
        return out

    eng._spec_verify_step = spy


def _hold_rejections(tag, model, prompts, reqs, log):
    """Each greedy proposal the target rejected (``_record_verifies``'
    ``log``) against the token it took instead: a fresh prefill of the
    request's tokens before that position must put the two within
    SPEC_MARGIN_ULPS bf16 ulps of its top logit (a near-tie between the
    draft's decode path and the verify's chunk path), not past it (a
    draft that reads a hole in its cache proposes far from the target).
    Returns (rejections, the widest gap in ulps)."""
    order = {id(r): i for i, r in enumerate(reqs)}
    n, worst = 0, 0.0
    for req, before, props, committed, accepted in log:
        j = before + accepted - 1          # the correction's token index
        if accepted > SPEC_K or j >= len(req.generated):
            continue
        i = order[id(req)]
        lg = _prefix_logits(model, np.concatenate(
            [prompts[i], req.generated[:j]]), MAIN_BS, 256).float()
        top = float(lg.max())
        ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
        took, proposed = committed[accepted - 1], props[accepted - 1]
        gap = abs(float(lg[took] - lg[proposed])) / ulp
        n, worst = n + 1, max(worst, gap)
        if gap > SPEC_MARGIN_ULPS:
            raise AssertionError(
                f"{tag}: request {i} token {j}: the target took {took} "
                f"over its own proposal {proposed}, {gap:.2f} ulps apart")
    print(f"  {tag}: {n} rejected proposals, each within {worst:.2f} bf16 "
          f"ulps of the token the target took (a fresh prefill's logits)",
          flush=True)
    return n, worst


def _serve_spec(model, draft, prompts, tag, num_blocks, kws=None,
                calls=None, verifies=None):
    """Phase 6's requests (the last submitted once the first has its
    first token, to hit its prefix) through a speculative engine (``draft``
    proposing SPEC_K tokens) whose graphs were captured first, with the
    launch counts set to 0 just before and read just after: every request
    its MAIN_NEW tokens, no leak, every block free again, one graph of
    each speculative step and of the target's prefill, none of the plain
    decode steps, and the launches of ``spec_launches``.  ``calls`` takes
    the recorded calls (``_record_spec_calls``), ``verifies`` each
    verify's outcome (``_record_verifies``).  Returns (numbers, launch
    counts with each instance's, engine, requests)."""
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.serving import (Engine, ServingConfig,
                                          SpeculativeConfig)

    kws = kws or [{}] * len(prompts)
    eng = Engine(model, ServingConfig(
        max_batch_size=8, block_size=MAIN_BS, chunk_tokens=256,
        num_blocks=num_blocks,
        speculative=SpeculativeConfig(draft, num_draft_tokens=SPEC_K)))
    if calls is not None:
        _record_spec_calls(eng, calls)
    if verifies is not None:
        _record_verifies(eng, verifies)
    _warm_spec_graphs(eng)
    torch.cuda.synchronize()
    late = len(prompts) - 1
    reqs = [None] * len(prompts)
    launches.reset()
    t0 = time.perf_counter()
    for i in range(late):
        reqs[i] = eng.submit(prompts[i], max_new_tokens=MAIN_NEW, **kws[i])
    while True:
        more = eng.step()
        if reqs[late] is None and reqs[0].generated:
            reqs[late] = eng.submit(prompts[late], max_new_tokens=MAIN_NEW,
                                    **kws[late])
        elif not more:
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, tally = launches.snapshot(), phase_counts()
    st = eng.stats()
    eng.pool.check_leaks()
    if eng.pool.num_free != eng.pool.capacity_blocks:
        raise AssertionError(f"{tag}: {eng.pool.num_free} of "
                             f"{eng.pool.capacity_blocks} blocks free")
    V = model.config.vocab_size
    for r in reqs:
        if r.finish_reason != "length" or len(r.generated) != MAIN_NEW or \
                not all(0 <= t < V for t in r.generated):
            raise AssertionError(f"{tag} {r.request_id}: {r.finish_reason}, "
                                 f"{len(r.generated)} tokens")
    sizes = eng.spec_cache_sizes()
    plain = [eng.prefill_cache_size(), eng.decode_cache_size(),
             eng.sampled_decode_cache_size()]
    if set(sizes.values()) != {1} or plain != [1, 0, 0]:
        raise AssertionError(f"{tag}: graphs {sizes}, prefill / decode / "
                             f"sampled decode {plain}")
    ctr = st["counters"]
    chunks, iters = ctr["prefill_chunks"], ctr["decode_iterations"]
    per_chunk, per_iter = spec_launches(model.config, draft.config, MAIN_BS,
                                        SPEC_K)
    expect = _merge({k: chunks * n for k, n in per_chunk.items()}, per_iter,
                    iters)
    print(f"  {tag}: launches {counts} over {chunks} prefill chunks (the "
          f"target's and the draft's) and {iters} speculative iterations; "
          f"expected per chunk {per_chunk}, per iteration {per_iter}",
          flush=True)
    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts} != {expect}")
    if any("_general" in k for k in counts):
        raise AssertionError(f"{tag}: a general instance launched")
    digest = hashlib.sha1(json.dumps(
        [[int(t) for t in r.generated] for r in reqs]).encode()).hexdigest()
    rq = st["requests"].values()
    tpot = [r["tpot_s"] for r in rq if r["tpot_s"] is not None]
    compiles = st["compiles"]
    out = dict(
        tokens_per_s=ctr["tokens_generated"] / wall, wall_s=wall,
        mean_ttft_s=float(np.mean([r["ttft_s"] for r in rq])),
        mean_tpot_s=float(np.mean(tpot)), tokens=digest[:16],
        accept_rate=eng.metrics.spec_accept_rate(),
        spec_tokens_drafted=ctr["spec_tokens_drafted"],
        spec_tokens_accepted=ctr["spec_tokens_accepted"],
        decode_iterations=iters, prefill_chunks=chunks,
        prefix_cache_hits=ctr["prefix_cache_hits"],
        num_blocks=eng.num_blocks, pool_layers=eng.pool.num_layers,
        pool_gb=eng.num_blocks * st["pool"]["block_bytes"] / 1e9,
        graph_capture_s={label.split("::")[1]: c["compile_seconds"]
                         for label, c in compiles.items()
                         if c["compiles"]},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"  {tag}: tokens {digest[:16]}; accept rate "
          f"{out['accept_rate']:.4f} ({out['spec_tokens_accepted']} of "
          f"{out['spec_tokens_drafted']} drafts), {iters} iterations, "
          f"{out['tokens_per_s']:.1f} tokens/s, mean TTFT "
          f"{out['mean_ttft_s']:.3f} s, mean TPOT "
          f"{out['mean_tpot_s'] * 1e3:.1f} ms; graphs {sizes}", flush=True)
    return out, tally, eng, reqs


def _hold_greedy(tag, model, prompts, got, want):
    """Greedy tokens ``got`` against phase 6's ``want`` by the rule of
    tools/turns: at a request's first differing token, the top-2 margin
    of a fresh prefill of the tokens before it, in bf16 ulps of the top
    logit, printed beside turns' 2 and held to SPEC_MARGIN_ULPS.  Returns
    the requests that differ."""
    parted = 0
    for i, (a, b) in enumerate(zip(got, want)):
        if a == b:
            continue
        parted += 1
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        top, second = torch.topk(_prefix_logits(
            model, np.concatenate([prompts[i], a[:j]]), MAIN_BS, 256)
            .float(), 2).values.tolist()
        ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
        m = (top - second) / ulp
        print(f"  {tag}: request {i} token {j} differs (speculative {a[j]}, "
              f"phase 6 {b[j]}); top-2 margin of a fresh prefill there "
              f"{top - second:.4e} = {m:.2f} bf16 ulps of {top:.4f} "
              f"({'within' if m < 2 else 'past'} turns' 2)", flush=True)
        if m > SPEC_MARGIN_ULPS:
            raise AssertionError(f"{tag}: request {i} token {j} differs "
                                 f"from phase 6's at a margin of {m:.2f} "
                                 f"ulps > {SPEC_MARGIN_ULPS}")
    print(f"  {tag}: {len(got) - parted} of {len(got)} requests' greedy "
          "tokens equal phase 6's", flush=True)
    return parted


def _spec_sampler_share(eng, calls, step_ms):
    """The sampler's part of the propose and the verify: the K draws and
    filtered distributions of the propose's passes over [S, V] f32
    logits, and the verify's acceptance (``spec_acceptance``: the
    filtered distributions of [S * (K+1), V] logits, the draws), each
    profiled three times on random logits and the recorded state; the
    median against the step's median kernel time ``step_ms[name]``."""
    from paddle_tpu_torch.serving.sampling import (DRAFT_TAG, filtered_probs,
                                                   fold_keys, sample_tokens)
    from paddle_tpu_torch.serving.speculative import spec_acceptance

    S, K = eng.config.max_batch_size, eng.spec.num_draft_tokens
    V, dev = eng.model.config.vocab_size, eng.device
    g = torch.Generator(device=dev).manual_seed(5)
    pargs, vargs = calls["draft_propose_step"][2], \
        calls["spec_verify_step"][2]
    temps, tks, tps, keys, counters = pargs[4:9]
    last = torch.randn((S, V), generator=g, device=dev) * 3
    lg = torch.randn((S, K + 1, V), generator=g, device=dev) * 3

    def propose_sampler():
        for i in range(K):
            sample_tokens(last, temps, tks, tps, fold_keys(
                fold_keys(keys, counters + i), DRAFT_TAG))
            filtered_probs(last, temps, tks, tps)

    def acceptance():
        spec_acceptance(lg, vargs[1], vargs[2], *vargs[6:11])

    shares = {}
    for name, what, fn in (("draft_propose_step", f"{K} draws and "
                            f"distributions over [{S}, {V}]",
                            propose_sampler),
                           ("spec_verify_step", f"the acceptance over "
                            f"[{S}, {K + 1}, {V}]", acceptance)):
        _, _, dev_ms, top, _ = _step_profile(fn, ())
        mid = float(np.median(dev_ms))
        shares[name] = (mid, mid / step_ms[name] if step_ms[name] else None)
        print(f"  sampler in {name}: {what}: "
              + ", ".join(f"{ms:.3f}" for ms in dev_ms) + " ms of kernels"
              + (f", {shares[name][1]:.1%} of the step's"
                 if shares[name][1] is not None else ""), flush=True)
        for kname, ms, count in top[:4]:
            print(f"    {ms:8.3f} ms  {count:5d}x  {kname[:90]}")
    return shares


def _spec_tiny(dev):
    """Phase 6sp (d): LlamaConfig.tiny in f32 (seed 0) with a 1-layer
    draft of it (seed 123), the same weights served on cuda and on cpu
    with SpeculativeConfig(draft, 3), pages of 4: 6 greedy requests, then
    the same with requests 0, 2 and 4 sampled; tokens and speculative
    counters equal."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import (Engine, ServingConfig,
                                          SpeculativeConfig)

    cfgs = (LlamaConfig.tiny(), LlamaConfig.tiny(num_hidden_layers=1))
    cpu = [LlamaForCausalLM(c, device="cpu", seed=s)
           for c, s in zip(cfgs, (0, 123))]
    cuda = [LlamaForCausalLM(c, device=dev, seed=None) for c in cfgs]
    for a, b in zip(cuda, cpu):
        a.load_state_dict(b.state_dict())
    rng = np.random.RandomState(0)
    prompts = [rng.randint(1, 256, size=n) for n in (3, 7, 5, 11, 4, 6)]
    mixed = [dict(temperature=0.8, top_k=16, top_p=0.95, seed=9), {},
             dict(temperature=1.0, seed=4), {},
             dict(temperature=0.6, top_p=0.9, seed=2 ** 31 - 1), {}]
    for what, kws in (("greedy", [{}] * 6), ("sampled", mixed)):
        out = {}
        for name, (target, draft) in (("cpu", cpu), ("cuda", cuda)):
            eng = Engine(target, ServingConfig(
                max_batch_size=4, block_size=4, num_blocks=64,
                speculative=SpeculativeConfig(draft, num_draft_tokens=3)))
            reqs = [eng.submit(p, max_new_tokens=9, **kw)
                    for p, kw in zip(prompts, kws)]
            eng.run_until_complete()
            eng.pool.check_leaks()
            c = eng.stats()["counters"]
            out[name] = ([r.generated for r in reqs],
                         (c["spec_tokens_drafted"],
                          c["spec_tokens_accepted"]))
        print(f"  spec tiny ({what}): cuda tokens "
              f"{'==' if out['cuda'] == out['cpu'] else '!='} cpu tokens; "
              f"drafted / accepted {out['cuda'][1]} (cpu {out['cpu'][1]})",
              flush=True)
        if out["cuda"] != out["cpu"]:
            raise AssertionError(f"spec tiny ({what}): cuda {out['cuda']} "
                                 f"!= cpu {out['cpu']}")


def spec_kernel_entries(dev):
    """Phase 6sp (e): the kernels of the speculative path at the shapes
    the card had not run: fused_norm_linear over Llama-3.2-3B's five
    projections at a propose pass's 8 rows (2d) and over Llama-3-8B's at
    the verify's 40 (2v), the paged decode at the draft's 24 q over 8 kv
    heads (3d), the chunk and the KV write at the verify's 8 sequences of
    K+1 tokens at staggered frontiers (4v, Sv)."""
    from paddle_tpu_torch.kernels import (_build, chunked_prefill, kv_quant,
                                          paged_attention)

    g = torch.Generator(device=dev).manual_seed(7)
    d = llama32_3b_config()
    entries = {}
    print("[spec kernels] the speculative path's new shapes, bf16",
          flush=True)
    for name, key, M, (HID, H, KVH, FFN) in (
            ("fused_norm_linear_skinny", "fused_norm_linear_skinny_llama32_3b",
             8, (d.hidden_size, d.num_attention_heads,
                 d.num_key_value_heads, d.intermediate_size)),
            ("fused_norm_linear_tiled", "fused_norm_linear_tiled_verify",
             8 * (SPEC_K + 1), (4096, 32, 8, 14336))):
        entries[key] = fnl_entry(g, name, M, HID, H, KVH, 128, FFN,
                                 path="spec", counter=name)
    ops = _attn_operands(g, dev, SPEC_DRAFT_ATTN)
    H, KVH = SPEC_DRAFT_ATTN[1:3]
    splits = paged_attention.decode_plan(
        8, KVH, ops["nbs"], SPEC_DRAFT_ATTN[4], _build.sm_count(dev),
        paged_attention.hopper_group(H // KVH)[1],
        paged_attention.blocks_per_sm(ops["q"], None))
    entries["paged_decode_llama32_3b"] = _decode_entry(
        ops, None, paged_attention.KERNEL, "spec", splits)
    del ops
    ops = _attn_operands(g, dev, SPEC_VERIFY_ATTN, T=SPEC_K + 1,
                         start=list(C1_FRONTIERS))
    entries["chunked_prefill_verify"] = _chunk_entry(
        ops, chunked_prefill.KERNEL, "spec")
    # the verify's KV write: every one of the K+1 rows kept (an all-true
    # write mask), into fresh bf16 pools over the chunk's tables
    bf = torch.bfloat16
    B, T, KVH, D = 8, SPEC_K + 1, SPEC_VERIFY_ATTN[2], SPEC_VERIFY_ATTN[3]
    k, v = (torch.randn((B, T, KVH, D), generator=g, device=dev).to(bf)
            for _ in range(2))
    pools = [torch.zeros_like(ops["k"]) for _ in range(2)]
    wops = [*pools, k, v, ops["bt"], ops["pos"]]
    kw = dict(scheme=None, write_mask=torch.ones((B, T), dtype=torch.bool,
                                                 device=dev))
    want_ops = [x.clone() for x in wops]
    want_kw = dict(kw)
    _one_launch(kv_quant.KERNEL, lambda: kv_quant.kv_write(*wops, **kw))
    kv_quant.kv_write_plain(*want_ops, **want_kw)
    hold_write(f"kv_write, verify rows {list(k.shape)} into bf16 pools",
               wops, kw, want_ops, want_kw, [])
    entries["kv_write_verify_bf16"] = write_entry("chunk", "bf16", "spec",
                                                  wops, kw, [])
    del ops, wops, want_ops, pools
    print_entries(entries)
    return entries


def phase_main_spec(model, prompts, greedy, main_out):
    """Phase 6sp: speculative decoding on phase 6's model (Llama-3-8B
    width, bf16, seed 0), requests and pages, SPEC_K = 4 drafts a verify,
    a pool sized for both models' layers and every request's K+1 horizon.
    (a) A Llama-3.2-3B-width draft (``llama32_3b_config``, random weights,
    seed 1), greedy: every request's tokens held to phase 6's (``greedy``)
    by the margin rule (``_hold_greedy``), one graph of each speculative
    step, a second batch adding none and no retrace, exact launch counts,
    no leak; its numbers beside phase 6's (``main_out``), each step
    profiled three times and the sampler's share of the propose and the
    verify.  (b) The target as its own draft: tokens by the margin rule,
    every rejected proposal a near-tie (``_hold_rejections``).  (c)
    Requests 0, 2, 4 and 6 sampled (SAMPLED, seed 1000 + i) with the 3B
    draft, served twice: the same tokens, the greedy ones (a)'s.  (d)
    ``_spec_tiny``.  (e) ``spec_kernel_entries``.  Returns ((a)'s launch
    counts, (e)'s kernel rows)."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    t_phase = time.perf_counter()
    dev = model.device
    dcfg = llama32_3b_config()
    t0 = time.perf_counter()
    draft = LlamaForCausalLM(dcfg, device=dev, seed=1)
    torch.cuda.synchronize()
    want = [r.generated for r in greedy]
    num_blocks = 1 + sum(-(-(len(p) + MAIN_NEW + SPEC_K) // MAIN_BS)
                         for p in prompts) + 8
    print(f"[main spec] phase 6's model with a Llama-3.2-3B-width draft "
          f"(bf16, {dcfg.num_hidden_layers} layers, random weights, seed 1, "
          f"made in {time.perf_counter() - t0:.1f} s), {SPEC_K} drafts a "
          f"verify; a pool of {num_blocks} blocks of {MAIN_BS} tokens over "
          f"{model.config.num_hidden_layers} + {dcfg.num_hidden_layers} "
          f"layers (every request's prompt, {MAIN_NEW} new tokens and the "
          f"K+1 horizon)", flush=True)

    # (a) the 3B draft, greedy
    calls = {}
    out, tally, eng, reqs = _serve_spec(model, draft, prompts, "spec (a)",
                                        num_blocks, calls=calls)
    _hold_greedy("spec (a)", model, prompts, [r.generated for r in reqs],
                 want)
    sizes = eng.spec_cache_sizes()
    eng.generate(prompts[2:6], max_new_tokens=8)
    retraces = [eng._steps[n].retraces for n in SPEC_STEPS]
    eng.pool.check_leaks()
    if eng.spec_cache_sizes() != sizes or any(retraces) or \
            eng.pool.num_free != eng.pool.capacity_blocks:
        raise AssertionError(f"spec (a): after a second batch graphs "
                             f"{eng.spec_cache_sizes()} (before {sizes}), "
                             f"retraces {retraces}")
    print(f"  spec (a): a second batch of 4 requests: graphs {sizes} as "
          f"before, retraces {retraces}, no block leaked", flush=True)
    step_ms = {}
    for name in SPEC_STEPS:
        n, step, args = calls[name]
        with _slot_state(eng, args, SPEC_POOLS[name] + 3) as bound:
            wall, span, dev_ms, top, kernels = _step_profile(step, bound)
        step_ms[name] = mid = float(np.median(dev_ms))
        unit = "tokens" if name == "draft_prefill_step" else "slots running"
        print(f"  {name} ({n} {unit}): {wall:.3f} ms on the host's clock, "
              f"{span:.3f} ms between CUDA events; kernels of "
              f"{len(dev_ms)} profiled steps: " + ", ".join(
                  f"{ms:.3f} ms in {k}" for ms, k in zip(dev_ms, kernels))
              + (f" (busy {mid / wall:.1%})" if mid else ""), flush=True)
        for kname, ms, count in top:
            print(f"    {ms:8.3f} ms  {count:5d}x  {kname[:90]}")
        out[f"{name}_host_ms"], out[f"{name}_span_ms"] = wall, span
        out[f"{name}_device_ms"], out[f"{name}_kernels"] = dev_ms, kernels
    shares = _spec_sampler_share(eng, calls, step_ms)
    out["sampler_device_ms"] = {k: v[0] for k, v in shares.items()}
    out["sampler_share"] = {k: v[1] for k, v in shares.items()}
    print(f"  spec (a): {out['tokens_per_s']:.1f} tokens/s (phase 6 "
          f"{main_out['tokens_per_s']:.1f}), mean TTFT "
          f"{out['mean_ttft_s']:.3f} s ({main_out['mean_ttft_s']:.3f}), "
          f"mean TPOT {out['mean_tpot_s'] * 1e3:.1f} ms "
          f"({main_out['mean_tpot_s'] * 1e3:.1f})", flush=True)
    print(f"  {json.dumps(out)}", flush=True)
    del eng, calls
    free()

    # (b) the target as its own draft: every rejection a near-tie
    verifies = []
    sout, _, seng, sreqs = _serve_spec(model, model, prompts, "spec (b)",
                                       num_blocks, verifies=verifies)
    del seng
    free()
    _hold_greedy("spec (b)", model, prompts, [r.generated for r in sreqs],
                 want)
    sout["rejections"], sout["widest_rejection_ulps"] = _hold_rejections(
        "spec (b)", model, prompts, sreqs, verifies)
    print(f"  {json.dumps(sout)}", flush=True)

    # (c) sampled, with the 3B draft, twice
    kws = [dict(SAMPLED, seed=1000 + i) if i % 2 == 0 else {}
           for i in range(len(prompts))]
    digests = []
    for attempt in ("first", "second"):
        tag = f"spec (c) sampled, {attempt} run"
        cout, _, ceng, creqs = _serve_spec(model, draft, prompts, tag,
                                           num_blocks, kws=kws)
        del ceng
        free()
        for i, r in enumerate(creqs):
            if not kws[i] and r.generated != reqs[i].generated:
                raise AssertionError(f"{tag}: greedy request {i}'s tokens "
                                     "differ from (a)'s")
        digests.append(hashlib.sha1(json.dumps(
            [r.generated for i, r in enumerate(creqs) if kws[i]])
            .encode()).hexdigest()[:16])
        print(f"  {tag}: sampled tokens {digests[-1]}; greedy requests "
              f"equal (a)'s; drafted {cout['spec_tokens_drafted']}, "
              f"accepted {cout['spec_tokens_accepted']}", flush=True)
    if digests[0] != digests[1]:
        raise AssertionError(f"spec (c): the two runs sampled other tokens "
                             f"({digests})")
    del draft
    free()

    # (d) the tiny f32 model, cuda against cpu; (e) the kernel rows
    _spec_tiny(dev)
    entries = spec_kernel_entries(dev)
    print(f"  phase 6sp in {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return tally, entries


def phase_spec_main(dev):
    """Phase 6's greedy run on its model, then phase 6sp: the speculative
    path alone (``tools/turns --phases spec_main``).  Returns what
    ``phase_main_spec`` returns."""
    model, prompts, num_blocks = _main_model(dev)
    greedy = []
    out, _, eng = _serve_main(model, prompts, "main",
                              num_blocks=num_blocks, requests=greedy)
    del eng
    free()
    return phase_main_spec(model, prompts, greedy, out)


# ---------------------------------------------------------------- phase 2d
SAMPLER_V = 128256              # Llama-3's vocabulary
SAMPLER_COUNTERS = 64
# (temperature, top_k, top_p) of the 8 lanes: greedy (one with filters
# that greedy ignores), temperature alone, with top-k, with top-p, with
# both (phase 6s's), top-k 1, a wide top-k under a hot temperature
SAMPLER_LANES = ((0.0, 0, 1.0), (0.8, 0, 1.0), (1.0, 50, 1.0),
                 (0.7, 0, 0.9), (0.8, 50, 0.95), (0.0, 5, 0.5),
                 (1.3, 1000, 0.8), (1.0, 1, 1.0))


def phase_sampler(dev):
    """Phase 2d: the sampler (``serving.sampling.sample_tokens``, plain
    torch ops) on the card against the same function on the CPU, over
    random f32 logits [8, SAMPLER_V] (N(0, 4^2), from a seed), the lanes
    of SAMPLER_LANES and SAMPLER_COUNTERS token counters of 8 seeded
    keys: every token must be equal.  On a mismatch it prints the
    Gumbel-perturbed top-2 margin of the row (the CPU's filtered logits
    plus its noise) and fails.  Prints the sampler's time on the card."""
    from paddle_tpu_torch.serving.sampling import (filter_logits, fold_keys,
                                                   gumbel, prng_key,
                                                   sample_at)

    g = torch.Generator().manual_seed(0)
    logits = torch.randn((len(SAMPLER_LANES), SAMPLER_V), generator=g) * 4
    temps = torch.tensor([t for t, _, _ in SAMPLER_LANES])
    top_ks = torch.tensor([k for _, k, _ in SAMPLER_LANES])
    top_ps = torch.tensor([p for _, _, p in SAMPLER_LANES])
    keys = torch.from_numpy(np.stack([prng_key(1000 + i)
                                      for i in range(len(SAMPLER_LANES))]))
    cpu = (logits, temps, top_ks, top_ps, keys)
    cuda = tuple(a.to(dev) for a in cpu)
    print(f"[sampler] sample_at over [{len(SAMPLER_LANES)}, {SAMPLER_V}] f32 "
          f"logits, lanes (T, top_k, top_p) {SAMPLER_LANES}, "
          f"{SAMPLER_COUNTERS} counters: cuda against cpu", flush=True)
    bad = []
    for c in range(SAMPLER_COUNTERS):
        ctr = torch.full((len(SAMPLER_LANES),), c, dtype=torch.int64)
        want = sample_at(*cpu, ctr)
        got = sample_at(*cuda, ctr.to(dev)).cpu()
        for row in torch.nonzero(got != want).flatten().tolist():
            pert = filter_logits(logits[row:row + 1], temps[row:row + 1],
                                 top_ks[row:row + 1], top_ps[row:row + 1])
            if temps[row] > 0:
                pert = pert + gumbel(fold_keys(keys[row:row + 1], c),
                                     SAMPLER_V)
            top2 = torch.topk(pert[0], 2).values
            bad.append((c, row, int(got[row]), int(want[row]),
                        float(top2[0] - top2[1])))
    if bad:
        for c, row, a, b, m in bad:
            print(f"  counter {c} lane {row}: cuda {a}, cpu {b}; "
                  f"perturbed top-2 margin {m:.4e}", flush=True)
        raise AssertionError(f"sampler: {len(bad)} of "
                             f"{SAMPLER_COUNTERS * len(SAMPLER_LANES)} tokens "
                             "differ between cuda and cpu")
    ctr = torch.zeros((len(SAMPLER_LANES),), dtype=torch.int64, device=dev)
    # few calls: its ~430 launches a call must all queue behind the sleep
    ms = time_ms(lambda: sample_at(*cuda, ctr), iters=4, warmup=2)
    print(f"  {SAMPLER_COUNTERS * len(SAMPLER_LANES)} tokens equal; "
          f"sample_at {ms:.3f} ms on the card (CUDA events, launches "
          "queued behind a sleep)", flush=True)


def phase_moe_main(dev):
    """The main serving path of a mixture-of-experts model: Mixtral-8x7B
    at full width, MOE_LAYERS of its 32 layers (all 32 would not fit the
    card in bf16), bf16, random weights from seed 0, dropless routing,
    behind serving.Engine with the 8 requests of phase 6 (token ids below
    32000) and a bf16 pool of the requests' blocks + 9.  Dropless routing
    makes a request's tokens independent of its batch mates, so its
    first token must equal a fresh prefill's."""
    from paddle_tpu_torch.models import LlamaForCausalLM

    cfg = mixtral_config(num_hidden_layers=MOE_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[main moe] Mixtral-8x7B width, bf16, {cfg.num_hidden_layers} of "
          f"32 layers, {n_params / 1e9:.3f} B parameters, 8 experts, top-2, "
          f"capacity factor {cfg.moe_capacity_factor} (dropless), random "
          f"weights (seed 0) in {time.perf_counter() - t0:.1f} s", flush=True)
    prompts = _main_prompts(cfg.vocab_size)
    num_blocks = 1 + sum(-(-(len(p) + MAIN_NEW) // MAIN_BS)
                         for p in prompts) + 8
    out, counts, _ = _serve_main(model, prompts, "main moe",
                                 num_blocks=num_blocks)
    out["n_params"] = n_params
    print(f"  {out['tokens_per_s']:.1f} tokens/s, mean TTFT "
          f"{out['mean_ttft_s']:.3f} s, mean TPOT "
          f"{out['mean_tpot_s'] * 1e3:.1f} ms; peak "
          f"{out['peak_mem_gb']:.1f} GB", flush=True)
    print(f"  {json.dumps(out)}", flush=True)
    return counts


# (kv_cache_dtype, weight_dtype) of the main quantized serving phase, in
# order: a bf16 pool first, the control that runs under the phase's own
# conditions (a fresh model, a cold allocator); int8 weights last, since
# they are quantized in place
QUANT_RUNS = ((None, None), ("fp8", None), ("int8", None), ("fp8", "int8"))


def _logprob(logits, tok):
    lf = logits.double()
    return float(lf[tok] - torch.logsumexp(lf, 0))


def phase_main_quant(dev, bf16_blocks):
    """The main serving path from quantized KV pools: Llama-3-8B at full
    width, MAIN_LAYERS layers, bf16 model, the same 8 requests as the main
    phase, served from a bf16 pool again (the control), from fp8 pools,
    from int8 pools, then from fp8 pools with int8 weights.  Each pool
    gets the bf16 main phase's KV bytes (``kv_pool_bytes``), so a
    quantized one holds about twice its blocks.  Beside each run's
    numbers: the greedy token's log-probability under the 1024-token
    prompt's prefill logits, against the bf16 pool's with the unquantized
    weights (the JAX package's quantized-serving measure).  Each
    configuration is served twice, both runs held to the same checks,
    and the second is reported beside the first's tokens/s: the
    host-clock numbers of a single run spread widely.  Returns the launch
    counts summed over the reported runs."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving.cache import BlockKVPool

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=MAIN_LAYERS)
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    prompts = _main_prompts(cfg.vocab_size)
    L, KVH = cfg.num_hidden_layers, cfg.num_key_value_heads
    bf16_block = BlockKVPool.block_bytes_for(L, MAIN_BS, KVH, cfg.head_dim,
                                             cfg.torch_dtype)
    long_prompt = prompts[6]                         # 1024 tokens
    ref = _prefix_logits(model, long_prompt, MAIN_BS, 256)
    tok = int(ref.argmax())
    ref_lp = _logprob(ref, tok)
    total = {}
    for kv, weights in QUANT_RUNS:
        tag = f"main {kv or 'bf16'}" + \
            (f" + {weights} weights" if weights else "")
        print(f"[{tag}] Llama-3-8B width, bf16, {L} of 32 layers, "
              f"{kv or 'bf16'} KV pools"
              + (f", {weights} weights" if weights else ""), flush=True)
        for attempt in ("first", "reported"):
            out, counts, eng = _serve_main(
                model, prompts, f"{tag} ({attempt} run)", kv, weights,
                kv_pool_bytes=bf16_blocks * bf16_block)
            if attempt == "first":
                first_tps = out["tokens_per_s"]
                del eng
                gc.collect()
        out["first_run_tokens_per_s"] = first_tps
        for k, n in counts.items():
            total[k] = total.get(k, 0) + n
        logits = _prefix_logits(model, long_prompt, MAIN_BS, 256, kv)
        out["greedy_logprob_delta"] = abs(_logprob(logits, tok) - ref_lp)
        out["bf16_block_bytes"] = bf16_block
        if not math.isfinite(out["greedy_logprob_delta"]):
            raise AssertionError(f"{tag}: non-finite prefill logits")
        print(f"  {out['tokens_per_s']:.1f} tokens/s (first run "
              f"{first_tps:.1f}), mean TTFT "
              f"{out['mean_ttft_s']:.3f} s, mean TPOT "
              f"{out['mean_tpot_s'] * 1e3:.1f} ms; {out['num_blocks']} "
              f"blocks of {out['block_bytes']} bytes (bf16: {bf16_blocks} of "
              f"{bf16_block}); peak {out['peak_mem_gb']:.1f} GB; greedy "
              f"log-prob delta of the 1024-token prefill vs the bf16 pool "
              f"{out['greedy_logprob_delta']:.4e}", flush=True)
        print(f"  {json.dumps(out)}", flush=True)
        del eng
        gc.collect()
    return total


def _copied(args):
    """A copy of a step's arguments as the engine handed them: its host
    arrays and tensors copied (the engine rewrites its own arrays, and a
    replayed step's inputs are its static buffers), the pools (a list)
    kept as they are."""
    return tuple(a.copy() if isinstance(a, np.ndarray) else
                 a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args)


SLOT_STATE = ("_temps", "_top_ks", "_top_ps", "_keys", "_counters")


@contextlib.contextmanager
def _slot_state(eng, args, at=4):
    """A recorded sampled decode step's arguments (or a speculative
    step's, whose state starts at position ``at``) over the engine's own
    per-slot sampling tensors, which hold the recorded values inside the
    block and their own again after it: the step binds those tensors by
    address, as it binds the pools, so a copy would be a new graph.  A
    decode or prefill step's arguments pass as they are."""
    if len(args) != at + len(SLOT_STATE):
        yield args
        return
    own = [getattr(eng, n) for n in SLOT_STATE]
    kept = [t.clone() for t in own]
    for t, a in zip(own, args[at:]):
        t.copy_(a)
    try:
        yield (*args[:at], *own)
    finally:
        for t, k in zip(own, kept):
            t.copy_(k)


def _on_device(args, dev):
    """A step's arguments with its host arrays moved to ``dev``: the
    form a step's eager function takes."""
    return [torch.as_tensor(a, device=dev) if isinstance(a, np.ndarray)
            else a for a in args]


def _capture_steps(eng):
    """Wrap the engine's steps to keep a copy of the arguments of one
    call of each, to replay after the run: the decode step (greedy, and
    sampled where the engine has one) with the most slots running and a
    full 256-token prefill chunk."""
    captured = {}
    decode, prefill = eng._decode_step, eng._prefill_step
    sampled = getattr(eng, "_sampled_decode_step", None)

    def decode_spy(*args):
        running = int((eng._lengths > 0).sum())
        if running > captured.get("decode", (0,))[0]:
            captured["decode"] = (running, decode, _copied(args))
        return decode(*args)

    def sampled_spy(*args):
        running = int((eng._lengths > 0).sum())
        if running > captured.get("sampled decode", (0,))[0]:
            captured["sampled decode"] = (running, sampled, _copied(args))
        return sampled(*args)

    def prefill_spy(*args):
        if "prefill" not in captured and \
                int(args[4]) == eng.chunk_tokens - 1:
            captured["prefill"] = (eng.chunk_tokens, prefill,
                                   _copied(args))
        return prefill(*args)

    eng._decode_step, eng._prefill_step = decode_spy, prefill_spy
    if sampled is not None:
        eng._sampled_decode_step = sampled_spy
    return captured


def _graph_sizes(eng, tag, sampled):
    """Raise unless the engine holds one graph of its decode step, one of
    its prefill step and one (``sampled``) or none of its sampled decode
    step; returns a line of the sizes and each graph's capture seconds
    (the line of an older package without graphs says so)."""
    if not hasattr(eng, "decode_cache_size"):
        return "no CUDA graphs in this package"
    sizes = [eng.decode_cache_size(), eng.prefill_cache_size(),
             eng.sampled_decode_cache_size()]
    if sizes != [1, 1, int(sampled)]:
        raise AssertionError(f"{tag}: graph cache sizes {sizes} != "
                             f"{[1, 1, int(sampled)]}")
    compiles = eng.stats()["compiles"]
    return (f"graphs of decode / prefill / sampled decode {sizes}, "
            "captured in " + ", ".join(
                f"{c['compile_seconds']:.3f}" for c in compiles.values()
                if c["compiles"]) + " s")


def _warm_graphs(eng, sampled):
    """Capture the engine's graphs before a timed run, as a server does
    at start-up: its prefill and decode steps (and with ``sampled`` its
    sampled decode step) on all-zero host inputs of the shapes the
    engine passes, which address only the pools' garbage block 0."""
    S, nbs = eng.config.max_batch_size, eng.max_blocks_per_seq
    pools, z = eng.pool.layers, lambda *shape: np.zeros(shape, np.int32)
    eng._steps["prefill_step"](z(1, eng.chunk_tokens), pools, z(1, nbs),
                               z(1), 0)
    eng._steps["decode_step"](z(S, 1), pools, z(S, nbs), z(S))
    if sampled:
        eng._steps["sampled_decode_step"](
            z(S, 1), pools, z(S, nbs), z(S), eng._temps, eng._top_ks,
            eng._top_ps, eng._keys, eng._counters)


def _sampler_share(model, kv_cache_dtype, args, step_ms):
    """The sampler alone (``sample_at``: the fold, the filter and the
    Gumbel argmax over [S, V] f32 logits) on a captured sampled step's
    state and its forward pass's logits: its kernel time and count in
    three profiles, and the median's share of the sampled step's kernel
    time ``step_ms``."""
    from paddle_tpu_torch.models.generation import make_paged_decode_step
    from paddle_tpu_torch.serving.sampling import sample_at

    # the step's eager function (a package without graphs: the step)
    step = make_paged_decode_step(model, kv_cache_dtype)
    logits = getattr(step, "eager", step)(*_on_device(args[:4],
                                                      model.device))
    wall, _, dev_ms, top, kernels = _step_profile(sample_at,
                                                  (logits, *args[4:]))
    mid = float(np.median(dev_ms))
    share = mid / step_ms if step_ms else None
    print(f"  sampler alone ([{logits.shape[0]}, {logits.shape[1]}] f32 "
          f"logits): {wall:.3f} ms on the host's clock; kernels of "
          f"{len(dev_ms)} profiles: "
          + ", ".join(f"{ms:.3f} ms in {k}" for ms, k in
                      zip(dev_ms, kernels))
          + ("; share of the sampled step's kernel time "
             f"{share:.1%}" if share is not None else ""), flush=True)
    for name, ms, count in top:
        print(f"    {ms:8.3f} ms  {count:5d}x  {name[:90]}")
    return {"sampler_host_ms": wall, "sampler_device_ms": dev_ms,
            "sampler_kernels": kernels, "sampler_share": share}


def _check_sse(tag, frames, req):
    """The SSE frames of a streamed request: one ``data:`` frame a token
    (``{"token", "index"}``), in order, equal to its tokens, then its
    summary, then ``[DONE]``."""
    from paddle_tpu_torch.serving import DONE_FRAME

    body = []
    for f in frames[:-1]:
        if not (f.startswith("data: ") and f.endswith("\n\n")):
            raise AssertionError(f"{tag}: malformed SSE frame {f!r}")
        body.append(json.loads(f[len("data: "):]))
    want = [{"token": int(t), "index": i}
            for i, t in enumerate(req.generated)]
    summary = {"finish_reason": req.finish_reason,
               "num_tokens": len(req.generated),
               "request_id": req.request_id}
    if frames[-1] != DONE_FRAME or body != want + [summary]:
        raise AssertionError(f"{tag}: the SSE frames of {req.request_id} "
                             "are not its tokens, summary and [DONE]")
    print(f"  {tag}: {req.request_id} streamed {len(frames)} SSE frames: "
          f"{len(want)} tokens, the summary and [DONE]", flush=True)


def _step_profile(fn, args, reps=5, top=8, profiles=3):
    """(host-clock ms, event ms, [device ms], top kernels, [kernel
    count]) of one step: the first as the engine sees it (the step, then
    a synchronize); the second the median over ``reps`` calls of the time
    between CUDA events recorded on the stream just before and after the
    call (the device's span of a step, its idle gaps included); the third
    the sum of the step's kernel times in a torch.profiler trace of each
    of ``profiles`` more calls (0 where the trace shows no device time;
    one trace has missed kernels before); the fourth the ``top`` kernels
    by device time of the last trace as (name, ms, launches); the last
    the launches of every kernel in each trace."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    spans = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        spans.append(start.elapsed_time(end))
    traces = [_profile_once(fn, args) for _ in range(profiles)]
    return (wall, float(np.median(spans)), [ms for ms, _ in traces],
            traces[-1][1][:top],
            [sum(r[2] for r in rows) for _, rows in traces])


def _profile_once(fn, args):
    """(device ms, kernels) of one ``fn(*args)`` in a torch.profiler
    trace: the sum of its kernel times (0 when the trace shows no device
    time) and every kernel as (name, ms, launches), longest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    return sum(r[1] for r in rows), rows


# kernel families of a training step, by the first pattern a kernel's
# name holds (the rest is "other elementwise and reductions")
TRAIN_FAMILIES = [
    ("fused_linear kernel", ("fused_linear",)),
    ("FlashAttention kernels", ("fa_fwd", "fa_bwd")),
    ("MoE dispatch and combine kernels", ("moe_",)),
    ("RoPE kernel", ("rope_kernel",)),
    ("RMSNorm kernel", ("rms_norm", "rms_rows")),
    ("f32 products on TF32 (the chunked LM loss)", ("tf32",)),
    ("bf16 products (cuBLAS)", ("nvjet", "gemm", "xmma")),
    ("copies and casts", ("copy",)),
]


def _families(rows):
    """{family: (ms, launches)} of profiler rows, in TRAIN_FAMILIES'
    order, then the rest."""
    out = {name: [0.0, 0] for name, _ in TRAIN_FAMILIES}
    out["other elementwise and reductions"] = [0.0, 0]
    for key, ms, count in rows:
        fam = next((name for name, pats in TRAIN_FAMILIES
                    if any(p in key for p in pats)),
                   "other elementwise and reductions")
        out[fam][0] += ms
        out[fam][1] += count
    return out


# ---------------------------------------------------------------- phase 7
def phase_train(dev, cfg, T, tag, title, attn=None):
    """The training path of ``cfg`` (bf16, fused loss), one [1, T] batch
    with labels = tokens, AdamW(1e-4) with its defaults; every step and
    the eval forward launch exactly ``train_launches`` (``attn``: the
    attention's counters, by default no general instance).  Returns the
    launch counts of the whole phase.  A MoE model's MFU counts its
    active parameters: the experts' weights K / E of them."""
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    L, V, E = cfg.num_hidden_layers, cfg.vocab_size, cfg.moe_num_experts
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    opt = AdamW(1e-4, parameters=model.parameters())
    n_params = sum(p.numel() for p in model.parameters())
    experts = sum(p.numel() for n, p in model.named_parameters()
                  if n.endswith(("w_gate", "w_up", "w_down")))
    n_active = n_params - (experts * (E - cfg.moe_top_k) // E if E else 0)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, V, (1, T))).to(dev)
    torch.cuda.synchronize()
    print(f"[{tag}] {title}, bf16, {L} of 32 layers, {n_params / 1e9:.3f} B "
          f"parameters ({n_active / 1e9:.3f} B active), random weights "
          f"(seed 0) in {time.perf_counter() - t0:.1f} s; batch [1, {T}]",
          flush=True)
    per_step = train_launches(L, moe=E > 0, attn=attn)
    per_eval = train_launches(L, grad=False, moe=E > 0, attn=attn)
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def step():
        marks[0].record()
        return train_step(model, opt, tokens, marks[1:])

    def counted(fn, want, what):
        before = launches.snapshot()
        out = fn()
        got = {k: n - before.get(k, 0) for k, n in launches.snapshot().items()
               if n != before.get(k, 0)}
        if got != want:
            raise AssertionError(f"{what}: launches {got} != {want}")
        return out

    torch.cuda.synchronize()
    launches.reset()
    losses, step_ms, fwd_bwd_ms, opt_ms = [], [], [], []
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(counted(step, per_step, f"train step {i}"))
        torch.cuda.synchronize()
        if i >= TRAIN_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            fwd_bwd_ms.append(marks[0].elapsed_time(marks[1]))
            opt_ms.append(marks[1].elapsed_time(marks[2]))
    dev_ms, rows = counted(lambda: _profile_once(step, ()), per_step,
                           "profiled train step")
    with torch.no_grad():
        eval_loss = counted(lambda: float(model(tokens, labels=tokens)[0]),
                            per_eval, "eval forward")
    counts = phase_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"  losses {[round(x, 4) for x in losses]}, eval after "
          f"{len(losses) + 1} steps {eval_loss:.4f}, ln V {math.log(V):.4f}")
    print(f"  launches a step {per_step}; eval forward {per_eval}; phase "
          f"{counts}", flush=True)
    # logits of unit variance (normed rows against std 1/sqrt(hidden)
    # columns) put the first loss at ln V + 1/2 in expectation
    if not all(math.isfinite(x) for x in losses + [eval_loss]) or \
            abs(losses[0] - math.log(V)) > 1.0 or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"{tag}: losses {losses}, eval {eval_loss}")
    mean_ms = float(np.mean(step_ms))
    tok_s = T / mean_ms * 1e3
    flops_per_token = 6.0 * n_active + 12.0 * L * cfg.hidden_size * T
    out = dict(step_ms=step_ms, mean_step_ms=mean_ms, tokens_per_s=tok_s,
               fwd_bwd_ms=float(np.mean(fwd_bwd_ms)),
               adamw_ms=float(np.mean(opt_ms)),
               mfu=tok_s * flops_per_token / BF16_FLOPS,
               flops_per_token=flops_per_token, n_params=n_params,
               n_active_params=n_active,
               first_loss=losses[0], last_loss=losses[-1],
               eval_loss=eval_loss, peak_mem_gb=peak_gb,
               step_device_ms=dev_ms, layers=L, tokens=T)
    busy = f"busy {dev_ms / mean_ms:.1%}" if dev_ms else "not measured"
    print(f"  step {mean_ms:.1f} ms on the host's clock (mean of "
          f"{TRAIN_STEPS}), {tok_s:.0f} tokens/s, MFU {out['mfu']:.1%}; "
          f"forward+backward {out['fwd_bwd_ms']:.1f} ms and AdamW "
          f"{out['adamw_ms']:.1f} ms on the device's clock; "
          f"one step's kernels {dev_ms:.1f} ms on the device ({busy}); "
          f"peak memory {peak_gb:.1f} GB", flush=True)
    print("  by family:")
    for name, (ms, count) in _families(rows).items():
        print(f"    {ms:8.3f} ms  {count:5d}x  {name}")
    print("  top kernels:")
    for name, ms, count in rows[:12]:
        print(f"    {ms:8.3f} ms  {count:5d}x  {name[:90]}")
    print(f"  {json.dumps(out)}", flush=True)
    return counts


def phase_train_phi3(dev, attn=None):
    """Phase 7c: phase 7's training path at Phi-3-mini's widths
    (phi3_mini_config: 32 heads of 96), PHI3_LAYERS layers, one [1,
    PHI3_T] batch.  A step's attention launches ``attn`` (by default
    every kernel on its 128-column wgmma instance under its own name,
    and no general instance of any kernel; ``tools/turns`` passes an
    older checkout's routes).  Returns the phase's launch counts."""
    counts = phase_train(dev, phi3_mini_config(
        num_hidden_layers=PHI3_LAYERS, fused_lm_loss=True), PHI3_T,
        "train phi3", "Phi-3-mini width", attn)
    general = sorted(k for k in counts if "_general" in k)
    if attn is None and general:
        raise AssertionError(f"train phi3: general instances launched: "
                             f"{general}")
    return counts


# ------------------------------------------------------- static graph
# (tag, M, K, N, activation, bias, dtype) of phase 2s; the first two are
# the main path's (BERT-base's FFN and MLM transform) and go in the
# kernels' JSON line
def fl_cases():
    M, H, FFN, bf = BERT_B * BERT_T, 768, 3072, torch.bfloat16
    return (("ffn", M, H, FFN, "gelu", True, bf),
            ("mlm", M, H, H, "gelu", True, bf),
            ("none", M, H, FFN, "none", True, bf),
            ("relu", M, H, FFN, "relu", True, bf),
            ("silu", M, H, FFN, "silu", True, bf),
            ("gelu_tanh", M, H, FFN, "gelu_tanh", True, bf),
            ("no bias", M, H, FFN, "gelu", False, bf),
            ("ragged", M - 3, H, FFN - 5, "gelu", True, bf),
            ("ragged8", M - 3, H, FFN - 8, "gelu", True, bf),
            ("k771", M, 771, FFN, "gelu", True, bf),
            ("f32", 4096, H, FFN, "gelu", True, torch.float32))


def phase_static_kernels(dev):
    """fused_linear against its plain version at BERT-base's shapes
    (``fl_cases``), with its time, the plain version's, the library call's
    (the activation of ``F.linear``: cuBLAS, then an elementwise pass)
    and its bound; then its backward at the FFN shape against autograd
    through the plain version.  Returns the JSON entries of the two main
    path shapes."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import fused_linear as fl

    g = torch.Generator(device=dev).manual_seed(5)
    library = {"none": lambda z: z, "relu": torch.relu, "gelu": F.gelu,
               "gelu_tanh": lambda z: F.gelu(z, approximate="tanh"),
               "silu": F.silu}
    entries, json_entries = {}, {}
    print("[static kernels] fused_linear at BERT-base shapes (M = "
          f"{BERT_B} x {BERT_T} tokens, hidden 768, FFN 3072)", flush=True)
    for tag, m, k, n, act, bias, dtype in fl_cases():
        x = torch.randn((m, k), generator=g, device=dev).to(dtype)
        w = (torch.randn((n, k), generator=g, device=dev)
             * k ** -0.5).to(dtype)
        b = (torch.randn((n,), generator=g, device=dev) * 0.1).to(dtype) \
            if bias else None
        got = fl.fused_linear(x, w, b, act)
        ref = fl.fused_linear_plain(x, w, b, act)
        tol = bf16_tol(ref) if dtype == torch.bfloat16 \
            else F32_TOL * max(1.0, float(ref.abs().max()))
        instance = "f32" if dtype == torch.float32 \
            else "wgmma" if fl.tma_ok(x, w) else "predicated"
        work = (f"[{m}, {k}] x [{n}, {k}]^T, {act}"
                f"{' + bias' if bias else ''}, {str(dtype)[6:]}, "
                f"{instance} instance")
        err = check_close(f"fused_linear {tag}: {work}", got, ref, tol)
        peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
        nbytes = x.element_size() * (m * k + n * k + m * n
                                     + (n if bias else 0))
        name = "fused_linear" if tag == "ffn" else f"fused_linear_{tag}"
        entries[name] = dict(
            path="static_train", counter=fl.KERNEL,
            replaces="paddle_tpu/kernels/fused_linear.py:42",
            source="paddle_tpu_torch/csrc/fused_linear.cu", max_abs_err=err,
            ms=time_ms(lambda: fl.fused_linear(x, w, b, act)),
            plain_ms=time_ms(lambda: fl.fused_linear_plain(x, w, b, act),
                             iters=5),
            library_ms=time_ms(lambda: library[act](F.linear(x, w, b))),
            bound=bound_ms(nbytes, 2.0 * m * n * k, peak), work=work)
        if tag in ("ffn", "mlm"):
            json_entries[name] = entries[name]
        if tag == "mlm":
            # the wgmma instance frees its ring stages without a proxy
            # fence and reuses its output staging after each TMA store:
            # RING_STRESS launches, every bit compared with the first
            bad = torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(RING_STRESS):
                bad += (fl.fused_linear(x, w, b, act) != got).any()
            print(f"  fused_linear {tag}: {RING_STRESS} more launches, "
                  f"{int(bad)} differ from the first", flush=True)
            if int(bad):
                raise AssertionError("fused_linear: the ring stress found "
                                     f"{int(bad)}")
        del got, ref
    # the backward (plain PyTorch on both paths: the reference's is XLA)
    # at the FFN shape: the kernel path's autograd.Function against
    # autograd through the plain version
    _, m, k, n, act, _, dtype = fl_cases()[0]
    x = torch.randn((m, k), generator=g, device=dev).to(dtype)
    w = (torch.randn((n, k), generator=g, device=dev) * k ** -0.5).to(dtype)
    b = (torch.randn((n,), generator=g, device=dev) * 0.1).to(dtype)
    cot = torch.randn((m, n), generator=g, device=dev).to(dtype)
    grads = []
    for fn in (fl.fused_linear, fl.fused_linear_plain):
        ops = [t.clone().requires_grad_() for t in (x, w, b)]
        grads.append(torch.autograd.grad(fn(*ops, act), ops, cot))
    for what, got, ref in zip(("dx", "dw", "db"), *grads):
        check_close(f"fused_linear backward {what} {tuple(ref.shape)}",
                    got, ref, bf16_tol(ref))
    print("  library: the activation of F.linear(x, w, b) (cuBLAS, then an "
          "elementwise pass)")
    print_entries(entries)
    return json_entries


def bert_batch(V, B, T, seed, dev):
    """A pretraining batch: random token ids, sequences of T * 3 / 4 .. T
    tokens (the first full) padded and masked after, 15 % of the real
    positions as MLM labels (-100 elsewhere)."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(T * 3 // 4, T + 1, B)
    lens[0] = T
    mask = np.arange(T)[None, :] < lens[:, None]
    labels = np.where(mask & (rng.rand(B, T) < 0.15),
                      rng.randint(0, V, (B, T)), -100)
    return {"input_ids": torch.from_numpy(rng.randint(0, V, (B, T))),
            "attention_mask": torch.from_numpy(mask.astype(np.float32)),
            "masked_lm_labels": torch.from_numpy(labels)}, int(lens.sum())


def static_bert_program(model, B, T, make_opt):
    """BERT pretraining recorded as a static Program through the port's
    entry points: ``static.data`` under ``program_guard``, the model's
    forward and loss, ``make_opt(model).minimize(loss)``, then
    ``apply_build_strategy`` with the loss kept (fuse_linear_act and
    eliminate_dead_ops).  Returns (Program, loss Variable, rewrites)."""
    from paddle_tpu_torch import static

    static.enable_static()
    try:
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            ids = static.data("input_ids", [B, T], "int64")
            mask = static.data("attention_mask", [B, T], "float32")
            labels = static.data("masked_lm_labels", [B, T], "int64")
            loss, _, _ = model(ids, attention_mask=mask,
                               masked_lm_labels=labels)
            make_opt(model).minimize(loss)
        rewrites = static.apply_build_strategy(main, keep=[loss.name])
    finally:
        static.disable_static()
    return main, loss, rewrites


def phase_tiny_static(dev):
    """BertConfig.tiny() in f32, dropout 0, the same seeded weights on
    cpu (plain versions) and cuda (the kernel), each recorded as a
    static Program with AdamW.minimize and the build strategy: 5 steps
    on one batch, losses within F32_TOL, 3 fused_linear launches a step
    on cuda and none on cpu.  Then ``static.nn.fc(x [None, 3], 5,
    "relu")`` fused to one fused_linear of K = 3, cuda against cpu."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.kernels import fused_linear as fl
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    cfg = BertConfig.tiny(hidden_dropout_prob=0.0,
                          attention_probs_dropout_prob=0.0)
    state = BertForPretraining(cfg, device="cpu", seed=0).state_dict()
    feed, _ = bert_batch(cfg.vocab_size, 2, 48, 2, "cpu")
    losses = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
        model = BertForPretraining(cfg, device=device, seed=None)
        model.load_state_dict(state)
        main, loss, _ = static_bert_program(
            model, 2, 48, lambda m: AdamW(1e-3,
                                          parameters=m.named_parameters()))
        exe = static.Executor(device)
        want = {fl.KERNEL: 3} if name == "cuda" else {}
        out = []
        for _ in range(5):
            launches.reset()
            out.append(float(exe.run(main, feed=feed, fetch_list=[loss])[0]))
            if launches.snapshot() != want:
                raise AssertionError(f"tiny static on {name}: launches "
                                     f"{launches.snapshot()} != {want}")
        losses[name] = out
    diff = float(np.abs(np.subtract(losses["cuda"], losses["cpu"])).max())
    print(f"[tiny static] BERT tiny, f32, static Program, 5 AdamW steps: "
          f"cuda losses {[round(x, 6) for x in losses['cuda']]}, max |cuda "
          f"- cpu| {diff:.2e} (tolerance {F32_TOL:.0e}); {fl.KERNEL} "
          f"launches a step 3", flush=True)
    if not diff <= F32_TOL or not losses["cuda"][-1] < losses["cuda"][0]:
        raise AssertionError(f"tiny static: losses {losses}")

    # static.nn.fc(x [None, 3], 5, "relu"), fused: K = 3 runs on the card
    rng = np.random.RandomState(3)
    xv = rng.randn(7, 3).astype(np.float32)
    w, b = rng.randn(5, 3).astype(np.float32), rng.randn(5).astype(np.float32)
    outs = {}
    for name, device in (("cpu", "cpu"), ("cuda", dev)):
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
        ops = [op.type for op in main.global_block().ops]
        launches.reset()
        outs[name] = static.Executor(device).run(main, feed={"x": xv},
                                                 fetch_list=[y])[0]
        want = {fl.KERNEL: 1} if name == "cuda" else {}
        if ops != ["fused_linear"] or launches.snapshot() != want:
            raise AssertionError(f"fc K=3 on {name}: ops {ops}, launches "
                                 f"{launches.snapshot()} != {want}")
    diff = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    print(f"  fused fc, K = 3: max |cuda - cpu| {diff:.2e} (tolerance "
          f"{F32_TOL:.0e}), 1 {fl.KERNEL} launch", flush=True)
    if not diff <= F32_TOL:
        raise AssertionError(f"fc K=3: cuda differs from cpu by {diff}")


def _bert_no_decay(name):
    """AdamW decays every weight but the biases and the LayerNorms'."""
    return not (name.endswith("bias") or "norm" in name)


def phase_static_train(dev):
    """BERT-base pretraining as a static Program: full width and depth
    (BERT_LAYERS of 12), bf16, dropout 0.1 from an explicit generator,
    one [BERT_B, BERT_T] batch, AdamW(1e-4, weight decay 0.01 except on
    biases and norms), the build strategy applied after minimize.
    Returns the launch counts of the phase."""
    from paddle_tpu_torch import static
    from paddle_tpu_torch.kernels import fused_linear as fl
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import BertConfig, BertForPretraining
    from paddle_tpu_torch.optimizer import AdamW

    torch.cuda.reset_peak_memory_stats()
    cfg = BertConfig.base(num_hidden_layers=BERT_LAYERS, dtype="bfloat16")
    L, V, B, T = cfg.num_hidden_layers, cfg.vocab_size, BERT_B, BERT_T
    t0 = time.perf_counter()
    model = BertForPretraining(cfg, device=dev, seed=0, generator=torch
                               .Generator(device=dev).manual_seed(1))
    n_params = sum(p.numel() for p in model.parameters())
    main, loss, rewrites = static_bert_program(
        model, B, T, lambda m: AdamW(
            1e-4, weight_decay=0.01, parameters=m.named_parameters(),
            apply_decay_param_fun=_bert_no_decay))
    ops = main.global_block().ops
    producer = {o.name: op for op in ops for o in op.outputs}
    pairs = [op for op in ops if op.type == "gelu" and any(
        v.name in producer and producer[v.name].type == "linear"
        for v in op.var_inputs())]
    n_fused = sum(op.type == fl.KERNEL for op in ops)
    feed, real_tokens = bert_batch(V, B, T, 3, "cpu")
    feed = {k: v.to(dev) for k, v in feed.items()}
    exe = static.Executor(dev)
    torch.cuda.synchronize()
    print(f"[static train] BERT-base, bf16, {L} of 12 layers, "
          f"{n_params / 1e6:.1f} M parameters, dropout "
          f"{cfg.hidden_dropout_prob}; static Program of {len(ops)} ops "
          f"({n_fused} fused_linear, {rewrites} rewrites by the build "
          f"strategy) recorded in {time.perf_counter() - t0:.1f} s; batch "
          f"[{B}, {T}], {real_tokens} real tokens", flush=True)
    if n_fused != L + 1 or pairs:
        raise AssertionError(f"static train: {n_fused} fused_linear ops, "
                             f"{len(pairs)} linear -> gelu pairs left")
    per_step = {fl.KERNEL: L + 1}
    # CUDA events at a step's start, after its backward op and at its
    # end split the device time into forward+backward and the updates
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    backward = exe._backward

    def marked_backward(*args, **kwargs):
        backward(*args, **kwargs)
        marks[1].record()

    exe._backward = marked_backward

    def step():
        marks[0].record()
        out = float(exe.run(main, feed=feed, fetch_list=[loss])[0])
        marks[2].record()
        return out

    def counted(fn, what):
        launches.reset()
        out = fn()
        if launches.snapshot() != per_step:
            raise AssertionError(f"{what}: launches {launches.snapshot()} "
                                 f"!= {per_step}")
        return out

    counts = {}
    losses, step_ms, fwd_bwd_ms, opt_ms = [], [], [], []
    for i in range(BERT_WARMUP + BERT_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(counted(step, f"static train step {i}"))
        torch.cuda.synchronize()
        if i >= BERT_WARMUP:
            step_ms.append((time.perf_counter() - t0) * 1e3)
            fwd_bwd_ms.append(marks[0].elapsed_time(marks[1]))
            opt_ms.append(marks[1].elapsed_time(marks[2]))
        for k, n in launches.snapshot().items():
            counts[k] = counts.get(k, 0) + n
    dev_ms, rows = counted(lambda: _profile_once(step, ()),
                           "profiled static train step")
    counts = {k: n + per_step[k] for k, n in counts.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"  losses {[round(x, 4) for x in losses]}, ln V {math.log(V):.4f}"
          f"; launches a step {per_step}; phase {counts}", flush=True)
    # MLM logits of std ~0.55 (normed rows against std-0.02 embeddings)
    # put the first loss just above ln V
    if not all(math.isfinite(x) for x in losses) or \
            abs(losses[0] - math.log(V)) > 1.0 or not losses[-1] < losses[0]:
        raise AssertionError(f"static train: losses {losses}")
    mean_ms = float(np.mean(step_ms))
    # tokens/s counts the batch's real tokens; MFU counts every position,
    # padding included, since the step computes all of them
    tok_s = real_tokens / mean_ms * 1e3
    pos_s = B * T / mean_ms * 1e3
    flops_per_token = 6.0 * n_params + 12.0 * L * cfg.hidden_size * T
    out = dict(step_ms=step_ms, mean_step_ms=mean_ms, tokens_per_s=tok_s,
               positions_per_s=pos_s, padding=1.0 - real_tokens / (B * T),
               fwd_bwd_ms=float(np.mean(fwd_bwd_ms)),
               update_ms=float(np.mean(opt_ms)),
               mfu=pos_s * flops_per_token / BF16_FLOPS,
               flops_per_token=flops_per_token, n_params=n_params,
               first_loss=losses[0], last_loss=losses[-1],
               peak_mem_gb=peak_gb, step_device_ms=dev_ms, layers=L,
               batch=[B, T], real_tokens=real_tokens, program_ops=len(ops))
    busy = f"busy {dev_ms / mean_ms:.1%}" if dev_ms else "not measured"
    print(f"  step {mean_ms:.1f} ms on the host's clock (mean of "
          f"{BERT_STEPS}), {tok_s:.0f} real tokens/s, {pos_s:.0f} "
          f"positions/s, MFU {out['mfu']:.1%} on all positions "
          f"({out['padding']:.1%} padding); "
          f"forward+backward {out['fwd_bwd_ms']:.1f} ms and the update ops "
          f"{out['update_ms']:.1f} ms between CUDA events; one step's "
          f"kernels {dev_ms:.1f} ms on the device ({busy}); peak memory "
          f"{peak_gb:.1f} GB", flush=True)
    print("  by family:")
    for name, (ms, count) in _families(rows).items():
        print(f"    {ms:8.3f} ms  {count:5d}x  {name}")
    print("  top kernels:")
    for name, ms, count in rows[:12]:
        print(f"    {ms:8.3f} ms  {count:5d}x  {name[:90]}")
    print(f"  {json.dumps(out)}", flush=True)
    return counts


def free():
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaConfig

    dev = torch.device("cuda")
    # f32 products in full f32 (PyTorch's default) wherever results are
    # compared; the fused loss picks TF32 itself for its bf16 rows
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t_all = time.perf_counter()
    phase_build()
    entries = phase_kernels(dev)
    train_entries = phase_train_kernels(dev)
    moe_entries = phase_moe_kernels(dev)
    free()
    c1_entries = phase_c1_kernels(dev)
    free()
    static_entries = phase_static_kernels(dev)
    free()
    phase_sampler(dev)
    launches.reset()
    phase_tiny(dev)
    phase_tiny_train(dev)
    phase_tiny_moe(dev)
    c1_tiny_counts = phase_tiny_c1(dev)
    phase_tiny_static(dev)
    counts, bf16_blocks, spec_counts, spec_entries = phase_main(dev)
    free()                        # each serving model's 16 GB go first
    quant_counts = phase_main_quant(dev, bf16_blocks)
    free()
    c1_counts = phase_c1_main(dev)
    free()
    phi3_serve_counts = phase_phi3_main(dev)
    free()
    moe_counts = phase_moe_main(dev)
    free()                        # the MoE model's 47 GB
    train_counts = phase_train(dev, LlamaConfig.llama3_8b(
        num_hidden_layers=TRAIN_LAYERS, fused_lm_loss=True), TRAIN_T,
        "train", "Llama-3-8B width")
    free()
    phi3_counts = phase_train_phi3(dev)
    free()
    moe_train_counts = phase_train(dev, mixtral_config(
        num_hidden_layers=MOE_TRAIN_LAYERS, fused_lm_loss=True),
        MOE_TRAIN_T, "train moe", "Mixtral-8x7B width")
    free()
    static_counts = phase_static_train(dev)
    runs = {"serve": counts, "quant": quant_counts, "train": train_counts,
            "moe_serve": moe_counts, "moe_train": moe_train_counts,
            "static_train": static_counts, "c1_tiny": c1_tiny_counts,
            "c1_serve": c1_counts, "train_phi3": phi3_counts,
            "phi3_serve": phi3_serve_counts, "spec": spec_counts}
    kernels = []
    for name, e in [*entries.items(), *train_entries.items(),
                    *moe_entries.items(), *c1_entries.items(),
                    *static_entries.items(), *spec_entries.items()]:
        # launches: from the main phase of the kernel's own path (bf16
        # serving, quantized serving or training), under the name of the
        # kernel's counter, of the row's own instance where it has one
        path = e.get("path", "serve" if name in entries else "train")
        counter = e.get("counter", name)
        if "instance" in e:
            counter += "@" + e["instance"]
        n = runs[path].get(counter, 0)
        if n == 0:
            raise AssertionError(f"{name}: no launch on its main path "
                                 f"({path})")
        kernels.append({
            "name": name, "route": "cuda", "source": e["source"],
            "replaces": e["replaces"], "launches": n,
            **({"instance": e["instance"]} if "instance" in e else {}),
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
            "bound_by": e["bound"][1], "library_ms": e["library_ms"],
            "bound_share": e["bound"][0] / e["ms"],
            "x_library": None if e["library_ms"] is None
            else e["ms"] / e["library_ms"],
            **{k: e[k] for k in ("hot_ms", "library_hot_ms") if k in e}})
    print(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
