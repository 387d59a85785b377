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
     by which the kernel loses to the library call);
     the paged-decode and chunked-prefill kernels also on int8 and fp8
     KV pools, and the quantize-at-write scatter, bit-identical; the
     fused_norm_linear groups (skinny and tiled) launched RING_STRESS
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
  7. main training: Llama-3-8B width, 8 of its 32 layers, bf16, one
     [1, 8192] batch, AdamW(1e-4): 2 warm-up and 5 timed steps, one
     profiled step and one eval forward without grad; finite, falling
     losses and exact launch counts per step.
Mixture of experts (Mixtral-8x7B's shape, mixtral_config):
  2m. MoE kernels: dispatch and combine against their plain versions at
     hidden 4096, 8 experts, top-2, bf16, at a decode step's, a prefill
     chunk's and a training batch's shapes, a dropping capacity and the
     duplicate-slot form a backward pass feeds dispatch;
  4m. tiny MoE: LlamaConfig.tiny with 4 experts, top-2, capacity factor
     2.0 (dropless), served on cuda and cpu from f32 and fp8 pools as in
     phase 4, and trained 5 AdamW steps on both as in phase 5;
  6m. main MoE serving: Mixtral width, 16 of its 32 layers, bf16, behind
     serving.Engine with phase 6's 8 requests, dropless routing (capacity
     factor 4.0 = E / K, as Mixtral routes);
  7m. main MoE training: Mixtral width, 2 layers, one [1, 4096] batch,
     as phase 7.
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
The launch counts of phases 6, 7, 6m, 7m and 7s, reset just before each
run and read just after it, show that each path went through every
kernel of its own.

Prints the card's name and power limit, then one JSON line of the
kernels' numbers, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Exits non-zero, printing no result, without a CUDA device.
"""
from __future__ import annotations

import gc
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


# the kernels whose -Xptxas -v lines phase 1 prints one by one
REDESIGNED = {"paged_attention": ("hopper",),
              "fused_norm_linear": ("skinny_mma", "wgmma"),
              "chunked_prefill": ("wgmma",),
              "flash_attention": ("wgmma",),
              "fused_linear": ("wgmma",)}


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

    from paddle_tpu_torch.kernels import (chunked_prefill,
                                          fused_norm_linear as fnl,
                                          kv_quant, launches,
                                          paged_attention, rms_norm)

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

    # fused_norm_linear: the 5 projections of one layer (q, k, v, gate
    # with silu, up), skinny at decode M = 8 and tiled at prefill M = 256,
    # one launch for q/k/v and one for gate/up, as the model calls them
    # (fused_norm_linear_group); each run twice and compared bit for
    # bit, then RING_STRESS times
    projs = [(H * D, "none"), (KVH * D, "none"), (KVH * D, "none"),
             (FFN, "silu"), (FFN, "none")]
    groups = ((0, 1, 2), (3, 4))
    ws = [randn(HID, n, std=HID ** -0.5) for n, _ in projs]
    nw = (1 + 0.1 * randn(HID, dtype=torch.float32)).to(bf)
    for M, name in ((8, "fused_norm_linear_skinny"),
                    (256, "fused_norm_linear_tiled")):
        x = randn(M, HID) * 3
        rs = fnl.rms_scale(x, eps)

        def run_kernel():
            return [o for grp in groups for o in fnl.fused_norm_linear_group(
                x, rs, nw, [ws[i] for i in grp],
                [projs[i][1] for i in grp])]

        errs = []
        launches.reset()
        got_all, again = run_kernel(), run_kernel()
        if launches.snapshot() != {name: 2 * len(groups)}:
            raise AssertionError(f"{name}: launches {launches.snapshot()}, "
                                 f"not {len(groups)} a run")
        if not all(torch.equal(a, b) for a, b in zip(got_all, again)):
            raise AssertionError(f"{name}: two runs differ")
        # a refill of a TMA ring stage under its readers gives a wrong
        # sum now and then, not a hang: many launches, every bit compared
        bad = torch.zeros((len(projs),), dtype=torch.int64, device=dev)
        for _ in range(RING_STRESS):
            bad += torch.stack([(a != b).any()
                                for a, b in zip(run_kernel(), got_all)])
        bad = bad.tolist()
        print(f"  {name}: {RING_STRESS} launches of each group, outputs "
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
        entries[name] = dict(
            replaces="paddle_tpu/kernels/fused_norm_linear.py:60",
            source="paddle_tpu_torch/csrc/fused_norm_linear.cu",
            max_abs_err=max(errs), ms=time_ms(run_kernel, iters=10),
            plain_ms=time_ms(run_plain, iters=10),
            library_ms=time_ms(run_library, iters=10),
            bound=bound_ms(nbytes, 2.0 * M * HID * N_all),
            work=f"q,k,v,gate,up of one layer at M={M}")

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
    q_rot = paged_attention._rotate_half(
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
            path=path, replaces="paddle_tpu/kernels/paged_attention.py:102",
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
            path=path, replaces="paddle_tpu/kernels/chunked_prefill.py:51",
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
    entries.update(scatter_entries(g, nb, bs, KVH, D, B, T))
    print_entries(entries)
    return entries


def _gathered(pool, bt, n_keys):
    """[B, KVH, n_keys, D] contiguous K or V of the first n_keys pages
    of ``bt``: the library yardstick's input."""
    B, nbs = bt.shape
    bs, KVH, D = pool.shape[1:]
    return pool[bt.long()].reshape(B, nbs * bs, KVH, D)[:, :n_keys] \
        .transpose(1, 2).contiguous()


def scatter_entries(g, nb, bs, KVH, D, B, T):
    """The quantize-at-write scatter at a decode step's [B, KVH, D] and a
    prefill chunk's [T, KVH, D] new k and v rows of one layer, into
    distinct rows of [nb, bs] int8 pools (rows that several tokens share,
    the garbage block's row 0, take any one of them in both versions):
    bit-identical to its plain version for both schemes, timed in fp8."""
    from paddle_tpu_torch.kernels import kv_quant

    dev, entries = g.device, {}
    for N, name in ((B, "kv_quant_scatter"), (T, "kv_quant_scatter_chunk")):
        new = [(torch.randn((N, KVH, D), generator=g, device=dev)
                * torch.logspace(-2, 2, N, device=dev)[:, None, None])
               .to(torch.bfloat16) for _ in range(2)]
        rows = torch.randperm(nb * bs, generator=g, device=dev)[:N]
        for scheme in ("int8", "fp8"):
            pools = [torch.zeros((nb, bs, KVH, D), dtype=torch.int8,
                                 device=dev) for _ in range(2)] + \
                [torch.ones((nb, bs), device=dev) for _ in range(2)]
            want = [x.clone() for x in pools]
            kv_quant.quantize_scatter(*pools, *new, rows, scheme)
            kv_quant.quantize_scatter_plain(*want, *new, rows, scheme)
            same = all(torch.equal(a, b) for a, b in zip(pools, want))
            print(f"  {name} [{N}, {KVH}, {D}] {scheme}: "
                  f"{'bit-identical' if same else 'FAIL'}", flush=True)
            if not same:
                raise AssertionError(f"{name} {scheme}: the kernel's codes "
                                     "or scales differ from the plain "
                                     "version's")
        args = (*pools, *new, rows, "fp8")
        entries[name] = dict(
            path="quant", counter=kv_quant.KERNEL,
            replaces="paddle_tpu/kernels/paged_attention.py:80" if N == B
            else "paddle_tpu/models/llama.py:390",
            source="paddle_tpu_torch/csrc/kv_quant.cu", max_abs_err=0.0,
            ms=time_ms(lambda: kv_quant.quantize_scatter(*args)),
            plain_ms=time_ms(lambda: kv_quant.quantize_scatter_plain(*args)),
            library_ms=None,
            # each element read once in bf16 and written once as a code,
            # each row's scale written, each row index read
            bound=bound_ms(2 * N * KVH * D * (2 + 1) + 2 * 4 * N + 8 * N,
                           2 * 3.0 * N * KVH * D, F32_FLOPS),
            work=f"k and v rows [{N}, {KVH}, {D}] of one layer, fp8")
    return entries


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
    entries[fa.FWD] = dict(
        replaces=f"{where}:54", source=src, max_abs_err=err["o"],
        ms=time_ms(lambda: fa._fwd_kernel(q, k, v, True, scale, False),
                   iters=10),
        plain_ms=plain_fwd_ms, library_ms=sdpa_ms,
        bound=bound_ms(2 * q_bytes + 2 * kv_bytes, 2 * prod), work=work)
    entries[fa.FWD_LSE] = dict(
        replaces=f"{where}:97", source=src,
        max_abs_err=max(err["o"], err["lse"]),
        ms=time_ms(lambda: fa._fwd_kernel(q, k, v, True, scale, True),
                   iters=10),
        plain_ms=plain_fwd_ms, library_ms=sdpa_grad_ms,
        bound=bound_ms(2 * q_bytes + 2 * kv_bytes + row_bytes, 2 * prod),
        work=work)
    entries[fa.BWD_DQ] = dict(
        replaces=f"{where}:113", source=src, max_abs_err=err["dq"],
        ms=time_ms(lambda: fa._dq_kernel(*ops, True, scale), iters=10),
        plain_ms=plain_bwd_ms, library_ms=sdpa_bwd_ms,
        bound=bound_ms(3 * q_bytes + 2 * kv_bytes + 2 * row_bytes,
                       3 * prod), work=work)
    entries[fa.BWD_DKV] = dict(
        replaces=f"{where}:151", source=src,
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
        err = check_exact(f"moe_dispatch {work}",
                          md.moe_dispatch(tok, eidx, sidx, ones, E, C),
                          md.dispatch_plain(tok, eidx, sidx, ones, E, C))
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


def _tiny_run(dev, kv_cache_dtype, weight_dtype, cfg=None):
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
    outs, stats = {}, {}
    for name, model in (("cpu", cpu_model), ("cuda", cuda_model)):
        eng = Engine(model, ServingConfig(
            max_batch_size=4, block_size=8, num_blocks=20, chunk_tokens=16,
            kv_cache_dtype=kv_cache_dtype, weight_dtype=weight_dtype))
        reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
        eng.run_until_complete()
        eng.pool.check_leaks()
        outs[name] = [r.generated for r in reqs]
        stats[name] = eng.stats()["counters"]
    c = stats["cuda"]
    moe = f", {cfg.moe_num_experts} experts" if cfg.moe_num_experts else ""
    print(f"[tiny{moe and ' moe'}] f32{moe}, KV {kv_cache_dtype or 'f32'}, "
          f"weights "
          f"{weight_dtype or 'f32'}, {len(prompts)} requests: preemptions "
          f"{c['preemptions']}, prefix-cache hits {c['prefix_cache_hits']}",
          flush=True)
    if c["preemptions"] == 0 or c["prefix_cache_hits"] == 0:
        raise AssertionError("the tiny phase must preempt and hit the "
                             f"prefix cache: {c}")
    for i, (a, b) in enumerate(zip(outs["cpu"], outs["cuda"])):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        top2 = torch.topk(_prefix_logits(cpu_model, np.concatenate(
            [prompts[i], a[:j]]), 8, 16, kv_cache_dtype), 2).values
        margin = float(top2[0] - top2[1])
        print(f"  request {i}: token {j} differs (cpu {a[j]}, cuda {b[j]}), "
              f"cpu top-2 margin {margin:.3e}")
        if margin >= F32_TOL:
            raise AssertionError(f"tiny: request {i} token {j} differs "
                                 f"with margin {margin} >= {F32_TOL}")
    print("  cuda tokens == cpu tokens", flush=True)


# ---------------------------------------------------------------- phase 5
def train_launches(L, grad=True, moe=False):
    """Kernel launches of one training step (``grad``) or one forward
    without grad of an L-layer model: two RMSNorms a layer and the final
    one (forward only: their backward is plain PyTorch); RoPE on q and
    k, forward and backward; one attention forward, dQ and dK/dV; with
    ``moe``, one dispatch and one combine a layer, and in the backward
    each again as the other's gradient."""
    from paddle_tpu_torch.kernels import flash_attention as fa

    if not grad:
        out = {"rms_norm": 2 * L + 1, "rope": 2 * L, fa.FWD: L}
    else:
        out = {"rms_norm": 2 * L + 1, "rope": 4 * L, fa.FWD_LSE: L,
               fa.BWD_DQ: L, fa.BWD_DKV: L}
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


def _serve_main(model, prompts, tag, kv_cache_dtype=None, weight_dtype=None,
                **pool_size):
    """One run of the main serving path: the 8 requests through
    ``serving.Engine`` with the launch counts set to 0 just before and
    read just after, held to exact counts, no leak, and the 128-token
    request's first token equal to a fresh prefill's through a pool of
    the same KV dtype.  Prints the run's numbers and one profiled decode
    and prefill step.  Returns (numbers, launch counts, engine)."""
    from paddle_tpu_torch.kernels import (chunked_prefill, launches,
                                          paged_attention)
    from paddle_tpu_torch.kernels.kv_quant import KERNEL as SCATTER
    from paddle_tpu_torch.kernels.kv_quant import counter_name
    from paddle_tpu_torch.serving import Engine, ServingConfig

    cfg, V, bs, new = model.config, model.config.vocab_size, MAIN_BS, \
        MAIN_NEW
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(model, ServingConfig(
        max_batch_size=8, block_size=bs, chunk_tokens=256,
        kv_cache_dtype=kv_cache_dtype, weight_dtype=weight_dtype,
        **pool_size))
    captured = _capture_steps(eng)
    torch.cuda.synchronize()
    launches.reset()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, max_new_tokens=new) for p in prompts[:-1]]
    # the last prompt shares the first one's 512-token prefix: submit it
    # once that prefix is registered, so it is served from the cache
    while not reqs[0].generated:
        eng.step()
    reqs.append(eng.submit(prompts[-1], max_new_tokens=new))
    eng.run_until_complete()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches.snapshot()
    st = eng.stats()
    eng.pool.check_leaks()
    for r in reqs:
        if r.finish_reason != "length" or len(r.generated) != new or \
                not all(0 <= t < V for t in r.generated):
            raise AssertionError(f"{tag} {r.request_id}: {r.finish_reason}, "
                                 f"{len(r.generated)} tokens")
    ctr = st["counters"]
    L = cfg.num_hidden_layers
    chunks, decodes = ctr["prefill_chunks"], ctr["decode_iterations"]
    if cfg.moe_num_experts:
        # a MoE layer serves unfused: its two norms, then one dispatch
        # and one combine
        per_layer = {"rms_norm": 2 * L + 1, "moe_dispatch": L,
                     "moe_combine": L}
        per_decode, per_chunk = dict(per_layer), dict(per_layer)
    else:
        # q/k/v in one launch, gate/up in another, in both steps
        per_decode = {"rms_norm": 1, "fused_norm_linear_skinny": 2 * L}
        per_chunk = {"rms_norm": 1, "fused_norm_linear_tiled": 2 * L}
    per_decode[counter_name(paged_attention.KERNEL, kv_cache_dtype)] = L
    per_chunk[counter_name(chunked_prefill.KERNEL, kv_cache_dtype)] = L
    if kv_cache_dtype is not None:
        per_decode[SCATTER] = per_chunk[SCATTER] = L
    expect = {k: per_decode.get(k, 0) * decodes + per_chunk.get(k, 0) * chunks
              for k in {**per_decode, **per_chunk}}
    print(f"  launches {counts} over {chunks} prefill chunks and {decodes} "
          f"decode steps; expected per decode step {per_decode}, per "
          f"prefill chunk {per_chunk}", flush=True)
    if counts != expect:
        raise AssertionError(f"{tag}: launch counts {counts} != {expect}")
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
               prefix_cache_hits=ctr["prefix_cache_hits"],
               prefill_chunks=chunks, decode_iterations=decodes,
               layers=L, kv_dtype=st["pool"]["kv_dtype"],
               weight_dtype=weight_dtype, num_blocks=eng.num_blocks,
               block_bytes=st["pool"]["block_bytes"],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    for what, unit in (("decode", "slots running"),
                       ("prefill", "tokens a chunk")):
        n, fn, args = captured[what]
        wall, dev_ms, top = _step_profile(fn, args)
        busy = f"busy {dev_ms / wall:.1%}" if dev_ms else "not measured"
        print(f"  {what} step ({n} {unit}): {wall:.3f} ms on the host's "
              f"clock, {dev_ms:.3f} ms of kernels on the device ({busy})",
              flush=True)
        for name, ms, count in top:
            print(f"    {ms:8.3f} ms  {count:5d}x  {name[:90]}")
        out[f"{what}_step_host_ms"] = wall
        out[f"{what}_step_device_ms"] = dev_ms
    return out, counts, eng


def phase_main(dev):
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
    out, counts, _ = _serve_main(model, prompts, "main",
                                 num_blocks=num_blocks)
    print(f"  {json.dumps(out)}", flush=True)
    return counts, num_blocks


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


def _capture_steps(eng):
    """Wrap the engine's two steps to keep the arguments of one call of
    each, to replay after the run: the decode step with the most slots
    running and a full 256-token prefill chunk."""
    captured = {}
    decode, prefill = eng._decode_step, eng._prefill_step

    def decode_spy(*args):
        running = int((eng._lengths > 0).sum())
        if running > captured.get("decode", (0,))[0]:
            captured["decode"] = (running, decode, args)
        return decode(*args)

    def prefill_spy(*args):
        if "prefill" not in captured and args[4] == eng.chunk_tokens - 1:
            captured["prefill"] = (eng.chunk_tokens, prefill, args)
        return prefill(*args)

    eng._decode_step, eng._prefill_step = decode_spy, prefill_spy
    return captured


def _step_profile(fn, args, reps=5, top=8):
    """(host-clock ms, device ms, top kernels) of one step: the first as
    the engine sees it (the step, then a synchronize); the second the sum
    of the step's kernel times in a torch.profiler trace of one more
    call (0 when the trace shows no device time); the third the ``top``
    kernels by device time as (name, ms, launches)."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    dev_ms, rows = _profile_once(fn, args)
    return wall, dev_ms, rows[:top]


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
    ("RMSNorm kernel", ("rms_norm",)),
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
def phase_train(dev, cfg, T, tag, title):
    """The training path of ``cfg`` (bf16, fused loss), one [1, T] batch
    with labels = tokens, AdamW(1e-4) with its defaults.  Returns the
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
    per_step = train_launches(L, moe=E > 0)
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
                            train_launches(L, grad=False, moe=E > 0),
                            "eval forward")
    counts = launches.snapshot()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    print(f"  losses {[round(x, 4) for x in losses]}, eval after "
          f"{len(losses) + 1} steps {eval_loss:.4f}, ln V {math.log(V):.4f}")
    print(f"  launches a step {per_step}; eval forward "
          f"{train_launches(L, grad=False, moe=E > 0)}; phase {counts}",
          flush=True)
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
    static_entries = phase_static_kernels(dev)
    free()
    launches.reset()
    phase_tiny(dev)
    phase_tiny_train(dev)
    phase_tiny_moe(dev)
    phase_tiny_static(dev)
    counts, bf16_blocks = phase_main(dev)
    free()                        # each serving model's 16 GB go first
    quant_counts = phase_main_quant(dev, bf16_blocks)
    free()
    moe_counts = phase_moe_main(dev)
    free()                        # the MoE model's 47 GB
    train_counts = phase_train(dev, LlamaConfig.llama3_8b(
        num_hidden_layers=TRAIN_LAYERS, fused_lm_loss=True), TRAIN_T,
        "train", "Llama-3-8B width")
    free()
    moe_train_counts = phase_train(dev, mixtral_config(
        num_hidden_layers=MOE_TRAIN_LAYERS, fused_lm_loss=True),
        MOE_TRAIN_T, "train moe", "Mixtral-8x7B width")
    free()
    static_counts = phase_static_train(dev)
    runs = {"serve": counts, "quant": quant_counts, "train": train_counts,
            "moe_serve": moe_counts, "moe_train": moe_train_counts,
            "static_train": static_counts}
    kernels = []
    for name, e in [*entries.items(), *train_entries.items(),
                    *moe_entries.items(), *static_entries.items()]:
        # launches: from the main phase of the kernel's own path (bf16
        # serving, quantized serving or training), under the name of the
        # kernel's counter
        path = e.get("path", "serve" if name in entries else "train")
        n = runs[path].get(e.get("counter", name), 0)
        kernels.append({
            "name": name, "route": "cuda", "source": e["source"],
            "replaces": e["replaces"], "launches": n,
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
