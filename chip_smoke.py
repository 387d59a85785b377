#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase; one card

Phases, each of which must pass (nothing is caught):
  1. build every kernel from paddle_tpu_torch/csrc (one nvcc per source,
     in parallel) and print the build time and each kernel's registers;
  2. kernels: each CUDA kernel of the serving path against its plain
     PyTorch version at Llama-3-8B shapes in bf16, with its stated
     tolerance, its time, the plain version's time, one library call's
     time (a yardstick the port never calls) and its bound on the card;
  3. tiny: LlamaConfig.tiny() in f32, the same seeded weights served on
     cuda (kernels) and on cpu (plain versions): greedy tokens must be
     identical over 6 requests with a shared prefix and forced
     preemption (a differing token is excused only when the CPU logits'
     top-2 margin there is below the f32 tolerance);
  4. main: Llama-3-8B width in bf16 (random weights from a seed) behind
     serving.Engine: 8 requests, prompts of 128..1024 tokens, two of
     them sharing a 512-token prefix, 32 new tokens each.  The launch
     counts of this phase alone show the path went through every kernel.

Prints the card's name and power limit, then one JSON line of the
kernels' numbers, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Exits non-zero, printing no result, without a CUDA device.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak, same source
F32_TOL = 1e-4                 # f32 logit tolerance of the tiny phase
MAIN_LAYERS = 32               # depth of the main phase (full: 32)
SLEEP_CYCLES = 50_000_000      # ~30 ms at the H100's clock: time to enqueue


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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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


# ---------------------------------------------------------------- phase 2
def phase_kernels(dev):
    """Each kernel against its plain version at the main path's 8B
    shapes, bf16.  Returns {entry name: numbers} for the JSON line."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels import (chunked_prefill,
                                          fused_norm_linear as fnl,
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
        bound=bound_ms(nbytes, 4.0 * x.numel()),
        work="one [8, 4096] row block")

    # fused_norm_linear: the 5 projections of one layer (q, k, v, gate
    # with silu, up), skinny at decode M = 8, tiled at prefill M = 256
    projs = [(H * D, "none"), (KVH * D, "none"), (KVH * D, "none"),
             (FFN, "silu"), (FFN, "none")]
    ws = [randn(HID, n, std=HID ** -0.5) for n, _ in projs]
    nw = (1 + 0.1 * randn(HID, dtype=torch.float32)).to(bf)
    for M, name in ((8, "fused_norm_linear_skinny"),
                    (256, "fused_norm_linear_tiled")):
        x = randn(M, HID) * 3
        rs = fnl.rms_scale(x, eps)
        errs = []
        for (n, act), wt in zip(projs, ws):
            got = fnl.fused_norm_linear(x, rs, nw, wt, act)
            ref = fnl.fused_norm_linear_plain(x, rs, nw, wt, act)
            errs.append(check_close(f"{name} [{M}, {HID}] x [{HID}, {n}] "
                                    f"{act}", got, ref, bf16_tol(ref)))
        xn = (x.float() * rs).to(bf) * nw

        def run_kernel():
            for (_, act), wt in zip(projs, ws):
                fnl.fused_norm_linear(x, rs, nw, wt, act)

        def run_plain():
            for (_, act), wt in zip(projs, ws):
                fnl.fused_norm_linear_plain(x, rs, nw, wt, act)

        def run_library():
            for wt in ws:
                torch.matmul(xn, wt)

        N_all = sum(n for n, _ in projs)
        nbytes = 2 * (5 * (M * HID + HID) + HID * N_all + M * N_all) \
            + 5 * M * 4
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
    args = (q, c, s, k_pool, v_pool, bt, positions, splits)
    got = paged_attention.paged_decode_attention(*args)
    ref = paged_attention.paged_decode_attention_plain(*args)
    err = check_close(f"paged_decode B={B} nbs={nbs} splits={splits}",
                      got, ref, bf16_tol(ref))
    keys = float((positions + 1).sum())
    Lmax = int(positions.max()) + 1
    q_rot = paged_attention._rotate_half(
        q.float().reshape(B, H, D), c[:, None, :].float(),
        s[:, None, :].float()).to(bf)[:, :, None, :]
    kg = k_pool[bt.long()].reshape(B, nbs * bs, KVH, D)[:, :Lmax] \
        .transpose(1, 2).contiguous()
    vg = v_pool[bt.long()].reshape(B, nbs * bs, KVH, D)[:, :Lmax] \
        .transpose(1, 2).contiguous()
    mask = (torch.arange(Lmax, device=dev)[None, :]
            <= positions[:, None])[:, None, None, :]
    entries["paged_decode"] = dict(
        replaces="paddle_tpu/kernels/paged_attention.py:102",
        source="paddle_tpu_torch/csrc/paged_attention.cu", max_abs_err=err,
        ms=time_ms(lambda: paged_attention.paged_decode_attention(*args)),
        plain_ms=time_ms(
            lambda: paged_attention.paged_decode_attention_plain(*args),
            iters=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q_rot, kg, vg, attn_mask=mask, enable_gqa=True)),
        bound=bound_ms(2 * (2 * keys * KVH * D + 2 * B * H * D)
                       + 4 * B * (nbs + 1 + D),
                       4.0 * keys * H * D),
        work=f"one layer's decode step, B={B}, {int(keys)} context keys")

    # chunked prefill: one 256-token chunk starting at 768 (the last
    # chunk of a 1024-token prompt)
    T, start = 256, 768
    ctx = start + T
    n = ctx // bs
    bt1 = torch.zeros((1, nbs), dtype=torch.int32, device=dev)
    bt1[0, :n] = 1 + torch.randperm(nb - 1, generator=g, device=dev)[:n].int()
    pos1 = torch.tensor([start], dtype=torch.int32, device=dev)
    qc = randn(1, T, H, D)
    cargs = (qc, k_pool, v_pool, bt1, pos1)
    got = chunked_prefill.chunked_attention(*cargs)
    ref = chunked_prefill.chunked_attention_plain(*cargs)
    err = check_close(f"chunked_prefill T={T} start={start}", got, ref,
                      bf16_tol(ref))
    keys = float(sum(start + t + 1 for t in range(T)))
    kg = k_pool[bt1.long()].reshape(1, nbs * bs, KVH, D)[:, :ctx] \
        .transpose(1, 2).contiguous()
    vg = v_pool[bt1.long()].reshape(1, nbs * bs, KVH, D)[:, :ctx] \
        .transpose(1, 2).contiguous()
    cmask = (torch.arange(ctx, device=dev)[None, :]
             <= start + torch.arange(T, device=dev)[:, None])[None, None]
    qt = qc.transpose(1, 2).contiguous()
    entries["chunked_prefill"] = dict(
        replaces="paddle_tpu/kernels/chunked_prefill.py:51",
        source="paddle_tpu_torch/csrc/chunked_prefill.cu", max_abs_err=err,
        ms=time_ms(lambda: chunked_prefill.chunked_attention(*cargs)),
        plain_ms=time_ms(
            lambda: chunked_prefill.chunked_attention_plain(*cargs),
            iters=5),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kg, vg, attn_mask=cmask, enable_gqa=True)),
        bound=bound_ms(2 * (2 * ctx * KVH * D + 2 * T * H * D)
                       + 4 * (nbs + 1), 4.0 * keys * H * D),
        work=f"one layer's prefill chunk, T={T}, context {ctx}")
    for name, e in entries.items():
        print(f"  {name}: {e['ms']:.4f} ms ({e['work']}), plain "
              f"{e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, "
              f"bound {e['bound'][0]:.4f} ms by {e['bound'][1]}", flush=True)
    return entries


def _rope_tables(head_dim, max_pos, theta, dev):
    from paddle_tpu_torch.models.llama import precompute_rope

    return precompute_rope(head_dim, max_pos, theta, device=dev)


# ---------------------------------------------------------------- phase 3
def _prefix_logits(model, tokens, block_size, chunk):
    """f32 last-token logits of ``tokens`` through a fresh one-sequence
    pool (the chunked prefill step, as the engine runs it)."""
    from paddle_tpu_torch.models.generation import make_chunked_prefill_step
    from paddle_tpu_torch.serving.cache import BlockKVPool

    cfg, dev = model.config, model.device
    n = -(-len(tokens) // block_size)
    pool = BlockKVPool(cfg.num_hidden_layers, n + 1, block_size,
                       cfg.num_key_value_heads, cfg.head_dim,
                       cfg.torch_dtype, device=dev)
    nbs = -(-cfg.max_position_embeddings // block_size)
    bt = torch.zeros((1, nbs), dtype=torch.int32, device=dev)
    bt[0, :n] = torch.arange(1, n + 1, dtype=torch.int32)
    step = make_chunked_prefill_step(model)
    toks = np.asarray(tokens, np.int32)
    for start in range(0, len(toks), chunk):
        part = toks[start:start + chunk]
        ids = np.zeros((1, chunk), np.int32)
        ids[0, :len(part)] = part
        last = step(torch.tensor(ids, device=dev), pool.layers, bt,
                    torch.tensor([start], dtype=torch.int32, device=dev),
                    len(part) - 1)
    return last[0].cpu()


def phase_tiny(dev):
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, ServingConfig

    cfg = LlamaConfig.tiny()
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
        eng = Engine(model, ServingConfig(max_batch_size=4, block_size=8,
                                          num_blocks=20, chunk_tokens=16))
        reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
        eng.run_until_complete()
        eng.pool.check_leaks()
        outs[name] = [r.generated for r in reqs]
        stats[name] = eng.stats()["counters"]
    c = stats["cuda"]
    print(f"[tiny] f32, {len(prompts)} requests: preemptions "
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
            [prompts[i], a[:j]]), 8, 16), 2).values
        margin = float(top2[0] - top2[1])
        print(f"  request {i}: token {j} differs (cpu {a[j]}, cuda {b[j]}), "
              f"cpu top-2 margin {margin:.3e}")
        if margin >= F32_TOL:
            raise AssertionError(f"tiny: request {i} token {j} differs "
                                 f"with margin {margin} >= {F32_TOL}")
    print("  cuda tokens == cpu tokens", flush=True)


# ---------------------------------------------------------------- phase 4
def phase_main(dev):
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.serving import Engine, ServingConfig

    cfg = LlamaConfig.llama3_8b(num_hidden_layers=MAIN_LAYERS)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, seed=0)
    torch.cuda.synchronize()
    print(f"[main] Llama-3-8B width, bf16, {cfg.num_hidden_layers} of 32 "
          f"layers, random weights (seed 0) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.RandomState(0)
    V, new = cfg.vocab_size, 32
    prefix = rng.randint(1, V, size=512)
    lens = [128, 256, 384, 640, 768, 1024]
    prompts = [np.concatenate([prefix, rng.randint(1, V, size=100)])] + \
        [rng.randint(1, V, size=n) for n in lens] + \
        [np.concatenate([prefix, rng.randint(1, V, size=200)])]
    bs = 16
    num_blocks = 1 + sum(-(-(len(p) + new) // bs) for p in prompts) + 8
    eng = Engine(model, ServingConfig(max_batch_size=8, block_size=bs,
                                      chunk_tokens=256,
                                      num_blocks=num_blocks))
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
            raise AssertionError(f"{r.request_id}: {r.finish_reason}, "
                                 f"{len(r.generated)} tokens")
    ctr = st["counters"]
    L = cfg.num_hidden_layers
    chunks, decodes = ctr["prefill_chunks"], ctr["decode_iterations"]
    per_decode = {"rms_norm": 1, "fused_norm_linear_skinny": 5 * L,
                  "paged_decode": L}
    per_chunk = {"rms_norm": 1, "fused_norm_linear_tiled": 5 * L,
                 "chunked_prefill": L}
    expect = {k: per_decode.get(k, 0) * decodes + per_chunk.get(k, 0) * chunks
              for k in {**per_decode, **per_chunk}}
    print(f"  launches {counts} over {chunks} prefill chunks and {decodes} "
          f"decode steps; expected per decode step {per_decode}, per "
          f"prefill chunk {per_chunk}", flush=True)
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    # the 128-token request's first token again, through a fresh pool
    ref = _prefix_logits(model, prompts[1], bs, 256)
    if not torch.isfinite(ref).all() or int(ref.argmax()) != \
            reqs[1].generated[0]:
        raise AssertionError("main: the engine's first token disagrees "
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
               layers=L, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
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
    print(f"  {json.dumps(out)}", flush=True)
    return counts


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
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0), key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), rows[:top]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from paddle_tpu_torch.kernels import launches

    dev = torch.device("cuda")
    # f32 products in full f32 wherever results are compared
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[device] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    t_all = time.perf_counter()
    phase_build()
    entries = phase_kernels(dev)
    launches.reset()
    phase_tiny(dev)
    counts = phase_main(dev)
    kernels = []
    for name, e in entries.items():
        kernels.append({
            "name": name, "route": "cuda", "source": e["source"],
            "replaces": e["replaces"], "launches": counts.get(name, 0),
            "max_abs_err": e["max_abs_err"], "ms": e["ms"],
            "plain_ms": e["plain_ms"], "bound_ms": e["bound"][0],
            "bound_by": e["bound"][1], "library_ms": e["library_ms"]})
    print(f"[done] all phases passed in {time.perf_counter() - t_all:.1f} s")
    print(smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
