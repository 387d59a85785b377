"""One rank of a mesh training run: a Llama trained through
``hapi.Model(mesh=...).fit``, its numbers written for the caller.

Started once a rank by the launcher::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 8 \\
        -m paddle_tpu_torch.tools.mesh_train --axes '{"data": 2, \\
        "fsdp": 2, "tp": 2}' --backend gloo --device cuda:0 --out DIR

Every rank builds the whole model from seed 0 on its device, lays it out
on the mesh (``prepare(mesh=...)``), and fits ``--steps`` global
batches of ``--batch`` rows of ``--seq`` tokens (seed ``--data-seed``,
``(ids[:, :-1], ids[:, 1:])``) with AdamW(``--lr``) and a vocab-parallel
loss (``distributed.ParallelCrossEntropy``).  ``--config`` picks
Llama-3-8B's widths, Mixtral-8x7B's (``mixtral``: 8 experts, top-2,
expert-parallel over an ``expert`` axis of ``--axes``; its dropless
capacity factor 4.0), or a tiny dense or MoE model (4 experts, the
dropless 2.0).  Without ``--axes`` it is the unsharded run of the same
model, batches and loss.

With ``--ckpt`` a ``resilience.ResilienceCallback`` (``--save-every``
from step ``--save-from``, no guard) writes format-2 checkpoints there
(every rank its own parts, rank 0 commits) and resumes from the newest,
each rank reading only the region the live layout gives it, whatever
layout wrote it.  Faults: ``--kill-at K`` raises at the start of step K
on every rank (``FaultPlan(kill_at_step=K)``); ``--kill-process K:R``
kills rank R alone there (``kill_process_at``); ``--kill-save-site
SITE`` with ``--save-fault-process R`` and ``--kill-save-step S`` kills
rank R at its first ``on_save`` site matching SITE in the save of step
S; ``--kill-hard`` makes those deaths ``os._exit(43)``.  The launcher
then ends the world.  ``--report-at K`` writes this rank's numbers at
the end of step K (0-based) as well, before that step's save; by
default at the end of the step before ``--kill-at`` or
``--kill-process``'s.  ``--check-restore`` compares, after the resume,
every parameter and AdamW slot part with the checkpoint's whole array
cut to that part, bit for bit.

``--save-params FILE`` writes this run's parameters when training
starts (after any resume) and after it (``{"init": ..., "final":
...}``, gathered); ``--ref FILE`` (that file of the unsharded run) makes
rank 0 measure each parameter's update over the run against the
unsharded one's (:func:`compare`), which :func:`against_single` holds
to its limits.  The backend and device default to
``init_parallel_env``'s (NCCL on ``cuda:LOCAL_RANK``, which refuses more
ranks than cards), the unsharded run's device to the card.

With ``--sp-modes ring,ulysses,sequence_parallel`` it is phase 7q's
program instead (:func:`sp_main`): for each mode in turn a fresh model
(seed 0, the fused loss) with that option (``context_parallel="ring"``
or ``"ulysses"``, or ``sequence_parallel=True``) is laid out on
``--axes`` (``{"sp": 4}``) through ``distributed.MeshExecutor``, takes
its rank's positions of one global batch [``--batch``, ``--seq``], runs
the forward and backward of the model's own shifted loss (its share of
the global mean), sums the gradients over ``sp``
(``reduce_gradients``) and takes one SGD(``--lr``) step.  Without
``--axes`` it is the unsharded forward and backward of the same model
and batch, its gradients written to ``--save-grads``; with
``--ref-grads`` (that file) rank 0 measures every parameter's summed
gradient against it (:func:`sp_against_single` holds them to
``SP_LOSS_REL`` and ``SP_GRAD_REL``).  Each rank writes
``DIR/rank<r>.json``: for each mode the global loss, the step's
seconds (forward and backward, the gradient sum, the SGD step), the
launches by kernel and instance, the collectives and staged ones, the
peak memory, and rank 0's gradient readings.

With ``--pp-steps 1F1B,1F1B,1F1B,FThenB`` it is phase 7p's program
(:func:`pp_main`): ``LlamaForCausalLMPipe`` of the config (seed 0, each
layer's weights from its own seed) trained through ``fleet.init``
(``--axes`` ``{"pp": 4}``, or with ``dp``/``mp``), ``fleet.
distributed_model`` (a ``PipelineParallel``) and its ``train_batch``,
one step a listed schedule, ``--micro-batches`` M microbatches of the
global batch [``--batch``, ``--seq``] (seed ``--data-seed``; the pipe's
own shifted loss), AdamW(``--lr``); with ``--clip-norm`` one more 1F1B
step under ``ClipGradByGlobalNorm`` of that norm, whose global norm (the
whole model's on every stage) each rank reports.  Without ``--axes`` it is the
unsharded run of the same pipe in one process (every stage, the 1F1B
schedule: one microbatch's forward and backward after another), which
writes its final parameters to ``--save-params`` (``{"final": ...}``);
with ``--ref`` (that file) each rank measures each of its parameters'
update against the unsharded one (:func:`pp_against_single`; both runs
draw the same initial weights, each layer from its own seed).  Each rank writes ``DIR/rank<r>.json``:
its stage and parameter names, bytes, each step's loss, host-clock
seconds, kernel launches (by kernel and instance), pipeline hops (and
those staged), the schedule's peak allocated memory (from the start of
``train_batch`` to its optimizer step) and microbatches in flight, and
the bytes one microbatch's forward kept.

With ``--tp-runs a,b,c_dgc,c_gm_localsgd,c_lars,B`` it is phase 7t's
program (:func:`tp_main`, :data:`TP_RUNS`): each run a fresh model (seed
0) trained ``steps`` global batches [``batch``, ``seq``] (seed
``--data-seed``) with the model's own loss (each step's path from
``fused``: the fused chunked loss or the logits): (a) Llama-3-8B's widths
at 2 layers laid out by ``hapi.Model(mesh={"data": 2, "tp": 2})``
(``prepare``; the steps by hand, as hapi feeds the logits path only),
the fused loss over the split vocabulary; (b) Llama-3.2-3B's (tied) at 2
layers through fleet ``{"dp": 2, "mp": 2}``, a fused and a logits step;
(c) the same model in f32 under fleet's ``dgc``, ``gradient_merge`` with
``localsgd``, and ``lars``; (B) Mixtral-8x7B's widths at 1 layer on
``{"expert": 2, "tp": 2}``.  It runs in the launcher's world, each run
followed by the same run unsharded on rank 0 alone (one replica a data
rank under local SGD, fed its rows, the replicas' parameters averaged
at its sync steps), whose final parameters rank 0 scatters to the
ranks holding each part: each rank writes every run's losses, step
seconds, collectives, staged calls, launches, peak memory, bytes of
parts and each parameter's update against the unsharded run's
(:func:`tp_against_single`, at the run's ``bounds``), rank 0 the
unsharded runs' numbers too.  A run with ``control`` is compared a
second time, against its emulation with the local-SGD syncs left out (a
planted fault the comparison must refuse).  Nothing else is written (a
machine's disk takes a bounded number of bytes a call).

Each rank writes ``DIR/rank<r>.json``: its mesh coordinates, each
step's loss, host-clock ms, the collectives it made and those staged
through host memory, its kernel launches (by kernel and by instance),
its parameters' and AdamW slots' bytes (split and replicated roles
apart, the expert stacks apart, beside the whole model's), its peak
device memory, with ``--digests`` a sha256 of every parameter and slot
part it holds (what a resumed world is compared by), each checkpoint's
save seconds, shard files and bytes written by this rank, and the
restore's seconds.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import hashlib
import json
import math
import os
import sys
import time

import numpy as np
import torch


def mixtral(**overrides):
    """Mixtral-8x7B's shape (mistralai/Mixtral-8x7B-v0.1 config.json):
    vocab 32000, hidden 4096, expert FFN 14336, 32 q / 8 kv heads,
    rope_theta 1e6, 8 experts, top-2, dropless capacity factor E / K =
    4.0."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaConfig

    return dataclasses.replace(LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        max_position_embeddings=32768, rms_norm_eps=1e-5, rope_theta=1e6,
        moe_num_experts=8, moe_top_k=2, moe_capacity_factor=4.0),
        **overrides)


def _config(a):
    from paddle_tpu_torch.models import LlamaConfig

    if a.config == "llama3_8b":
        return LlamaConfig.llama3_8b(num_hidden_layers=a.layers,
                                     max_position_embeddings=a.seq)
    if a.config == "mixtral":
        return mixtral(num_hidden_layers=a.layers,
                       max_position_embeddings=a.seq)
    moe = {} if a.config == "tiny" else dict(
        moe_num_experts=4, moe_capacity_factor=2.0)
    return LlamaConfig.tiny(num_hidden_layers=a.layers,
                            max_position_embeddings=a.seq, dtype=a.dtype,
                            **moe)


def batches(vocab, steps, batch, seq, seed):
    """``steps`` global batches ``(ids[:, :-1], ids[:, 1:])`` [batch, seq]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        ids = rng.randint(0, vocab, (batch, seq + 1)).astype(np.int64)
        out.append((ids[:, :-1], ids[:, 1:]))
    return out


def lm_loss(logits, labels):
    """Mean next-token cross entropy of (vocab-parallel) logits."""
    from paddle_tpu_torch.distributed import ParallelCrossEntropy

    return ParallelCrossEntropy()(logits, labels).mean()


def _digest(t) -> str:
    t = t.detach().contiguous().cpu()
    return hashlib.sha256(t.view(torch.uint8).numpy()
                          if t.dtype != torch.bool else
                          t.numpy()).hexdigest()[:16]


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def shard_bytes(net, opt) -> dict:
    """This rank's bytes of parameters and slots, split roles and
    replicated ones apart, the expert stacks apart again, beside the
    whole model's."""
    out = dict(split_params=0, split_params_whole=0, replicated_params=0,
               split_slots=0, split_slots_whole=0, replicated_slots=0,
               expert_params=0, expert_params_whole=0)
    for name, p in net.named_parameters():
        if name.endswith(("w_gate", "w_up", "w_down")):
            pl = getattr(p, "placement", None)
            out["expert_params"] += _bytes(p)
            out["expert_params_whole"] += p.element_size() * int(
                np.prod(pl.full_shape if pl is not None else p.shape))
    for p in net.parameters():
        pl = getattr(p, "placement", None)
        split = pl is not None and not pl.replicated
        whole = int(np.prod(pl.full_shape)) * p.element_size() if split \
            else _bytes(p)
        slots = [store[id(p)] for store in opt._accumulators.values()
                 if id(p) in store]
        slot_bytes = sum(_bytes(s) for s in slots)
        if split:
            out["split_params"] += _bytes(p)
            out["split_params_whole"] += whole
            out["split_slots"] += slot_bytes
            out["split_slots_whole"] += sum(
                int(np.prod(pl.full_shape)) * s.element_size()
                for s in slots)
        else:
            out["replicated_params"] += _bytes(p)
            out["replicated_slots"] += slot_bytes
    return out


#: (a): |loss - unsharded| / |unsharded| at every step
LOSS_REL = 2.0 ** -14
#: (b): ||dw - dw_unsharded|| / ||dw_unsharded|| for every parameter, dw
#: its update over the run: twice the worst reading of a sound phase-7d
#: world (0.0964, NVIDIA H100 80GB HBM3 at 700 W)
UPDATE_REL = 0.2


def compare(net, ref_path):
    """Rank 0: ``{name: [||dw - dw_ref||, ||dw_ref||]}`` over every
    parameter, ``dw`` its update over the run (the gathered parameter
    minus the unsharded run's initial one) and ``dw_ref`` the unsharded
    run's, in f32 on the host (every rank takes part in the
    gathers)."""
    from paddle_tpu_torch.distributed import get_rank

    refs = torch.load(ref_path, mmap=True) if get_rank() == 0 else None
    out = {}
    for name, p in net.named_parameters():
        pl = getattr(p, "placement", None)
        full = p.detach() if pl is None else pl.gather_to_rank0(p.detach())
        if refs is not None:
            w0 = refs["init"][name].float()
            d_ref = refs["final"][name].float() - w0
            d = full.cpu().float() - w0
            out[name] = [float(torch.linalg.vector_norm(d - d_ref)),
                         float(torch.linalg.vector_norm(d_ref))]
        del full
    return out


def against_single(r0, single):
    """A world's comparison with the unsharded run of the same weights
    and batches, from rank 0's results and the unsharded run's: (a) each
    step's loss within ``LOSS_REL`` of the unsharded one; (b) each
    parameter's update within ``UPDATE_REL`` of the unsharded update
    (:func:`compare`; a parameter the unsharded run left as it was must
    stay as it was, its reading 0, else inf), and some parameter moved.
    Returns ``(readings, failures)``: the worst loss reading, every
    parameter's update reading, and what broke a limit."""
    fails = []
    losses = [abs(g - w) / abs(w) if math.isfinite(g) else math.inf
              for g, w in zip(r0["losses"], single["losses"])]
    if len(losses) != len(single["losses"]) or max(losses) > LOSS_REL:
        fails.append(f"(a) losses {r0['losses']} vs unsharded "
                     f"{single['losses']}: worst {max(losses):.3g} > "
                     f"{LOSS_REL:.3g}")
    upd = {n: e / ref if ref else (0.0 if e == 0 else math.inf)
           for n, (e, ref) in r0["vs_ref"].items()}
    worst = max(upd, key=upd.get)
    if not upd[worst] <= UPDATE_REL:
        fails.append(f"(b) {worst}'s update off by {upd[worst]:.3g} of "
                     f"the unsharded one's > {UPDATE_REL:.3g}")
    if not any(ref for _, ref in r0["vs_ref"].values()):
        fails.append("(b) the unsharded run moved no parameter")
    return {"loss": max(losses), "update": upd, "worst": worst}, fails


def gathered_params(net) -> dict:
    from paddle_tpu_torch.distributed import get_rank

    out = {}
    for name, p in net.named_parameters():
        pl = getattr(p, "placement", None)
        full = p.detach() if pl is None else pl.gather_to_rank0(p.detach())
        if get_rank() == 0:
            out[name] = full.to("cpu", copy=True)
    return out


def restore_check(net, opt, ckpt, step) -> dict:
    """Every parameter and AdamW slot part of this rank against the
    checkpoint's whole array (every shard assembled) cut to the part's
    bounds, bit for bit: ``{"checked": n, "mismatched": [...]}`` (every
    rank takes part in the checkpointer's collectives)."""
    from paddle_tpu_torch.framework.io import to_host
    from paddle_tpu_torch.resilience import ResilientCheckpointer
    from paddle_tpu_torch.resilience.checkpoint import _cut, _raw

    tree = ResilientCheckpointer(ckpt).restore(step)
    index = {id(p): i for i, p in enumerate(opt._parameter_list)}
    pairs = [(tree["model"][n], p, getattr(p, "placement", None), n)
             for n, p in net.named_parameters()]
    for acc, store in opt._accumulators.items():
        for pid, t in store.items():
            p = opt._parameter_list[index[pid]]
            key = f"{acc}_{index[pid]}"
            pairs.append((tree["optimizer"][key], t, opt._slot_placement(p),
                          key))
    bad = []
    for leaf, t, pl, name in pairs:
        want = leaf.assemble()
        if pl is not None and not pl.replicated:
            want = _cut(want, pl.bounds)
        got, want = _raw(to_host(t)), _raw(want)
        if got.shape != want.shape or not np.array_equal(
                *(np.ascontiguousarray(x).reshape(-1).view(np.uint8)
                  for x in (got, want))):
            bad.append(name)
        del want
    return {"checked": len(pairs), "mismatched": bad}


#: phase 7q (a): |loss - unsharded| / |unsharded| of each mode
SP_LOSS_REL = 2.0 ** -10
#: phase 7q (b): ||g - g_unsharded|| / ||g_unsharded|| of every
#: parameter's gradient summed over sp
SP_GRAD_REL = 0.05
SP_OPTIONS = {"ring": dict(context_parallel="ring"),
              "ulysses": dict(context_parallel="ulysses"),
              "sequence_parallel": dict(sequence_parallel=True)}


def sp_against_single(r0, single):
    """Phase 7q's comparison of each mode of rank 0's results with the
    unsharded run: (a) the global loss within ``SP_LOSS_REL``; (b) every
    parameter's gradient, summed over sp, within ``SP_GRAD_REL``
    (relative 2-norm; a parameter whose unsharded gradient is 0 must
    get 0).  Returns ``({mode: {"loss": x, "grad": worst, "worst":
    name}}, failures)``."""
    read, fails = {}, []
    want = single["loss"]
    for mode, res in r0["modes"].items():
        loss = abs(res["loss"] - want) / abs(want) \
            if math.isfinite(res["loss"]) else math.inf
        rel = {n: e / ref if ref else (0.0 if e == 0 else math.inf)
               for n, (e, ref) in res["grad_err"].items()}
        worst = max(rel, key=rel.get)
        read[mode] = {"loss": loss, "grad": rel[worst], "worst": worst,
                      "median": float(np.median(list(rel.values())))}
        if not loss <= SP_LOSS_REL:
            fails.append(f"(a) {mode}: loss {res['loss']} vs unsharded "
                         f"{want}: {loss:.3g} > {SP_LOSS_REL:.3g}")
        if not rel[worst] <= SP_GRAD_REL:
            fails.append(f"(b) {mode}: {worst}'s gradient off by "
                         f"{rel[worst]:.3g} > {SP_GRAD_REL:.3g}")
    return read, fails


def sp_main(a) -> int:
    """Phase 7q's rank program (the module docstring)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.kernels import launches

    modes = a.sp_modes.split(",")
    sharded = a.axes is not None
    if sharded:
        dist.init_parallel_env(backend=a.backend, device=a.device,
                               timeout=a.timeout)
        dev = dist.current_device()
    else:
        dev = torch.device(a.device or "cuda")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    rng = np.random.RandomState(a.data_seed)
    cfg0 = _config(a)
    ids_all = torch.from_numpy(rng.randint(0, cfg0.vocab_size,
                                           (a.batch, a.seq))).to(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    refs = None
    if a.ref_grads and rank == 0:
        refs = torch.load(a.ref_grads, mmap=True)
    out = {"rank": rank, "world": dist.get_world_size(), "device": str(dev),
           "modes": {}}
    for mode in (modes if sharded else modes[:1]):
        import dataclasses

        from paddle_tpu_torch.models import LlamaForCausalLM

        cfg = dataclasses.replace(cfg0, fused_lm_loss=True,
                                  **(SP_OPTIONS[mode] if sharded else {}))
        net = LlamaForCausalLM(cfg, device=dev, seed=0)
        opt = pt.optimizer.SGD(a.lr, parameters=net.parameters())
        ex = dist.MeshExecutor(json.loads(a.axes)) if sharded else None
        ids = ids_all
        if ex is not None:
            ex.install(net)
            ids, = ex.shard_batch([ids_all])
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        sync()
        launches.reset()
        dist.collective.reset_counts()
        t0 = time.perf_counter()
        loss, _ = net(ids, labels=ids)
        loss.backward()
        sync()
        t1 = time.perf_counter()
        if ex is not None:
            ex.reduce_gradients(net)
        sync()
        t2 = time.perf_counter()
        counts = dist.collective.counts()
        staged = dist.collective.staged_counts()
        res = dict(part=list(ids.shape), launches=launches.snapshot(),
                   instances=launches.by_instance(), collectives=counts,
                   staged=staged, fb_s=t1 - t0, reduce_s=t2 - t1)
        res["loss"] = ex.mean_over_data(float(loss.detach())) \
            if ex is not None else float(loss.detach())
        if refs is not None:
            err = {}
            for name, p in net.named_parameters():
                ref = refs[name].to(dev).float()
                g = p.grad.float()
                err[name] = [float(torch.linalg.vector_norm(g - ref)),
                             float(torch.linalg.vector_norm(ref))]
                del ref, g
            res["grad_err"] = err
        if a.save_grads:
            torch.save({n: p.grad.detach().cpu()
                        for n, p in net.named_parameters()}, a.save_grads)
        sync()
        t3 = time.perf_counter()
        opt.step()
        opt.clear_grad()
        sync()
        res["sgd_s"] = time.perf_counter() - t3
        res["step_s"] = t2 - t0 + res["sgd_s"]
        res["finite"] = all(bool(torch.isfinite(p).all())
                            for p in net.parameters())
        res["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 \
            if cuda else 0.0
        out["modes"][mode if sharded else "unsharded"] = res
        if ex is not None:
            ex.close()
        del net, opt, loss
        if cuda:
            torch.cuda.empty_cache()
    if not sharded:
        out.update(out["modes"].pop("unsharded"))
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    if sharded:
        dist.collective.barrier()
        dist.destroy_parallel_env()
    return 0


def pp_against_single(ranks, single):
    """Phase 7p's comparison of a world's ranks with the unsharded run:
    (a) each step's loss within ``LOSS_REL`` of the unsharded one and
    equal on every rank; (b) every parameter's update within
    ``UPDATE_REL`` of the unsharded update (a parameter the unsharded
    run left as it was must stay as it was), and some parameter moved.
    Returns ``(readings, failures)``."""
    fails = []
    r0 = ranks[0]
    losses = [abs(g - w) / abs(w) if math.isfinite(g) else math.inf
              for g, w in zip(r0["losses"], single["losses"])]
    if len(losses) != len(single["losses"]) or max(losses) > LOSS_REL:
        fails.append(f"(a) losses {r0['losses']} vs unsharded "
                     f"{single['losses']}: worst {max(losses):.3g} > "
                     f"{LOSS_REL:.3g}")
    for r in ranks:
        if r["losses"] != r0["losses"]:
            fails.append(f"(a) rank {r['rank']} losses {r['losses']} != "
                         f"rank 0's {r0['losses']}")
    upd = {n: e / ref if ref else (0.0 if e == 0 else math.inf)
           for r in ranks for n, (e, ref) in r["vs_ref"].items()}
    worst = max(upd, key=upd.get)
    if not upd[worst] <= UPDATE_REL:
        fails.append(f"(b) {worst}'s update off by {upd[worst]:.3g} of "
                     f"the unsharded one's > {UPDATE_REL:.3g}")
    if not any(ref for r in ranks for _, ref in r["vs_ref"].values()):
        fails.append("(b) the unsharded run moved no parameter")
    return {"loss": max(losses), "update": upd, "worst": worst}, fails


def llama32_3b(**overrides):
    """Llama-3.2-3B's widths (meta-llama/Llama-3.2-3B config.json): vocab
    128256, hidden 3072, intermediate 8192, 28 layers, 24 q / 8 kv heads,
    rope_theta 500000, tied embeddings (its llama3 rope scaling left out,
    as neither package models it)."""
    import dataclasses

    from paddle_tpu_torch.models import LlamaConfig

    return dataclasses.replace(LlamaConfig(
        vocab_size=128256, hidden_size=3072, intermediate_size=8192,
        num_hidden_layers=28, num_attention_heads=24, num_key_value_heads=8,
        max_position_embeddings=131072, rms_norm_eps=1e-5,
        rope_theta=500000.0, tie_word_embeddings=True), **overrides)


_B = dict(config="llama32_3b", layers=2, fleet={"dp": 2, "mp": 2},
          seq=2048, batch=2)
#: (c) in f32: DGC's top-k choice and LARS's norms then compare without
#: the flips that bf16 roundings of the summed gradients cause
_C = dict(_B, steps=4, fused=(True,) * 4, dtype="float32")
#: phase 7t's runs (:func:`tp_main`): world A's (a), (b) and the three
#: meta-optimizer runs (c) of the tied model, and world B.  ``mesh``: the
#: hapi.Model(mesh=...) layout; ``fleet``: fleet's hybrid degrees;
#: ``fused``: each step's loss path (the fused chunked loss, or the
#: logits); ``meta``: the strategy's meta-optimizer flags and configs;
#: ``bounds``: (loss, update) limits of :func:`tp_against_single`, 7d's
#: for the bf16 runs; the f32 runs' each ~60x above the loss and 6-25x
#: above the update read in a sound run (NVIDIA H100 80GB HBM3 at 700 W:
#: losses 1.05e-7-1.59e-7; updates dgc 0.00781, whose top k flips at its
#: threshold, merge with local SGD 4.32e-4, lars 4.44e-6); ``control``:
#: compared again against the emulation without local SGD's syncs
TP_RUNS = {
    "a": dict(config="llama3_8b", layers=2, mesh={"data": 2, "tp": 2},
              seq=2048, batch=2, steps=3, fused=(True,) * 3, opt="adamw",
              lr=1e-4),
    "b": dict(_B, steps=2, fused=(True, False), opt="adamw", lr=1e-4),
    "c_dgc": dict(_C, opt="momentum", lr=0.01, meta={"dgc": {
        "rampup_begin_step": 1, "sparsity": 0.999}}, bounds=(1e-5, 0.05)),
    "c_gm_localsgd": dict(_C, opt="adamw", lr=1e-4, meta={
        "gradient_merge": {"k_steps": 2, "avg": True},
        "localsgd": {"k_steps": 2, "begin_step": 1}}, bounds=(1e-5, 5e-3),
        control=True),
    "c_lars": dict(_C, opt="momentum", lr=10.0, meta={"lars": {
        "lars_coeff": 0.001, "lars_weight_decay": 0.0005}},
        bounds=(1e-5, 1e-4)),
    "B": dict(config="mixtral", layers=1, mesh={"expert": 2, "tp": 2},
              seq=1024, batch=2, steps=3, fused=(True,) * 3, opt="adamw",
              lr=1e-4),
}


def _tp_config(spec):
    """The run's config, in the run's dtype."""
    from paddle_tpu_torch.models import LlamaConfig

    make = {"llama3_8b": LlamaConfig.llama3_8b, "llama32_3b": llama32_3b,
            "mixtral": mixtral}[spec["config"]]
    return make(num_hidden_layers=spec["layers"],
                max_position_embeddings=spec["seq"],
                fused_lm_loss=spec["fused"][0],
                dtype=spec.get("dtype", "bfloat16"))


def _tp_strategy(spec):
    from paddle_tpu_torch.distributed import fleet

    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v
                        for k, v in (spec.get("fleet") or {}).items()}
    for flag, cfg in (spec.get("meta") or {}).items():
        setattr(s, flag, True)
        setattr(s, f"{flag}_configs", dict(cfg))
    return s


def _tp_optimizer(spec, params, strategy):
    """The run's optimizer: AdamW or Momentum(0.9) over ``params``, then
    fleet's wrap (with ``strategy``'s meta-optimizers) where the run has
    a fleet layout or meta-optimizers (unsharded: no mesh, so no
    collective)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.distributed import fleet

    opt = pt.optimizer.AdamW(spec["lr"], parameters=params) \
        if spec["opt"] == "adamw" else \
        pt.optimizer.Momentum(spec["lr"], momentum=0.9, parameters=params)
    if spec.get("fleet") or spec.get("meta"):
        opt = fleet.distributed_optimizer(opt, strategy)
    return opt


def _tp_vs_ref(held, ref, replica, dev):
    """``{name: [||dw - dw_ref||, ||dw_ref||]}`` of every parameter on
    every rank (a collective of the world): dw this rank's part's update
    (``held``: its parts before and after the run, and their placements)
    and dw_ref the same part of the update of unsharded replica
    ``replica`` (rank 0's ``ref``: each replica's final parameters, whole,
    on the host; None elsewhere), each part scattered from rank 0
    (``executor._scatter_leaf``); the squares summed over the ranks
    holding the other parts, so the norms are the whole parameter's."""
    from paddle_tpu_torch.distributed import collective
    from paddle_tpu_torch.distributed.executor import _Leaf, _scatter_leaf

    count = [None if ref is None else len(ref)]
    collective.broadcast_object_list(count, 0)
    out = {}
    for name in sorted(held["init"]):
        w0 = held["init"][name]
        pl = held["placements"][name]
        split = pl is not None and not pl.replicated
        shape = pl.full_shape if split else tuple(w0.shape)
        leaf = _Leaf(shape, str(w0.dtype).replace("torch.", ""))
        sq = None
        for r in range(count[0]):
            full = ref[r][name] if ref is not None else None
            part = _scatter_leaf(leaf, full, pl)
            if r == replica:
                w0d = w0.to(dev).float()
                d_ref = part.to(dev).float() - w0d
                d = held["final"][name].to(dev).float() - w0d
                sq = torch.stack([(d - d_ref).square().sum(),
                                  d_ref.square().sum()]).double()
                del w0d, d_ref, d
            del part
        if split:
            collective.all_reduce(sq, group=pl.mesh.group(*pl.axes))
        out[name] = [float(sq[0].sqrt()), float(sq[1].sqrt())]
    return out


def tp_run(name, spec, a, dev, sharded, synced=True) -> dict:
    """One run of :data:`TP_RUNS` on this rank (``sharded``: in the
    world, its layout from the spec) or unsharded in this process (with
    local SGD, one replica a data rank, fed its rows, the replicas'
    parameters averaged at the wrapper's sync steps, or never with
    ``synced`` False: the planted fault of a ``control``).  Returns the
    run's numbers; unsharded, also each replica's final parameters."""
    import gc

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.fleet.meta_optimizers import _base
    from paddle_tpu_torch.distributed.sharding import placement_of
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaForCausalLM

    cuda = dev.type == "cuda"
    cfg = _tp_config(spec)
    strategy = _tp_strategy(spec)
    local = "localsgd" in (spec.get("meta") or {})
    dp = (spec.get("fleet") or {}).get("dp") or \
        (spec.get("mesh") or {}).get("data", 1)
    ex, nets, opts = None, [], []
    if not sharded:
        fleet.shutdown()          # no mesh: the optimizers' steps are local
    if sharded and spec.get("fleet"):
        fleet.init(is_collective=True, strategy=strategy)
        nets.append(fleet.distributed_model(
            LlamaForCausalLM(cfg, device=dev, seed=0)))
    elif sharded:
        nets.append(LlamaForCausalLM(cfg, device=dev, seed=0))
    else:
        nets = [LlamaForCausalLM(cfg, device=dev, seed=0)
                for _ in range(dp if local else 1)]
    for net in nets:
        opts.append(_tp_optimizer(spec, list(net.named_parameters()),
                                  strategy))
    if sharded and spec.get("mesh"):
        ex = dist.MeshExecutor(spec["mesh"])
        pt.Model(nets[0]).prepare(opts[0], None, mesh=ex)
    syncs = []
    if not sharded and local:
        for opt in opts:
            opt._average_parameters = lambda: syncs.append(synced)
    init = {n: p.detach().to("cpu", copy=True)
            for n, p in nets[0].named_parameters()} if sharded else None
    rank_rows = None
    if sharded and spec.get("fleet"):
        hcg = fleet.fleet.hcg
        rank_rows = (hcg.get_data_parallel_rank(), dp)
        data_group = hcg.get_data_parallel_group()
    rng = np.random.RandomState(a.data_seed)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (spec["batch"], spec["seq"]))).to(dev)
        for _ in range(spec["steps"])]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    launches.reset()
    res = dict(losses=[[] for _ in nets], step_s=[], collectives=[],
               staged=[])
    for i, ids in enumerate(batches):
        collective.reset_counts()
        t0 = time.perf_counter()
        for r, (net, opt) in enumerate(zip(nets, opts)):
            net.config.fused_lm_loss = spec["fused"][i]
            if ex is not None:
                x, = ex.shard_batch([ids])
            elif rank_rows is not None or len(nets) > 1:
                d, n = rank_rows if rank_rows is not None else (r, dp)
                rows = ids.shape[0] // n
                x = ids[d * rows:(d + 1) * rows]
            else:
                x = ids
            loss, _ = net(x, labels=x)
            loss.backward()
            if ex is not None:
                ex.reduce_gradients(net)
            opt.step()
            opt.clear_grad()
            value = float(loss.detach())
            if ex is not None:
                value = ex.mean_over_data(value)
            elif rank_rows is not None and not local:
                t = torch.tensor([value], dtype=torch.float64,
                                 device=collective.comm_device(data_group))
                collective.all_reduce(t, collective.ReduceOp.AVG,
                                      data_group)
                value = float(t[0])
            res["losses"][r].append(value)
        if any(syncs):
            syncs.clear()
            with torch.no_grad():
                for ps in zip(*(net.parameters() for net in nets)):
                    mean = (ps[0] + ps[1]) / 2 if len(ps) == 2 else \
                        sum(ps) / len(ps)
                    for p in ps:
                        p.copy_(mean)
        if cuda:
            torch.cuda.synchronize()
        res["step_s"].append(time.perf_counter() - t0)
        res["collectives"].append(collective.counts())
        res["staged"].append(collective.staged_counts())
    res.update(launches=launches.snapshot(),
               instances=launches.by_instance(),
               peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9
               if cuda else 0.0,
               bytes=shard_bytes(nets[0], _base(opts[0])),
               finite=all(bool(torch.isfinite(p).all())
                          for net in nets for p in net.parameters()),
               chain=[type(o).__name__ for o in _chain(opts[0])])
    if sharded:
        res["replica"] = rank_rows[0] if (local and rank_rows is not None) \
            else 0
        res["parts"] = {n: list(p.shape) for n, p in
                        nets[0].named_parameters()
                        if n.endswith(("w_gate", "w_down",
                                       "embed_tokens.weight"))}
        res["held"] = dict(init=init, placements={
            n: placement_of(p) for n, p in nets[0].named_parameters()},
            final={n: p.detach().to("cpu", copy=True)
                   for n, p in nets[0].named_parameters()})
    else:
        res["final"] = [{n: p.detach().to("cpu", copy=True)
                         for n, p in net.named_parameters()} for net in nets]
    if ex is not None:
        ex.close()
    if spec.get("fleet") and sharded:
        fleet.shutdown()
    del nets, opts, batches, init
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return res


def _chain(opt):
    """``opt`` and the optimizers it wraps, outermost first."""
    out = [opt]
    while "_inner" in vars(out[-1]):
        out.append(out[-1]._inner)
    return out


def tp_bounds(spec):
    """A run's (loss, update) limits: (a) |loss - unsharded| /
    |unsharded| at every step, (b) ||dw - dw_unsharded|| /
    ||dw_unsharded|| of every parameter over the run; 7d's unless the
    run states its own."""
    return spec.get("bounds", (LOSS_REL, UPDATE_REL))


def tp_against_single(ranks, single, bounds):
    """Phase 7t's comparison of one run across a world's ranks with its
    unsharded run, at ``bounds`` (:func:`tp_bounds`): (a) each step's
    loss (under local SGD each rank against the replica of its data
    rank, else the global loss, equal on every rank); (b) every
    parameter's update (a parameter the unsharded run left as it was
    must stay), and some parameter moved.  Returns ``(readings,
    failures)``."""
    loss_rel, update_rel = bounds
    fails, worst_loss, upd = [], 0.0, {}
    for r in ranks:
        want = single["losses"][r["replica"]]
        got = r["losses"][0]
        rel = [abs(g - w) / abs(w) if math.isfinite(g) else math.inf
               for g, w in zip(got, want)]
        if len(rel) != len(want) or max(rel) > loss_rel:
            fails.append(f"(a) rank {r['rank']} losses {got} vs unsharded "
                         f"{want}: worst {max(rel):.3g} > {loss_rel:.3g}")
        worst_loss = max(worst_loss, max(rel))
        for n, (e, ref) in r["vs_ref"].items():
            upd[n] = max(upd.get(n, 0.0), e / ref if ref else
                         (0.0 if e == 0 else math.inf))
        if not r["finite"]:
            fails.append(f"rank {r['rank']}: parameters not finite")
    worst = max(upd, key=upd.get)
    if not upd[worst] <= update_rel:
        fails.append(f"(b) {worst}'s update off by {upd[worst]:.3g} of the "
                     f"unsharded one's > {update_rel:.3g}")
    if not any(ref for r in ranks for _, ref in r["vs_ref"].values()):
        fails.append("(b) the unsharded run moved no parameter")
    return {"loss": worst_loss, "update": upd, "worst": worst}, fails


def tp_main(a) -> int:
    """Phase 7t's program (the module docstring): the runs of
    ``--tp-runs`` in turn in the launcher's world, each followed by its
    unsharded run on rank 0 alone (the other ranks' models freed, their
    parts kept on the host) and the comparison (:func:`_tp_vs_ref`),
    and a ``control`` run's against its unsynced emulation too: nothing
    is written but each rank's JSON."""
    from paddle_tpu_torch import distributed as dist

    names = a.tp_runs.split(",")
    dist.init_parallel_env(backend=a.backend, device=a.device,
                           timeout=a.timeout)
    dev = dist.current_device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    out = dict(rank=rank, world=dist.get_world_size(), device=str(dev),
               runs={})
    for name in names:
        res = tp_run(name, TP_RUNS[name], a, dev, True)
        held = res.pop("held")
        dist.collective.barrier()
        ref = None
        if rank == 0:
            single = tp_run(name, TP_RUNS[name], a, dev, False)
            ref = single.pop("final")
            res["single"] = single
        dist.collective.barrier()
        res["vs_ref"] = _tp_vs_ref(held, ref, res["replica"], dev)
        if TP_RUNS[name].get("control"):
            ref = None
            if rank == 0:
                bad = tp_run(name, TP_RUNS[name], a, dev, False,
                             synced=False)
                ref = bad.pop("final")
                res["single"]["control_losses"] = bad["losses"]
            dist.collective.barrier()
            res["control_vs_ref"] = _tp_vs_ref(held, ref, res["replica"],
                                               dev)
        del held, ref
        out["runs"][name] = res
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.collective.barrier()
    dist.destroy_parallel_env()
    return 0


def p2p_messages(counts) -> dict:
    """The activations and gradients a rank sent and received, from its
    pipeline hops (``collective.counts()``)."""
    n = collections.Counter(counts)
    return {"activations_sent": n["send_forward"]
            + n["send_forward_recv_backward"],
            "gradients_received": n["recv_backward"]
            + n["send_forward_recv_backward"],
            "activations_received": n["recv_forward"]
            + n["send_backward_recv_forward"],
            "gradients_sent": n["send_backward"]
            + n["send_backward_recv_forward"]}


def pp_main(a) -> int:
    """Phase 7p's rank program (the module docstring)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective, fleet
    from paddle_tpu_torch.distributed.pipeline import PipelineParallel
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models.llama_pp import LlamaForCausalLMPipe

    schedules = a.pp_steps.split(",")
    if a.clip_norm is not None:          # the clipped step, last
        schedules.append("1F1B")
    sharded = a.axes is not None
    if sharded:
        dist.init_parallel_env(backend=a.backend, device=a.device,
                               timeout=a.timeout)
        dev = dist.current_device()
    else:
        dev = torch.device(a.device or "cuda")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    cfg = _config(a)
    strategy = fleet.DistributedStrategy()
    strategy.pipeline_configs = {"accumulate_steps": a.micro_batches}
    if sharded:
        strategy.hybrid_configs = {f"{k}_degree": v
                                   for k, v in json.loads(a.axes).items()}
        fleet.init(is_collective=True, strategy=strategy)
        pipe = LlamaForCausalLMPipe(cfg, device=dev, seed=0)
        model = fleet.distributed_model(pipe)
    else:
        pipe = LlamaForCausalLMPipe(cfg, num_stages=1, device=dev, seed=0)
        model = PipelineParallel(pipe, None, strategy)
    named = dict(pipe.named_parameters())
    refs = None
    if a.ref:
        refs = torch.load(a.ref, mmap=True)
        init = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}
    opt = pt.optimizer.AdamW(a.lr, parameters=list(named.items()))
    if sharded:
        opt = fleet.distributed_optimizer(opt)
    peaks = []
    orig_step = opt.step

    def step_after_schedule():
        # the schedule's peak: from train_batch's start to here
        if cuda:
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated(dev))
        return orig_step()

    opt.step = step_after_schedule
    rng = np.random.RandomState(a.data_seed)
    data = [torch.from_numpy(rng.randint(0, cfg.vocab_size,
                                         (a.batch, a.seq))).to(dev)
            for _ in schedules]
    if cuda:
        torch.cuda.empty_cache()
    res = dict(rank=rank, world=dist.get_world_size(), device=str(dev),
               stage=pipe.stage_id or 0, n_stages=pipe.num_stages,
               segment=list(pipe._held), names=sorted(named),
               param_bytes=sum(_bytes(p) for p in named.values()),
               params=sum(p.numel() for p in named.values()),
               schedules=schedules, losses=[],
               step_s=[], launches=[], instances=[], hops=[], staged=[],
               in_flight=[], sched_peak_gb=[], step_peak_gb=[],
               act_gb=[])
    clip = None
    for i, (ids, mode) in enumerate(zip(data, schedules)):
        if a.clip_norm is not None and i == len(schedules) - 1:
            clip = pt.nn.ClipGradByGlobalNorm(a.clip_norm)
            opt._grad_clip = clip
        model.schedule_mode = mode
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        launches.reset()
        collective.reset_counts()
        t0 = time.perf_counter()
        loss = float(model.train_batch((ids, ids), opt))
        if cuda:
            torch.cuda.synchronize()
        res["step_s"].append(time.perf_counter() - t0)
        res["losses"].append(loss)
        res["launches"].append(launches.snapshot())
        res["instances"].append(launches.by_instance())
        res["hops"].append({k: n for k, n in collective.counts().items()
                            if k in collective.PIPELINE_P2P})
        res["staged"].append({k: n for k, n in
                              collective.staged_counts().items()
                              if k in collective.PIPELINE_P2P})
        st = model.last_stats
        res["in_flight"].append(st.max_in_flight)
        res["act_gb"].append(st.act_bytes / 1e9)
        res["sched_peak_gb"].append(peaks[-1] / 1e9 if cuda else 0.0)
        res["step_peak_gb"].append(
            torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else 0.0)
    res["finite"] = all(bool(torch.isfinite(p).all())
                        for p in named.values())
    if clip is not None:
        res["clip_norm"] = float(clip.last_global_norm)
    if refs is not None:
        err = {}
        for n, p in named.items():
            w0 = init[n].to(dev).float()
            d = p.detach().float() - w0
            d_ref = refs["final"][n].to(dev).float() - w0
            err[n] = [float(torch.linalg.vector_norm(d - d_ref)),
                      float(torch.linalg.vector_norm(d_ref))]
            del w0, d, d_ref
        res["vs_ref"] = err
    if a.save_params:
        os.makedirs(os.path.dirname(os.path.abspath(a.save_params)),
                    exist_ok=True)
        torch.save({"final": {n: p.detach().cpu()
                              for n, p in named.items()}}, a.save_params)
    os.makedirs(a.out, exist_ok=True)
    with open(os.path.join(a.out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if sharded:
        collective.barrier()
        dist.destroy_parallel_env()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("paddle_tpu_torch.tools.mesh_train")
    ap.add_argument("--axes", default=None,
                    help="mesh axes as JSON; none: the unsharded run")
    ap.add_argument("--config", default="llama3_8b",
                    choices=("llama3_8b", "mixtral", "tiny", "tiny_moe"))
    ap.add_argument("--dtype", default="float32",
                    help="the tiny config's dtype")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--data-seed", type=int, default=7)
    ap.add_argument("--backend", default=None,
                    help="default NCCL (init_parallel_env's)")
    ap.add_argument("--device", default=None,
                    help="default cuda:LOCAL_RANK; unsharded, the card")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--save-from", type=int, default=1,
                    help="the first step a checkpoint is saved after")
    ap.add_argument("--kill-at", type=int, default=None)
    ap.add_argument("--kill-process", default=None, help="STEP:RANK")
    ap.add_argument("--kill-save-site", default=None)
    ap.add_argument("--save-fault-process", type=int, default=None)
    ap.add_argument("--kill-save-step", type=int, default=None)
    ap.add_argument("--kill-hard", action="store_true")
    ap.add_argument("--report-at", type=int, default=None)
    ap.add_argument("--check-restore", action="store_true")
    ap.add_argument("--digests", action="store_true",
                    help="report a sha256 of every parameter and slot part")
    ap.add_argument("--ref", default=None)
    ap.add_argument("--save-params", default=None)
    ap.add_argument("--sp-modes", default=None,
                    help="phase 7q: comma-separated SP_OPTIONS")
    ap.add_argument("--save-grads", default=None)
    ap.add_argument("--pp-steps", default=None,
                    help="phase 7p: each step's schedule (1F1B, FThenB)")
    ap.add_argument("--micro-batches", type=int, default=8,
                    help="phase 7p: accumulate_steps M")
    ap.add_argument("--clip-norm", type=float, default=None,
                    help="phase 7p: one more 1F1B step, its gradients "
                         "clipped to this global norm")
    ap.add_argument("--ref-grads", default=None)
    ap.add_argument("--tp-runs", default=None,
                    help="phase 7t: comma-separated TP_RUNS")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    # eight processes share one card: segments that grow in place keep
    # each allocator's reserve close to what it holds
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if a.sp_modes:
        return sp_main(a)
    if a.pp_steps:
        return pp_main(a)
    if a.tp_runs:
        return tp_main(a)

    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.hapi.callbacks import Callback
    from paddle_tpu_torch.kernels import launches
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.resilience import FaultPlan, ResilienceCallback

    if a.axes is not None:
        dist.init_parallel_env(backend=a.backend, device=a.device,
                               timeout=a.timeout)
        dev = dist.current_device()
    else:
        dev = torch.device(a.device or "cuda")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
    rank = dist.get_rank()
    cfg = _config(a)
    net = LlamaForCausalLM(cfg, device=dev, seed=0)
    opt = pt.optimizer.AdamW(a.lr, parameters=net.parameters())
    model = pt.Model(net)
    model.prepare(opt, lm_loss,
                  mesh=None if a.axes is None else json.loads(a.axes))
    if cuda:
        torch.cuda.empty_cache()      # the whole model's blocks go back
        torch.cuda.reset_peak_memory_stats()
    data = batches(cfg.vocab_size, a.steps, a.batch, a.seq, a.data_seed)

    mesh = getattr(model._mesh_executor, "mesh", None)
    kill_process = None if a.kill_process is None else \
        tuple(int(x) for x in a.kill_process.split(":"))
    report_at = a.report_at
    if report_at is None:
        kill = a.kill_at if a.kill_at is not None else \
            (kill_process[0] if kill_process else None)
        report_at = None if kill is None else kill - 1
    start = {}

    def report(fit_s):
        """This rank's numbers, written to ``--out``: after the fit, and
        at the end of step ``report_at`` (before its save)."""
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 1e9
            reserved = torch.cuda.memory_reserved(dev) / 1e9
            torch.cuda.empty_cache()     # room for the gathers below
        res = dict(
            rank=rank, world=dist.get_world_size(),
            coord=mesh.coord if mesh is not None else {},
            device=str(dev), backend=dist.collective.world_group().backend,
            losses=rec.losses, step_ms=rec.ms, steps=rec.steps,
            fit_s=fit_s,
            resumed_from=resil.resume_step if resil is not None else 0,
            checkpoints=resil.saves_log if resil is not None else [],
            restore_s=resil.restore_s if resil is not None else None,
            reshard_restores=resil.checkpointer.reshard_restores
            if resil is not None else 0,
            restore_check=start.get("check"),
            launches=launches.snapshot(), instances=launches.by_instance(),
            step_collectives=rec.collectives, step_staged=rec.staged,
            bytes=shard_bytes(net, opt),
            peak_gb=peak if cuda else 0.0,
            reserved_gb=reserved if cuda else 0.0)
        if a.digests:
            res["digests"] = {n: _digest(p) for n, p in
                              net.named_parameters()}
            res["slot_digests"] = {
                f"{k}:{n}": _digest(store[id(p)])
                for k, store in opt._accumulators.items()
                for n, p in net.named_parameters() if id(p) in store}
        if a.ref:
            res["vs_ref"] = compare(net, a.ref)
        if a.save_params:
            params = gathered_params(net)
            if rank == 0:
                torch.save({"init": start["params"], "final": params},
                           a.save_params)
        os.makedirs(a.out, exist_ok=True)
        with open(os.path.join(a.out, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
        if a.axes is not None:
            # every rank's numbers (and rank 0's --save-params file) are
            # written before any rank goes on to a fault
            dist.collective.barrier()

    class Recorder(Callback):
        """Each step's loss, host-clock ms and the collectives it made
        (a checkpoint's, made after this callback's step end, fall in
        no step)."""

        def __init__(self):
            super().__init__()
            self.losses, self.ms, self.steps = [], [], []
            self.collectives, self.staged = [], []

        def on_train_batch_begin(self, step, logs=None):
            if cuda:
                torch.cuda.synchronize()
            dist.collective.reset_counts()
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            self.ms.append((time.perf_counter() - self.t0) * 1e3)
            self.losses.append(logs["loss"])
            self.steps.append(step)
            self.collectives.append(dist.collective.counts())
            self.staged.append(dist.collective.staged_counts())
            if step == report_at:
                report(time.perf_counter() - t0)

    class Checkpoints(ResilienceCallback):
        """The resilience callback (no guard) timing the restore and
        each save, with this rank's shard files and bytes of each, and
        ``--kill-save-site``'s fault armed for one step's save."""

        def on_train_begin(self, logs=None):
            t = time.perf_counter()
            super().on_train_begin(logs)
            self.restore_s = time.perf_counter() - t
            self.saves_log = []

        def _save(self):
            step = self.global_step
            if step < a.save_from:
                return
            plan = contextlib.nullcontext()
            if a.kill_save_site is not None and step == a.kill_save_step:
                plan = FaultPlan(kill_save_site=a.kill_save_site,
                                 save_fault_process=a.save_fault_process,
                                 kill_hard=a.kill_hard)
            if cuda:
                torch.cuda.synchronize()
            t = time.perf_counter()
            before = self.checkpointer.shard_files_written
            with plan:
                super()._save()
            secs = time.perf_counter() - t
            lst = os.path.join(self.checkpointer._step_dir(step),
                               f"process_{rank:04d}.files.json")
            with open(lst) as f:
                files = json.load(f)["files"]
            nbytes = sum(os.path.getsize(os.path.join(
                self.checkpointer._step_dir(step), n)) for n in files)
            self.saves_log.append(dict(
                step=step, seconds=secs, bytes=nbytes,
                shard_files=self.checkpointer.shard_files_written - before))

    class Start(Callback):
        """After any resume: the gathered parameters (``--save-params``)
        and the restore check (``--check-restore``)."""

        def on_train_begin(self, logs=None):
            if a.check_restore and resil is not None and resil.resume_step:
                start["check"] = restore_check(net, opt, a.ckpt,
                                               resil.resume_step)
            if a.save_params:
                start["params"] = gathered_params(net)

    rec = Recorder()
    cbs = [rec]
    resil = None
    if a.ckpt:
        resil = Checkpoints(a.ckpt, save_every=a.save_every, guard=False)
        cbs.append(resil)
    cbs.append(Start())
    launches.reset()
    plan = contextlib.nullcontext()
    if a.kill_at is not None:
        plan = FaultPlan(kill_at_step=a.kill_at)
    elif kill_process is not None:
        plan = FaultPlan(kill_process_at={kill_process[0]: kill_process[1]},
                         kill_hard=a.kill_hard)
    t0 = time.perf_counter()
    with plan:
        model.fit(data, epochs=1, verbose=0, callbacks=cbs)
    report(time.perf_counter() - t0)
    if a.axes is not None:
        dist.destroy_parallel_env()
    return 0


if __name__ == "__main__":
    sys.exit(main())
