"""The rank side of ``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_meta_optimizers.py``: one process a rank, started by
the port's launcher (``torch_mesh_world.run_world``), running the cases
the test names.  Imports torch and the port only (never JAX): the test
process hands the JAX package's weights and inputs over as numpy
arrays.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        tests/torch_tp_ranks.py IN OUT case [case ...]
"""
from __future__ import annotations

import sys

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.convert import (from_jax_state_dict,
                                      from_jax_state_dict_sharded)
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.sharding import gather_full, placement_of
from paddle_tpu_torch.models import LlamaConfig

from torch_mesh_ranks import _fleet, _np, _reset, lm_loss, main

CPU = "cpu"


def _cfg(inp, **kw):
    return LlamaConfig(**{**inp["cfg"], **kw})


def _grads(net):
    """Every gradient, gathered whole (a collective of the parts'
    holders)."""
    out = {}
    for n, p in net.named_parameters():
        pl = placement_of(p)
        g = p.grad
        out[n] = _np(g if pl is None or pl.replicated else pl.gather(g))
    return out


def _final(net):
    return {n: _np(gather_full(p)) for n, p in net.named_parameters()}


def _split(net):
    return sorted(n for n, p in net.named_parameters()
                  if placement_of(p) is not None
                  and not placement_of(p).replicated)


def _ids(b):
    return torch.from_numpy(np.asarray(b).astype(np.int64))


# ------------------------------------------------ the tensor-parallel loss
def case_tp_loss(inp):
    """{"data": 2, "tp": 2} through MeshExecutor: for the untied and the
    tied tiny Llama, the fused chunked loss and the logits path on one
    global batch: the global loss, every gradient (averaged over data,
    gathered whole), the collectives of each."""
    out = {}
    for tied in (False, True):
        for fused in (True, False):
            ex = dist.MeshExecutor({"data": 2, "tp": 2})
            cfg = _cfg(inp, tie_word_embeddings=tied, fused_lm_loss=fused)
            net = from_jax_state_dict_sharded(inp["weights"][tied], cfg, ex,
                                              device=CPU)
            ex.install(net)
            ids, = ex.shard_batch([_ids(inp["batch"])])
            C.reset_counts()
            loss, _ = net(ids, labels=ids)
            loss.backward()
            counts = C.counts()
            ex.reduce_gradients(net)
            out[(tied, fused)] = dict(
                loss=ex.mean_over_data(float(loss.detach())),
                grads=_grads(net), counts=counts,
                vocab_group=net._vocab_group() is not None,
                split=_split(net))
            ex.close()
    return out


def case_tp_hapi_tied(inp):
    """The tied tiny Llama through hapi.Model(mesh={"data": 2, "tp":
    2}), the vocab-parallel loss (ParallelCrossEntropy on the logits),
    SGD: the global losses and the gathered final weights."""
    ex = dist.MeshExecutor({"data": 2, "tp": 2})
    net = from_jax_state_dict_sharded(
        inp["weights"][True], _cfg(inp, tie_word_embeddings=True), ex,
        device=CPU)
    model = pt.Model(net)
    model.prepare(pt.optimizer.SGD(inp["lr"], parameters=net.parameters()),
                  lm_loss, mesh=ex)
    losses = [model.train_batch([b], [b.astype(np.int64)])
              for b in inp["batches"]]
    out = {"losses": losses, "final": _final(net),
           "table": tuple(net.model.embed_tokens.weight.shape)}
    ex.close()
    return out


def _fleet_steps(net, opt, batches, fused=None):
    """Each data rank (dp and sharding alike) its rows of each global
    batch through ``opt``: the model's own loss, on each step's path
    from ``fused``, or without it the vocab-parallel loss on the
    logits; the global losses (averaged over the data ranks)."""
    mesh = dist.get_mesh()
    axes = tuple(a for a in ("dp", "sharding") if a in mesh.shape)
    group = mesh.group(*axes) if axes else None
    nd = group.nranks if group is not None else 1
    d = group.rank if group is not None else 0
    losses = []
    for i, b in enumerate(batches):
        rows = b.shape[0] // nd
        ids = _ids(b[d * rows:(d + 1) * rows])
        if fused is None:
            loss = lm_loss(net(ids), ids)
        else:
            net.config.fused_lm_loss = fused[i]
            loss, _ = net(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        t = loss.detach().reshape(1).double()
        if group is not None:
            C.all_reduce(t, C.ReduceOp.AVG, group)
        losses.append(float(t[0]))
    return losses


def case_tp_fleet_tied(inp):
    """The tied tiny Llama through fleet {"dp": 2, "mp": 2}, and through
    {"mp": 2, "sharding": 2} (ZeRO stage 3: the Megatron parts split
    over sharding too): the table split by rows over mp
    (distributed_model), the fused loss for the first steps and the
    logits path after (``fused``), SGD: the global losses, the gathered
    final weights, the parts, and the parameters split over sharding."""
    out = {}
    for degrees in (dict(dp=2, mp=2), dict(mp=2, sharding=2)):
        _fleet(**degrees)
        net = fleet.distributed_model(from_jax_state_dict(
            inp["weights"][True], _cfg(inp, tie_word_embeddings=True),
            device=CPU))
        opt = fleet.distributed_optimizer(
            pt.optimizer.SGD(inp["lr"], parameters=net.parameters()))
        losses = _fleet_steps(net, opt, inp["batches"], inp["fused"])
        params = dict(net.named_parameters())
        out[tuple(degrees)] = {
            "losses": losses, "final": _final(net), "split": _split(net),
            "table": tuple(net.model.embed_tokens.weight.shape),
            "parts": {n: tuple(p.shape) for n, p in params.items()},
            "zero3": sorted(n for n, p in params.items()
                            if placement_of(p) is not None
                            and "sharding" in placement_of(p).axes)}
        _reset()
    return out


# ------------------------------------------------------ experts over tp
def case_tp_moe(inp):
    """The tiny MoE Llama on {"expert": 2, "tp": 2} through
    hapi.Model(mesh=...), SGD: the global losses, the gathered final
    weights, this rank's stack shapes."""
    ex = dist.MeshExecutor({"expert": 2, "tp": 2})
    net = from_jax_state_dict_sharded(inp["moe"], _cfg(inp, **inp["moe_cfg"]),
                                      ex, device=CPU)
    model = pt.Model(net)
    model.prepare(pt.optimizer.SGD(inp["lr"], parameters=net.parameters()),
                  lm_loss, mesh=ex)
    losses = [model.train_batch([b], [b.astype(np.int64)])
              for b in inp["batches"]]
    params = dict(net.named_parameters())
    out = {"losses": losses, "final": _final(net),
           "parts": {n: tuple(p.shape) for n, p in params.items()
                     if n.endswith(("w_gate", "w_up", "w_down"))}}
    ex.close()
    return out


def case_tp_moe_fleet(inp):
    """The tiny MoE Llama through fleet on {"ep": 2, "mp": 2} and on
    {"ep": 2, "sharding": 2} (ZeRO stage 3, the stacks split over ep and
    sharding), SGD, the vocab-parallel loss on the logits: the global
    losses, the gathered final weights and the stacks' parts of each."""
    out = {}
    for degrees in (dict(ep=2, mp=2), dict(ep=2, sharding=2)):
        _fleet(**degrees)
        net = fleet.distributed_model(from_jax_state_dict(
            inp["moe"], _cfg(inp, **inp["moe_cfg"]), device=CPU))
        opt = fleet.distributed_optimizer(
            pt.optimizer.SGD(inp["lr"], parameters=net.parameters()))
        losses = _fleet_steps(net, opt, inp["batches"])
        params = dict(net.named_parameters())
        out[tuple(degrees)] = {
            "losses": losses, "final": _final(net),
            "parts": {n: tuple(p.shape) for n, p in params.items()
                      if n.endswith(("w_gate", "w_up", "w_down"))}}
        _reset()
    return out


# ----------------------------------------------------- meta-optimizers
def _strategy(meta):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 2, "mp_degree": 2}
    for flag, cfg in meta.items():
        setattr(s, flag, True)
        setattr(s, f"{flag}_configs", dict(cfg))
    return s


def case_meta(inp):
    """The tied tiny Llama through fleet {"dp": 2, "mp": 2} under each
    run's strategy flags and base optimizer (Momentum or SGD), the
    model's own loss (fused): each rank's own loss a step (its data
    rows), its parameters gathered over mp after the last step, the
    optimizer's class chain; then local SGD with ZeRO, refused."""
    out = {}
    for name, run in inp["runs"].items():
        fleet.init(is_collective=True, strategy=_strategy(run["meta"]))
        hcg = fleet.fleet.hcg
        net = fleet.distributed_model(from_jax_state_dict(
            inp["weights"], _cfg(inp, tie_word_embeddings=True,
                                 fused_lm_loss=True), device=CPU))
        params = list(net.named_parameters())
        base = pt.optimizer.Momentum(run["lr"], momentum=0.9,
                                     parameters=params) \
            if run["base"] == "momentum" else \
            pt.optimizer.SGD(run["lr"], parameters=params)
        opt = fleet.distributed_optimizer(base)
        d = hcg.get_data_parallel_rank()
        nd = hcg.get_data_parallel_world_size()
        losses = []
        for b in inp["batches"]:
            rows = b.shape[0] // nd
            ids = _ids(b[d * rows:(d + 1) * rows])
            loss, _ = net(ids, labels=ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss.detach()))
        chain, o = [], opt
        while o is not None:
            chain.append(type(o).__name__)
            o = getattr(o, "_inner", None) if "_inner" in vars(o) else None
        out[name] = {"losses": losses, "final": _final(net), "data_rank": d,
                     "chain": chain}
        _reset()
    s = _strategy({"localsgd": {"k_steps": 2}})
    s.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
    fleet.init(is_collective=True, strategy=s)
    try:
        fleet.distributed_optimizer(pt.optimizer.SGD(
            0.1, parameters=[torch.nn.Parameter(torch.zeros(2))]))
        out["refused"] = None
    except NotImplementedError as e:
        out["refused"] = (type(e).__name__, str(e))
    _reset()
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], CASES))
