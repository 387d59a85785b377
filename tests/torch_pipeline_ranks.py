"""The rank side of ``tests/test_torch_pipeline.py``: one process a rank,
started by the port's launcher (``torch_mesh_world.run_world``), running
the pipeline cases the test names.  Imports torch and the port only
(never JAX): the test process hands the JAX package's weights and
inputs over as numpy arrays.

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        tests/torch_pipeline_ranks.py IN OUT case [case ...]
"""
from __future__ import annotations

import sys

import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.convert import (load_pipeline_stage,
                                      optimizer_state_from_jax,
                                      pipeline_named)
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.pipeline import (
    LayerDesc, PipelineLayer, gpipe_spmd, pipeline_1f1b, pipeline_gpipe,
    schedule_p2p_calls)
from paddle_tpu_torch.models import LlamaConfig
from paddle_tpu_torch.models.llama_pp import (LlamaForCausalLMPipe,
                                              llama_1f1b_step_fn)

from torch_mesh_ranks import _fleet, _np, _reset, _t, main

CPU = "cpu"


def _cfg(d):
    return LlamaConfig(**d)


def _hops():
    """The pipeline hops of ``collective.counts()``."""
    return {k: n for k, n in C.counts().items() if k in C.PIPELINE_P2P}


def _pp_stage(mesh):
    return mesh.axis_rank("pp")


# --------------------------------------------------------- functional
def case_pp_gpipe(inp):
    """gpipe_spmd on {"pp": 4}: rank s applies its [L, ...] slice."""
    mesh = dist.init_mesh({"pp": 4})
    s = _pp_stage(mesh)
    W, B = _t(inp["Ws"][s]), _t(inp["Bs"][s])

    def stage_fn(params, x):
        for w, b in zip(*params):
            x = torch.tanh(x @ w + b)
        return x

    out = gpipe_spmd(stage_fn, (W, B), _t(inp["x"]), mesh=mesh)
    _reset()
    return _np(out)


def _generic_stage_fn(S):
    def stage_fn(stage, shared, local, x, mb_in, mb_tgt):
        h = shared["emb"][mb_in.long()] if stage == 0 else x
        for w in local:
            h = torch.tanh(h @ w)
        loss = None
        if stage == S - 1:
            logp = torch.log_softmax(h @ shared["head"], -1)
            loss = -logp.gather(-1, mb_tgt.long()[..., None])[..., 0].mean()
        return h, loss
    return stage_fn


def case_pp_generic(inp):
    """tests/test_distributed.py::Test1F1B's generic stage on {"pp": 4},
    M = 6, under both schedules: the loss, this stage's gradients and
    the shared ones, and the hops each made."""
    S = 4
    mesh = dist.init_mesh({"pp": S})
    s = _pp_stage(mesh)
    local = _t(inp["Ws"][s])
    shared = {"emb": _t(inp["emb"]), "head": _t(inp["head"])}
    act = torch.zeros(inp["act_shape"])
    out = {}
    for name, fn in (("1F1B", pipeline_1f1b), ("FThenB", pipeline_gpipe)):
        C.reset_counts()
        loss, g_local, g_shared = fn(_generic_stage_fn(S), local, shared,
                                     _t(inp["tokens"]), _t(inp["labels"]),
                                     act, mesh=mesh)
        out[name] = dict(loss=float(loss), g_local=_np(g_local),
                         g_shared={k: _np(v) for k, v in g_shared.items()},
                         counts=_hops(), staged=C.staged_counts(),
                         want=schedule_p2p_calls(S, s, 6, name))
    _reset()
    return out


def case_pp_llama_dp(inp):
    """llama_1f1b_step_fn on {"dp": 2, "pp": 2}: with the microbatches'
    rows split over dp, and without (each dp replica the whole
    microbatch: the pp-only run)."""
    cfg = _cfg(inp["cfg"])
    mesh = dist.init_mesh({"dp": 2, "pp": 2})
    s = _pp_stage(mesh)
    shared = {k: _t(v) for k, v in inp["shared"].items()}
    local = {k: _t(v[s]) for k, v in inp["stacked_S"].items()}
    M, micro, T = inp["mb"].shape
    mb = _t(inp["mb"])
    out = {}
    for tag, axis in (("pp", None), ("hybrid", "dp")):
        step = llama_1f1b_step_fn(cfg, mesh, M, micro, T, data_axis=axis)
        loss, g_st, g_sh = step(shared, local, mb, mb)
        out[tag] = dict(loss=float(loss), stage=s,
                        g_st={k: _np(v) for k, v in g_st.items()},
                        g_sh={k: _np(v) for k, v in g_sh.items()})
    _reset()
    return out


def case_pp_llama_steps(inp):
    """10 SGD steps of llama_1f1b_step_fn at pp 2 (on {"dp": 4, "pp":
    2}, each dp replica its own pipeline of the whole batch): the
    losses."""
    cfg = _cfg(inp["cfg"])
    mesh = dist.init_mesh({"dp": 4, "pp": 2})
    s = _pp_stage(mesh)
    shared = {k: _t(v) for k, v in inp["shared"].items()}
    local = {k: _t(v[s]) for k, v in inp["stacked_S"].items()}
    M, lr = inp["M"], inp["lr"]
    losses = []
    for tok in inp["data"]:
        B, T = tok.shape
        step = llama_1f1b_step_fn(cfg, mesh, M, B // M, T)
        mb = _t(tok).reshape(M, B // M, T)
        loss, g_st, g_sh = step(shared, local, mb, mb)
        losses.append(float(loss))
        shared = {k: v - lr * g_sh[k] for k, v in shared.items()}
        local = {k: v - lr * g_st[k] for k, v in local.items()}
    _reset()
    return losses


def case_pp_tied(inp):
    """A tied-embedding Llama on {"pp": 4}: llama_1f1b_step_fn, and the
    tied LlamaForCausalLMPipe (the table a SharedLayerDesc of the first
    and last stage) through PipelineParallel's schedule: the loss, this
    stage's gradients, the table's on the stages that hold it."""
    cfg = _cfg(inp["cfg"])
    mesh = _fleet(pp=4).hcg._mesh
    s = _pp_stage(mesh)
    shared = {k: _t(v) for k, v in inp["shared"].items()}
    local = {k: _t(v[s]) for k, v in inp["stacked_S"].items()}
    mb = _t(inp["mb"])
    M, micro, T = mb.shape
    step = llama_1f1b_step_fn(cfg, mesh, M, micro, T)
    loss, g_st, g_sh = step(shared, local, mb, mb)
    out = dict(stage=s, loss=float(loss),
               g_st={k: _np(v) for k, v in g_st.items()},
               g_sh={k: _np(v) for k, v in g_sh.items()})
    fleet.fleet.strategy.pipeline_configs = {"accumulate_steps": M}
    pl = LlamaForCausalLMPipe(cfg, device=CPU, seed=None)
    load_pipeline_stage(pl, pipeline_named(inp["shared"], inp["stacked"],
                                           cfg))
    model = fleet.distributed_model(pl)
    ids = mb.reshape(M * micro, T)
    mloss = model.forward_backward_pipeline((ids, ids))
    out["module"] = dict(
        loss=float(mloss),
        grads={n: _np(p.grad) for n, p in pl.named_parameters()})
    _reset()
    return out


def case_pp_schedules(inp):
    """The tiny Llama pipe (4 layers) on {"pp": 4}, M = 6, through
    PipelineParallel under 1F1B then FThenB on one batch: the
    microbatches in flight, the hops, the loss and the gradients of
    each."""
    cfg = _cfg(inp["cfg"])
    _fleet(pp=4)
    out = {}
    pl = LlamaForCausalLMPipe(cfg, device=CPU, seed=0)
    fleet.fleet.strategy.pipeline_configs = {"accumulate_steps": 6}
    model = fleet.distributed_model(pl)
    ids = _t(inp["ids"])
    for mode in ("1F1B", "FThenB"):
        model.schedule_mode = mode
        C.reset_counts()
        loss = model.forward_backward_pipeline((ids, ids))
        st = model.last_stats
        out[mode] = dict(
            loss=float(loss), in_flight=st.max_in_flight, stage=st.stage,
            counts=_hops(), staged=C.staged_counts(),
            want=schedule_p2p_calls(4, st.stage, 6, mode),
            grads={n: _np(p.grad) for n, p in pl.named_parameters()},
            names=[n for n, _ in pl.named_parameters()])
        for p in pl.parameters():
            p.grad = None
    _reset()
    return out


def case_pp_refusals(inp):
    """What a pp mesh refuses, by exception type and message."""
    cfg = _cfg(inp["cfg"])
    out = {}

    def catch(key, fn):
        try:
            fn()
            out[key] = None
        except Exception as e:     # noqa: BLE001 -- recorded for the test
            out[key] = (type(e).__name__, str(e))

    _fleet(pp=4)
    fleet.fleet.strategy.pipeline_configs = {"accumulate_steps": 2}
    catch("plain", lambda: fleet.distributed_model(torch.nn.Linear(2, 2)))
    pl = LlamaForCausalLMPipe(cfg, device=CPU, seed=0)
    model = fleet.distributed_model(pl)
    out["wrapped"] = type(model).__name__
    opt = pt.optimizer.SGD(0.1, parameters=pl.parameters())
    ids = torch.zeros((4, 8), dtype=torch.long)
    catch("scaler", lambda: model.train_batch((ids, ids), opt,
                                              scaler=object()))
    odd = torch.zeros((5, 8), dtype=torch.long)
    catch("indivisible", lambda: model.train_batch((odd, odd), opt))
    _reset()
    _fleet(pp=2, sharding=2)
    catch("sharding", lambda: fleet.distributed_model(
        LlamaForCausalLMPipe(cfg, num_stages=2, device=CPU, seed=0)))
    _reset()
    return out


def case_pp_opt_state(inp):
    """The JAX pipe's weights and AdamW state after one step, each stage
    of {"pp": 4} taking its own (``optimizer_state_from_jax(...,
    held_only=True)``), then one train_batch: the loss, the slots
    loaded and this stage's weights."""
    cfg = _cfg(inp["cfg"])
    _fleet(pp=4)
    fleet.fleet.strategy.pipeline_configs = {"accumulate_steps": 2}
    pl = LlamaForCausalLMPipe(cfg, device=CPU, seed=None)
    load_pipeline_stage(pl, inp["state"])
    model = fleet.distributed_model(pl)
    opt = pt.optimizer.AdamW(1e-3, parameters=list(pl.named_parameters()))
    state = optimizer_state_from_jax(inp["opt"], inp["names"], opt, pl,
                                     held_only=True)
    ids = _t(inp["batch"])
    loss = float(model.train_batch((ids, ids), opt))
    out = dict(loss=loss,
               slots=sum(not k.startswith("@") and k != "LR_Scheduler"
                         for k in state),
               final={n: _np(p) for n, p in pl.named_parameters()})
    _reset()
    return out


# ------------------------------------------------------- through fleet
class _Block(torch.nn.Module):
    def __init__(self, d):
        super().__init__()
        self.fc = torch.nn.Linear(d, d)

    def forward(self, x):
        return torch.tanh(self.fc(x))


def _generic_layers(vocab, d, nblocks):
    return ([LayerDesc(torch.nn.Embedding, vocab, d)]
            + [LayerDesc(_Block, d) for _ in range(nblocks)]
            + [LayerDesc(torch.nn.Linear, d, vocab)])


def _load_generic(pl, state):
    """The JAX generic PipelineLayer's weights (Linear [in, out])."""
    with torch.no_grad():
        for name, p in pl.named_parameters():
            w = _t(state[name])
            p.copy_(w.t() if name.endswith("weight") and p.dim() == 2 and
                    not name.startswith("0.") else w)


def case_pp_fleet_generic(inp):
    """Test1F1B::test_fleet_train_batch_compiled_1f1b_generic: an
    embedding, 4 tanh blocks and a linear head through
    fleet.distributed_model on pp 2 x dp 4, SGD, 5 train_batch steps:
    the losses and this stage's final weights (JAX layout)."""
    vocab, d, M = inp["vocab"], inp["d"], inp["M"]
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"dp_degree": 4, "pp_degree": 2}
    s.pipeline_configs = {"accumulate_steps": M}
    fleet.init(is_collective=True, strategy=s)

    def loss_fn(out, lab):
        return torch.nn.functional.cross_entropy(out.reshape(-1, vocab),
                                                 lab.reshape(-1).long())

    pl = PipelineLayer(_generic_layers(vocab, d, 4), num_stages=2,
                       loss_fn=loss_fn,
                       activation_shape=lambda x: ((*x.shape, d),
                                                   torch.float32))
    _load_generic(pl, inp["state"])
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(
        pt.optimizer.SGD(inp["lr"], parameters=pl.parameters()))
    losses = [float(model.train_batch((_t(tok), _t(tok)), opt))
              for tok in inp["data"]]
    final = {}
    for name, p in pl.named_parameters():
        w = _np(p)
        final[name] = w.T if name.endswith("weight") and w.ndim == 2 and \
            not name.startswith("0.") else w
    out = dict(losses=losses, final=final, wrapped=type(model).__name__,
               segments=pl._segments)
    _reset()
    return out


def case_pp_tpxpp(inp):
    """TestTPxPP::test_pp2_mp2_dp2_matches_pp1_mp1 on the port: the JAX
    pipe's initial state on pp 2 x mp 2 x dp 2 (each stage's Megatron
    parts), AdamW(1e-3) through fleet, 3 train_batch steps: the losses,
    and which parameters are split over mp."""
    cfg = _cfg(inp["cfg"])
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {"pp_degree": 2, "mp_degree": 2, "dp_degree": 2}
    s.pipeline_configs = {"accumulate_steps": 2}
    fleet.init(is_collective=True, strategy=s)
    pl = LlamaForCausalLMPipe(cfg, device=CPU, seed=None)
    load_pipeline_stage(pl, inp["state"])
    model = fleet.distributed_model(pl)
    opt = fleet.distributed_optimizer(
        pt.optimizer.AdamW(1e-3, parameters=list(pl.named_parameters())))
    losses = [float(model.train_batch((_t(tok), _t(tok)), opt))
              for tok in inp["data"]]
    split = sorted(n for n, p in pl.named_parameters()
                   if getattr(p, "placement", None) is not None)
    out = dict(losses=losses, split=split, wrapped=type(model).__name__)
    _reset()
    return out


def case_pp_clip(inp):
    """One train_batch of the tied tiny Llama pipe (4 layers, M = 2)
    with SGD under ClipGradByGlobalNorm at a norm that bites, on {"pp":
    2, "dp": 2} and on {"pp": 2, "mp": 2}: the norm every rank clipped
    by, and this stage's parameters after the step (gathered over
    mp)."""
    from paddle_tpu_torch.distributed.sharding import gather_full

    cfg = _cfg(inp["cfg"])
    out = {}
    for degrees in (dict(pp=2), dict(pp=2, mp=2)):
        _fleet(**degrees)
        fleet.fleet.strategy.pipeline_configs = {"accumulate_steps": 2}
        pl = LlamaForCausalLMPipe(cfg, device=CPU, seed=None)
        load_pipeline_stage(pl, inp["init"])
        model = fleet.distributed_model(pl)
        clip = pt.nn.ClipGradByGlobalNorm(inp["clip"])
        opt = fleet.distributed_optimizer(pt.optimizer.SGD(
            inp["lr"], parameters=list(pl.named_parameters()),
            grad_clip=clip))
        ids = _t(inp["ids"])
        loss = float(model.train_batch((ids, ids), opt))
        out[tuple(degrees)] = dict(
            loss=loss, norm=float(clip.last_global_norm),
            stage=pl.stage_id,
            final={n: _np(gather_full(p)) for n, p in pl.named_parameters()})
        _reset()
    return out


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], CASES))
