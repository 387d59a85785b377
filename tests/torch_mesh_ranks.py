"""The rank side of the mesh tests: one process a rank, started by the
port's launcher (``torch_mesh_world.run_world``), running the cases a
test module names and writing each case's result to
``OUT/rank<r>.pkl``.  Imports torch and the port only (never JAX): the
test process computes the JAX package's side and hands it over as
numpy arrays in ``IN`` (a pickle this test run wrote).

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 8 \\
        tests/torch_mesh_ranks.py IN OUT case [case ...]
"""
from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np
import torch

import paddle_tpu_torch as pt
from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import collective as C
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed import mesh as meshmod
from paddle_tpu_torch.distributed.parallel_layers import (
    ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
    mp_all_gather, mp_allreduce, mp_identity, mp_scatter)
from paddle_tpu_torch.distributed.sharding import gather_full
from paddle_tpu_torch.nn.clip import clip_grad_norm_

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().numpy()


def _reset():
    fleet.shutdown()
    dist.executor._ACTIVE = None


def _fleet(**degrees):
    s = fleet.DistributedStrategy()
    s.hybrid_configs = {f"{k}_degree": v for k, v in degrees.items()}
    return fleet.init(is_collective=True, strategy=s)


# ------------------------------------------------------------ collectives
def case_collectives(inp):
    """Each collective over the world on x_r = arange(6) + 10 r."""
    r, n = dist.get_rank(), dist.get_world_size()
    x = torch.arange(6, dtype=torch.float32) + 10 * r
    out = {}
    for op in ("sum", "max", "min", "avg"):
        out[f"all_reduce_{op}"] = _np(C.all_reduce(x.clone(), op))
    out["all_reduce_prod"] = _np(C.all_reduce(
        torch.full((2,), 1.0 + r / 10), C.ReduceOp.PROD))
    out["all_gather"] = np.stack([_np(t) for t in C.all_gather([], x)])
    rs = torch.arange(8 * 2, dtype=torch.float32) + r
    out["reduce_scatter"] = _np(C.reduce_scatter(rs))
    out["reduce_scatter_list"] = _np(C.reduce_scatter(
        torch.empty(2), list(rs.reshape(8, 2))))
    ins = [torch.full((3,), float(10 * r + j)) for j in range(n)]
    out["alltoall"] = np.stack([_np(t) for t in C.alltoall(ins, [])])
    out["alltoall_single"] = _np(C.alltoall_single(
        torch.arange(n * 2, dtype=torch.float32) + 100 * r))
    out["broadcast"] = _np(C.broadcast(x.clone(), src=3))
    out["scatter"] = _np(C.scatter(
        torch.empty(6), [torch.full((6,), float(k)) for k in range(n)]
        if r == 2 else None, src=2))
    red = C.reduce(x.clone(), dst=1)
    out["reduce_dst1"] = _np(red) if r == 1 else None
    objs = C.all_gather_object([], {"rank": r})
    out["all_gather_object"] = [o["rank"] for o in objs]
    box = [{"from": r}]
    C.broadcast_object_list(box, src=5)
    out["broadcast_object_list"] = box[0]["from"]
    # a ring: rank r sends to r + 1
    buf = torch.empty(6)
    if r % 2 == 0:
        C.send(x, dst=(r + 1) % n)
        C.recv(buf, src=(r - 1) % n)
    else:
        C.recv(buf, src=(r - 1) % n)
        C.send(x, dst=(r + 1) % n)
    out["ring_recv"] = _np(buf)
    g = C.new_group([1, 3, 5, 7])
    out["odd_group_sum"] = _np(C.all_reduce(x.clone(), group=g)) \
        if r % 2 else None
    out["odd_group_rank"] = g.rank
    out["barrier"] = C.barrier().wait()
    out["sum_rounded_once_bf16"] = _np(C.sum_rounded_once(
        torch.full((4,), 1.0 + 2.0 ** -7 * r, dtype=torch.bfloat16)))
    out["mean_equal"] = _np(C.mean_rounded_once(torch.full((5,), 0.1)))
    out["counts"] = C.counts()
    out["staged"] = C.staged_counts()
    return out


# ----------------------------------------------------------- the mp ops
def case_mp_ops(inp):
    """The four mp ops over the fleet mesh's mp group (dp 2 x mp 4):
    forward values and the gradient of sum(out * w) for fixed w."""
    _fleet(dp=2, mp=4)
    g = fleet.fleet.hcg.get_model_parallel_group()
    out = {}
    x = _t(inp["x"])                    # [4, 8], the same on every rank
    w_full = _t(inp["w"])               # [4, 8]
    part = x.shape[-1] // g.nranks
    mine = slice(g.rank * part, (g.rank + 1) * part)
    for name, fn, local_in, local_out in (
            ("allreduce", mp_allreduce, False, False),
            ("identity", mp_identity, False, False),
            ("all_gather", mp_all_gather, True, False),
            ("scatter", mp_scatter, False, True)):
        xi = (x[:, mine] if local_in else x).clone().requires_grad_(True)
        y = fn(xi * (g.rank + 1), g)
        w = w_full[:, mine] if local_out else w_full
        (y * w).sum().backward()
        out[name] = (_np(y), _np(xi.grad))
    _reset()
    return out


# -------------------------------------------------- the TP/DP net
def _tp_net(inp, device=CPU):
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up = ColumnParallelLinear(16, 64, gather_output=False,
                                           device=device)
            self.down = RowParallelLinear(64, 16, input_is_parallel=True,
                                          device=device)
            self.head = pt.nn.Linear(16, 4, device=device)

        def forward(self, x):
            return self.head(self.down(torch.nn.functional.gelu(
                self.up(x))))

    net = Net()
    with torch.no_grad():
        for name, p in net.named_parameters():
            full = _t(inp["weights"][name])
            if name == "head.weight":
                full = full.t()          # the port's Linear is [out, in]
            pl = getattr(p, "placement", None)
            p.copy_(full if pl is None else pl.local(full))
    return net


def case_tp_dp_net(inp):
    """tests/test_distributed.py::TestShardedTraining::test_tp_dp_training's
    net on a dp 2 x mp 4 fleet mesh: 10 AdamW(1e-2) steps, each data rank
    on its 4 rows; the global losses and the gathered final weights."""
    hcg = _fleet(dp=2, mp=4).hcg
    net = fleet.distributed_model(_tp_net(inp))
    opt = fleet.distributed_optimizer(
        pt.optimizer.AdamW(1e-2, parameters=net.parameters()))
    d, nd = hcg.get_data_parallel_rank(), hcg.get_data_parallel_world_size()
    x, y = _t(inp["x"]), _t(inp["y"]).long()
    rows = slice(d * x.shape[0] // nd, (d + 1) * x.shape[0] // nd)
    losses = []
    for _ in range(10):
        loss = pt.nn.functional.cross_entropy(net(x[rows]), y[rows])
        loss.backward()
        opt.step()
        opt.clear_grad()
        t = loss.detach().clone()
        C.all_reduce(t, C.ReduceOp.AVG, hcg.get_data_parallel_group())
        losses.append(float(t))
    final = {n: _np(gather_full(p)) for n, p in net.named_parameters()}
    final["head.weight"] = final["head.weight"].T
    spec = str(net.up.weight.placement.spec)
    _reset()
    return {"losses": losses, "final": final, "up_spec": spec}


def _seq_net(inp):
    net = torch.nn.Sequential(pt.nn.Linear(16, 32, device=CPU),
                              torch.nn.GELU(),
                              pt.nn.Linear(32, 4, device=CPU))
    with torch.no_grad():
        for name, p in net.named_parameters():
            full = _t(inp["weights"][name])
            p.copy_(full.t() if full.dim() == 2 else full)
    return net


def _train_seq(net, opt, data):
    out = []
    for x, y in data:
        loss = pt.nn.functional.cross_entropy(net(_t(x)), _t(y).long())
        loss.backward()
        opt.step()
        opt.clear_grad()
        out.append(float(loss))
    return out


def case_zero(inp):
    """TestZeROStages: the unsharded port run, then ZeRO stages 1-3 on a
    dp x sharding 2 fleet mesh (every rank the same rows, as the
    reference's replicated batch), the same weights and data."""
    base_net = _seq_net(inp)
    base = _train_seq(base_net, pt.optimizer.AdamW(
        1e-2, parameters=base_net.parameters()), inp["data"])
    out = {"base": base, "base_final": {
        n: _np(p) for n, p in base_net.named_parameters()}}
    for stage in (1, 2, 3):
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
        s.sharding_configs = {"stage": stage, "sharding_degree": 2}
        fleet.init(is_collective=True, strategy=s)
        net = fleet.distributed_model(_seq_net(inp))
        opt = fleet.distributed_optimizer(
            pt.optimizer.AdamW(1e-2, parameters=net.parameters()))
        losses = _train_seq(net, opt, inp["data"])
        w = net[0].weight
        m1 = opt._accumulators["moment1"][id(w)]
        out[stage] = {
            "losses": losses,
            "final": {n: _np(gather_full(p))
                      for n, p in net.named_parameters()},
            "param_shape": tuple(w.shape), "slot_shape": tuple(m1.shape),
            "state": {k: None if v is None else _np(v) for k, v in
                      opt.state_dict().items() if k.startswith("moment1")},
            "mesh": dict(meshmod.get_mesh().shape)}
        _reset()
    return out


def case_group_sharded(inp):
    """group_sharded_parallel at each level on a {"sharding": 8} mesh of
    its own making, and its refusals."""
    out = {}
    for level in ("os", "os_g", "p_g_os"):
        net = _seq_net(inp)
        opt = pt.optimizer.AdamW(1e-2, parameters=net.parameters())
        net, opt, _ = dist.group_sharded_parallel(net, opt, level)
        out[level] = _train_seq(net, opt, inp["data"])
        _reset()
    for kw in (dict(level="bad"), dict(level="os", offload=True)):
        try:
            net = _seq_net(inp)
            dist.group_sharded_parallel(net, None, **kw)
            out[str(kw)] = None
        except (ValueError, NotImplementedError) as e:
            out[str(kw)] = type(e).__name__
        _reset()
    return out


def case_clip(inp):
    """ClipGradByGlobalNorm and clip_grad_norm_ over parameters split on
    a dp 2 x mp 4 mesh (a column weight, its split bias, a replicated
    weight) against the same gradients whole."""
    _fleet(dp=2, mp=4)
    layer = ColumnParallelLinear(16, 64, gather_output=False, device=CPU)
    rep = torch.nn.Parameter(torch.zeros(16, 4))
    params = [layer.weight, layer.bias, rep]
    grads = [_t(inp["g_w"]), _t(inp["g_b"]), _t(inp["g_r"])]
    out = {}
    pairs = []
    for p, g in zip(params, grads):
        pl = getattr(p, "placement", None)
        pairs.append((p, g if pl is None else pl.local(g)))
    clip = pt.nn.ClipGradByGlobalNorm(inp["clip"])
    clipped = clip(pairs)
    out["norm"] = float(clip.last_global_norm)
    out["clipped"] = [_np(gather_full_like(p, g)) for p, g in clipped]
    for p, (_, g) in zip(params, pairs):
        p.grad = g.clone()
    for norm_type in (2.0, float("inf")):
        for p, (_, g) in zip(params, pairs):
            p.grad = g.clone()
        total = clip_grad_norm_(params, inp["clip"], norm_type)
        out[f"total_{norm_type}"] = float(total)
        out[f"grads_{norm_type}"] = [_np(gather_full_like(p, p.grad))
                                     for p in params]
    _reset()
    return out


def gather_full_like(p, t):
    pl = getattr(p, "placement", None)
    return t if pl is None else pl.gather(t)


def case_topology(inp):
    """HybridCommunicateGroup on a dp 2 x mp 4 fleet mesh: degrees, this
    rank's coordinates and groups."""
    hcg = _fleet(dp=2, mp=4).hcg
    mesh = meshmod.get_mesh()
    out = dict(
        dp=hcg.get_data_parallel_world_size(),
        mp=hcg.get_model_parallel_world_size(),
        pp=hcg.get_pipe_parallel_world_size(),
        sharding=hcg.get_sharding_parallel_world_size(),
        dp_rank=hcg.get_data_parallel_rank(),
        mp_rank=hcg.get_model_parallel_rank(),
        stage=hcg.get_stage_id(),
        dp_group=hcg.get_data_parallel_group().ranks,
        mp_group=hcg.get_model_parallel_group().ranks,
        dp_src=hcg.get_data_parallel_group_src_rank(),
        mp_src=hcg.get_model_parallel_group_src_rank(),
        first=hcg.is_first_stage(), last=hcg.is_last_stage(),
        mode=hcg.get_parallel_mode(), nranks=hcg.nranks,
        axes=dict(mesh.shape), coord=mesh.coord,
        both=mesh.group("dp", "mp").ranks,
        util_sum=fleet.util.all_reduce([dist.get_rank()], "sum").tolist(),
        file_shard=fleet.util.get_file_shard(list(range(10))),
        env=(dist.ParallelEnv().rank, dist.ParallelEnv().world_size,
             dist.ParallelEnv().local_rank))
    vemb = VocabParallelEmbedding(16, 4, device=CPU,
                                  generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[0, 5, 11, 15]])
    out["vocab_lookup"] = _np(vemb(ids))
    out["vocab_full"] = _np(gather_full(vemb.weight))
    _reset()
    return out


def case_refusals(inp):
    """What the mesh runtime refuses across ranks, by exception type and
    a word of its message (None where it ran), and the parts of what
    earlier slices refused and now runs."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    out = {}

    def catch(key, fn):
        try:
            fn()
            out[key] = None
        except Exception as e:     # noqa: BLE001 -- recorded for the test
            out[key] = (type(e).__name__, str(e))

    _fleet(dp=4, pp=2)
    fleet.fleet.strategy.pipeline_configs = {"accumulate_steps": 2}
    from paddle_tpu_torch.models.llama_pp import LlamaForCausalLMPipe

    pipe = LlamaForCausalLMPipe(LlamaConfig.tiny(), device=CPU)
    ids = torch.zeros((4, 8), dtype=torch.long)
    catch("pipeline", lambda: fleet.distributed_model(pipe).train_batch(
        (ids, ids), pt.optimizer.SGD(0.1, parameters=pipe.parameters()),
        scaler=object()))
    _reset()
    ex = dist.MeshExecutor({"data": 2, "fsdp": 2, "tp": 2})
    catch("install_serving", lambda: ex.install_serving(None, None))
    catch("reconcile_train", lambda: ex.reconcile_train())
    catch("reconcile_serving", lambda: ex.reconcile_serving())
    # what earlier slices refused on this mesh now runs
    moe = LlamaForCausalLM(LlamaConfig.tiny(moe_num_experts=4), device=CPU)
    catch("moe", lambda: ex.install(moe))
    out["moe_part"] = tuple(moe.model.layers[0].mlp.w_gate.shape)
    tied = LlamaForCausalLM(LlamaConfig.tiny(tie_word_embeddings=True),
                            device=CPU)
    catch("tied", lambda: ex.install(tied))
    out["tied_part"] = tuple(tied.model.embed_tokens.weight.shape)
    net = LlamaForCausalLM(LlamaConfig.tiny(fused_lm_loss=True), device=CPU)
    ex.install(net)
    ids = torch.zeros(1, 8, dtype=torch.long)
    catch("fused_loss_tp", lambda: net(ids, labels=ids))
    catch("wrong_size", lambda: dist.MeshExecutor({"data": 3}))
    catch("mesh_size", lambda: dist.init_mesh({"dp": 3}))
    opt = []
    catch("meta_optimizer", lambda: opt.append(fleet.distributed_optimizer(
        pt.optimizer.Momentum(0.1, parameters=[torch.nn.Parameter(
            torch.zeros(2))]), _dgc())))
    out["meta_optimizer_class"] = type(opt[0]).__name__ if opt else None
    _reset()
    return out


def _dgc():
    s = fleet.DistributedStrategy()
    s.dgc = True
    return s


def case_data_parallel(inp):
    """DataParallel: the parameters broadcast from rank 0, each gradient
    the mean over the world, none under no_sync."""
    torch.manual_seed(dist.get_rank())
    lin = torch.nn.Linear(3, 2)
    dp = dist.DataParallel(lin)
    w0 = _np(lin.weight)
    x = torch.full((1, 3), float(dist.get_rank() + 1))
    dp(x).sum().backward()
    synced = _np(lin.weight.grad)
    lin.weight.grad = None
    with dp.no_sync():
        dp(x).sum().backward()
    local = _np(lin.weight.grad)
    return {"w0": w0, "synced": synced, "local": local,
            "scaled": float(dp.scale_loss(torch.tensor(2.0)))}


def case_data_parallel_resilience(inp):
    """hapi.Model over a DataParallel replica on every rank, with a
    ResilienceCallback: 4 steps saved every 2 and 2 more; then a fresh
    model of other weights resumed from the checkpoints, trained over
    the same 6 batches: the same parameters and slots bit for bit."""
    from paddle_tpu_torch.resilience import ResilienceCallback

    r = dist.get_rank()
    rng = np.random.RandomState(10 + r)      # each rank its own rows
    data = [(rng.randn(2, 4).astype(np.float32),
             rng.randn(2, 3).astype(np.float32)) for _ in range(6)]
    ckpt = os.path.join(inp["tmp"], "dp_ckpt")

    def model(seed):
        torch.manual_seed(seed)
        net = dist.DataParallel(torch.nn.Linear(4, 3))
        m = pt.Model(net)
        m.prepare(pt.optimizer.AdamW(0.1, parameters=net.parameters()),
                  lambda out, y: ((out - y) ** 2).mean())
        return m

    first = model(r)
    first.fit(data[:4], epochs=1, verbose=0,
              callbacks=[ResilienceCallback(ckpt, save_every=2)])
    steps = sorted(d for d in os.listdir(ckpt) if not d.startswith("."))
    C.barrier()
    cont = [first.train_batch([x], [y]) for x, y in data[4:]]
    fresh = model(100 + r)
    resil = ResilienceCallback(ckpt, save_every=2)
    fresh.fit(data, epochs=1, verbose=0, callbacks=[resil])
    return {"steps": steps, "resumed_from": resil.resume_step,
            "cont": cont, "first": _state(first), "fresh": _state(fresh),
            "same": _same(_state(first), _state(fresh))}


def case_sharding_helpers(inp):
    """shard_tensor, mark_sharding, reshard and gather over a data 2 x
    fsdp 2 x tp 2 executor's mesh; a spec naming an absent axis is a
    no-op."""
    ex = dist.MeshExecutor({"data": 2, "fsdp": 2, "tp": 2})
    t = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    out = {}
    s = dist.shard_tensor(t, placements=["fsdp", "tp"])
    out["shard"] = _np(s)
    out["spec"] = tuple(dist.get_sharding_spec(s))
    out["gathered"] = _np(gather_full(s))
    p = torch.nn.Parameter(t.clone())
    dist.mark_sharding(p, ["fsdp", None])
    out["marked"] = _np(p)
    r = dist.reshard(s, placements=[("data", "tp"), None])
    out["reshard"] = _np(r)
    out["noop"] = dist.shard_tensor(t, placements=["sp", None]) is t
    out["shard_shape"] = ex.shard_shape((8, 8), ["fsdp", "tp"])
    out["clean"] = (tuple(ex.clean_spec(["sp"], (8,))),
                    tuple(ex.clean_spec(["data"], (7,))),
                    tuple(ex.clean_spec(["fsdp", "tp"], (8, 8))))
    out["batch"] = _np(ex.shard_batch([t])[0])
    ex.close()
    return out


# ------------------------------------------------ the tiny Llama on a mesh
def _llama(inp, mesh=None, **overrides):
    from paddle_tpu_torch.convert import from_jax_state_dict_sharded
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.tiny(max_position_embeddings=inp["seq"], **overrides)
    return from_jax_state_dict_sharded(inp["llama"], cfg, mesh, device=CPU)


def lm_loss(logits, labels):
    return dist.ParallelCrossEntropy()(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1)).mean()


def _hapi(inp, axes, **overrides):
    ex = dist.MeshExecutor(axes)
    net = _llama(inp, ex, **overrides)
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(3e-4, parameters=net.parameters()),
                  lm_loss, mesh=ex)
    return model


def _train(model, batches):
    return [model.train_batch([b], [b.astype(np.int64)]) for b in batches]


def _state(model):
    """Parameter and slot parts by name."""
    names = {id(p): n for n, p in model.network.named_parameters()}
    return ({n: _np(p) for n, p in model.network.named_parameters()},
            {k: {names[pid]: _np(v) for pid, v in s.items()}
             for k, s in model._optimizer._accumulators.items()})


def _same(a, b):
    return all(np.array_equal(a[0][k], b[0][k]) for k in a[0]) and all(
        np.array_equal(a[1][k][i], b[1][k][i]) for k in a[1] for i in a[1][k])


def case_llama_hapi(inp):
    """TestMeshTrain: hapi.Model(mesh=AXES) on the tiny Llama, 20 steps;
    the global losses, the gathered final parameters, the launch
    counts."""
    model = _hapi(inp, inp["axes"])
    losses = _train(model, inp["batches"])
    q = dict(model.network.named_parameters())
    name = next(n for n in q if n.endswith("q_proj.weight"))
    out = {"losses": losses, "q_local": tuple(q[name].shape),
           "q_full": q[name].placement.full_shape,
           "final": {n: _np(gather_full(p))
                     for n, p in model.network.named_parameters()}}
    b = inp["batches"][0]
    out["predict"] = _np(model.predict_batch([b]))
    out["eval"] = model.eval_batch([b], [b.astype(np.int64)])
    model._mesh_executor.close()
    return out


def case_llama_resume(inp):
    """TestMeshCheckpoint: 5 steps, collect_state, 3 more, apply_state,
    the 3 again: the same losses and parts bit for bit; then Model.save
    and load into a fresh model (the files read by rank 0 alone, so one
    host copy of the whole exists), and 2 steps on both."""
    from paddle_tpu_torch.resilience.checkpoint import (apply_state,
                                                        collect_state)

    model = _hapi(inp, inp["axes"])
    b = inp["resume_batches"]
    _train(model, b[:5])
    snap = collect_state(model.network, model._optimizer)
    cont = _train(model, b[5:])
    after = _state(model)
    apply_state(snap, model.network, model._optimizer)
    resumed = _train(model, b[5:])
    out = {"cont": cont, "resumed": resumed,
           "same_parts": _same(after, _state(model)),
           "snap_model_leaves": sorted(
               {type(v).__name__ for v in snap["model"].values()})}
    path = os.path.join(inp["tmp"], "saved")
    model.save(path)
    fresh = _hapi(inp, inp["axes"])
    from paddle_tpu_torch.hapi import model as hapi_model

    read, fload = [], hapi_model.fload
    hapi_model.fload = lambda f: read.append(f) or fload(f)
    try:
        fresh.load(path)
    finally:
        hapi_model.fload = fload
    out["files_read"] = len(read)
    out["load_same"] = _same(_state(model), _state(fresh))
    out["after_load"] = (_train(model, b[:2]), _train(fresh, b[:2]))
    model._mesh_executor.close()
    return out


def case_llama_opt_from_jax(inp):
    """The JAX package's AdamW state after its single run, carried into
    a sharded optimizer (convert.optimizer_state_from_jax): the gathered
    slots equal JAX's, and the next step's loss."""
    from paddle_tpu_torch.convert import optimizer_state_from_jax

    ex = dist.MeshExecutor(inp["axes"])
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.convert import from_jax_state_dict_sharded

    cfg = LlamaConfig.tiny(max_position_embeddings=inp["seq"])
    net = from_jax_state_dict_sharded(inp["jax_trained"], cfg, ex,
                                      device=CPU)
    model = pt.Model(net)
    opt = pt.optimizer.AdamW(3e-4, parameters=net.parameters())
    model.prepare(opt, lm_loss, mesh=ex)
    optimizer_state_from_jax(inp["jax_opt"], inp["jax_names"], opt, net)
    slots = opt.state_dict()
    loss = _train(model, inp["next_batch"])
    ex.close()
    return {"slots": {k: None if v is None else _np(v)
                      for k, v in slots.items() if not k.startswith("@")},
            "loss": loss}


def case_llama_recompute(inp):
    """Recompute on a {"fsdp": 8} mesh: 2 steps with and without it, the
    same losses and parts bit for bit; the fused chunked loss there
    (tp 1) beside the logits path."""
    out = {}
    for rc in (False, True):
        model = _hapi(inp, {"fsdp": 8}, recompute=rc)
        out[rc] = (_train(model, inp["batches"][:2]), _state(model))
        model._mesh_executor.close()
    ex = dist.MeshExecutor({"fsdp": 8})
    net = _llama(inp, ex, fused_lm_loss=True)
    ex.install(net)
    ids = torch.from_numpy(inp["batches"][0].astype(np.int64))
    fused, _ = net(ids, labels=ids)
    net.config.fused_lm_loss = False
    plain, _ = net(ids, labels=ids)
    ex.close()
    return {"losses": (out[False][0], out[True][0]),
            "same": _same(out[False][1], out[True][1]),
            "fused": float(fused), "plain": float(plain)}


# --------------------------------------------- expert parallelism (MoE)
def _moe_llama(inp, ex, cf):
    from paddle_tpu_torch.convert import from_jax_state_dict_sharded
    from paddle_tpu_torch.models import LlamaConfig

    cfg = LlamaConfig.tiny(max_position_embeddings=inp["seq"],
                           moe_num_experts=inp["experts"],
                           moe_capacity_factor=cf)
    return from_jax_state_dict_sharded(inp["weights"][cf], cfg, ex,
                                       device=CPU)


def case_ep_llama(inp):
    """The tiny MoE Llama on {data: 2, fsdp: 2, expert: 2} through
    hapi.Model(mesh=...), at each capacity factor: the global losses,
    the gathered final parameters, this rank's expert part shapes."""
    out = {}
    for cf in inp["cfs"]:
        ex = dist.MeshExecutor(inp["axes"])
        net = _moe_llama(inp, ex, cf)
        model = pt.Model(net)
        model.prepare(pt.optimizer.AdamW(3e-4, parameters=net.parameters()),
                      lm_loss, mesh=ex)
        losses = _train(model, inp["batches"])
        params = dict(net.named_parameters())
        out[cf] = {"losses": losses,
                   "final": {n: _np(gather_full(p))
                             for n, p in params.items()},
                   "parts": {n: tuple(p.shape) for n, p in params.items()
                             if "w_" in n}}
        ex.close()
    return out


def case_ep_fleet(inp):
    """fleet with dp 2 x ep 4: distributed_model lays the expert stacks
    along ep, the step averages over dp; the losses of the global
    batches and the gathered final parameters."""
    from paddle_tpu_torch.convert import from_jax_state_dict
    from paddle_tpu_torch.models import LlamaConfig

    hcg = _fleet(dp=2, ep=4).hcg
    cf = inp["cfs"][-1]
    cfg = LlamaConfig.tiny(max_position_embeddings=inp["seq"],
                           moe_num_experts=inp["experts"],
                           moe_capacity_factor=cf)
    net = fleet.distributed_model(from_jax_state_dict(inp["weights"][cf],
                                                      cfg, device=CPU))
    opt = fleet.distributed_optimizer(
        pt.optimizer.AdamW(3e-4, parameters=net.parameters()))
    d, nd = hcg.get_data_parallel_rank(), \
        hcg.get_data_parallel_world_size()
    group = hcg.get_data_parallel_group()
    losses = []
    for b in inp["batches"]:
        rows = b.shape[0] // nd
        ids = torch.from_numpy(b[d * rows:(d + 1) * rows].astype(np.int64))
        logits = net(ids)
        loss = lm_loss(logits, ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        t = loss.detach().reshape(1).double()
        C.all_reduce(t, C.ReduceOp.AVG, group)
        losses.append(float(t[0]))
    w = dict(net.named_parameters())
    name = next(n for n in w if n.endswith("w_gate"))
    out = {"losses": losses, "local": tuple(w[name].shape),
           "ep_group": hcg.get_expert_parallel_group().ranks,
           "final": {n: _np(gather_full(p)) for n, p in w.items()}}
    _reset()
    return out


def case_ep_gpt_moe(inp):
    """The tiny MoEForCausalLM (top-2 and top-1 gates) on {data: 2,
    expert: 4}, one expert a rank: 3 AdamW steps by hand (the losses
    with the aux loss, averaged over the data ranks), the gathered final
    parameters."""
    from paddle_tpu_torch.convert import moe_from_jax
    from paddle_tpu_torch.models import MoEConfig

    out = {}
    for k in inp["top_ks"]:
        ex = dist.MeshExecutor({"data": 2, "expert": 4})
        cfg = MoEConfig.tiny(top_k=k, capacity_factor=inp["cf"],
                             max_position_embeddings=inp["seq"])
        net = moe_from_jax(inp["weights"][k], cfg, device=CPU)
        opt = pt.optimizer.AdamW(1e-3, parameters=net.parameters())
        losses = []
        for b in inp["batches"]:
            ids = torch.from_numpy(ex.shard_batch([b])[0].astype(np.int64))
            loss, _ = net(ids, labels=ids)
            loss.backward()
            ex.reduce_gradients(net)
            opt.step()
            opt.clear_grad()
            losses.append(ex.mean_over_data(float(loss)))
        params = dict(net.named_parameters())
        out[k] = {"losses": losses,
                  "final": {n: _np(gather_full(p))
                            for n, p in params.items()},
                  "w1": tuple(params["layers.1.moe.experts.w1"].shape)}
        ex.close()
    return out


def case_global_scatter(inp):
    """global_scatter / global_gather over the world: the expert blocks
    land on their ranks, the gather inverts the scatter, and counts
    that do not sum to the rows raise."""
    from paddle_tpu_torch.distributed.utils import (global_gather,
                                                    global_scatter)

    r, W = dist.get_rank(), dist.get_world_size()
    E, Cap, D = 2, 3, 4
    x = (torch.arange(W * E * Cap * D, dtype=torch.float32)
         .reshape(W * E * Cap, D) + 1000 * r)
    routed = global_scatter(x, local_count=[Cap] * W * E)
    back = global_gather(routed, global_count=[Cap] * W * E)
    blocks = torch.full((W * 2, D), float(10 * r))
    for e in range(W):
        blocks[2 * e:2 * e + 2] += e
    moved = global_scatter(blocks)
    try:
        global_scatter(x, local_count=[1])
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"x": _np(x), "routed": _np(routed), "back": _np(back),
            "moved": _np(moved), "refused": refused}


def case_ep_ckpt_save(inp):
    """The tiny MoE Llama on {data: 2, fsdp: 2, expert: 2}, 2 steps,
    then a format-2 checkpoint of step 2 (every rank its own parts):
    each rank's shard files and whether it commits."""
    from paddle_tpu_torch.resilience import (ResilientCheckpointer,
                                             collect_state)

    cf = inp["cfs"][0]
    ex = dist.MeshExecutor(inp["axes"])
    net = _moe_llama(inp, ex, cf)
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(3e-4, parameters=net.parameters()),
                  lm_loss, mesh=ex)
    _train(model, inp["batches"][:2])
    ck = ResilientCheckpointer(inp["ckpt"])
    ck.save(2, collect_state(net, model._optimizer,
                             extra={"meta": {"global_step": 2}}))
    ex.close()
    return {"shards": ck.shard_files_written, "saves": ck.saves}


def case_ep_ckpt_restore(inp):
    """A world of 4 on {data: 2, expert: 2} restores that checkpoint
    into a model of other weights: this rank's parameter and slot parts
    with their bounds, the reshard count, and a step's loss."""
    from paddle_tpu_torch.convert import from_jax_state_dict_sharded
    from paddle_tpu_torch.models import LlamaConfig
    from paddle_tpu_torch.resilience import (ResilientCheckpointer,
                                             apply_state)

    ex = dist.MeshExecutor({"data": 2, "expert": 2})
    cfg = LlamaConfig.tiny(max_position_embeddings=inp["seq"],
                           moe_num_experts=inp["experts"],
                           moe_capacity_factor=inp["cf"])
    net = from_jax_state_dict_sharded(inp["other"], cfg, ex, device=CPU)
    model = pt.Model(net)
    opt = pt.optimizer.AdamW(3e-4, parameters=net.parameters())
    model.prepare(opt, lm_loss, mesh=ex)
    _train(model, inp["batches"][:1])         # slots exist before restore
    ck = ResilientCheckpointer(inp["ckpt"])
    step, state = ck.restore_latest()
    apply_state(state, net, opt)
    index = {id(p): i for i, p in enumerate(opt._parameter_list)}

    def bounds(p, pl):
        return pl.bounds if pl is not None else \
            tuple((0, s) for s in p.shape)

    params = {n: (_np(p).copy(), bounds(p, getattr(p, "placement", None)))
              for n, p in net.named_parameters()}
    slots = {f"{k}_{index[pid]}": (_np(v).copy(), bounds(v, opt._slot_placement(
        opt._parameter_list[index[pid]])))
        for k, s in opt._accumulators.items() for pid, v in s.items()}
    loss = _train(model, inp["batches"][2:3])
    ex.close()
    return {"step": step, "reshard": ck.reshard_restores, "params": params,
            "slots": slots, "loss": loss}


# --------------------------------------------- sequence / context parallel
def _sp_part(a, group, dim=1):
    from paddle_tpu_torch.distributed.sequence_parallel import sequence_part

    return sequence_part(_t(a), group, dim).contiguous()


def _attention_case(fn, q, k, v, w, group):
    """This rank's output and dq/dk/dv of ``sum(fn(q, k, v) * w)`` on its
    positions of the global q, k, v and cotangent w."""
    ql, kl, vl = (_sp_part(a, group).requires_grad_() for a in (q, k, v))
    out = fn(ql, kl, vl)
    (out * _sp_part(w, group)).sum().backward()
    return {"out": _np(out), "dq": _np(ql.grad), "dk": _np(kl.grad),
            "dv": _np(vl.grad)}


def case_sp_attention(inp):
    """Ring and Ulysses attention on an sp 8 mesh (and Ulysses on sp 4 x
    tp 2 with each tp rank's heads): this rank's output and gradients
    of each of the module's inputs, and the hops and all-to-alls made."""
    from paddle_tpu_torch.kernels.ring_attention import ring_attention
    from paddle_tpu_torch.kernels.ulysses_attention import ulysses_attention

    out = {}
    mesh = dist.Mesh({"sp": 8})
    g = mesh.group("sp")
    for name, a in inp["cases"].items():
        causal = a["causal"]
        C.reset_counts()
        if name.startswith("ring"):
            fn = lambda q, k, v, c=causal: ring_attention(  # noqa: E731
                q, k, v, mesh=mesh, causal=c)
        else:
            fn = lambda q, k, v, c=causal: ulysses_attention(  # noqa: E731
                q, k, v, mesh=mesh, causal=c)
        out[name] = _attention_case(fn, a["q"], a["k"], a["v"], a["w"], g)
        out[name]["counts"] = C.counts()
        out[name]["staged"] = C.staged_counts()
    a = inp["tp"]
    mesh = dist.Mesh({"sp": 4, "tp": 2})
    g, tp = mesh.group("sp"), mesh.group("tp")
    heads = [_sp_part(x, tp, dim=2).numpy() for x in (a["q"], a["k"], a["v"],
                                                       a["w"])]
    res = _attention_case(lambda q, k, v: ulysses_attention(
        q, k, v, mesh=mesh, causal=True, head_axis="tp"), *heads, g)
    res["heads"] = (tp.rank, heads[0].shape[2])
    out["ulysses_tp"] = res
    return out


def _sp_hapi(inp, axes, **overrides):
    ex = dist.MeshExecutor(axes)
    net = _llama(inp, ex, **overrides)
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(3e-4, parameters=net.parameters()),
                  lm_loss, mesh=ex)
    return model


def case_sp_llama(inp):
    """The tiny Llama with each sequence/context-parallel option on
    {data: 2, sp: 4} (or the mode's own axes) through
    hapi.Model(mesh=...): the global losses of 3 AdamW steps, the
    gathered final parameters, this rank's input part, and the in-model
    loss (labels shifted inside the model, fused and not; the logits
    path alone where tp splits the vocabulary) of the first batch as
    the global mean."""
    out = {}
    for name, opts in inp["modes"].items():
        axes = inp["mode_axes"].get(name, inp["axes"])
        model = _sp_hapi(dict(inp, llama=inp["weights"][name]), axes,
                         **opts)
        ex = model._mesh_executor
        losses = _train(model, inp["batches"])
        net = model.network
        ids, = ex.shard_batch([inp["batches"][0].astype(np.int64)])
        ids = torch.from_numpy(ids)
        shifted = {}
        for fused in (False, True)[:1 if "tp" in axes else 2]:
            net.config.fused_lm_loss = fused
            with torch.no_grad():
                shifted[fused] = ex.mean_over_data(float(net(ids,
                                                             labels=ids)[0]))
        net.config.fused_lm_loss = False
        b = inp["batches"][0]
        predict = _np(model.predict_batch([b]))
        evaluated = model.eval_batch([b], [b.astype(np.int64)])
        out[name] = {"losses": losses, "part": tuple(ids.shape),
                     "predict": predict, "eval": evaluated,
                     "sharded": ex.sequence_sharded, "shifted": shifted,
                     "final": {n: _np(gather_full(p))
                               for n, p in net.named_parameters()}}
        ex.close()
    return out


def case_sp_fleet(inp):
    """fleet with dp 2 x sep 4 and a ring Llama: each rank's rows and
    positions of every batch (sequence_part over the sep group), the
    model's own shifted loss, the fleet step (summed over sep, averaged
    over dp): the global losses and the final parameters.  Then a dense
    Llama in the same session, replicated over sep, trained with SGD
    (averaged over dp only): its global losses and final parameters."""
    from paddle_tpu_torch.convert import from_jax_state_dict
    from paddle_tpu_torch.distributed.sequence_parallel import sequence_part
    from paddle_tpu_torch.models import LlamaConfig

    hcg = _fleet(dp=2, sep=4).hcg
    cfg = LlamaConfig.tiny(max_position_embeddings=inp["seq"],
                           context_parallel="ring")
    net = fleet.distributed_model(from_jax_state_dict(inp["llama"], cfg,
                                                      device=CPU))
    opt = fleet.distributed_optimizer(
        pt.optimizer.AdamW(3e-4, parameters=net.parameters()))
    d, nd = hcg.get_data_parallel_rank(), hcg.get_data_parallel_world_size()
    sep = hcg.get_sep_parallel_group()
    both = dist.get_mesh().group("dp", "sp")
    losses = []
    for b in inp["batches"]:
        rows = b.shape[0] // nd
        ids = sequence_part(torch.from_numpy(
            b[d * rows:(d + 1) * rows].astype(np.int64)), sep)
        loss, _ = net(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        t = loss.detach().reshape(1).double()
        C.all_reduce(t, group=both)
        losses.append(float(t[0]) / nd)
    out = {"losses": losses, "sep": (hcg.get_sep_parallel_world_size(),
                                     hcg.get_sep_parallel_rank()),
           "final": {n: _np(p) for n, p in net.named_parameters()}}
    dense = fleet.distributed_model(from_jax_state_dict(
        inp["llama"], LlamaConfig.tiny(max_position_embeddings=inp["seq"]),
        device=CPU))
    opt = fleet.distributed_optimizer(
        pt.optimizer.SGD(inp["sgd_lr"], parameters=dense.parameters()))
    dp = dist.get_mesh().group("dp")
    losses = []
    for b in inp["batches"]:
        ids = torch.from_numpy(b[d * rows:(d + 1) * rows].astype(np.int64))
        loss, _ = dense(ids, labels=ids)
        loss.backward()
        opt.step()
        opt.clear_grad()
        t = loss.detach().reshape(1).double()
        C.all_reduce(t, group=dp)
        losses.append(float(t[0]) / nd)
    out["dense"] = {"losses": losses,
                    "final": {n: _np(p) for n, p in dense.named_parameters()}}
    _reset()
    return out


def case_sp_step(inp):
    """make_ring_sp_step on {data: 2, sp: 4} with a ring Llama: this
    rank's logits rows of the global ids, the step's cache size after
    two calls, and that the model keeps one step for its mesh."""
    from paddle_tpu_torch.models.generation import make_ring_sp_step

    ex = dist.MeshExecutor(inp["axes"], register=False)
    net = _llama(inp, ex, context_parallel="ring")
    step = make_ring_sp_step(net, mesh=ex.mesh)
    ids = inp["ids"]
    first = step(ids)
    again = step(ids)
    return {"logits": _np(first), "same": bool(torch.equal(first, again)),
            "cache": step._cache_size(),
            "kept": make_ring_sp_step(net, mesh=ex.mesh) is step,
            "coord": ex.mesh.coord}


def case_sp_refusals(inp):
    """What a sequence-parallel mesh refuses: a sequence that does not
    split over sp, a MoE model with its sequence split; and a model
    with neither option stays replicated over sp (its batch cut on
    data only, its gradients averaged over data)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    out = {}
    ex = dist.MeshExecutor({"data": 2, "sp": 4})
    net = LlamaForCausalLM(LlamaConfig.tiny(context_parallel="ring"),
                           device=CPU)
    ex.install(net)
    try:
        ex.shard_batch([np.zeros((2, 6), np.int64)])
    except ValueError as e:
        out["odd_sequence"] = str(e)
    ex.close()
    ex = dist.MeshExecutor({"data": 2, "sp": 4})
    moe = LlamaForCausalLM(LlamaConfig.tiny(sequence_parallel=True,
                                            moe_num_experts=4), device=CPU)
    try:
        ex.install(moe)
    except NotImplementedError as e:
        out["moe"] = str(e)
    ex.close()
    ex = dist.MeshExecutor({"data": 2, "sp": 4})
    ex.install(LlamaForCausalLM(LlamaConfig.tiny(), device=CPU))
    out["dense"] = (ex.sequence_sharded, ex.sequence_reduction(),
                    ex.shard_batch([np.zeros((2, 8), np.int64)])[0].shape)
    ex.close()
    return out

CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


def main(argv, table=None) -> int:
    """Run the cases ``argv`` names from ``table`` (default this
    module's)."""
    table = CASES if table is None else table
    src, dst, *cases = argv
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo", device=CPU, timeout=90)
    with open(src, "rb") as f:
        inp = pickle.load(f)
    results = {}
    for name in cases:
        try:
            results[name] = ("ok", table[name](inp.get(name, {})))
        except Exception:          # noqa: BLE001 -- reported by the test
            results[name] = ("error", traceback.format_exc())
            _reset()
    with open(os.path.join(dst, f"rank{dist.get_rank()}.pkl"), "wb") as f:
        pickle.dump(results, f)
    C.barrier()
    dist.destroy_parallel_env()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
