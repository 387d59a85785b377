"""Fleet, the distributed training front end (the port of
``paddle_tpu/distributed/fleet/__init__.py``).

``init`` makes the hybrid mesh of ``strategy.hybrid_configs`` over the
world's ranks; ``distributed_model`` lays the model out (ZeRO over the
``sharding`` axis: ``apply_group_sharding``); ``distributed_optimizer``
makes the optimizer's step reduce the gradients over the data-parallel
ranks and, with ZeRO, update each parameter's part and gather it back.

ZeRO stages (the reference's ``apply_group_sharding``), over the
``sharding`` axis, whose ranks take different rows as data-parallel
ranks do:

- stage 1: parameters and gradients whole; each gradient averaged over
  the data ranks (``dp`` and ``sharding``), and each rank updates its
  part of the parameter with its part of the slots, then the parts are
  gathered;
- stage 2: each gradient reduce-scattered (averaged) over ``sharding``
  into its part, averaged over ``dp``, and updated as stage 1;
- stage 3: the parameters too are parts; a layer gathers its
  parameters for its forward (``_zero3_hooks``) and the gather's
  backward reduce-scatters the gradient.

``sep_degree`` makes the mesh's ``sp`` axis.  A model that splits its
sequence over it (a Llama with ``context_parallel`` or
``sequence_parallel``; ``distributed_model`` marks each of its
parameters) takes this rank's positions of each batch
(``sequence_parallel.sequence_part`` over
``hcg.get_sep_parallel_group()``) and gives its share of the global
loss, so the step SUMS each marked parameter's gradient over ``sp``
before the means over the data ranks.  Any other model in the session
stays replicated over ``sp``: its gradients are averaged over the data
ranks only.

A parameter's part is along the canonical ``SpecLayout`` role's dim
(``fsdp`` read as ``sharding``, ``tp`` as ``mp``) at stages 2 and 3,
else along its first dim the sharding degree divides.  Parameters of
the model-parallel layers keep their own split.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import collective
from ..env import get_rank, get_world_size
from ..mesh import (CommunicateTopology, HybridCommunicateGroup, fleet_mesh,
                    get_hybrid_communicate_group, get_mesh, reset_mesh)
from ..sequence_parallel import uses_sequence_parallel
from ..sharding import (PartitionSpec, Placement, SpecLayout,
                        llama_param_role, placement_of)
from .distributed_strategy import DistributedStrategy

__all__ = ["DistributedStrategy", "Fleet", "PaddleCloudRoleMaker", "Role",
           "UserDefinedRoleMaker", "UtilBase", "apply_group_sharding",
           "barrier_worker", "distributed_model", "distributed_optimizer",
           "fleet", "init", "is_first_worker", "shard_optimizer",
           "shutdown", "util", "worker_index", "worker_num"]

_PIPELINE = ("pipeline parallelism (pp_degree > 1: PipelineLayer, the 1F1B "
             "schedule) waits for ROADMAP item A3's pipeline item")


class _Fleet:
    def __init__(self):
        self.strategy: Optional[DistributedStrategy] = None
        self.hcg: Optional[HybridCommunicateGroup] = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True, strategy=None):
        self.strategy = strategy or DistributedStrategy()
        hc = self.strategy.hybrid_configs
        degrees = {k: int(hc.get(f"{k}_degree", 1) or 1)
                   for k in ("dp", "mp", "pp", "sharding", "sep", "ep")}
        n = get_world_size()
        if degrees["dp"] * degrees["mp"] * degrees["pp"] * \
                degrees["sharding"] * degrees["sep"] * degrees["ep"] == 1:
            degrees["dp"] = n          # pure data parallelism by default
        fleet_mesh(dp_degree=degrees["dp"], mp_degree=degrees["mp"],
                   pp_degree=degrees["pp"],
                   sharding_degree=degrees["sharding"],
                   sp_degree=degrees["sep"], ep_degree=degrees["ep"])
        topo = CommunicateTopology(
            ["data", "pipe", "sharding", "model"],
            [degrees["dp"], degrees["pp"], degrees["sharding"],
             degrees["mp"]])
        self.hcg = HybridCommunicateGroup(topo)
        self._is_initialized = True
        return self


fleet = _Fleet()
Fleet = _Fleet


def init(role_maker=None, is_collective=True, strategy=None,
         log_level="INFO"):
    return fleet.init(role_maker, is_collective, strategy)


def shutdown():
    """Forget the mesh, the hybrid group and the strategy."""
    reset_mesh()
    fleet.strategy = None
    fleet.hcg = None
    fleet._is_initialized = False


def distributed_model(model):
    """Lay ``model`` out for the installed mesh: a MoE Llama's expert
    stacks along ``ep`` (dim 0, expert parallelism: each rank its
    experts, the gradients averaged over the data ranks only), ZeRO over
    ``sharding`` (stage from ``strategy.sharding_configs``, default 3).
    A mesh with ``pp`` > 1 raises: pipeline parallelism is not ported;
    so do expert stacks on a mesh with ``sharding`` or ``mp`` > 1."""
    mesh = get_mesh()
    if mesh is None:
        return model
    if mesh.shape.get("pp", 1) > 1:
        raise NotImplementedError(_PIPELINE)
    if mesh.shape.get("ep", 1) > 1:
        _lay_out_experts(model, mesh)
    hcg = fleet.hcg or get_hybrid_communicate_group()
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        stage = 3
        if fleet.strategy is not None:
            stage = int((fleet.strategy.sharding_configs or {}).get(
                "stage", 3))
        apply_group_sharding(model, mesh, stage=stage)
    cfg = getattr(model, "config", None)
    if cfg is not None and uses_sequence_parallel(cfg) and \
            mesh.shape.get("sp", 1) > 1:
        # each gradient is this rank's share of a sum over sp
        for p in model.parameters():
            p._sequence_sharded = True
    return model


def _lay_out_experts(model, mesh):
    """Each expert stack of ``model`` (a MoE Llama's ``w_gate``,
    ``w_up``, ``w_down``) this rank's part along ``ep``."""
    stacks = [(n, p) for n, p in model.named_parameters()
              if llama_param_role(n) in ("moe_expert_in", "moe_expert_out")
              and placement_of(p) is None]
    if stacks and (mesh.shape.get("sharding", 1) > 1
                   or mesh.shape.get("mp", 1) > 1):
        raise NotImplementedError(
            "expert stacks with ZeRO (sharding) or mp on the same mesh are "
            "not ported; use ep with dp (or hapi.Model(mesh=...) with "
            "the expert and fsdp axes)")
    for _, p in stacks:
        pl = Placement(mesh, PartitionSpec("ep"), p.shape)
        p.data = pl.local(p.data)
        p.placement = pl


def _zero_spec(p, mesh) -> PartitionSpec:
    """The first dim of ``p`` the sharding degree divides."""
    deg = mesh.shape.get("sharding", 1)
    for axis, size in enumerate(p.shape):
        if size % deg == 0 and size >= deg:
            spec = [None] * p.dim()
            spec[axis] = "sharding"
            return PartitionSpec(*spec)
    return PartitionSpec()


def _canonical_zero_spec(name, p, mesh) -> Optional[PartitionSpec]:
    """The canonical role's spec on this mesh's axes (fsdp read as
    sharding, tp as mp), restricted to axes it has and dims they divide;
    None without a role or with nothing left."""
    role = llama_param_role(name)
    if role is None:
        return None
    spec = SpecLayout(data_axis="dp", fsdp_axis="sharding", tp_axis="mp",
                      batch_axis="dp").spec_for_role(role)
    if not tuple(spec):
        return PartitionSpec()
    pl = Placement(mesh, spec, p.shape)
    return None if pl.replicated else pl.spec


class _ZeroGather(torch.autograd.Function):
    """A stage-3 parameter whole along ``dim``; its gradient
    reduce-scattered (averaged) over the sharding group back into the
    part."""

    @staticmethod
    def forward(ctx, w, group, dim):
        ctx.group, ctx.dim = group, dim
        return torch.cat(collective.all_gather(None, w.contiguous(),
                                               group=group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        parts = list(g.chunk(ctx.group.nranks, dim=ctx.dim))
        out = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
        collective.reduce_scatter(out, parts, collective.ReduceOp.AVG,
                                  ctx.group)
        return out, None, None


def _zero3_hooks(module, names):
    """Gather ``module``'s stage-3 parameters ``names`` for its forward
    (the whole tensors stand in for them while it runs)."""

    def pre(mod, args):
        for n in names:
            p = mod._parameters.pop(n)
            mod.__dict__[n] = _ZeroGather.apply(
                p, p.placement.group(p.placement.dim_of("sharding")),
                p.placement.dim_of("sharding"))
            mod.__dict__.setdefault("_zero3_parts", {})[n] = p

    def post(mod, args, out):
        for n in names:
            del mod.__dict__[n]
            mod._parameters[n] = mod.__dict__["_zero3_parts"].pop(n)
        return out

    module.register_forward_pre_hook(pre)
    module.register_forward_hook(post)


def apply_group_sharding(model, mesh, stage=3):
    """Mark every parameter of ``model`` not already split by a
    model-parallel layer with its ZeRO part along ``sharding``
    (``_zero_spec``); stage 3 makes the parameters their parts and hooks
    the layers that own them."""
    owners = {}
    for mod_name, mod in model.named_modules():
        for n, p in mod.named_parameters(recurse=False):
            owners[id(p)] = (mod, n)
    for name, p in model.named_parameters():
        pl = placement_of(p)
        if pl is not None and not pl.replicated:
            continue
        spec = _canonical_zero_spec(name, p, mesh) if stage >= 2 else None
        if spec is None:
            spec = _zero_spec(p, mesh)
        zpl = Placement(mesh, PartitionSpec(*[
            e if e == "sharding" else None for e in spec]), p.shape)
        if zpl.replicated:
            continue
        p._zero_placement = zpl
        p._zero_stage = stage
        if stage >= 3:
            p.data = zpl.local(p.data)
            p.placement = zpl
            mod, n = owners[id(p)]
            mod.__dict__.setdefault("_zero3_names", []).append(n)
    for mod in model.modules():
        names = mod.__dict__.pop("_zero3_names", None)
        if names:
            _zero3_hooks(mod, names)


def _data_axes(mesh):
    return tuple(a for a in ("dp", "data", "sharding") if a in mesh.shape)


def shard_optimizer(optimizer, model=None, mesh=None):
    """Make ``optimizer.step`` the ZeRO step over ``mesh`` (see the
    module docstring); parameters without a ZeRO part average their
    gradients over the data ranks and update whole."""
    mesh = mesh or get_mesh()
    if mesh is None or getattr(optimizer, "_fleet_step", False):
        return optimizer
    optimizer._fleet_step = True
    params = optimizer._parameter_list
    for p in params:
        zpl = getattr(p, "_zero_placement", None)
        if zpl is not None and p._zero_stage < 3:
            optimizer._slot_placements[id(p)] = zpl
    orig_step = optimizer.step
    data_axes = _data_axes(mesh)
    dp_axes = tuple(a for a in data_axes if a != "sharding")

    def whole_mean(p, axes):
        """``p.grad`` averaged over ``axes`` (summed over ``sp`` as
        well for a parameter of a model that splits its sequence over
        it), rounded once."""
        if getattr(p, "_sequence_sharded", False):
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            collective.sum_divided_rounded_once(
                p.grad, mesh.group(*axes, "sp"), n)
        elif axes:
            collective.mean_rounded_once(p.grad, mesh.group(*axes))

    @torch.no_grad()
    def step():
        swapped = []
        for p in params:
            if p.grad is None:
                continue
            zpl = getattr(p, "_zero_placement", None)
            stage = getattr(p, "_zero_stage", 0)
            if zpl is None or stage >= 3:
                # whole, or a stage-3 part whose gather's backward
                # already averaged over sharding
                whole_mean(p, dp_axes if stage >= 3 else data_axes)
                continue
            if getattr(p, "_sequence_sharded", False):
                collective.sum_rounded_once(p.grad, mesh.group("sp"))
            dim = zpl.dim_of("sharding")
            group = zpl.group(dim)
            if stage == 2:
                parts = list(p.grad.chunk(group.nranks, dim=dim))
                g = torch.empty_like(parts[0],
                                     memory_format=torch.contiguous_format)
                collective.reduce_scatter(g, parts, collective.ReduceOp.AVG,
                                          group)
                if dp_axes:
                    collective.mean_rounded_once(g, mesh.group(*dp_axes))
            else:
                collective.mean_rounded_once(p.grad, mesh.group(*data_axes))
                g = zpl.local(p.grad)
            swapped.append((p, p.data, zpl))
            p.data = zpl.local(p.data)
            p.grad = g
            p.placement = zpl
        try:
            out = orig_step()
        finally:
            for p, _, zpl in swapped:
                dim = zpl.dim_of("sharding")
                p.data = torch.cat(collective.all_gather(
                    None, p.data, group=zpl.group(dim)), dim=dim)
                p.grad = None
                del p.placement
        return out

    optimizer.step = step
    return optimizer


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer with the hybrid mesh's step (``shard_optimizer``):
    gradients averaged over the data ranks, ZeRO parts updated and
    gathered.  The strategy's meta-optimizers (dgc, lars, gradient merge,
    local SGD) are not ported and raise."""
    strategy = strategy or fleet.strategy
    for flag in ("dgc", "lars", "gradient_merge", "localsgd"):
        if strategy is not None and getattr(strategy, flag, False):
            raise NotImplementedError(
                f"strategy.{flag} (a fleet meta-optimizer) is not ported to "
                "paddle_tpu_torch")
    optimizer._is_distributed = True
    return shard_optimizer(optimizer)


worker_index = get_rank
worker_num = get_world_size


def is_first_worker():
    return get_rank() == 0


def barrier_worker():
    collective.barrier()


class UserDefinedRoleMaker:
    def __init__(self, *a, **k):
        pass


class PaddleCloudRoleMaker:
    def __init__(self, is_collective=True, **kwargs):
        self._is_collective = is_collective


class Role:
    WORKER = 1
    SERVER = 2
    HETER_WORKER = 3
    ALL = 4


class UtilBase:
    """Collectives over the world for host values (the reference's
    ``UtilBase``; ``comm_world`` is taken and selects nothing)."""

    def __init__(self):
        self.role_maker = None

    def _set_role_maker(self, role_maker):
        self.role_maker = role_maker

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np

        op = {"sum": collective.ReduceOp.SUM, "max": collective.ReduceOp.MAX,
              "min": collective.ReduceOp.MIN}[mode]
        t = torch.as_tensor(np.asarray(input)).clone()
        collective.all_reduce(t, op=op)
        return t.numpy()

    def barrier(self, comm_world="worker"):
        collective.barrier()

    def all_gather(self, input, comm_world="worker"):
        import numpy as np

        parts = collective.all_gather(
            None, torch.as_tensor(np.asarray(input)).clone())
        return [t.numpy() for t in parts]

    def get_file_shard(self, files):
        """A contiguous, near-even split of ``files`` for this worker
        (the first ``len % n`` workers get one more)."""
        if not isinstance(files, list):
            raise TypeError("files should be a list of file need to be read")
        rank, world = worker_index(), worker_num()
        per, rem = divmod(len(files), world)
        begin = rank * per + min(rank, rem)
        return files[begin:begin + per + (1 if rank < rem else 0)]

    def print_on_rank(self, message, rank_id):
        if get_rank() == rank_id:
            print(message)


util = UtilBase()
