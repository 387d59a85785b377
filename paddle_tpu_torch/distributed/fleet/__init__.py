"""Fleet, the distributed training front end (the port of
``paddle_tpu/distributed/fleet/__init__.py``).

``init`` makes the hybrid mesh of ``strategy.hybrid_configs`` over the
world's ranks; ``distributed_model`` lays the model out (a Llama's
Megatron parts over ``mp``, expert stacks over ``ep`` and ``mp``, ZeRO
over the ``sharding`` axis: ``apply_group_sharding``);
``distributed_optimizer`` makes the optimizer's step reduce the
gradients over the data-parallel ranks and, with ZeRO, update each
parameter's part and gather it back, and applies the strategy's
meta-optimizers (``meta_optimizers``: dgc, lars, gradient merge, local
SGD).

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
                        lay_out_by_role, llama_param_role, placement_of)
from .distributed_strategy import DistributedStrategy
from .meta_optimizers import (DGCMomentum, GradientMergeOptimizer,
                              LocalSGDOptimizer)

__all__ = ["DGCMomentum", "DistributedStrategy", "Fleet",
           "LocalSGDOptimizer", "PaddleCloudRoleMaker", "Role",
           "UserDefinedRoleMaker", "UtilBase", "apply_group_sharding",
           "barrier_worker", "distributed_model", "distributed_optimizer",
           "fleet", "init", "is_first_worker", "shard_optimizer",
           "shutdown", "util", "worker_index", "worker_num"]

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
    """Lay ``model`` out for the installed mesh (``_lay_out_roles``): a
    MoE Llama's expert stacks along ``ep`` (dim 0, expert parallelism:
    each rank its experts, the gradients averaged over the data ranks
    only) and ``mp`` (each expert's FFN Megatron-parallel), a Llama's
    Megatron parts along ``mp``, and at ZeRO stage 3 all of them along
    ``sharding`` too by role; then ZeRO over ``sharding`` (stage from
    ``strategy.sharding_configs``, default 3) for every parameter left
    whole (stages 1 and 2 leave the state of parts split over ``ep`` and
    ``mp`` whole).  On a mesh with ``pp`` > 1 a ``PipelineLayer``
    comes back as ``PipelineParallel`` (the reference's
    ``fleet_base.py:1042``), which trains one stage a rank with the 1F1B
    schedule, with ``dp`` and with ``mp`` (its layers' Megatron parts);
    any other model there raises, as does a pipeline on a mesh with
    ``sharding``, ``sep`` or ``ep`` > 1."""
    mesh = get_mesh()
    if mesh is None:
        return model
    if mesh.shape.get("pp", 1) > 1:
        return _pipeline_model(model, mesh)
    hcg = fleet.hcg or get_hybrid_communicate_group()
    stage = 0
    if hcg is not None and hcg.get_sharding_parallel_world_size() > 1:
        stage = 3
        if fleet.strategy is not None:
            stage = int((fleet.strategy.sharding_configs or {}).get(
                "stage", 3))
    _lay_out_roles(model, mesh, stage)
    if stage:
        apply_group_sharding(model, mesh, stage=stage)
    cfg = getattr(model, "config", None)
    if cfg is not None and uses_sequence_parallel(cfg) and \
            mesh.shape.get("sp", 1) > 1:
        # each gradient is this rank's share of a sum over sp
        for p in model.parameters():
            p._sequence_sharded = True
    return model


def _pipeline_model(model, mesh):
    from ..pipeline import PipelineLayer, PipelineParallel

    if not isinstance(model, PipelineLayer):
        raise NotImplementedError(
            f"a {type(model).__name__} on a mesh with pp > 1: pipeline "
            "parallelism takes a PipelineLayer (each rank builds and runs "
            "its stage); a plain module would run whole on every pp rank")
    other = [a for a in ("sharding", "sp", "ep") if mesh.shape.get(a, 1) > 1]
    if other:
        raise NotImplementedError(
            f"pipeline parallelism with {other} > 1 on the same mesh is "
            "not ported (the last of ROADMAP item A3's smaller leftovers); "
            "compose pp with dp and mp")
    if model.num_stages != mesh.shape["pp"]:
        raise ValueError(f"a PipelineLayer of {model.num_stages} stages on "
                         f"a mesh of pp {mesh.shape['pp']}")
    return PipelineParallel(model, fleet.hcg or
                            get_hybrid_communicate_group(), fleet.strategy)


_EXPERT_ROLES = ("moe_expert_in", "moe_expert_out")


def _lay_out_roles(model, mesh, zero_stage=0):
    """``model``'s parameters laid out by their canonical Llama role
    (``sharding.lay_out_by_role``, the ``SpecLayout`` read with
    ``expert`` as ``ep``, ``tp`` as ``mp`` and ``fsdp`` as
    ``sharding``) along the mesh's ``ep`` and ``mp`` axes, and under
    ZeRO stage 3 (``zero_stage``) along ``sharding`` too: the expert
    stacks of any model (a MoE Llama's ``w_gate``/``w_up`` on ``(ep,
    sharding, mp)``, ``w_down`` on ``(ep, mp, sharding)``), and on an
    ``mp`` axis every parameter of a model that opts in
    (``canonical_layout``, a Llama's: column-parallel q/k/v and gate/up,
    row-parallel o/down, the vocab-parallel table and head, a tied
    table both).  A part split over ``sharding`` is a stage-3 part,
    gathered for each product (``parallel_layers.fsdp_gather``,
    ``moe.ExpertLayout.gather``), whose gradient the gather's backward
    averages over ``sharding``.  At stages 1 and 2 the parts split over
    ``mp`` or ``ep`` keep their state whole (ZeRO takes the parameters
    left whole).  Parameters already laid out keep their placement."""
    axes = tuple(a for a in ("ep", "mp") if mesh.shape.get(a, 1) > 1)
    keep = axes + (("sharding",) if zero_stage >= 3 else ())
    if not keep:
        return
    layout = SpecLayout(data_axis="dp", fsdp_axis="sharding", tp_axis="mp",
                        batch_axis="dp", expert_axis="ep")
    dense = "mp" in axes and getattr(model, "canonical_layout", False)
    for p in lay_out_by_role(model, mesh, layout, keep,
                             None if dense else _EXPERT_ROLES):
        if "sharding" in p.placement.axes:
            p._zero_stage, p._zero_placement = 3, p.placement


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
        it), rounded once.  A pipeline's parameters come averaged over
        ``dp`` from its schedule; under local SGD each rank keeps its
        own gradient (summed over ``sp`` alone)."""
        if getattr(p, "_pipeline_reduced", False):
            return
        if getattr(optimizer, "_local_sgd", False):
            axes = ()
            if getattr(p, "_sequence_sharded", False):
                collective.sum_rounded_once(p.grad, mesh.group("sp"))
                return
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
            swapped.append((p, placement_of(p), zpl))
            p.data = zpl.local(p.data)
            p.grad = g
            p.placement = zpl
        try:
            out = orig_step()
        finally:
            for p, prior, zpl in swapped:
                dim = zpl.dim_of("sharding")
                p.data = torch.cat(collective.all_gather(
                    None, p.data, group=zpl.group(dim)), dim=dim)
                p.grad = None
                if prior is None:
                    del p.placement
                else:
                    p.placement = prior
        return out

    optimizer.step = step
    return optimizer


def _swapped(optimizer, cls, **kwargs):
    """A ``cls`` over ``optimizer``'s parameters (their names kept),
    learning rate and clip."""
    new = cls(learning_rate=optimizer._learning_rate,
              momentum=optimizer._momentum,
              parameters=list(optimizer._parameter_list),
              grad_clip=optimizer._grad_clip, **kwargs)
    new._names = dict(optimizer._names)
    return new


def distributed_optimizer(optimizer, strategy=None):
    """The optimizer with the hybrid mesh's step (``shard_optimizer``):
    gradients averaged over the data ranks, ZeRO parts updated and
    gathered; then the strategy's meta-optimizers in the reference's
    order (``meta_optimizers``): ``dgc`` makes a ``Momentum`` a
    ``DGCMomentum`` (any other optimizer: a warning, and as it is),
    ``lars`` a plain ``Momentum`` a ``LarsMomentum`` with
    ``lars_configs``, ``gradient_merge`` wraps it, and ``localsgd``
    wraps outermost, its step skipping the gradients' mean over the
    data ranks and its syncs averaging the parameters over them.  Local
    SGD with ZeRO (``sharding``) or on a pipeline raises: both average
    over the data ranks inside the step."""
    import warnings

    from ...optimizer.optimizer import LarsMomentum, Momentum

    strategy = strategy or fleet.strategy
    on = (lambda flag: strategy is not None and
          bool(getattr(strategy, flag, False)))
    if on("dgc"):
        if isinstance(optimizer, Momentum) and \
                not isinstance(optimizer, DGCMomentum):
            optimizer = _swapped(
                optimizer, DGCMomentum,
                weight_decay=optimizer._weight_decay or None,
                use_nesterov=optimizer._use_nesterov,
                multi_precision=optimizer._multi_precision,
                **(strategy.dgc_configs or {}))
        elif not isinstance(optimizer, DGCMomentum):
            warnings.warn("strategy.dgc only applies to Momentum optimizers "
                          f"(got {type(optimizer).__name__}); ignored, as "
                          "the reference's DGCOptimizer ignores it")
    if on("lars"):
        if type(optimizer) is Momentum:
            optimizer = _swapped(optimizer, LarsMomentum,
                                 **(strategy.lars_configs or {}))
        elif not isinstance(optimizer, LarsMomentum):
            warnings.warn("strategy.lars only applies to Momentum optimizers "
                          f"(got {type(optimizer).__name__}); ignored, as "
                          "the reference's LarsOptimizer ignores it")
    mesh = get_mesh()
    if on("localsgd") and mesh is not None:
        busy = [a for a in ("sharding", "pp") if mesh.shape.get(a, 1) > 1]
        if busy:
            raise NotImplementedError(
                f"strategy.localsgd with {busy} > 1: ZeRO and the pipeline "
                "schedule average over the data ranks inside the step; "
                "local SGD there waits for the last of ROADMAP item A3's "
                "smaller leftovers")
        optimizer._local_sgd = True
    optimizer._is_distributed = True
    optimizer = shard_optimizer(optimizer)
    if on("gradient_merge"):
        cfg = strategy.gradient_merge_configs or {}
        optimizer = GradientMergeOptimizer(
            optimizer, k_steps=cfg.get("k_steps", 1), avg=cfg.get("avg", True))
    if on("localsgd"):
        axes = () if mesh is None else tuple(
            a for a in ("dp", "data") if mesh.shape.get(a, 1) > 1)
        optimizer = LocalSGDOptimizer(
            optimizer, **(strategy.localsgd_configs or {}),
            group=mesh.group(*axes) if axes else None)
    return optimizer


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
