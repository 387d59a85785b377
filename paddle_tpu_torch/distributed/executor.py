"""The training half of the mesh executor (the port of
``paddle_tpu/distributed/executor.py``).

``MeshExecutor({"data": 2, "fsdp": 2, "tp": 2})`` lays a model out over a
mesh of ranks, one process a rank, as the reference's executor lays it
out over a mesh of devices:

- ``install(model)`` (``hapi.Model(mesh=...)`` calls it) makes each
  parameter this rank's part under the canonical ``SpecLayout`` (every
  rank built the whole model from one seeded initialisation; the parts
  are sliced from it), and the optimizer's slots follow their
  parameter's part (ZeRO: the update runs at the part's shape);
- ``shard_batch`` keeps this rank's rows of a global batch (the batch is
  split along ``data`` only, as the reference's ``batch_spec``);
- ``reduce_gradients`` averages each gradient over ``data`` (the other
  axes computed on the same rows, so their gradients need no sum: the
  parallel layers' collectives already made them whole);
- a model that splits its sequence over ``sp`` (a Llama with
  ``context_parallel`` or ``sequence_parallel`` on a mesh with an
  ``sp`` axis of more than one rank, ``sequence_sharded``) gets each
  [B, T, ...] batch leaf cut along the sequence too (``sequence_spec``:
  batch on ``data``, sequence on ``sp``; inputs and labels alike, the
  model carrying the labels across the boundaries); a rank's loss is
  then its share of the global mean (``loss_share`` makes an outside
  loss, a mean over the rank's tokens, one), so the gradients are
  SUMMED over ``sp`` and averaged over ``data``, rounded once, and the
  loss reported is the shares' sum averaged over ``data``.  A mesh with
  ``sp`` and a model with neither option stays replicated over ``sp``,
  as in the JAX package;
- ``host_state``/``scatter_state`` make a host copy of this rank's parts
  of a state tree and put a tree's parts back into this rank's
  parameters and slots, with no collective (the sharded checkpoint,
  format 2); ``gathered_state`` gathers a tree whole on rank 0 and
  ``scatter_from_rank0`` puts rank 0's tree back into every rank's parts
  (the one-file ``Model.save`` / ``load``).

The mesh's size must equal the world's.  A world of one given a larger
mesh degrades to a mesh of ones, with the reference's warning, and
``degraded`` set; any other mismatch raises.  ``install_serving`` waits
for ROADMAP item A3's serving on a mesh; ``reconcile_train`` and
``reconcile_serving`` read jaxprs in the reference and wait for item
A5's shard-plan analysis.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional

import numpy as np
import torch

from . import collective
from .env import get_rank, get_world_size
from .mesh import Mesh
from .sequence_parallel import uses_sequence_parallel
from .sharding import (PartitionSpec, Placement, SpecLayout, _entry_axes,
                       lay_out_by_role, placement_of)

__all__ = ["MeshExecutor", "active_mesh", "active_mesh_axes", "as_executor",
           "current_executor", "default_shardplan_mesh"]

_ACTIVE: Optional["MeshExecutor"] = None


def current_executor() -> Optional["MeshExecutor"]:
    return _ACTIVE


def active_mesh() -> Optional[Mesh]:
    return _ACTIVE.mesh if _ACTIVE is not None else None


def active_mesh_axes() -> Optional[Dict[str, int]]:
    return dict(_ACTIVE.axes) if _ACTIVE is not None else None


def default_shardplan_mesh() -> Optional[Dict[str, int]]:
    return active_mesh_axes()


def as_executor(mesh) -> "MeshExecutor":
    """An ``{axis: size}`` dict, a :class:`Mesh` or a ``MeshExecutor`` as
    a ``MeshExecutor``."""
    if isinstance(mesh, MeshExecutor):
        return mesh
    if isinstance(mesh, Mesh):
        return MeshExecutor(dict(mesh.shape), devices=mesh.ranks)
    if isinstance(mesh, dict):
        return MeshExecutor(mesh)
    raise TypeError(f"mesh must be an axis dict, a Mesh or a MeshExecutor, "
                    f"got {type(mesh).__name__}")


_SERVING = ("serving on a mesh (the KV pool's heads on tp, NCCL "
            "collectives inside the serving steps' CUDA graphs) waits for "
            "ROADMAP item A3's serving item")
_RECONCILE = ("the reference reconciles compiled programs against the "
              "static shard plan by reading jaxprs; that waits for ROADMAP "
              "item A5's shard-plan analysis")


class MeshExecutor:
    """Lays a model's state out over a mesh of ranks and keeps the
    training step's collectives consistent with that layout.

    ``axes``: ``{name: size}`` in mesh-major order.  ``layout``: the
    ``SpecLayout`` of parameter roles (default the canonical Llama
    one).  ``devices``: the mesh's global ranks (default every rank).
    ``register``: make this the process's executor, which the sharding
    helpers and the parallel layers fall back to."""

    def __init__(self, axes: Dict[str, int], *, layout: SpecLayout = None,
                 devices=None, register: bool = True):
        names = list(axes)
        sizes = [int(axes[k]) for k in names]
        if not names or any(s < 1 for s in sizes):
            raise ValueError(f"invalid mesh axes {axes!r}")
        ranks = list(devices) if devices is not None \
            else list(range(get_world_size()))
        need = int(np.prod(sizes))
        self.degraded = False
        if need != len(ranks):
            if len(ranks) != 1:
                raise ValueError(f"mesh {dict(axes)} needs {need} ranks, "
                                 f"the world has {len(ranks)}")
            warnings.warn(
                f"mesh {dict(zip(names, sizes))} needs {need} ranks but the "
                f"world has 1; degrading to a single-rank "
                f"{dict.fromkeys(names, 1)} mesh")
            sizes = [1] * len(names)
            self.degraded = True
        self.mesh = Mesh(dict(zip(names, sizes)), ranks)
        self.axes: Dict[str, int] = dict(zip(names, sizes))
        self.layout = layout if layout is not None else SpecLayout()
        self.sequence_sharded = False
        if register:
            global _ACTIVE
            _ACTIVE = self
        self._export_gauges()

    # ----------------------------------------------------- layout primitives
    def clean_spec(self, spec, shape=None) -> PartitionSpec:
        """``spec`` restricted to this mesh: entries naming absent axes,
        and (given ``shape``) splits that do not divide their dim,
        dropped (the reference's ``clean_spec``)."""
        out = []
        for dim, entry in enumerate(list(spec or ())):
            axes = _entry_axes(entry)
            n = int(np.prod([self.mesh.shape.get(a, 0) for a in axes])) \
                if axes else 0
            if not axes or any(a not in self.mesh.shape for a in axes) or (
                    shape is not None and (dim >= len(shape)
                                           or int(shape[dim]) % n)):
                out.append(None)
            else:
                out.append(entry if len(axes) == 1 else tuple(axes))
        if shape is not None:
            out = out[:len(shape)]
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    def placement(self, spec, shape) -> Placement:
        return Placement(self.mesh, self.clean_spec(spec, shape), shape)

    def shard_shape(self, shape, spec):
        """This rank's part's shape of ``shape`` under ``spec``."""
        return self.placement(spec, shape).local_shape

    def put(self, value, spec=None, shape=None):
        """This rank's part of ``value`` (every rank holds it whole) as a
        tensor carrying its placement."""
        t = value if isinstance(value, torch.Tensor) \
            else torch.as_tensor(np.asarray(value))
        pl = self.placement(spec, tuple(t.shape) if shape is None else shape)
        out = pl.local(t)
        out.placement = pl
        return out

    def fetch(self, value) -> np.ndarray:
        """The whole of ``value`` on the host (a collective of the ranks
        holding its parts)."""
        pl = placement_of(value)
        if pl is not None and not pl.replicated:
            value = pl.gather(value)
        return _numpy(value)

    # --------------------------------------------------------- state layout
    def _check_model(self, net):
        cfg = getattr(net, "config", None)
        if cfg is None:
            return
        if getattr(cfg, "moe_num_experts", 0) > 0 and \
                self._splits_sequence(cfg):
            raise NotImplementedError(
                "a mixture-of-experts model with its sequence split over "
                "sp (capacity over the global tokens) is not ported; it "
                "waits for the last of ROADMAP item A3's smaller leftovers")

    def _splits_sequence(self, cfg) -> bool:
        return uses_sequence_parallel(cfg) and \
            self.mesh.axis_size(self.layout.sp_axis) > 1

    def shard_params(self, layer) -> int:
        """Make every parameter this rank's part under its role's spec
        (``sharding.lay_out_by_role``); returns the count laid out.  A
        parameter already laid out on this mesh is left alone."""
        return len(lay_out_by_role(layer, self.mesh, self.layout))

    def install_optimizer(self, opt) -> None:
        opt._mesh_executor = self
        self.reshard_optimizer(opt)

    def reshard_optimizer(self, opt) -> None:
        """Slots made before the layout (or loaded whole) become their
        parameter's part."""
        opt._reshard_slots()

    def install(self, model) -> "MeshExecutor":
        """Lay a ``hapi.Model`` (or a bare network) out on the mesh: its
        parameters and its optimizer's slots."""
        net = getattr(model, "network", model)
        self._check_model(net)
        cfg = getattr(net, "config", None)
        self.sequence_sharded = cfg is not None and self._splits_sequence(cfg)
        self.shard_params(net)
        opt = getattr(model, "_optimizer", None)
        if opt is not None:
            self.install_optimizer(opt)
        model._mesh_executor = self
        net._mesh_executor = self
        return self

    def reshard(self, network, optimizer=None) -> None:
        """Re-lay-out after a load that wrote whole tensors."""
        self.shard_params(network)
        if optimizer is not None:
            self.reshard_optimizer(optimizer)

    def shard_batch(self, values):
        """This rank's rows (dim 0 split along the layout's batch axis)
        of each batch leaf, and of a ``sequence_sharded`` model's [B, T,
        ...] leaves its positions too (dim 1 along ``sp``); other leaves
        as they are."""
        batch = self.layout.batch_spec()
        out = []
        for v in values:
            if isinstance(v, torch.Tensor) or isinstance(v, np.ndarray):
                t = torch.as_tensor(v)
                seq = self.sequence_sharded and t.dim() >= 2
                spec = self.layout.sequence_spec() if seq else batch
                pl = self.placement(spec, tuple(t.shape))
                if pl.parts(0) == 1 and self.mesh.axis_size(
                        self.layout.batch_axis or "") > 1:
                    raise ValueError(
                        f"a batch of {t.shape[0]} rows does not split over "
                        f"{self.mesh.axis_size(self.layout.batch_axis)} "
                        "data ranks")
                if seq and pl.parts(1) == 1:
                    raise ValueError(
                        f"a sequence of {t.shape[1]} positions does not "
                        f"split over "
                        f"{self.mesh.axis_size(self.layout.sp_axis)} sp "
                        "ranks")
                out.append(pl.local(t) if isinstance(v, torch.Tensor)
                           else pl.local(t).numpy())
            else:
                out.append(v)
        return out

    def data_group(self) -> collective.Group:
        axis = self.layout.batch_axis
        if axis is None or axis not in self.mesh.shape:
            return collective.Group([get_rank()])
        return self.mesh.group(axis)

    def sequence_reduction(self):
        """``(group, divisor)`` of a ``sequence_sharded`` model's
        reductions: the group of the data and ``sp`` axes and the data
        ranks' count (a sum over ``sp``, a mean over ``data``); None
        otherwise."""
        if not self.sequence_sharded:
            return None
        axes = [a for a in (self.layout.batch_axis, self.layout.sp_axis)
                if a is not None and a in self.mesh.shape]
        return self.mesh.group(*axes), self.data_group().nranks

    def loss_share(self, loss):
        """A loss computed on this rank's part of the batch as a mean
        over its tokens, made its share of the global mean: divided by
        the ``sp`` ranks when the model splits its sequence over them
        (equal parts), as it is otherwise."""
        if not self.sequence_sharded:
            return loss
        return loss / self.mesh.axis_size(self.layout.sp_axis)

    @torch.no_grad()
    def reduce_gradients(self, network) -> None:
        """Average every gradient over the data group, in parameter
        order (every rank walks the same order), each rounded once to
        its dtype (``collective.mean_rounded_once``); a
        ``sequence_sharded`` model's summed over ``sp`` as well
        (:meth:`sequence_reduction`)."""
        g = self.data_group()
        sp = self.sequence_reduction()
        for p in network.parameters():
            if p.grad is not None:
                if sp is not None:
                    collective.sum_divided_rounded_once(p.grad, *sp)
                else:
                    collective.mean_rounded_once(p.grad, g)

    def mean_over_data(self, value: float) -> float:
        """A per-rank scalar (a loss) averaged over the data group; the
        shares of a ``sequence_sharded`` model summed over ``sp`` first
        (the global loss)."""
        g, div = self.sequence_reduction() or (self.data_group(), None)
        if g.nranks == 1:
            return float(value)
        t = torch.tensor([float(value)], dtype=torch.float64,
                         device=collective.comm_device(g))
        if div is None:
            collective.all_reduce(t, collective.ReduceOp.AVG, g)
        else:
            collective.all_reduce(t, group=g)
            t /= div
        return float(t[0])

    # ----------------------------------------------------- checkpoints
    def host_state(self, tree):
        """A host copy of this rank's part of a state tree: each tensor
        split on the mesh (by its ``placement``) a
        ``resilience.checkpoint.ShardedHostLeaf`` of its part, its
        bounds in the whole and whether this rank writes it; every
        other tensor whole.  No collective: a sharded checkpoint writes
        each part from the rank that holds it (format 2)."""
        from ..framework.io import to_host
        from ..resilience.checkpoint import ShardedHostLeaf

        def walk(v):
            if isinstance(v, torch.Tensor):
                pl = placement_of(v)
                if pl is not None and not pl.replicated:
                    return ShardedHostLeaf.from_part(v, pl)
                return to_host(v)
            if isinstance(v, dict):
                return {k: walk(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                out = [walk(x) for x in v]
                return out if isinstance(v, list) else tuple(out)
            return v

        return walk(tree)

    def optimizer_host_state(self, optimizer):
        """A host copy of this rank's part of ``optimizer``'s state, in
        the layout of ``Optimizer.state_dict``: each slot split on the
        mesh (by ``Optimizer._slot_placement``) a ``ShardedHostLeaf`` of
        its part, every other slot whole.  No collective (format 2)."""
        from ..framework.io import to_host
        from ..resilience.checkpoint import ShardedHostLeaf

        params = optimizer._parameter_list
        index = {id(p): i for i, p in enumerate(params)}
        state = {}
        for name, store in optimizer._accumulators.items():
            for pid, acc in store.items():
                pl = optimizer._slot_placement(params[index[pid]]) \
                    if pid in index else None
                acc = acc.detach()
                state[f"{name}_{index.get(pid, pid)}"] = \
                    ShardedHostLeaf.from_part(acc, pl) \
                    if pl is not None and not pl.replicated else to_host(acc)
        state.update(optimizer._step_state())
        return state

    def gathered_state(self, tree):
        """A host copy of a state tree, its split tensors gathered whole
        on rank 0 (None elsewhere; every rank calls it): the one-file
        ``Model.save`` format."""
        from ..framework.io import to_host

        def walk(v):
            if isinstance(v, torch.Tensor):
                pl = placement_of(v)
                full = v if pl is None else pl.gather_to_rank0(v)
                return None if full is None else to_host(full)
            if isinstance(v, dict):
                return {k: walk(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                out = [walk(x) for x in v]
                return out if isinstance(v, list) else tuple(out)
            return v

        return walk(tree)

    def scatter_state(self, state, network=None, optimizer=None):
        """This rank's parts of a state tree that every rank holds (a
        ``collect_state`` tree, or one restored from a checkpoint of
        either format): each leaf under a parameter's placement
        (``model`` by name, ``optimizer`` slots by index) cut to this
        rank's part: a format-2 ``StoredLeaf`` reads only that region
        from its shards, a ``ShardedHostLeaf`` (an in-memory snapshot)
        gives its own part, a whole array is sliced.  Every other leaf
        is taken whole.  No collective."""
        from ..resilience.checkpoint import (ShardedHostLeaf, StoredLeaf,
                                             _cut)

        placement_for = self._placements(network, optimizer)

        def part(value, pl):
            split = pl is not None and not pl.replicated
            if isinstance(value, ShardedHostLeaf):
                return value.local(pl.bounds if split else None)
            if isinstance(value, StoredLeaf):
                return value.region(pl.bounds) if split and \
                    value.shape == pl.full_shape else value.assemble()
            if split and value is not None and \
                    tuple(np.shape(getattr(value, "array", value))) == \
                    pl.full_shape:
                if isinstance(value, torch.Tensor):
                    return pl.local(value)
                return _cut(value, pl.bounds)
            return value

        def walk(value, path):
            if isinstance(value, dict):
                return {k: walk(v, path + (k,)) for k, v in value.items()}
            if isinstance(value, (list, tuple)):
                out = [walk(v, path + (i,)) for i, v in enumerate(value)]
                return out if isinstance(value, list) else tuple(out)
            return part(value, placement_for(path))

        return walk(state, ())

    def scatter_from_rank0(self, state, network=None, optimizer=None):
        """Rank 0's host ``state`` (the tree of one-file
        ``Model.save`` files, which rank 0 alone reads) as every rank's
        parts: its structure broadcast, each tensor leaf under a
        placement (as in :meth:`scatter_state`) scattered to the ranks
        holding each part, every other leaf broadcast.  Every rank
        calls it; only rank 0's ``state`` is read, so one host copy of
        the whole exists."""
        from ..framework.io import to_tensor

        root = get_rank() == 0
        skeleton = [_skeleton(state) if root else None]
        collective.broadcast_object_list(skeleton, 0)
        skeleton = skeleton[0]
        placement_for = self._placements(network, optimizer)

        def walk(skel, value, path):
            if isinstance(skel, _Leaf):
                full = to_tensor(value) if root else None
                return _scatter_leaf(skel, full, placement_for(path))
            if isinstance(skel, dict):
                return {k: walk(s, value[k] if root else None, path + (k,))
                        for k, s in skel.items()}
            if isinstance(skel, (list, tuple)):
                out = [walk(s, value[i] if root else None, path + (i,))
                       for i, s in enumerate(skel)]
                return out if isinstance(skel, list) else tuple(out)
            return skel

        return walk(skeleton, state, ())

    @staticmethod
    def _placements(network, optimizer):
        """path -> the placement of the parameter (``model`` by name) or
        slot (``optimizer`` by index) a state tree's leaf restores."""
        by_name = dict(network.named_parameters()) if network is not None \
            else {}
        params = optimizer._parameter_list if optimizer is not None else []

        def placement_for(path):
            if len(path) == 2 and path[0] == "model":
                return placement_of(by_name.get(path[1]))
            if len(path) == 2 and path[0] == "optimizer":
                _, _, idx = str(path[1]).rpartition("_")
                if idx.isdigit() and int(idx) < len(params):
                    return optimizer._slot_placement(params[int(idx)])
            return None

        return placement_for

    # -------------------------------------------------------------- serving
    def install_serving(self, model, pool):
        raise NotImplementedError(_SERVING)

    def reconcile_train(self, *args, **kwargs):
        raise NotImplementedError(_RECONCILE)

    def reconcile_serving(self, *args, **kwargs):
        raise NotImplementedError(_RECONCILE)

    # -------------------------------------------------------- observability
    def _export_gauges(self) -> None:
        from .. import observability

        if not observability.enabled():
            return
        reg = observability.get_registry()
        reg.gauge("mesh_num_devices",
                  "devices in the executor's mesh").set(self.mesh.size)
        g = reg.gauge("mesh_axis_sizes",
                      "per-axis size of the executor's mesh")
        for ax, sz in self.axes.items():
            g.set(int(sz), axis=ax)
        reg.gauge("mesh_process_span",
                  "distinct processes owning this mesh's devices").set(
            self.mesh.size)

    def close(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def __enter__(self) -> "MeshExecutor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        return f"MeshExecutor({self.axes}, degraded={self.degraded})"


class _Leaf:
    """A tensor leaf of a broadcast state skeleton: shape and dtype."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = tuple(shape)
        self.dtype = dtype


def _skeleton(tree):
    from ..framework.io import to_tensor

    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_skeleton(v) for v in tree]
        return out if isinstance(tree, list) else tuple(out)
    if isinstance(tree, (np.ndarray, torch.Tensor)) or \
            type(tree).__name__ == "TensorPayload":
        t = to_tensor(tree)
        return _Leaf(t.shape, str(t.dtype).replace("torch.", ""))
    return tree


def _scatter_leaf(leaf: _Leaf, full, pl: Optional[Placement]):
    """This rank's part of rank 0's host tensor ``full`` (a CPU tensor on
    rank 0, None elsewhere); on the CPU for gloo, on this rank's card
    for NCCL."""
    dtype = getattr(torch, leaf.dtype)
    world = collective.world_group()
    dev = collective.comm_device(world)
    if full is not None:
        full = full.to(dev)
    if pl is None or pl.replicated or pl.full_shape != leaf.shape:
        out = full.clone() if full is not None else \
            torch.empty(leaf.shape, dtype=dtype, device=dev)
        return collective.broadcast(out, 0)
    out = torch.empty(pl.local_shape, dtype=dtype, device=dev)
    parts = None
    if full is not None:
        mesh = pl.mesh
        parts = []
        for r in world.ranks:
            coord = np.argwhere(mesh.rank_array == r)[0]
            at = dict(zip(mesh.axis_names, (int(c) for c in coord)))
            parts.append(_part_at(full, pl, at))
    return collective.scatter(out, parts, 0, world)


def _part_at(full, pl: Placement, coord):
    """The part of ``full`` the rank at mesh coordinates ``coord``
    holds."""
    out = full
    for d, axes in enumerate(pl.dims):
        n = pl.parts(d)
        if n == 1:
            continue
        i = 0
        for a in axes:
            i = i * pl.mesh.shape[a] + coord[a]
        size = full.shape[d] // n
        out = out.narrow(d, i * size, size)
    return out.contiguous()


def _numpy(t):
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
