"""Placements of tensors over a rank mesh (the port of
``paddle_tpu/distributed/sharding.py``).

The JAX package annotates GLOBAL arrays with ``PartitionSpec``s and lets
GSPMD move the bytes.  The port runs one process a rank, so a sharded
tensor here is an ordinary local tensor holding this rank's part, and
its :class:`Placement` (``tensor.placement``: the mesh and the spec)
says which part: dim i is split into one part a rank along the axes of
``spec[i]``, this rank's part taken at its coordinates (over several
axes of one entry, row-major in the mesh's axis order).  The kernels,
optimizers, ``convert`` and checkpoints take such tensors as they take
any other; what must see the whole tensor gathers it
(:meth:`Placement.gather`).

``SpecLayout``, ``llama_param_role`` and ``llama_param_specs`` are the
reference's canonical Llama layout, unchanged: column-parallel q/k/v
and gate/up and row-parallel o/down (the features on ``tp``, ``fsdp``
on the other dim), a vocab-parallel embedding and head, replicated
norms, the batch on ``data``.  ``lay_out_by_role`` makes a model's
parameters their parts under it (the executor's and fleet's layout).

``shard_tensor``/``mark_sharding``/``reshard`` take this rank's part of
a tensor every rank holds whole (every rank built it from one seeded
initialisation); ``group_sharded_parallel`` is ZeRO over the
``sharding`` axis (``fleet.apply_group_sharding``);
``save_group_sharded_model`` gathers, and rank 0 writes.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Dict, Optional, Sequence

import torch

from . import collective

__all__ = ["PartitionSpec", "Placement", "SpecLayout", "gather_full",
           "get_sharding_spec", "group_sharded_parallel", "lay_out_by_role",
           "llama_param_role", "llama_param_specs", "mark_sharding",
           "reshard",
           "save_group_sharded_model", "shard_op", "shard_tensor"]


class PartitionSpec(tuple):
    """One entry a dim: ``None`` (whole), an axis name, or a tuple of
    axis names (the reference's ``jax.sharding.PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


_LLAMA_ROLE_PATTERNS = (
    ("embed", ("embed_tokens.weight",)),
    ("lm_head", ("lm_head.weight",)),
    ("attn_qkv", ("q_proj.weight", "k_proj.weight", "v_proj.weight")),
    ("attn_out", ("o_proj.weight",)),
    ("mlp_in", ("gate_proj.weight", "up_proj.weight")),
    ("mlp_out", ("down_proj.weight",)),
    ("norm", ("layernorm.weight", "norm.weight")),
)

_MOE_ROLE_PATTERNS = (
    ("moe_router", ("router.weight",)),
    ("moe_expert_in", ("w_gate", "w_up")),
    ("moe_expert_out", ("w_down",)),
)


def llama_param_role(name: str) -> Optional[str]:
    """The layout role of a qualified Llama parameter name, or None."""
    for role, pats in _LLAMA_ROLE_PATTERNS + _MOE_ROLE_PATTERNS:
        if any(name.endswith(p) for p in pats):
            return role
    return None


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """Canonical specs per parameter role over named mesh axes (the
    reference's ``SpecLayout``; weights are [in, out])."""

    data_axis: str = "data"
    fsdp_axis: str = "fsdp"
    tp_axis: str = "tp"
    batch_axis: Optional[str] = "data"
    expert_axis: str = "expert"
    sp_axis: str = "sp"

    def batch_spec(self) -> PartitionSpec:
        if self.batch_axis is None:
            return PartitionSpec()
        return PartitionSpec(self.batch_axis)

    def sequence_spec(self) -> PartitionSpec:
        return PartitionSpec(self.batch_axis, self.sp_axis)

    def spec_for_role(self, role: str) -> PartitionSpec:
        table = {
            "embed": PartitionSpec(self.tp_axis, self.fsdp_axis),
            "lm_head": PartitionSpec(self.fsdp_axis, self.tp_axis),
            "attn_qkv": PartitionSpec(self.fsdp_axis, self.tp_axis),
            "attn_out": PartitionSpec(self.tp_axis, self.fsdp_axis),
            "mlp_in": PartitionSpec(self.fsdp_axis, self.tp_axis),
            "mlp_out": PartitionSpec(self.tp_axis, self.fsdp_axis),
            "norm": PartitionSpec(),
            "moe_router": PartitionSpec(),
            "moe_expert_in": PartitionSpec(
                self.expert_axis, self.fsdp_axis, self.tp_axis),
            "moe_expert_out": PartitionSpec(
                self.expert_axis, self.tp_axis, self.fsdp_axis),
        }
        if role not in table:
            raise KeyError(f"unknown param role {role!r}; known roles: "
                           f"{sorted(table)}")
        return table[role]

    def param_spec(self, name: str) -> PartitionSpec:
        """Unmatched names (and biases) replicate."""
        role = llama_param_role(name)
        if role is None:
            return PartitionSpec()
        return self.spec_for_role(role)

    def role_layout(self, moe: bool = False) -> Dict[str, PartitionSpec]:
        roles = _LLAMA_ROLE_PATTERNS + (_MOE_ROLE_PATTERNS if moe else ())
        return {role: self.spec_for_role(role) for role, _ in roles}


def llama_param_specs(model) -> Dict[str, PartitionSpec]:
    layout = SpecLayout()
    return {name: layout.param_spec(name)
            for name, _ in model.named_parameters()}


class Placement:
    """Where this rank's part of a tensor of ``full_shape`` lies:
    ``spec`` (cleaned to ``mesh``: axes it lacks and splits that do not
    divide the dim dropped, one entry a dim) over ``mesh``."""

    def __init__(self, mesh, spec, full_shape: Sequence[int]):
        self.mesh = mesh
        self.full_shape = tuple(int(s) for s in full_shape)
        entries = list(spec or ())[:len(self.full_shape)]
        entries += [None] * (len(self.full_shape) - len(entries))
        clean = []
        for dim, entry in zip(self.full_shape, entries):
            axes = tuple(a for a in mesh.axis_names
                         if a in _entry_axes(entry))
            if len(axes) != len(_entry_axes(entry)):
                axes = ()
            n = 1
            for a in axes:
                n *= mesh.shape[a]
            clean.append(axes if axes and n > 1 and dim % n == 0 else ())
        self.dims = tuple(clean)

    @property
    def spec(self) -> PartitionSpec:
        out = [None if not a else (a[0] if len(a) == 1 else a)
               for a in self.dims]
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)

    @property
    def replicated(self) -> bool:
        return not any(self.dims)

    @property
    def axes(self) -> tuple:
        """Every axis some dim is split over, in mesh order."""
        used = {a for d in self.dims for a in d}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def parts(self, dim) -> int:
        n = 1
        for a in self.dims[dim]:
            n *= self.mesh.shape[a]
        return n

    def index(self, dim) -> int:
        """This rank's part along ``dim``."""
        i = 0
        for a in self.dims[dim]:
            i = i * self.mesh.shape[a] + self.mesh.axis_rank(a)
        return i

    def group(self, dim) -> "collective.Group":
        return self.mesh.group(*self.dims[dim])

    @property
    def local_shape(self):
        return tuple(s // self.parts(d)
                     for d, s in enumerate(self.full_shape))

    @property
    def bounds(self) -> tuple:
        """This rank's part as ``(start, stop)`` a dim of the whole."""
        out = []
        for d, s in enumerate(self.full_shape):
            n = s // self.parts(d)
            out.append((self.index(d) * n, (self.index(d) + 1) * n))
        return tuple(out)

    @property
    def writer(self) -> bool:
        """Whether this rank is the lowest of the ranks holding its part
        (its coordinates 0 on every axis no dim is split over): the one
        that writes the part to a sharded checkpoint."""
        return all(self.mesh.axis_rank(a) == 0 for a in self.mesh.axis_names
                   if a not in self.axes)

    def dim_of(self, axis) -> Optional[int]:
        return next((d for d, a in enumerate(self.dims) if axis in a), None)

    def local(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's part of ``full`` (a copy, contiguous)."""
        out = full
        for d in range(len(self.dims)):
            n = self.parts(d)
            if n > 1:
                size = full.shape[d] // n
                out = out.narrow(d, self.index(d) * size, size)
        return out.clone(memory_format=torch.contiguous_format)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's part (a collective of the
        groups along the split dims)."""
        out = local
        for d in range(len(self.dims)):
            if self.parts(d) > 1:
                parts = collective.all_gather(None, out.contiguous(),
                                              group=self.group(d))
                out = torch.cat(parts, dim=d)
        return out

    def gather_to_rank0(self, local: torch.Tensor):
        """The whole tensor on global rank 0, None on every other rank,
        gathered in host memory under gloo (on the card under NCCL): a
        checkpoint's gathers take no device memory.  Only the ranks of
        the copy rank 0 assembles (their coordinates off the split axes
        all 0) take part."""
        from .env import get_rank

        if self.replicated:
            return local
        if any(self.mesh.axis_rank(a) for a in self.mesh.axis_names
               if a not in self.axes):
            return None
        full = self.gather(local.detach().to(collective.comm_device(
            self.mesh.group())))
        return full if get_rank() == 0 else None

    def __repr__(self):
        return f"Placement({self.spec}, {self.mesh})"


def placement_of(t) -> Optional[Placement]:
    return getattr(t, "placement", None)


def lay_out_by_role(model, mesh, layout: SpecLayout, keep_axes=None,
                    roles=None) -> list:
    """Make ``model``'s parameters this rank's parts on ``mesh``, in
    place (the same ``nn.Parameter``s, so optimizers keep them), each
    under its role's spec in ``layout`` (``param_spec``: no role, whole)
    and carrying its ``placement``: only the spec's entries whose axes
    are all in ``keep_axes`` (default: every axis) split, and only the
    parameters whose role is in ``roles`` (default: every parameter)
    laid out.  A parameter already laid out on ``mesh`` keeps its
    placement (a whole value loaded into it is cut back to its part).
    Returns the parameters laid out."""
    out = []
    for name, p in model.named_parameters():
        if roles is not None and llama_param_role(name) not in roles:
            continue
        pl = placement_of(p)
        if pl is not None and pl.mesh is mesh:
            if tuple(p.shape) == pl.full_shape != pl.local_shape:
                p.data = pl.local(p.data)
            continue
        spec = layout.param_spec(name)
        if keep_axes is not None:
            spec = PartitionSpec(*[
                e if set(_entry_axes(e)) <= set(keep_axes) else None
                for e in spec])
        pl = Placement(mesh, spec, p.shape)
        if not pl.replicated:
            p.data = pl.local(p.data)
        p.placement = pl
        out.append(p)
    return out


def gather_full(t: torch.Tensor) -> torch.Tensor:
    """The whole of ``t`` (``t`` itself when it has no placement)."""
    pl = placement_of(t)
    return t if pl is None or pl.replicated else pl.gather(t)


def get_sharding_spec(t) -> Optional[PartitionSpec]:
    pl = placement_of(t)
    return None if pl is None else pl.spec


def _context_mesh(mesh=None):
    if hasattr(mesh, "to_mesh"):
        return mesh.to_mesh()
    if mesh is not None:
        return mesh
    from .mesh import _active_mesh

    return _active_mesh()


_warned_dangling: set = set()


def _known(spec, mesh) -> bool:
    missing = tuple(sorted({a for e in spec for a in _entry_axes(e)
                            if a not in mesh.shape}))
    if missing and (missing, mesh.axis_names) not in _warned_dangling:
        _warned_dangling.add((missing, mesh.axis_names))
        warnings.warn(
            f"sharding spec {spec} names mesh axes {list(missing)} unknown "
            f"on the active mesh (axes {list(mesh.axis_names)}); the "
            "annotation is a no-op", RuntimeWarning, stacklevel=3)
    return not missing


def _pspec(placements) -> PartitionSpec:
    if placements is None:
        return PartitionSpec()
    return placements if isinstance(placements, PartitionSpec) \
        else PartitionSpec(*placements)


def shard_tensor(x: torch.Tensor, mesh=None, placements=None,
                 dist_attr=None) -> torch.Tensor:
    """This rank's part of ``x`` (which every rank holds whole) under
    ``placements`` over ``mesh`` (default: the installed mesh, else the
    executor's), as a new tensor carrying its placement; ``x`` itself
    without a mesh, or (with one warning) when the spec names axes the
    mesh lacks."""
    spec = _pspec(placements)
    mesh = _context_mesh(mesh)
    if mesh is None or not _known(spec, mesh):
        return x
    pl = Placement(mesh, spec, x.shape)
    out = pl.local(x)
    out.placement = pl
    return out


def mark_sharding(param, placements, mesh=None):
    """Lay ``param`` out in place: its data becomes this rank's part,
    and it carries the placement."""
    spec = _pspec(placements)
    mesh = _context_mesh(mesh)
    if mesh is None or not _known(spec, mesh):
        return param
    full = gather_full(param) if placement_of(param) is not None \
        else param.data
    pl = Placement(mesh, spec, full.shape)
    param.data = pl.local(full)
    param.placement = pl
    return param


def reshard(x: torch.Tensor, mesh=None, placements=None) -> torch.Tensor:
    """``x`` under another placement: gathered whole, then this rank's
    part taken."""
    return shard_tensor(gather_full(x), mesh, placements)


def shard_op(op_fn, mesh=None, in_placements=None, out_placements=None):
    """``op_fn`` with its tensor inputs and output laid out by the given
    placements."""

    def wrapped(*args, **kwargs):
        if in_placements is not None:
            args = tuple(
                shard_tensor(a, mesh, p) if isinstance(a, torch.Tensor)
                and p is not None else a
                for a, p in zip(args, in_placements))
        out = op_fn(*args, **kwargs)
        if out_placements is not None and isinstance(out, torch.Tensor):
            out = shard_tensor(out, mesh, out_placements)
        return out

    return wrapped


_GSP_LEVELS = {"os": 1, "os_g": 2, "p_g_os": 3}


def group_sharded_parallel(model, optimizer, level, scaler=None, group=None,
                           offload=False, sync_buffers=False,
                           buffer_max_size=2 ** 23, segment_size=2 ** 20,
                           sync_comm=False):
    """ZeRO over the ``sharding`` axis (the reference's
    ``group_sharded_parallel``): level ``os`` shards the optimizer's
    state, ``os_g`` the gradients too, ``p_g_os`` the parameters too
    (``fleet.apply_group_sharding``).  Without a mesh, one of
    ``{"sharding": world}`` is made; a mesh without a ``sharding`` axis
    raises.  ``offload=True`` raises, as in the reference; the buffer
    and overlap arguments are taken and unused."""
    if level not in _GSP_LEVELS:
        raise ValueError(
            f"level must be one of {sorted(_GSP_LEVELS)}, got {level!r}")
    if offload:
        raise NotImplementedError(
            "offload=True (CPU parameter offload) is not supported; use "
            "recompute or a higher sharding degree instead")
    from .fleet import apply_group_sharding, shard_optimizer
    from .env import get_world_size
    from .mesh import get_mesh, init_mesh

    mesh = get_mesh()
    if mesh is not None and "sharding" not in mesh.shape:
        raise ValueError(
            f"the installed mesh {mesh.shape} has no 'sharding' axis; build "
            "one with it (fleet.init with sharding_degree > 1, or "
            "init_mesh({'dp': ..., 'sharding': ...})) first")
    if mesh is None:
        n = get_world_size()
        if group is not None and group.nranks != n:
            raise ValueError(
                f"group.nranks={group.nranks} != world size {n}: subgroup "
                "sharding needs a hybrid mesh (fleet.init with "
                "sharding_degree)")
        mesh = init_mesh({"sharding": n})
    apply_group_sharding(model, mesh, stage=_GSP_LEVELS[level])
    if optimizer is not None:
        optimizer = shard_optimizer(optimizer, model, mesh)
    return model, optimizer, scaler


def save_group_sharded_model(model, output, optimizer=None):
    """Gather the model's (and the optimizer's) state whole and, on rank
    0, save it as ``output/model.pdparams`` (``model.pdopt``); every
    rank takes part in the gathers."""
    from ..framework.io import save
    from .env import get_rank

    state = {k: gather_full(v) for k, v in
             model.state_dict(keep_vars=True).items()}
    opt_state = optimizer.state_dict() if optimizer is not None else None
    if get_rank() == 0:
        os.makedirs(output, exist_ok=True)
        save({k: v.detach() for k, v in state.items()},
             os.path.join(output, "model.pdparams"))
        if opt_state is not None:
            save(opt_state, os.path.join(output, "model.pdopt"))
