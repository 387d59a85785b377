"""Rank meshes and the hybrid topology (the port of
``paddle_tpu/distributed/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` of devices, driven by
one process, and its per-axis "groups" are views of the mesh.  The port
runs one process a rank, so a :class:`Mesh` names axes over the world's
ranks (rank-major: ``ranks.reshape(sizes)``, the last axis varying
fastest, as the reference lays devices out) and holds real process
groups: one for every set of its axes, along which ranks differ while
the other axes stay put, all built once when the mesh is made (every
rank makes them, in one order, as ``torch.distributed`` asks).
``mesh.group("tp")`` is this rank's tensor-parallel group,
``mesh.group("fsdp", "tp")`` the ranks holding one replica of the
sharded parameters.

``init_mesh``/``fleet_mesh`` make and install the process's mesh;
``HybridCommunicateGroup`` reads degrees, this rank's coordinates and
groups from it.  Where the reference's single controller is rank 0 of
every axis, each rank here reads its own coordinate.
"""
from __future__ import annotations

import contextlib
import itertools
from typing import Dict, Optional, Sequence

import numpy as np

from . import collective
from .env import get_rank, get_world_size

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "Mesh",
           "ProcessMesh", "data_group", "fleet_mesh", "get_mesh",
           "get_hybrid_communicate_group", "init_mesh", "model_axis",
           "reset_mesh", "sequence_group", "set_mesh", "use_mesh"]

_GLOBAL_MESH: Optional["Mesh"] = None
_GLOBAL_HCG: Optional["HybridCommunicateGroup"] = None

#: the names each role's axis goes by: fleet's meshes (dp, sharding,
#: mp, ...) and the executor's layout (data, fsdp, tp)
AXIS_ALIASES = {"dp": ("dp", "data"), "mp": ("mp", "tp"),
                "sharding": ("sharding", "fsdp"), "pp": ("pp",),
                "sp": ("sp",), "ep": ("ep", "expert")}


class Mesh:
    """Named axes ``{name: size}`` over ``ranks`` (default every rank of
    the world), whose sizes multiply to the rank count."""

    def __init__(self, axes: Dict[str, int], ranks: Sequence[int] = None):
        names = [str(k) for k in axes]
        sizes = [int(v) for v in axes.values()]
        if not names or any(s < 1 for s in sizes):
            raise ValueError(f"invalid mesh axes {axes!r}")
        ranks = list(range(get_world_size())) if ranks is None \
            else [int(r) for r in ranks]
        if int(np.prod(sizes)) != len(ranks):
            raise ValueError(f"mesh {axes} needs {int(np.prod(sizes))} "
                             f"ranks, the world has {len(ranks)}")
        self.axis_names = tuple(names)
        self.shape: Dict[str, int] = dict(zip(names, sizes))
        self.rank_array = np.asarray(ranks).reshape(sizes)
        # a process group orders its ranks ascending, so a gather along
        # an axis is in the axis's order only when the ranks ascend there
        if any((np.diff(self.rank_array, axis=i) <= 0).any()
               for i in range(len(sizes))):
            raise ValueError(f"mesh ranks must ascend along every axis: "
                             f"{ranks}")
        self.size = len(ranks)
        me = get_rank()
        at = np.argwhere(self.rank_array == me)
        self.coord: Dict[str, int] = dict(zip(
            names, (int(c) for c in at[0]))) if len(at) else {}
        self._groups = {}
        self._build_groups()

    @property
    def axes(self) -> Dict[str, int]:
        return dict(self.shape)

    @property
    def ranks(self):
        return self.rank_array.flatten().tolist()

    def _build_groups(self):
        n = len(self.axis_names)
        world = collective.world_group()
        for k in range(1, n + 1):
            for subset in itertools.combinations(range(n), k):
                key = tuple(self.axis_names[i] for i in subset)
                moved = np.moveaxis(self.rank_array, subset,
                                    range(n - k, n))
                rows = moved.reshape(-1, int(np.prod(
                    [moved.shape[i] for i in range(n - k, n)])))
                for row in rows:
                    row = [int(r) for r in row]
                    if len(row) == world.nranks and \
                            sorted(row) == world.ranks:
                        g = collective.Group(world.ranks, world.pg,
                                             "+".join(key), gid=0)
                    else:
                        g = collective.new_group(row,
                                                 axis_name="+".join(key))
                    if g.rank >= 0:
                        self._groups[key] = g

    def group(self, *axes) -> "collective.Group":
        """This rank's group along ``axes`` (names of this mesh; none is
        the whole mesh)."""
        axes = axes or self.axis_names
        unknown = [a for a in axes if a not in self.shape]
        if unknown:
            raise KeyError(f"axes {unknown} are not in mesh {self.shape}")
        key = tuple(a for a in self.axis_names if a in axes)
        return self._groups[key]

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def axis_rank(self, axis: str) -> int:
        return self.coord.get(axis, 0)

    def __repr__(self):
        return f"Mesh({self.shape})"


def init_mesh(axes: Dict[str, int], devices=None) -> Mesh:
    """Make and install the process's mesh, e.g. ``init_mesh({"dp": 2,
    "mp": 4})``; ``devices`` (global ranks) defaults to the world."""
    global _GLOBAL_MESH
    _GLOBAL_MESH = Mesh(axes, devices)
    return _GLOBAL_MESH


def get_mesh() -> Optional[Mesh]:
    return _GLOBAL_MESH


def reset_mesh():
    """Forget the installed mesh and hybrid group (``fleet.shutdown``)."""
    global _GLOBAL_MESH, _GLOBAL_HCG
    _GLOBAL_MESH = None
    _GLOBAL_HCG = None


def set_mesh(mesh: Mesh) -> Mesh:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    return mesh


@contextlib.contextmanager
def use_mesh(mesh):
    """``mesh`` installed while the block runs, the previous one
    after."""
    global _GLOBAL_MESH
    prev = _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    try:
        yield mesh
    finally:
        _GLOBAL_MESH = prev


def fleet_mesh(dp_degree=1, mp_degree=1, pp_degree=1, sharding_degree=1,
               sp_degree=1, ep_degree=1, devices=None) -> Mesh:
    """Fleet's hybrid mesh in the canonical axis order [dp, pp,
    sharding, sp, ep, mp], axes of degree 1 left out; degrees that
    cover part of the world get the rest as data parallelism."""
    axes = {}
    for name, deg in (("dp", dp_degree), ("pp", pp_degree),
                      ("sharding", sharding_degree), ("sp", sp_degree),
                      ("ep", ep_degree), ("mp", mp_degree)):
        if deg and deg > 1:
            axes[name] = int(deg)
    if not axes:
        axes = {"dp": 1}
    n = int(np.prod(list(axes.values())))
    world = len(devices) if devices is not None else get_world_size()
    if n != world:
        if world % n:
            raise ValueError(f"degrees {axes} incompatible with {world} "
                             "ranks")
        if "dp" in axes:
            axes["dp"] *= world // n
        else:
            axes = {"dp": world // n, **axes}
    return init_mesh(axes, devices)


def _active_mesh() -> Optional[Mesh]:
    """The installed mesh, else the registered executor's."""
    if _GLOBAL_MESH is not None:
        return _GLOBAL_MESH
    from .executor import active_mesh

    return active_mesh()


def _axis(mesh: Optional[Mesh], role: str) -> Optional[str]:
    if mesh is None:
        return None
    return next((a for a in AXIS_ALIASES[role] if a in mesh.shape), None)


def model_axis(mesh: Optional[Mesh]) -> Optional[str]:
    """The model-parallel axis of ``mesh``: ``tp`` or ``mp``."""
    return _axis(mesh, "mp")


def _role_group(role: str, mesh=None) -> "collective.Group":
    mesh = mesh or _active_mesh()
    axis = _axis(mesh, role)
    if axis is None:
        return collective.Group([get_rank()])
    return mesh.group(axis)


def sequence_group(mesh=None) -> Optional["collective.Group"]:
    """This rank's ``sp`` group on ``mesh`` (or the active one), along
    which a sequence- or context-parallel model splits its sequence;
    None where there is no ``sp`` axis."""
    mesh = mesh or _active_mesh()
    axis = _axis(mesh, "sp")
    return None if axis is None else mesh.group(axis)


def data_group(mesh=None) -> "collective.Group":
    """The data-parallel group of ``mesh`` (or the active one); the
    world without a mesh."""
    mesh = mesh or _active_mesh()
    if mesh is None:
        return collective.world_group()
    return _role_group("dp", mesh)


class CommunicateTopology:
    """Rank and coordinate bookkeeping over the hybrid axes (the
    reference's ``CommunicateTopology``)."""

    def __init__(self, hybrid_group_names=("data", "pipe", "sharding",
                                           "model"), dims=(1, 1, 1, 1)):
        self._parallel_names = list(hybrid_group_names)
        self._dims = list(dims)
        self.coordinate = list(itertools.product(*[range(d) for d in dims]))
        self._coord2rank = {c: i for i, c in enumerate(self.coordinate)}

    def get_hybrid_group_names(self):
        return self._parallel_names

    def get_dim(self, axis_name):
        return self._dims[self._parallel_names.index(axis_name)]

    get_dim_size = get_dim

    def world_size(self):
        return len(self.coordinate)

    def get_rank(self, **kwargs):
        return self._coord2rank[tuple(kwargs[n] for n in
                                      self._parallel_names)]

    def get_coord(self, rank):
        return self.coordinate[rank]

    def get_axis_list(self, axis_name, index):
        axis = self._parallel_names.index(axis_name)
        return [r for r, c in enumerate(self.coordinate) if c[axis] == index]

    def get_comm_list(self, axis_name):
        """Every group along ``axis_name``: lists of the ranks that
        differ only there."""
        axis = self._parallel_names.index(axis_name)
        others = [i for i in range(len(self._dims)) if i != axis]
        groups = {}
        for rank, coord in enumerate(self.coordinate):
            groups.setdefault(tuple(coord[i] for i in others),
                              []).append(rank)
        return list(groups.values())


class HybridCommunicateGroup:
    """Degrees, this rank's coordinates and its groups along the hybrid
    axes of the installed mesh (the reference's
    ``HybridCommunicateGroup``; an absent axis has degree 1)."""

    def __init__(self, topology: Optional[CommunicateTopology] = None,
                 mesh: Optional[Mesh] = None):
        global _GLOBAL_HCG
        self._mesh = mesh or get_mesh()
        self._topo = topology
        _GLOBAL_HCG = self

    def _size(self, role):
        axis = _axis(self._mesh, role)
        return 1 if axis is None else self._mesh.shape[axis]

    def _rank(self, role):
        axis = _axis(self._mesh, role)
        return 0 if axis is None else self._mesh.axis_rank(axis)

    def _group(self, role):
        return _role_group(role, self._mesh) if self._mesh is not None \
            else collective.Group([get_rank()])

    # degrees
    def get_data_parallel_world_size(self):
        return self._size("dp")

    def get_model_parallel_world_size(self):
        return self._size("mp")

    def get_pipe_parallel_world_size(self):
        return self._size("pp")

    def get_sharding_parallel_world_size(self):
        return self._size("sharding")

    def get_sep_parallel_world_size(self):
        return self._size("sp")

    def get_expert_parallel_world_size(self):
        return self._size("ep")

    # this rank's coordinates
    def get_data_parallel_rank(self):
        return self._rank("dp")

    def get_sep_parallel_rank(self):
        return self._rank("sp")

    def get_model_parallel_rank(self):
        return self._rank("mp")

    def get_stage_id(self):
        return self._rank("pp")

    def get_sharding_parallel_rank(self):
        return self._rank("sharding")

    # groups
    def get_data_parallel_group(self):
        return self._group("dp")

    def get_model_parallel_group(self):
        return self._group("mp")

    def get_pipe_parallel_group(self):
        return self._group("pp")

    def get_sharding_parallel_group(self):
        return self._group("sharding")

    def get_sep_parallel_group(self):
        return self._group("sp")

    def get_expert_parallel_group(self):
        return self._group("ep")

    def get_data_parallel_group_src_rank(self):
        return self.get_data_parallel_group().ranks[0]

    def get_model_parallel_group_src_rank(self):
        return self.get_model_parallel_group().ranks[0]

    def is_first_stage(self):
        return self.get_stage_id() == 0

    def is_last_stage(self):
        return self.get_stage_id() == self.get_pipe_parallel_world_size() - 1

    @property
    def nranks(self):
        return self._mesh.size if self._mesh is not None else 1

    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self.get_pipe_parallel_world_size() > 1:
            return "pipeline"
        if self.get_sharding_parallel_world_size() > 1:
            return "sharding"
        if self.get_model_parallel_world_size() > 1:
            return "model"
        return "data"


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _GLOBAL_HCG


class ProcessMesh:
    """A named view over global ranks (the reference's auto-parallel
    ``ProcessMesh``); :meth:`to_mesh` makes its :class:`Mesh`."""

    def __init__(self, mesh=None, dim_names=None, shape=None,
                 process_ids=None):
        arr = np.asarray(mesh) if mesh is not None \
            else np.asarray(process_ids).reshape(shape)
        self._shape = list(arr.shape)
        self._ids = arr.flatten().tolist()
        self._dim_names = list(dim_names) if dim_names else [
            f"d{i}" for i in range(arr.ndim)]

    @property
    def shape(self):
        return self._shape

    @property
    def process_ids(self):
        return self._ids

    @property
    def dim_names(self):
        return self._dim_names

    @property
    def ndim(self):
        return len(self._shape)

    def to_mesh(self) -> Mesh:
        return Mesh(dict(zip(self._dim_names, self._shape)), self._ids)

    def __eq__(self, other):
        return (isinstance(other, ProcessMesh) and self._shape == other._shape
                and self._ids == other._ids)

    def __repr__(self):
        return f"ProcessMesh(shape={self._shape}, dims={self._dim_names})"
