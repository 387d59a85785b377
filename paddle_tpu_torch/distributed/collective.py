"""Collective communication (the port of
``paddle_tpu/distributed/collective.py``) over ``torch.distributed``.

The JAX package lowers each call to an XLA collective of one program
that drives every chip; the port runs one process a rank, so each call
here is a ``torch.distributed`` collective over a :class:`Group`'s
process group, with the reference's semantics: ``all_reduce`` and
``broadcast`` in place, ``all_gather`` filling a list, ``src``/``dst``
global ranks.  A group of one rank (a world of one, or a process that
never joined one) makes every collective the identity, as the
reference's eager path is; ``send``/``recv`` then have no peer and
raise.

The backend is the caller's (``parallel.init_parallel_env``).  NCCL
takes CUDA tensors for every call.  gloo takes some calls on CUDA
tensors and not others: of those this module makes, PyTorch 2.11's gloo
(probed on an NVIDIA H100 machine) runs ``all_reduce`` (sum, max, min,
avg; f32 and bf16), ``reduce``, ``all_gather``,
``all_gather_into_tensor``, ``reduce_scatter``,
``reduce_scatter_tensor``, ``all_to_all_single``, ``broadcast``,
``gather``, ``scatter`` and ``barrier`` on CUDA tensors (copying
through host memory itself), and fails ``send``/``recv`` of a CUDA
tensor (the TCP pair writes from the device pointer and aborts the
process).  Those two, :func:`ring_exchange` and the pipeline
schedule's hops (:data:`PIPELINE_P2P`), made of the same
point-to-point calls (:data:`GLOO_CUDA_STAGED`), go through pinned
host buffers here: the tensor copied to it, the call made on it, the
result copied back.  Each such call adds one to :func:`staged_counts`
under its name, and every call of this module adds one to
:func:`counts`, so a caller can print what a step staged.  The list
form of ``alltoall``, which gloo has for no tensor, is one
``all_to_all_single`` over the concatenated tensors.
"""
from __future__ import annotations

import collections
import contextlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .env import get_rank, get_world_size

__all__ = [
    "GLOO_CUDA_STAGED", "Group", "PIPELINE_P2P", "ParallelMode",
    "ReduceOp", "all_gather",
    "all_gather_object", "all_reduce", "alltoall", "alltoall_single",
    "barrier", "broadcast", "broadcast_object_list", "comm_device",
    "counted_under", "counts",
    "get_group",
    "irecv", "isend", "mean_rounded_once", "new_group", "recv",
    "recv_backward", "recv_forward", "reduce", "reduce_scatter",
    "reset_counts", "ring_exchange", "scatter", "send", "send_backward",
    "send_backward_recv_forward", "send_forward",
    "send_forward_recv_backward", "split", "staged_counts",
    "sum_divided_rounded_once",
    "sum_rounded_once", "wait", "world_group",
]

#: the pipeline schedule's hops along a pipeline group (``send_forward``
#: and the rest below)
PIPELINE_P2P = ("send_forward", "recv_forward", "send_backward",
                "recv_backward", "send_forward_recv_backward",
                "send_backward_recv_forward")
#: calls gloo fails on CUDA tensors; they are staged through host memory
GLOO_CUDA_STAGED = frozenset({"send", "recv", "ring_exchange",
                              *PIPELINE_P2P})

_CALLS: collections.Counter = collections.Counter()
_STAGED: collections.Counter = collections.Counter()
_TAGS: list = []


@contextlib.contextmanager
def counted_under(tag: str):
    """Count the collectives made inside the block as ``tag.call`` (the
    fused loss's apart from the rest of a step)."""
    _TAGS.append(tag)
    try:
        yield
    finally:
        _TAGS.pop()


def counts() -> dict:
    """``{call: n}`` of the collectives made since :func:`reset_counts`."""
    return dict(_CALLS)


def staged_counts() -> dict:
    """``{call: n}`` of those staged through a pinned host buffer."""
    return dict(_STAGED)


def reset_counts():
    _CALLS.clear()
    _STAGED.clear()


class ReduceOp:
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OPS = {ReduceOp.SUM: "SUM", ReduceOp.MAX: "MAX", ReduceOp.MIN: "MIN",
              ReduceOp.PROD: "PRODUCT"}


def _torch_op(op):
    if op not in _TORCH_OPS:
        raise ValueError(f"unknown reduce op {op!r}")
    return getattr(dist.ReduceOp, _TORCH_OPS[op])


class ParallelMode:
    """Parallelism kinds (the reference's ``ParallelMode``)."""

    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3


class Group:
    """A set of global ``ranks`` and the process group that joins them
    (``None`` for a group of one rank).  ``rank`` is this process's
    index in ``ranks`` (-1 when it is not a member); ``axis_name`` is
    the mesh axis the group runs along, where a mesh made it."""

    def __init__(self, ranks: Sequence[int], pg=None, axis_name=None,
                 gid: int = 0):
        self.ranks = list(ranks)
        self.pg = pg
        self.axis_name = axis_name
        self.id = gid
        me = get_rank()
        self.rank = self.ranks.index(me) if me in self.ranks else -1

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    @property
    def backend(self) -> Optional[str]:
        return None if self.pg is None else dist.get_backend(self.pg)

    def get_group_rank(self, rank: int) -> int:
        return self.ranks.index(rank) if rank in self.ranks else -1

    def process_group(self):
        return self.pg

    def __repr__(self):
        return (f"Group(ranks={self.ranks}, rank={self.rank}, "
                f"axis={self.axis_name!r})")


_GROUPS = {}
_WORLD: Optional[Group] = None


def comm_device(group=None) -> torch.device:
    """Where a small host value goes to take part in a collective of
    ``group``: this rank's card under NCCL (which takes CUDA tensors
    only), else the CPU."""
    g = _group(group)
    if g.backend == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def world_group() -> Group:
    """Every rank of the joined world, or this process alone."""
    global _WORLD
    n = get_world_size()
    if _WORLD is None or _WORLD.nranks != n or \
            (n > 1 and _WORLD.pg is None):
        pg = dist.group.WORLD if n > 1 and dist.is_initialized() else None
        _WORLD = Group(range(n), pg, gid=0)
        _GROUPS[0] = _WORLD
    return _WORLD


def _reset_world():
    """Forget the cached world and groups (``parallel.destroy``)."""
    global _WORLD
    _WORLD = None
    _GROUPS.clear()


def new_group(ranks=None, backend=None, timeout=None, axis_name=None
              ) -> Group:
    """A group over the global ``ranks`` (default every rank).  Like
    ``torch.distributed.new_group``, every rank of the world calls it,
    in the same order, members or not."""
    ranks = list(range(get_world_size())) if ranks is None else \
        sorted(int(r) for r in ranks)
    pg = None
    if len(ranks) > 1:
        kw = {} if timeout is None else {"timeout": timeout}
        pg = dist.new_group(ranks, backend=backend, **kw)
    g = Group(ranks, pg, axis_name, gid=len(_GROUPS) + 1)
    _GROUPS[g.id] = g
    return g


def get_group(gid: int = 0) -> Optional[Group]:
    if gid == 0:
        return world_group()
    return _GROUPS.get(gid)


def _group(group) -> Group:
    return world_group() if group is None else group


def _trivial(g: Group) -> bool:
    """No peer to talk to: identity (or, for send/recv, an error)."""
    return g.nranks == 1 or g.rank < 0


def _staged(name, g, tensors):
    return (name in GLOO_CUDA_STAGED and g.backend == "gloo"
            and any(t.is_cuda for t in tensors))


def _call(name, g: Group, fn, *tensors, written=()):
    """Run ``fn(*tensors)`` on the process group, through pinned host
    copies when gloo cannot take the CUDA tensors; the copies of
    ``written`` (indices into ``tensors``) are copied back."""
    key = f"{_TAGS[-1]}.{name}" if _TAGS else name
    _CALLS[key] += 1
    if not _staged(name, g, tensors):
        return fn(*tensors)
    _STAGED[key] += 1
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            for t in tensors]
    out = fn(*host)
    if hasattr(out, "wait"):
        out.wait()
    for i in written:
        tensors[i].copy_(host[i])
    return None


def all_reduce(tensor, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce ``tensor`` over the group's ranks, in place; ``AVG`` is the
    sum divided by the rank count."""
    g = _group(group)
    if _trivial(g):
        return tensor
    if op == ReduceOp.AVG:
        _call("all_reduce", g, lambda t: dist.all_reduce(
            t, dist.ReduceOp.SUM, group=g.pg), tensor)
        tensor.div_(g.nranks)
        return tensor
    _call("all_reduce", g, lambda t: dist.all_reduce(
        t, _torch_op(op), group=g.pg), tensor)
    return tensor


def _wide(tensor, nranks):
    """``tensor`` in a type where the sum of ``nranks`` parts rounds
    once when rounded back: f64 for f32, f32 for the 16-bit floats.
    Two parts keep their dtype (a sum of two values rounds once in any
    type, and the wide copy would double the bytes sent), as does any
    tensor that is not floating point."""
    if nranks <= 2 or not tensor.is_floating_point():
        return tensor
    if tensor.dtype == torch.float32:
        return tensor.double()
    return tensor.float() if tensor.element_size() < 4 else tensor


def _rounded_once(tensor, group, divisor):
    g = _group(group)
    if _trivial(g):
        return tensor
    wide = _wide(tensor, g.nranks)
    all_reduce(wide, group=g)
    if divisor != 1:
        wide.div_(divisor)
    return tensor if wide is tensor else tensor.copy_(wide)


def sum_rounded_once(tensor, group=None):
    """``tensor`` summed over the group, in place, rounded to its dtype
    once: the parts widened (:func:`_wide`), summed by one
    ``all_reduce``, the sum copied back.  A sum of equal parts is exact
    in the wide type, whatever the backend's order."""
    return _rounded_once(tensor, group, 1)


def mean_rounded_once(tensor, group=None):
    """``tensor`` averaged over the group, in place: the wide sum of
    :func:`sum_rounded_once` divided in the wide type (halving two
    parts is exact in any type) and rounded to the tensor's dtype once;
    the mean of equal tensors is each of them, bit for bit."""
    return _rounded_once(tensor, group, _group(group).nranks)


def sum_divided_rounded_once(tensor, group, divisor):
    """``tensor`` summed over ``group`` and divided by ``divisor``, in
    place, rounded once as :func:`mean_rounded_once` (the sequence-
    parallel gradient: summed over the ``sp`` ranks, each holding a
    share of one global mean, and averaged over the data ranks, the
    group being both and ``divisor`` the data ranks' count)."""
    return _rounded_once(tensor, group, divisor)


def all_gather(tensor_list, tensor, group=None, sync_op=True, axis=0):
    """Every rank's ``tensor``, in rank order, into ``tensor_list``
    (cleared first); returns the list."""
    g = _group(group)
    if _trivial(g):
        parts = [tensor]
    else:
        parts = [torch.empty_like(tensor) for _ in range(g.nranks)]
        _call("all_gather", g, lambda t: dist.all_gather(
            parts, t, group=g.pg), tensor.contiguous())
    if isinstance(tensor_list, list):
        tensor_list.clear()
        tensor_list.extend(parts)
    return parts


def all_gather_object(object_list, obj, group=None):
    g = _group(group)
    if _trivial(g):
        out = [obj]
    else:
        _CALLS["all_gather_object"] += 1
        out = [None] * g.nranks
        dist.all_gather_object(out, obj, group=g.pg)
    object_list.clear()
    object_list.extend(out)
    return object_list


def reduce_scatter(tensor, tensor_list=None, op=ReduceOp.SUM, group=None,
                   sync_op=True):
    """Reduce over the group and keep this rank's part.  With
    ``tensor_list`` (one tensor a rank), ``tensor`` receives the
    reduction of every rank's ``tensor_list[rank]`` and is returned;
    without it, ``tensor`` is the input, split along dim 0 into one
    part a rank, and the reduced part is returned as a new tensor."""
    g = _group(group)
    avg = op == ReduceOp.AVG
    top = _torch_op(ReduceOp.SUM if avg else op)
    if tensor_list is None:
        if tensor.shape[0] % g.nranks:
            raise ValueError(f"dim 0 of {tuple(tensor.shape)} does not "
                             f"split over {g.nranks} ranks")
        if _trivial(g):
            return tensor.clone()
        out = torch.empty((tensor.shape[0] // g.nranks, *tensor.shape[1:]),
                          dtype=tensor.dtype, device=tensor.device)
        _call("reduce_scatter", g, lambda o, t: dist.reduce_scatter_tensor(
            o, t, top, group=g.pg), out, tensor.contiguous())
    else:
        out = tensor
        if _trivial(g):
            return out.copy_(tensor_list[0 if g.rank < 0 else g.rank])
        _call("reduce_scatter", g, lambda o: dist.reduce_scatter(
            o, [t.contiguous() for t in tensor_list], top, group=g.pg), out)
    if avg:
        out.div_(g.nranks)
    return out


def alltoall(in_tensor_list, out_tensor_list=None, group=None, sync_op=True):
    """Rank i's ``in_tensor_list[j]`` goes to rank j's
    ``out_tensor_list[i]`` (same shapes), as one ``all_to_all_single``."""
    g = _group(group)
    ins = list(in_tensor_list)
    if _trivial(g):
        outs = ins
    else:
        flat = torch.stack([t.contiguous() for t in ins])
        got = alltoall_single(flat, group=g)
        outs = list(got.unbind(0))
    if isinstance(out_tensor_list, list):
        out_tensor_list.clear()
        out_tensor_list.extend(outs)
    return outs


def alltoall_single(in_tensor, out_tensor=None, in_split_sizes=None,
                    out_split_sizes=None, group=None, sync_op=True):
    """Dim 0 of ``in_tensor`` split into one part a rank (even, or
    ``in_split_sizes``); part j goes to rank j, and the parts received
    are concatenated in rank order into ``out_tensor`` (returned)."""
    g = _group(group)
    if _trivial(g):
        if out_tensor is None:
            return in_tensor.clone()
        return out_tensor.copy_(in_tensor)
    if out_tensor is None:
        rows = in_tensor.shape[0] if out_split_sizes is None \
            else sum(out_split_sizes)
        out_tensor = torch.empty((rows, *in_tensor.shape[1:]),
                                 dtype=in_tensor.dtype,
                                 device=in_tensor.device)
    _call("all_to_all_single", g, lambda o, t: dist.all_to_all_single(
        o, t, out_split_sizes, in_split_sizes, group=g.pg),
        out_tensor, in_tensor.contiguous())
    return out_tensor


def broadcast(tensor, src=0, group=None, sync_op=True):
    """Global rank ``src``'s ``tensor`` onto every rank of the group, in
    place."""
    g = _group(group)
    if _trivial(g):
        return tensor
    _call("broadcast", g, lambda t: dist.broadcast(t, src, group=g.pg),
          tensor)
    return tensor


def broadcast_object_list(object_list, src=0, group=None):
    g = _group(group)
    if not _trivial(g):
        _CALLS["broadcast_object_list"] += 1
        dist.broadcast_object_list(object_list, src, group=g.pg)
    return object_list


def reduce(tensor, dst=0, op=ReduceOp.SUM, group=None, sync_op=True):
    """Reduce onto global rank ``dst``, in place there (other ranks'
    tensors are left as the backend leaves them)."""
    g = _group(group)
    if _trivial(g):
        return tensor
    avg = op == ReduceOp.AVG
    _call("reduce", g, lambda t: dist.reduce(
        t, dst, _torch_op(ReduceOp.SUM if avg else op), group=g.pg), tensor)
    if avg and get_rank() == dst:
        tensor.div_(g.nranks)
    return tensor


def scatter(tensor, tensor_list=None, src=0, group=None, sync_op=True):
    """Global rank ``src``'s ``tensor_list[i]`` into the ``tensor`` of
    the group's i-th rank."""
    g = _group(group)
    if _trivial(g):
        if tensor_list:
            tensor.copy_(tensor_list[max(g.rank, 0)])
        return tensor
    lst = [t.contiguous() for t in tensor_list] \
        if get_rank() == src else None
    _call("scatter", g, lambda t: dist.scatter(t, lst, src, group=g.pg),
          tensor)
    return tensor


class _Task:
    """What an asynchronous call returns: ``wait()`` blocks until it is
    done (the calls here finish before they return)."""

    def __init__(self, work=None):
        self._work = work

    def wait(self):
        if self._work is not None:
            self._work.wait()
        return True

    def is_completed(self):
        return True


def _peerless(g):
    if _trivial(g):
        raise RuntimeError(
            "send/recv need a peer: this process is alone in its group "
            "(join a world with init_parallel_env first)")


def send(tensor, dst=0, group=None, sync_op=True):
    g = _group(group)
    _peerless(g)
    _call("send", g, lambda t: dist.send(t, dst, group=g.pg), tensor)
    return _Task()


def recv(tensor, src=0, group=None, sync_op=True):
    g = _group(group)
    _peerless(g)
    _call("recv", g, lambda t: dist.recv(t, src, group=g.pg), tensor,
          written=(0,))
    return _Task()


def isend(tensor, dst=0, group=None):
    return send(tensor, dst, group, sync_op=False)


def irecv(tensor, src=0, group=None):
    return recv(tensor, src, group, sync_op=False)


def ring_exchange(tensors, group=None):
    """One hop of a ring over the group's ranks: each of ``tensors``
    goes to the next rank of the group, and the previous rank's come
    back, as new tensors, in the same order.  Every rank posts all its sends and receives together
    (``batch_isend_irecv``) and then waits, so no two neighbours wait on
    each other whatever the backend's buffering.  One call of
    :func:`counts` a hop; gloo on CUDA tensors stages it through pinned
    host buffers (:func:`staged_counts`)."""
    g = _group(group)
    _peerless(g)
    n = g.nranks
    nxt, prv = g.ranks[(g.rank + 1) % n], g.ranks[(g.rank - 1) % n]
    ins = [t.contiguous() for t in tensors]
    outs = [torch.empty_like(t) for t in ins]
    k = len(ins)

    def hop(*bufs):
        ops = [dist.P2POp(dist.isend, b, nxt, g.pg) for b in bufs[:k]] + \
            [dist.P2POp(dist.irecv, b, prv, g.pg) for b in bufs[k:]]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    _call("ring_exchange", g, hop, *ins, *outs,
          written=tuple(range(k, 2 * k)))
    return outs


def _batch(name, g, sends, recvs):
    """Post the sends ``[(tensor, global peer)]`` and receives
    ``[(buffer, global peer)]`` together (``batch_isend_irecv``) and wait
    for all of them, as one call ``name`` of :func:`counts` (staged under
    gloo on CUDA tensors, as :func:`ring_exchange`); returns the
    buffers."""
    _peerless(g)
    ins = [t.contiguous() for t, _ in sends]
    outs = [t for t, _ in recvs]
    peers = [p for _, p in sends] + [p for _, p in recvs]
    k = len(ins)

    def hop(*bufs):
        ops = [dist.P2POp(dist.isend if i < k else dist.irecv, b, peer, g.pg)
               for i, (b, peer) in enumerate(zip(bufs, peers))]
        for work in dist.batch_isend_irecv(ops):
            work.wait()

    _call(name, g, hop, *ins, *outs,
          written=tuple(range(k, k + len(outs))))
    return outs


def _stage_peer(g, step):
    """The global rank ``step`` places along the pipeline group ``g``
    (+1 the next stage, -1 the previous one)."""
    i = g.rank + step
    if not 0 <= i < g.nranks:
        raise ValueError(f"stage {g.rank} of {g.nranks} has no "
                         f"{'next' if step > 0 else 'previous'} stage")
    return g.ranks[i]


def _like(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def send_forward(tensor, group=None):
    """A stage's output activation to the next stage of the pipeline
    group (the reference's ``p2p.send_forward``)."""
    g = _group(group)
    _batch("send_forward", g, [(tensor, _stage_peer(g, 1))], [])


def recv_forward(shape, dtype, device=None, group=None):
    """The previous stage's activation, a new tensor of ``shape`` and
    ``dtype`` (the receiver knows them: the pipeline's caller gives
    them)."""
    g = _group(group)
    return _batch("recv_forward", g, [], [(_like(shape, dtype, device),
                                           _stage_peer(g, -1))])[0]


def send_backward(tensor, group=None):
    """The gradient of a stage's input activation to the previous
    stage."""
    g = _group(group)
    _batch("send_backward", g, [(tensor, _stage_peer(g, -1))], [])


def recv_backward(shape, dtype, device=None, group=None):
    """The next stage's gradient of this stage's output activation."""
    g = _group(group)
    return _batch("recv_backward", g, [], [(_like(shape, dtype, device),
                                            _stage_peer(g, 1))])[0]


def send_forward_recv_backward(tensor, group=None):
    """The steady 1F1B hop down the pipe: ``tensor`` (an output
    activation) to the next stage and, posted with it, that stage's
    gradient of an earlier output (``tensor``'s shape and dtype) back:
    the two neighbours never wait on each other."""
    g = _group(group)
    peer = _stage_peer(g, 1)
    return _batch("send_forward_recv_backward", g, [(tensor, peer)],
                  [(torch.empty_like(tensor), peer)])[0]


def send_backward_recv_forward(tensor, group=None):
    """The steady 1F1B hop up the pipe: ``tensor`` (an input gradient)
    to the previous stage and, posted with it, that stage's next
    activation (``tensor``'s shape and dtype)."""
    g = _group(group)
    peer = _stage_peer(g, -1)
    return _batch("send_backward_recv_forward", g, [(tensor, peer)],
                  [(torch.empty_like(tensor), peer)])[0]


def barrier(group=None):
    g = _group(group)
    if not _trivial(g):
        _CALLS["barrier"] += 1
        dist.barrier(group=g.pg)
    return _Task()


def wait(tensor, group=None, use_calc_stream=True):
    """Wait for the device work that writes ``tensor``."""
    if isinstance(tensor, torch.Tensor) and tensor.is_cuda:
        torch.cuda.synchronize(tensor.device)


def split(x, size, operation, axis=0, num_partitions=1, gather_out=True,
          weight_attr=None, bias_attr=None, name=None):
    """A model-parallel linear or embedding in one call (the reference's
    ``split``): the parallel layer of ``size`` built on ``x``'s device
    over the active mesh's model-parallel group, applied to ``x``."""
    from .parallel_layers import (ColumnParallelLinear, RowParallelLinear,
                                  VocabParallelEmbedding)

    if operation == "embedding":
        layer = VocabParallelEmbedding(size[0], size[1], device=x.device)
    elif operation != "linear":
        raise ValueError(f"split supports linear/embedding, got {operation}")
    elif axis == 0:
        layer = RowParallelLinear(size[0], size[1],
                                  has_bias=bias_attr is not False,
                                  input_is_parallel=False, device=x.device)
    elif axis == 1:
        layer = ColumnParallelLinear(size[0], size[1],
                                     has_bias=bias_attr is not False,
                                     gather_output=gather_out,
                                     device=x.device)
    else:
        raise ValueError("axis must be 0 (row) or 1 (column)")
    return layer(x)
