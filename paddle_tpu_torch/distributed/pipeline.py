"""Pipeline parallelism (the port of ``paddle_tpu/distributed/pipeline.py``).

The JAX package runs a pipeline as ONE program over the mesh: the
repeated body stacked with a leading [pp] axis, a ``lax.scan`` over ticks
with a ``ppermute`` hop a tick, and a per-tick ``jax.vjp`` that
recomputes the stage's forward.  The port runs one process a stage, as
the original Paddle's ``pipeline_parallel.py`` does, so the schedule is
re-derived per rank: stage ``s`` of ``S`` runs M microbatches as

- 1F1B: a warm-up of ``min(S - s - 1, M)`` forwards, a steady phase
  where each forward is followed by one backward, and a cool-down of the
  backwards left.  At most ``S - s`` microbatches' autograd graphs are
  in flight on stage ``s``; nothing is recomputed unless the model's
  own ``recompute`` option asks for it, so the gradients are the JAX
  schedule's (which recomputes) and only the memory differs.
- GPipe (``"FThenB"``): every forward, then every backward; M graphs in
  flight.

Both run the backwards in microbatch order, so both give the same
gradients, bit for bit.  The hops are ``collective``'s
``send_forward``/``recv_forward``/``send_backward``/``recv_backward`` of
the warm-up and cool-down and, in the steady phase, the paired
``send_forward_recv_backward`` and ``send_backward_recv_forward``, each
posted as one batch (``batch_isend_irecv``) so two neighbours never wait
on each other; each is counted in ``collective.counts()`` and, under
gloo on CUDA tensors, staged through host memory
(``collective.staged_counts()``).

The receiver knows an activation's shape and dtype without asking: the
pipeline's caller gives them.  The functional schedules take
``act_example`` (the JAX signature's); a :class:`PipelineLayer` takes
``activation_shape``, a function of a stage-0 microbatch input giving
``(shape, dtype)``: ``LlamaForCausalLMPipe``'s is ``[micro, T,
hidden]`` in the config's dtype, from the config and the microbatch.
Every boundary's activation has that shape, and so has its gradient.

Loss and gradients follow the reference: each microbatch loss enters
the backward scaled by 1/M, the loss reported is the sum of the M
microbatch losses over M (the same on every rank: the last stage's sum
all-reduced over the pipeline group), and with a ``dp`` axis the loss
and every gradient are then averaged over ``dp``.  A parameter several
stages hold (:class:`SharedLayerDesc`, a tied embedding: the first and
the last stage) has its gradients summed over those stages.

Where layers land (:func:`stage_segments`) is the JAX package's
compiled placement: the layers before the longest run of alike layers
(the prologue, an embedding) with stage 0, that run evenly over the
stages, the layers after it (the epilogue, norm and head) with the last
stage.  A rank builds only its stage's layers from their descs, each
under its global index (``"3.layer.self_attn.q_proj.weight"``), so the
JAX ``PipelineLayer``'s state dict maps onto every stage.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.utils import _pytree as pytree

from . import collective
from .mesh import get_mesh

__all__ = ["LayerDesc", "PipelineLayer", "PipelineParallel",
           "SharedLayerDesc", "gpipe_spmd", "pipeline_1f1b",
           "pipeline_gpipe", "run_schedule", "schedule_p2p_calls",
           "stage_segments"]

SCHEDULES = ("1F1B", "FThenB")
_AMP = ("train_batch with a GradScaler (the reference's amp path) waits "
        "for ROADMAP item A5's amp, with the last of A3's smaller "
        "leftovers")


# ------------------------------------------------------------ schedule
@dataclasses.dataclass
class ScheduleStats:
    """What one run of the schedule did on this rank: its stage, the
    most microbatches whose autograd graphs were held at once, and on
    the card the allocated bytes one microbatch's forward kept (the
    first one's)."""

    stage: int
    max_in_flight: int = 0
    act_bytes: int = 0


def _schedule_name(schedule: str) -> str:
    name = {"1f1b": "1F1B", "fthenb": "FThenB"}.get(str(schedule).lower())
    if name is None:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; "
                         f"known: {SCHEDULES}")
    return name


def schedule_p2p_calls(n_stages: int, stage: int, n_micro: int,
                       schedule: str = "1F1B") -> dict:
    """``{call: n}`` of the hops one run of the schedule makes on
    ``stage`` (:func:`run_schedule`): on every stage but the last, M
    activations sent and M gradients received; on every stage but the
    first, M activations received and M gradients sent."""
    S, s, M = n_stages, stage, n_micro
    first, last = s == 0, s == S - 1
    out = collections.Counter()
    if _schedule_name(schedule) == "FThenB":
        if not first:
            out["recv_forward"] += M
            out["send_backward"] += M
        if not last:
            out["send_forward"] += M
            out["recv_backward"] += M
        return {k: n for k, n in out.items() if n}
    w = min(S - s - 1, M)
    r = M - w
    if not first:
        out["recv_forward"] += w + (1 if r else 0)
        out["send_backward"] += w + (1 if r else 0)
        out["send_backward_recv_forward"] += max(r - 1, 0)
    if not last:
        out["send_forward"] += w
        out["send_forward_recv_backward"] += r
        out["recv_backward"] += w
    return {k: n for k, n in out.items() if n}


def run_schedule(stage_forward: Callable, n_micro: int, group,
                 act_shape, act_dtype, device, schedule: str = "1F1B"):
    """Run one pipeline step's forwards and backwards on this rank.

    ``stage_forward(i, x)`` runs microbatch ``i``'s forward of this
    rank's stage with grad on: ``x`` is the received activation (a leaf
    that requires grad; None on stage 0, which reads its own input) and
    it returns ``(y, loss)``: the output activation (ignored on the last
    stage) and, on the last stage, the microbatch's scalar loss.  The
    backward of microbatch ``i`` is ``loss / M`` on the last stage, else
    ``y`` against the gradient the next stage sent; gradients accumulate
    into whatever ``stage_forward`` read.  ``group`` is the pipeline
    group (this rank's index in it is the stage; None with one stage);
    ``act_shape`` and ``act_dtype`` are every boundary's activation's.
    Returns ``(loss, stats)``: the f32 sum of the microbatch losses
    times 1/M, the scale of their backward (0 off the last stage), and a
    :class:`ScheduleStats`."""
    name = _schedule_name(schedule)
    S, s = (group.nranks, group.rank) if group is not None else (1, 0)
    M = n_micro
    first, last = s == 0, s == S - 1
    cuda = torch.device(device).type == "cuda"
    if group is not None and S > 1 and group.backend == "nccl" and \
            not getattr(group, "_p2p_ready", False):
        # NCCL's first call on a group must involve all of its ranks
        collective.barrier(group)
        group._p2p_ready = True
    stats = ScheduleStats(s)
    pending = collections.deque()
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    scale = 1.0 / M

    def recv_forward():
        if first:
            return None
        return collective.recv_forward(act_shape, act_dtype, device, group)

    def forward(i, x):
        nonlocal loss_sum
        if x is not None:
            x.requires_grad_()
        before = torch.cuda.memory_allocated(device) if cuda and i == 0 \
            else 0
        y, loss = stage_forward(i, x)
        if last:
            y = None
            loss_sum = loss_sum + loss.detach().float()
        elif tuple(y.shape) != tuple(act_shape) or y.dtype != act_dtype:
            raise ValueError(
                f"stage {s} gave an activation {tuple(y.shape)} "
                f"{y.dtype}; the pipeline's is {tuple(act_shape)} "
                f"{act_dtype}")
        if cuda and i == 0:
            stats.act_bytes = torch.cuda.memory_allocated(device) - before
        pending.append((x, y, loss if last else None))
        stats.max_in_flight = max(stats.max_in_flight, len(pending))
        return y

    def backward(g):
        x, y, loss = pending.popleft()
        if last:
            torch.autograd.backward(loss, torch.full_like(loss, scale))
        else:
            torch.autograd.backward(y, g)
        return None if first else x.grad

    if name == "FThenB":
        for i in range(M):
            y = forward(i, recv_forward())
            if not last:
                collective.send_forward(y.detach(), group)
        for _ in range(M):
            g = None if last else collective.recv_backward(
                act_shape, act_dtype, device, group)
            dx = backward(g)
            if not first:
                collective.send_backward(dx, group)
        return loss_sum * scale, stats

    warm = min(S - s - 1, M)
    steady = M - warm
    for i in range(warm):
        y = forward(i, recv_forward())
        collective.send_forward(y.detach(), group)
    x = recv_forward() if steady else None
    for j in range(steady):
        y = forward(warm + j, x)
        g = None if last else collective.send_forward_recv_backward(
            y.detach(), group)
        dx = backward(g)
        if first:
            x = None
        elif j == steady - 1:
            collective.send_backward(dx, group)
        else:
            x = collective.send_backward_recv_forward(dx, group)
    for _ in range(warm):
        dx = backward(collective.recv_backward(act_shape, act_dtype, device,
                                               group))
        if not first:
            collective.send_backward(dx, group)
    return loss_sum * scale, stats


# ------------------------------------------------- functional schedules
def _pp_group(mesh, axis_name):
    mesh = mesh or get_mesh()
    if mesh is None or axis_name not in mesh.shape:
        raise ValueError(f"a pipeline needs a mesh with a {axis_name!r} "
                         "axis (init_mesh or fleet.init)")
    return mesh, mesh.group(axis_name)


def _data_part(t, mesh, data_axis):
    """This rank's rows of ``t`` [M, micro, ...] along ``data_axis``
    (the JAX ``P(None, data_axis)`` layout of the microbatches)."""
    if data_axis is None or mesh.shape.get(data_axis, 1) == 1:
        return t
    n, r = mesh.shape[data_axis], mesh.axis_rank(data_axis)
    if t.shape[1] % n:
        raise ValueError(f"microbatch {t.shape[1]} not divisible by "
                         f"{data_axis}={n}")
    rows = t.shape[1] // n
    return t[:, r * rows:(r + 1) * rows]


def _leaves(tree):
    """Detached leaf copies of ``tree``'s tensors that take gradients."""
    flat, spec = pytree.tree_flatten(tree)
    leaves = [t.detach().requires_grad_(t.is_floating_point())
              for t in flat]
    return leaves, spec


def _grads(leaves):
    return [torch.zeros_like(p) if p.grad is None else p.grad
            for p in leaves]


def _pipeline(schedule, stage_fn, stage_params, shared_params, inputs_mb,
              targets_mb, act_example, mesh, axis_name, data_axis):
    mesh, group = _pp_group(mesh, axis_name)
    S, s = group.nranks, group.rank
    inputs = _data_part(inputs_mb, mesh, data_axis)
    targets = _data_part(targets_mb, mesh, data_axis)
    M = inputs.shape[0]
    local, l_spec = _leaves(stage_params)
    shared, s_spec = _leaves(shared_params)
    local_t = pytree.tree_unflatten(local, l_spec)
    shared_t = pytree.tree_unflatten(shared, s_spec)
    device = act_example.device

    def stage_forward(i, x):
        return stage_fn(s, shared_t, local_t, x, inputs[i], targets[i])

    loss, stats = run_schedule(stage_forward, M, group, act_example.shape,
                               act_example.dtype, device, schedule)
    g_local, g_shared = _grads(local), _grads(shared)
    # the JAX closing psum: the loss and the shared gradients over pp
    loss = collective.all_reduce(loss, group=group)
    for g in g_shared:
        collective.all_reduce(g, group=group)
    if data_axis is not None and mesh.shape.get(data_axis, 1) > 1:
        dgroup = mesh.group(data_axis)
        loss = collective.mean_rounded_once(loss.clone(), dgroup)
        for g in (*g_local, *g_shared):
            collective.mean_rounded_once(g, dgroup)
    return (loss, pytree.tree_unflatten(g_local, l_spec),
            pytree.tree_unflatten(g_shared, s_spec))


def pipeline_1f1b(stage_fn: Callable, stage_params, shared_params,
                  inputs_mb, targets_mb, act_example, mesh=None,
                  axis_name: str = "pp", data_axis: Optional[str] = None):
    """The 1F1B schedule over the ``axis_name`` ranks of ``mesh``, one
    process a stage (the JAX ``pipeline_1f1b``'s semantics).

    ``stage_fn(stage, shared, local, x, mb_inputs, mb_targets) -> (y,
    loss)`` applies this rank's stage: ``x`` is the received activation
    (None on stage 0, which embeds ``mb_inputs``), ``y`` must have
    ``act_example``'s shape and dtype, and ``loss`` is the microbatch's
    scalar loss on the last stage (ignored elsewhere).
    ``stage_params`` is this rank's stage's pytree (rank ``s``'s slice
    ``[s]`` of the JAX ``[S, L/S, ...]`` stacked leaves);
    ``shared_params`` the pytree every stage is given.
    ``inputs_mb``/``targets_mb`` [M, micro, ...] are the whole
    microbatches (with ``data_axis``, this rank takes its rows, and
    ``act_example`` has the local shape).  Returns ``(loss,
    grads_local, grads_shared)``: the mean loss over the M microbatches
    (and the data ranks), the same on every rank; this stage's
    gradients, laid out as ``stage_params``; and the shared
    gradients summed over the stages (the JAX closing psum), as
    ``shared_params``; with ``data_axis`` both averaged over it."""
    return _pipeline("1F1B", stage_fn, stage_params, shared_params,
                     inputs_mb, targets_mb, act_example, mesh, axis_name,
                     data_axis)


def pipeline_gpipe(stage_fn: Callable, stage_params, shared_params,
                   inputs_mb, targets_mb, act_example, mesh=None,
                   axis_name: str = "pp", data_axis: Optional[str] = None):
    """:func:`pipeline_1f1b`'s signature and result under the GPipe
    schedule (every forward, then every backward; M graphs in
    flight): the JAX ``gpipe_spmd`` differentiated."""
    return _pipeline("FThenB", stage_fn, stage_params, shared_params,
                     inputs_mb, targets_mb, act_example, mesh, axis_name,
                     data_axis)


@torch.no_grad()
def gpipe_spmd(stage_fn: Callable, stage_params, x_microbatches,
               mesh=None, axis_name: str = "pp"):
    """The JAX ``gpipe_spmd`` forward, one process a stage:
    ``stage_fn(stage_params, x) -> y`` applies this rank's stage (its
    share of the layers; ``y`` of ``x``'s shape and dtype);
    ``x_microbatches`` [M, micro, ...] enter stage 0.  Returns the last
    stage's outputs [M, micro, ...] on every rank (broadcast from it).
    Training differentiates through :func:`pipeline_gpipe`."""
    mesh, group = _pp_group(mesh, axis_name)
    S, s = group.nranks, group.rank
    xs = x_microbatches
    outs = []
    for m in range(xs.shape[0]):
        x = xs[m] if s == 0 else collective.recv_forward(
            xs.shape[1:], xs.dtype, xs.device, group)
        y = stage_fn(stage_params, x)
        if s < S - 1:
            collective.send_forward(y, group)
        else:
            outs.append(y)
    out = torch.stack(outs) if outs else torch.empty_like(xs)
    return collective.broadcast(out.contiguous(), src=group.ranks[-1],
                                group=group)


# ----------------------------------------------------------- the layers
class LayerDesc:
    """A layer to build later, on the stage that holds it (the
    reference's ``pp_layers.py`` ``LayerDesc``)."""

    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build_layer(self):
        return self.layer_cls(*self.args, **self.kwargs)


class SharedLayerDesc(LayerDesc):
    """A layer every stage that lists it holds alike, its gradients
    summed over them (``key`` names it; ``forward_func(layer, x)``, when
    given, is how this place in the list uses it: a tied head reads the
    embedding's ``shared_weight_attr``)."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


#: build arguments that do not change what a layer is (which card, which
#: random draws): left out of the placement's likeness test
_BUILD_ONLY = ("device", "seed", "generator")


def _frozen(v):
    """A value-comparable digest of a build argument: numbers, strings,
    containers and dataclasses by value, anything else by identity."""
    if isinstance(v, (int, float, bool, str, bytes, type(None))):
        return v
    if isinstance(v, (tuple, list)):
        return ("seq", tuple(_frozen(e) for e in v))
    if isinstance(v, dict):
        return ("dict", tuple(sorted((repr(k), _frozen(x))
                                     for k, x in v.items())))
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return ("dc", type(v).__name__, tuple(
            (f.name, _frozen(getattr(v, f.name)))
            for f in dataclasses.fields(v)))
    if isinstance(v, (torch.dtype, torch.device)):
        return str(v)
    return ("opaque", id(v))


def _signature(entry):
    """What makes two entries of a layer list alike for the placement:
    a desc's class and build arguments, a built module's class and
    parameter shapes; a shared desc is alike to nothing."""
    if isinstance(entry, SharedLayerDesc):
        return ("shared", id(entry))
    if isinstance(entry, LayerDesc):
        kw = {k: v for k, v in entry.kwargs.items() if k not in _BUILD_ONLY}
        return ("desc", entry.layer_cls, _frozen(entry.args), _frozen(kw))
    if isinstance(entry, nn.Module):
        return ("module", type(entry), tuple(
            (n, tuple(p.shape), p.dtype) for n, p in entry.named_parameters()))
    return ("opaque", id(entry))


def stage_segments(entries: Sequence, n_stages: int) -> List[tuple]:
    """``(start, stop)`` of each stage in ``entries`` (descs, modules or
    functions): the JAX compiled path's placement (``_split_stages``).
    The body is the longest run of alike entries, cut to a multiple of
    ``n_stages`` (its spare tail joins the epilogue) and split evenly;
    the prologue before it goes with stage 0, the epilogue after it with
    the last stage.  Raises when no body of ``n_stages`` entries
    exists."""
    if not entries:
        raise ValueError("PipelineLayer has no layers")
    sigs = [_signature(e) for e in entries]
    best_start, best_len, start = 0, 1, 0
    for i in range(1, len(sigs) + 1):
        if i == len(sigs) or sigs[i] != sigs[start]:
            if i - start > best_len:
                best_start, best_len = start, i - start
            start = i
    per = best_len // n_stages
    if per == 0:
        raise ValueError(
            f"no homogeneous body of >= {n_stages} layers found for "
            f"{n_stages} pipeline stages (longest run: {best_len})")
    bounds = [best_start + k * per for k in range(n_stages + 1)]
    bounds[0], bounds[-1] = 0, len(entries)
    return [(bounds[k], bounds[k + 1]) for k in range(n_stages)]


class PipelineLayer(nn.Module):
    """A model as a list of layers (descs, modules or functions) cut
    into ``num_stages`` stages (the reference's ``pp_layers.py:159``).

    With a mesh whose ``pp`` axis has ``num_stages`` ranks, this rank
    builds only its stage's layers, each registered under its global
    index in the list; a :class:`SharedLayerDesc` is built once on every
    stage that lists it and registered as ``shared_layers.<key>``.
    Without such a mesh the process is every stage: it builds every
    layer (the reference's single controller), and :meth:`forward` runs
    them all (the ``pp`` = 1 path).  ``loss_fn(output, label)`` is the
    last stage's loss (default: cross entropy over the last dim).
    ``activation_shape(mb_input) -> (shape, dtype)`` gives the
    activation between stages for a stage-0 microbatch input (this
    rank's rows); a pipeline of more than one stage needs it.
    ``topology``, ``seg_method`` and ``recompute_interval`` are taken
    for the reference's signature: the placement is
    :func:`stage_segments`', and recomputation is the layers' own."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 activation_shape=None, **kwargs):
        super().__init__()
        entries = list(layers)
        mesh = get_mesh()
        pp = mesh.shape.get("pp", 1) if mesh is not None else 1
        self._num_stages = int(num_stages or pp)
        self._loss_fn = loss_fn
        self.activation_shape = activation_shape
        self._segments = stage_segments(entries, self._num_stages)
        self._entries = entries
        distributed = pp > 1 and pp == self._num_stages
        self.stage_id = mesh.axis_rank("pp") if distributed else None
        lo, hi = self._segments[self.stage_id] if distributed \
            else (0, len(entries))
        self._held = (lo, hi)
        self.shared_layers = nn.ModuleDict()
        self.run_function = []
        for i in range(lo, hi):
            self.run_function.append(self._build(i, entries[i]))
        self._shared_groups = self._make_shared_groups(mesh) \
            if distributed else {}

    def _build(self, i, entry):
        if isinstance(entry, SharedLayerDesc):
            key = entry.layer_name
            if key not in self.shared_layers:
                self.shared_layers[key] = entry.build_layer()
            layer = self.shared_layers[key]
            if entry.forward_func is None:
                return layer
            return functools.partial(entry.forward_func, layer)
        layer = entry.build_layer() if isinstance(entry, LayerDesc) \
            else entry
        if isinstance(layer, nn.Module):
            self.add_module(str(i), layer)
        return layer

    def _make_shared_groups(self, mesh):
        """``{key: group}`` of the shared layers this stage holds, over
        the stages that list each key (every rank makes every group, in
        one order, as ``torch.distributed`` asks)."""
        keys = collections.OrderedDict()
        for i, e in enumerate(self._entries):
            if isinstance(e, SharedLayerDesc):
                stage = next(k for k, (a, b) in enumerate(self._segments)
                             if a <= i < b)
                keys.setdefault(e.layer_name, set()).add(stage)
        out = {}
        pp_dim = mesh.axis_names.index("pp")
        lines = np.moveaxis(mesh.rank_array, pp_dim, -1).reshape(
            -1, mesh.shape["pp"]).tolist()
        for key, stages in keys.items():
            if len(stages) < 2:
                continue
            for line in lines:
                ranks = [line[k] for k in sorted(stages)]
                g = mesh.group("pp") if len(ranks) == len(line) else \
                    collective.new_group(ranks, axis_name="pp")
                if collective.get_rank() in ranks:
                    out[key] = g
        return out

    @property
    def num_stages(self) -> int:
        return self._num_stages

    def get_stage_layers(self, stage_id):
        """Stage ``stage_id``'s layers, where this process holds them."""
        lo, hi = self._segments[stage_id]
        if not (self._held[0] <= lo and hi <= self._held[1]):
            raise ValueError(f"stage {stage_id}'s layers live on another "
                             f"rank (this one holds stage {self.stage_id})")
        return self.run_function[lo - self._held[0]:hi - self._held[0]]

    def forward(self, x):
        for layer in self.run_function:
            x = layer(x)
        return x

    def loss(self, output, label):
        if self._loss_fn is not None:
            return self._loss_fn(output, label)
        return nn.functional.cross_entropy(
            output.reshape(-1, output.shape[-1]).float(),
            label.reshape(-1).long())


class PipelineParallel(nn.Module):
    """A :class:`PipelineLayer` trained with the pipeline schedule (the
    reference's ``pipeline_parallel.py:31``): ``accumulate_steps`` M and
    ``schedule_mode`` (``"1F1B"``, default, or ``"FThenB"``) come from
    ``strategy.pipeline_configs``.  On a mesh with a ``pp`` axis of
    the layer's stage count it runs one stage a rank; without one, every
    stage in this process (no hops)."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel wraps a PipelineLayer, got "
                            f"{type(layers).__name__}")
        self._layers = layers
        self._hcg = hcg
        cfg = (strategy.pipeline_configs or {}) if strategy is not None \
            else {}
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.schedule_mode = _schedule_name(cfg.get("schedule_mode", "1F1B"))
        mesh = get_mesh()
        self._group = mesh.group("pp") if layers.stage_id is not None \
            else None
        self._data_group = mesh.group("dp") if mesh is not None and \
            mesh.shape.get("dp", 1) > 1 else None
        for p in layers.parameters():
            # the schedule averages these gradients over dp itself
            p._pipeline_reduced = True
        if self._group is not None and self._group.nranks > 1:
            # a global-norm clip sums the stages' totals over pp, each
            # shared weight counted on the first stage holding it
            for p in layers.parameters():
                p._pipeline_norm = (self._group, True)
            for key, g in layers._shared_groups.items():
                for p in layers.shared_layers[key].parameters():
                    p._pipeline_norm = (self._group, g.rank == 0)
        self.last_stats: Optional[ScheduleStats] = None

    def forward(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    @property
    def is_first_stage(self):
        return self._group is None or self._group.rank == 0

    @property
    def is_last_stage(self):
        return self._group is None or \
            self._group.rank == self._group.nranks - 1

    def _microbatches(self, t, device):
        M = self.accumulate_steps
        t = torch.as_tensor(t).to(device)
        t = t.reshape((M, t.shape[0] // M) + tuple(t.shape[1:]))
        if self._data_group is not None:
            n, r = self._data_group.nranks, self._data_group.rank
            if t.shape[1] % n:
                raise ValueError(f"microbatch {t.shape[1]} not divisible "
                                 f"by dp={n}")
            rows = t.shape[1] // n
            t = t[:, r * rows:(r + 1) * rows]
        return t

    def forward_backward_pipeline(self, data):
        """The schedule over ``data`` = ``(inputs, labels)`` [B, ...]
        (the whole batch, on every rank): each rank's gradients in its
        parameters' ``.grad``, averaged over dp and summed over the
        stages of each shared layer; returns the mean loss, the same on
        every rank (a 0-dim f32 tensor)."""
        x, y = data
        M = self.accumulate_steps
        B = x.shape[0]
        if B % M:
            raise ValueError(
                f"batch {B} not divisible by accumulate_steps {M}")
        layers = self._layers
        device = next(layers.parameters()).device
        xs, ys = self._microbatches(x, device), self._microbatches(y, device)
        first, last = self.is_first_stage, self.is_last_stage
        if self._group is not None and self._group.nranks > 1:
            if layers.activation_shape is None:
                raise ValueError("a pipeline of more than one stage needs "
                                 "PipelineLayer(activation_shape=...)")
            shape, dtype = layers.activation_shape(xs[0])
        else:
            shape, dtype = (), torch.float32

        def stage_forward(i, h):
            h = xs[i] if first else h
            for fn in layers.run_function:
                h = fn(h)
            if last:
                return None, layers.loss(h, ys[i])
            return h, None

        loss, self.last_stats = run_schedule(
            stage_forward, M, self._group, tuple(shape), dtype, device,
            self.schedule_mode)
        if self._group is not None:
            loss = collective.all_reduce(loss, group=self._group)
        for key, g in layers._shared_groups.items():
            for p in layers.shared_layers[key].parameters():
                if p.grad is not None:
                    collective.all_reduce(p.grad, group=g)
        if self._data_group is not None:
            loss = collective.mean_rounded_once(loss.clone(),
                                                self._data_group)
            for p in layers.parameters():
                if p.grad is not None:
                    collective.mean_rounded_once(p.grad, self._data_group)
        return loss.detach()

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One step: the schedule (:meth:`forward_backward_pipeline`),
        ``optimizer.step()``, ``optimizer.clear_grad()`` and the LR
        scheduler's step; returns the mean loss.  A ``scaler`` raises
        (amp is not ported)."""
        B, M = data[0].shape[0], self.accumulate_steps
        if B % M:
            raise ValueError(
                f"batch {B} not divisible by accumulate_steps {M}")
        if scaler is not None:
            raise NotImplementedError(_AMP)
        loss = self.forward_backward_pipeline(data)
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

