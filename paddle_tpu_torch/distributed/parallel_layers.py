"""Tensor-parallel layers and the collectives they differentiate through
(the port of ``paddle_tpu/distributed/parallel_layers.py``).

The reference holds whole weights and lets GSPMD insert the
collectives; inside ``shard_map`` it uses four custom-VJP ops.  The port
holds each rank's part of a weight (``sharding.Placement``) and calls
those four ops explicitly, as ``torch.autograd.Function``s over a
model-parallel group (the Megatron f/g pair and its gather/scatter):

- :func:`mp_allreduce`: sum forward, identity backward (a row-parallel
  output);
- :func:`mp_identity`: identity forward, sum backward (a
  column-parallel input);
- :func:`mp_all_gather`: concatenate the last dim forward, this rank's
  slice backward;
- :func:`mp_scatter`: this rank's slice of the last dim forward,
  concatenate backward.

Sums over a group round once to the tensor's dtype
(``collective.sum_rounded_once``: two bf16 partials summed in bf16,
more in f32 and rounded to bf16 once).  Every row-parallel product
(``RowParallelLinear``, :func:`sharded_matmul` for a model laid out by
the executor or fleet, a MoE expert's down product) keeps each rank's
partial product in f32 (:func:`f32_partial`) and rounds the f32 sum
once, as the unsharded product rounds its f32 accumulator once.

``ColumnParallelLinear``, ``RowParallelLinear`` and
``VocabParallelEmbedding`` hold the reference's weights ([in, out],
embeddings [vocab, hidden]) split over the model-parallel axis, drawn
whole from one seeded generator on every rank and sliced, so every rank
holds its part of one initialisation.  ``ParallelCrossEntropy`` is a
real vocab-parallel softmax cross entropy: the max, the sum of
exponentials and the label's logit all-reduced over the group (the
reference leaves that to GSPMD).

For a model laid out by ``executor.MeshExecutor``, :func:`sharded_matmul`,
:func:`column_input` and :func:`sharded_embedding` read a weight's
placement: dims split over ``fsdp`` are gathered for the product and
never kept (the backward gathers again and keeps this rank's slice of
the weight's gradient: the batch is whole along ``fsdp``, so every rank
of the group computes that gradient alike), and the model-parallel dim
makes the product column- or row-parallel.
"""
from __future__ import annotations

import contextlib
import random
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device, tf32_if_exact
from . import collective
from .mesh import _active_mesh, get_hybrid_communicate_group, model_axis
from .sharding import PartitionSpec, Placement, placement_of

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RNGStatesTracker", "RowParallelLinear", "VocabParallelEmbedding",
           "column_input", "fsdp_gather", "get_rng_state_tracker",
           "model_parallel_random_seed", "mp_all_gather", "mp_allreduce",
           "mp_identity", "mp_scatter", "sharded_embedding",
           "sharded_matmul", "vocab_parallel_cross_entropy"]


def _mp_group(group=None) -> collective.Group:
    """``group``, else the hybrid group's model-parallel group, else the
    active mesh's ``tp``/``mp`` axis, else this rank alone."""
    if group is not None:
        return group
    hcg = get_hybrid_communicate_group()
    if hcg is not None:
        return hcg.get_model_parallel_group()
    mesh = _active_mesh()
    axis = model_axis(mesh)
    if axis is None:
        return collective.Group([collective.get_rank()])
    return mesh.group(axis)


class _Identity(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return collective.sum_rounded_once(g.clone(), ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return collective.sum_rounded_once(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.width = group, x.shape[-1]
        return torch.cat(collective.all_gather(None, x.contiguous(),
                                               group=group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g.narrow(-1, ctx.group.rank * w, w).contiguous(), None


class _ScatterLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        w = x.shape[-1] // group.nranks
        return x.narrow(-1, group.rank * w, w).contiguous()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(collective.all_gather(None, g.contiguous(),
                                               group=ctx.group),
                         dim=-1), None


def _apply(fn, x, group):
    g = _mp_group(group)
    return x if g.nranks == 1 else fn.apply(x, g)


def mp_allreduce(x, group=None):
    """Sum over the model-parallel group forward; identity backward."""
    return _apply(_AllReduce, x, group)


def mp_identity(x, group=None):
    """Identity forward; sum over the model-parallel group backward."""
    return _apply(_Identity, x, group)


def mp_all_gather(x, group=None):
    """Every rank's last-dim part concatenated forward; this rank's
    slice of the gradient backward."""
    return _apply(_AllGatherLast, x, group)


def mp_scatter(x, group=None):
    """This rank's part of the last dim forward; the parts' gradients
    concatenated backward."""
    return _apply(_ScatterLast, x, group)


# ------------------------------------------------------ fsdp (executor)
def _gather_dim(w, group, dim):
    return torch.cat(collective.all_gather(None, w.contiguous(),
                                           group=group), dim=dim)


def _own(full, group, dim, average=False):
    """This rank's slice of ``full`` along ``dim``; with ``average``, the
    slices averaged over ``group`` (a reduce-scatter) first: its ranks
    computed ``full`` from different rows."""
    if average:
        parts = list(full.chunk(group.nranks, dim=dim))
        out = torch.empty_like(parts[0],
                               memory_format=torch.contiguous_format)
        collective.reduce_scatter(out, parts, collective.ReduceOp.AVG,
                                  group)
        return out
    n = full.shape[dim] // group.nranks
    return full.narrow(dim, group.rank * n, n).contiguous()


def _zero_part(w, pl, dim) -> bool:
    """Whether ``w``'s split along ``dim`` is a ZeRO stage-3 part over
    fleet's ``sharding`` axis, whose ranks take different rows (its
    gradient is averaged over them), not an ``fsdp`` split."""
    return getattr(w, "_zero_stage", 0) >= 3 and \
        pl.dims[dim] == ("sharding",)


class _FSDPGather(torch.autograd.Function):
    """The whole of ``w`` along ``dim`` over ``group``; backward, this
    rank's slice of the gradient (the group computed it alike), or with
    ``average`` the group's slices averaged."""

    @staticmethod
    def forward(ctx, w, group, dim, average=False):
        ctx.group, ctx.dim, ctx.average = group, dim, average
        return _gather_dim(w, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.group, ctx.dim, ctx.average), None, None, None


def _f32_product(x, w):
    """``x @ w`` (w [in, out], or a batch of them) unrounded, in f32: on
    the card, of bf16 or f16 operands, cuBLAS's product with an f32
    output; else the f32 product (TF32 on the card, which holds such
    operands exactly)."""
    if x.is_cuda and w.dtype == x.dtype and \
            x.dtype in (torch.bfloat16, torch.float16):
        if w.dim() == 2:
            y = torch.mm(x.reshape(-1, x.shape[-1]), w,
                         out_dtype=torch.float32)
            return y.reshape(*x.shape[:-1], w.shape[-1])
        return torch.bmm(x, w, out_dtype=torch.float32)
    with tf32_if_exact(x.dtype):
        return x.float() @ w.float()


class _F32Partial(torch.autograd.Function):
    """:func:`_f32_product`; the backward rounds the f32 gradient to the
    operands' dtype first, as the gradient of a product rounded to it
    comes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _f32_product(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = g @ w.transpose(-1, -2)
        if ctx.needs_input_grad[1]:
            dw = x.transpose(-1, -2) @ g if w.dim() == 3 else \
                x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw


def f32_partial(x, w):
    """``x @ w`` unrounded, in f32 (:func:`_f32_product`): a
    row-parallel rank's partial product, summed in f32 before its one
    rounding."""
    return _F32Partial.apply(x, w)


class _ShardedMatmul(torch.autograd.Function):
    """``x @ W`` of a weight laid out on a mesh, W this rank's part
    ``w`` gathered along ``fdim`` over ``fgroup`` (its ``fsdp`` or
    stage-3 parts; None: whole) and not kept: the backward gathers it
    again for dx and keeps this rank's slice of dW (with ``average``,
    the group's slices averaged).  With ``mgroup`` (a row-parallel
    weight) the partial products are f32 (:func:`_f32_product`), summed
    over the model-parallel group and rounded once to x's dtype; the
    backward is the unsharded product's, the sum's gradient being the
    output's."""

    @staticmethod
    def forward(ctx, x, w, fgroup, fdim, average, mgroup):
        ctx.save_for_backward(x, w)
        ctx.fgroup, ctx.fdim, ctx.average = fgroup, fdim, average
        W = w if fgroup is None else _gather_dim(w, fgroup, fdim)
        if mgroup is None:
            return x @ W
        return collective.sum_rounded_once(_f32_product(x, W),
                                           mgroup).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        W = w if ctx.fgroup is None else _gather_dim(w, ctx.fgroup, ctx.fdim)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = g @ W.t()
        if ctx.needs_input_grad[1]:
            dw = x.reshape(-1, x.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
            if ctx.fgroup is not None:
                dw = _own(dw, ctx.fgroup, ctx.fdim, ctx.average)
            dw = dw.to(w.dtype)
        return dx, dw, None, None, None, None


def _split(pl: Placement):
    """(model dim, model group, [(dim, group)] of the other splits)."""
    axis = model_axis(pl.mesh)
    mdim = pl.dim_of(axis) if axis is not None else None
    other = [(d, pl.group(d)) for d in range(len(pl.dims))
             if pl.parts(d) > 1 and d != mdim]
    if mdim is not None and pl.dims[mdim] != (axis,):
        raise NotImplementedError(
            f"a dim split over {pl.dims[mdim]} mixes the model-parallel "
            "axis with others")
    return mdim, (pl.mesh.group(axis) if mdim is not None else None), other


def fsdp_gather(w):
    """``w`` whole along its dims split over axes other than the
    model-parallel one (differentiable; the gradient comes back as this
    rank's slice)."""
    pl = placement_of(w)
    if pl is None:
        return w
    whole = w
    for d, g in _split(pl)[2]:
        whole = _FSDPGather.apply(whole, g, d, _zero_part(w, pl, d))
    return whole


def column_input(x, weight):
    """``x`` as the input of column-parallel products with ``weight``
    (:func:`mp_identity` when its output features are split over the
    model-parallel axis); apply it once to an input several such
    products share."""
    pl = placement_of(weight)
    if pl is None:
        return x
    mdim, mgroup, _ = _split(pl)
    return mp_identity(x, mgroup) if mdim == 1 else x


def sharded_matmul(x, weight):
    """``x @ weight`` of a weight [in, out] laid out by its placement:
    gathered along its other splits, row-parallel (the partial products
    summed in f32 over the model-parallel group and rounded once,
    :class:`_ShardedMatmul`) when its input features are split
    there.  A column-parallel input goes through :func:`column_input`
    first."""
    pl = placement_of(weight)
    if pl is None:
        return x @ weight
    mdim, mgroup, other = _split(pl)
    if len(other) > 1:
        raise NotImplementedError("a weight split along both dims outside "
                                  "the model-parallel axis")
    if mdim != 0 and not other:
        return x @ weight
    fdim, fgroup = other[0] if other else (None, None)
    return _ShardedMatmul.apply(
        x, weight, fgroup, fdim,
        bool(other) and _zero_part(weight, pl, fdim),
        mgroup if mdim == 0 else None)


def _vocab_lookup(ids, w, group):
    """Rows of the vocab-parallel table part ``w`` [V/n, h]: ids outside
    this rank's range masked to zero before the sum over ``group``."""
    vloc = w.shape[0]
    loc = ids.long() - group.rank * vloc
    inside = (loc >= 0) & (loc < vloc)
    e = F.embedding(loc.clamp(0, vloc - 1), w)
    e = e * inside[..., None].to(e.dtype)
    return mp_allreduce(e, group)


def sharded_embedding(ids, weight):
    """``weight[ids]`` of a table [vocab, hidden] laid out by its
    placement: gathered along its other splits, vocab-parallel when its
    rows are split over the model-parallel axis."""
    pl = placement_of(weight)
    if pl is None:
        return F.embedding(ids, weight)
    mdim, mgroup, _ = _split(pl)
    w = fsdp_gather(weight)
    if mdim == 0:
        return _vocab_lookup(ids, w, mgroup)
    return F.embedding(ids, w)


# ------------------------------------------------------------- layers
def _init_full(shape, generator, device, dtype, kind):
    w = torch.empty(shape, device=device, dtype=torch.float32)
    if kind == "xavier":
        bound = (6.0 / (shape[0] + shape[1])) ** 0.5
        w.uniform_(-bound, bound, generator=generator)
    else:
        w.normal_(0.0, 1.0, generator=generator)
    return w.to(dtype)


class _ParallelLayer(nn.Module):
    def _param(self, shape, spec, kind, generator, device, dtype, zero=False):
        """A parameter holding this rank's part of a whole tensor drawn
        from ``generator`` (the same on every rank), split along the
        dim whose ``spec`` entry is ``"mp"``."""
        full = torch.zeros(shape, device=device, dtype=dtype) if zero else \
            _init_full(shape, generator, device, dtype, kind)
        if self.group.nranks == 1 or "mp" not in spec:
            return nn.Parameter(full)
        mesh = _active_mesh()
        if mesh is None or model_axis(mesh) is None:
            raise ValueError("a model-parallel layer over more than one "
                             "rank needs an installed mesh with a tp or "
                             "mp axis")
        pl = Placement(mesh, PartitionSpec(
            *[self.axis if e == "mp" else e for e in spec]), shape)
        if pl.parts(spec.index("mp")) != self.group.nranks:
            raise ValueError(f"{shape} does not split over "
                             f"{self.group.nranks} model-parallel ranks")
        p = nn.Parameter(pl.local(full))
        p.placement = pl
        return p

    def _setup(self, mp_group, device):
        self.group = _mp_group(mp_group)
        self.world_size = self.group.nranks
        self.axis = model_axis(_active_mesh()) or "mp"
        return resolve_device(device)


class ColumnParallelLinear(_ParallelLayer):
    """``x @ W + b`` with W [in, out] split by output features over the
    model-parallel group; ``gather_output`` concatenates the parts."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = self._setup(mp_group, device)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        self.weight = self._param((in_features, out_features), (None, "mp"),
                                  "xavier", generator, device, dtype)
        self.bias = self._param((out_features,), ("mp",), None, None,
                                device, dtype, zero=True) \
            if has_bias else None

    def forward(self, x):
        out = mp_identity(x, self.group) @ self.weight
        if self.bias is not None:
            out = out + self.bias
        return mp_all_gather(out, self.group) if self.gather_output else out


class RowParallelLinear(_ParallelLayer):
    """``x @ W + b`` with W [in, out] split by input features over the
    model-parallel group: the f32 partial products summed over it and
    rounded once (:class:`_ShardedMatmul`), then the (replicated) bias
    added once.  Without ``input_is_parallel`` the input is whole and
    each rank takes its part."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        device = self._setup(mp_group, device)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self.weight = self._param((in_features, out_features), ("mp", None),
                                  "xavier", generator, device, dtype)
        self.bias = self._param((out_features,), (), None, None, device,
                                dtype, zero=True) if has_bias else None

    def forward(self, x):
        if not self.input_is_parallel:
            x = mp_scatter(x, self.group)
        out = _ShardedMatmul.apply(
            x, self.weight, None, None, False,
            self.group if self.group.nranks > 1 else None)
        return out + self.bias if self.bias is not None else out


class VocabParallelEmbedding(_ParallelLayer):
    """A [vocab, hidden] table split by rows over the model-parallel
    group: ids outside a rank's rows are masked before the sum."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        device = self._setup(mp_group, device)
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = self._param((num_embeddings, embedding_dim),
                                  ("mp", None), "normal", generator, device,
                                  dtype)

    def forward(self, x):
        if self.group.nranks == 1:
            return F.embedding(x, self.weight)
        return _vocab_lookup(x, self.weight, self.group)


class _VocabParallelCE(torch.autograd.Function):
    """Per-row softmax cross entropy of logits split by vocabulary over
    ``group``, in f32: the max all-reduced, then the sum of
    exponentials and the label's shifted logit (the rank owning its
    column gives it, the others 0) all-reduced together, two
    collectives in all; rows labelled ``ignore_index`` give 0 and no
    gradient.  The backward is softmax minus one-hot over the rank's
    own columns, with no collective."""

    @staticmethod
    def forward(ctx, logits, labels, group, ignore_index):
        x = logits.float()          # becomes the probabilities, in place
        if x is logits:
            x = x.clone()
        vloc = x.shape[-1]
        gmax = x.max(dim=-1).values
        collective.all_reduce(gmax, collective.ReduceOp.MAX, group=group)
        x.sub_(gmax[..., None])
        valid = labels != ignore_index
        loc = labels.long() - group.rank * vloc
        inside = (loc >= 0) & (loc < vloc) & valid
        loc = loc.clamp(0, vloc - 1)
        both = torch.stack([x.gather(-1, loc[..., None])[..., 0] * inside,
                            x.exp_().sum(dim=-1)])
        collective.all_reduce(both, group=group)
        picked, total = both[0], both[1]
        loss = (total.log() - picked) * valid
        ctx.save_for_backward(x.div_(total[..., None]), loc, inside, valid)
        ctx.dtype = logits.dtype
        return loss

    @staticmethod
    def backward(ctx, g):
        probs, loc, inside, valid = ctx.saved_tensors
        grad = probs * (g * valid)[..., None]
        onehot = torch.zeros_like(grad).scatter_(
            -1, loc[..., None], (g * inside)[..., None].to(grad.dtype))
        return (grad - onehot).to(ctx.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, labels, group=None,
                                 ignore_index=-100):
    """Per-row cross entropy (f32) of vocab-split ``logits`` [..., V/n]
    against whole-vocabulary ``labels`` [...]."""
    return _VocabParallelCE.apply(logits, labels, _mp_group(group),
                                  ignore_index)


class ParallelCrossEntropy(nn.Module):
    """The reference's vocab-parallel softmax cross entropy: per-row
    losses [...] (``reduction="none"``) of logits [..., V/n] split by
    vocabulary over the model-parallel group; labels [...] or
    [..., 1]."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.mp_group = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label[..., 0]
        return vocab_parallel_cross_entropy(input, label, self.mp_group,
                                            self.ignore_index)


# ---------------------------------------------------------------- rng
class RNGStatesTracker:
    """Named random streams (the reference's ``RNGStatesTracker``): each
    a ``torch.Generator`` on the CPU; :meth:`rng_state` makes one the
    default CPU generator's state while the block runs and keeps where
    the stream got to."""

    def __init__(self):
        self.states_ = {}
        self.seeds_ = set()

    def add(self, name, seed):
        if seed in self.seeds_:
            raise ValueError(f"seed {seed} already exists")
        self.seeds_.add(seed)
        self.states_[name] = torch.Generator().manual_seed(seed).get_state()

    @contextlib.contextmanager
    def rng_state(self, name="model_parallel_rng"):
        if name not in self.states_:
            raise ValueError(f"unknown rng region {name}")
        saved = torch.get_rng_state()
        torch.set_rng_state(self.states_[name])
        try:
            yield
        finally:
            self.states_[name] = torch.get_rng_state()
            torch.set_rng_state(saved)


_RNG_TRACKER = RNGStatesTracker()


def get_rng_state_tracker() -> RNGStatesTracker:
    return _RNG_TRACKER


def model_parallel_random_seed(seed: Optional[int] = None):
    """Seed the default generator with ``seed`` (every rank alike) and a
    fresh tracker with ``model_parallel_rng`` (``seed + 1 +`` this
    rank's model-parallel coordinate: dropout differs across the parts
    of a split activation) and ``global_seed`` (``seed``, the same on
    every rank), as the original Paddle seeds them."""
    global _RNG_TRACKER
    seed = seed or (1024 + random.randint(0, 10000))
    group = _mp_group()
    _RNG_TRACKER = RNGStatesTracker()
    torch.manual_seed(seed)
    _RNG_TRACKER.add("global_seed", seed)
    _RNG_TRACKER.add("model_parallel_rng", seed + 1 + max(group.rank, 0))
