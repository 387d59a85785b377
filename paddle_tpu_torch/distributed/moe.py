"""Mixture of experts with expert parallelism (the port of
``paddle_tpu/distributed/moe.py``, and the expert-parallel half of
``models.llama.LlamaMoEMLP``).

The reference's gates (GShard top-2 with its ``second_policy``, Switch
top-1 with its ``jitter_eps``; both arguments taken and, as there,
unused), ``ExpertMLP`` (stacked expert FFNs with biases, gelu / silu /
relu), ``MoELayer`` and ``MoEMLP``.  The reference dispatches and
combines with einsums against a [tokens, E, C] one-hot; the same
function, as (expert, slot, gate) triples, goes through the MoE kernels
(``kernels.moe_dispatch``, one dispatch and one combine launch a layer,
each the other's backward): a choice's slot is the gate's own rule (a
first choice's running count among first choices, a second choice's
among second choices after every kept first choice), a dropped choice
gets the slot C, which the kernels skip.  What stays plain PyTorch: the
router's product and softmax, the slot arithmetic (cumulative sums),
the expert FFN's batched products, biases and activation, and the
aux loss.

Expert parallelism (``ExpertLayout``, :func:`expert_ffn`).  The
reference computes on global arrays under GSPMD; the port holds it to
that on a mesh of ranks, one process a rank, the expert stacks split
along dim 0 over the expert axis (``expert``, or fleet's ``ep``) and
their other dims over ``fsdp``, the batch split along the data ranks
only, so the tokens are replicated across the expert ranks:

(a) capacity and slots are global: C comes from the GLOBAL token
    count, and a choice's slot counts the choices of the lower data
    ranks first (each data rank's per-expert counts, all-gathered over
    the data group: E integers a rank), so the same choices drop as in
    the unsharded layer;
(b) nothing is held whole: a rank dispatches its data rank's rows to
    its own E/ep experts only, into a local buffer [E/ep, C_loc, M]
    (C_loc = min(C, the rank's rows): a slot local to the data rank,
    the drop decided by the global one), and gathers only its experts'
    ``fsdp`` parts.  Since every expert rank already holds the rows,
    the dispatch needs no exchange; the one exchange is the return: the
    combine of the rank's own choices in f32, all-reduced (summed) over
    the expert group, [rows, M] f32 a layer forward, and in the
    backward the tokens' f32 gradient partials the same way and the
    gates' gradients (each choice's nonzero on one rank);
(c) the rounding stays single: a token's K rows are summed in f32 and
    rounded once to the model's dtype after the sum over ranks (for
    K = 2, the kernel's ``w0 r0 + w1 r1`` exactly);
(d) the expert stacks' gradients are reduced by the caller over the
    data ranks only (``MeshExecutor.reduce_gradients``), never over the
    expert axis; the router's gradient is whole on every expert rank
    (the gates' gradients are summed over it).

Non-local choices reach the kernels remapped to expert 0 and slot
C_loc, a slot the kernels skip (``routed`` in ``csrc/moe_dispatch.cu``
checks 0 <= e < E and 0 <= s < C before any row is read or written).

Stacks split over the model-parallel axis as well (tp, or fleet's
``mp``; the reference's ``(expert, fsdp, tp)`` for ``w_gate``/``w_up``
and ``(expert, tp, fsdp)`` for ``w_down``) make each expert's FFN
Megatron-parallel: gate and up column-parallel, down row-parallel, so a
tp rank's expert rows are partial sums over its columns.  The router and
the routing stay replicated (every tp rank routes the same rows the same
way, so the slots and the capacity agree), and the tp ranks join the
expert group (``ExpertLayout.group``): the partial rows, kept in f32, go
through the same f32 combine and the same one sum over the group before
the one rounding, and the backward's partials (the tokens' and the
gates') are summed over it too.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..kernels.moe_dispatch import (_combine, _dispatch, _weights_grad,
                                    moe_combine, moe_dispatch)
from . import collective
from .env import get_rank
from .sharding import PartitionSpec, Placement, placement_of

__all__ = ["ExpertLayout", "ExpertMLP", "MoELayer", "MoEMLP", "expert_ffn",
           "data_mean", "top1_gating", "top2_gating"]


# --------------------------------------------------------------- layout
def _data_group(mesh):
    """The ranks that hold other rows of the batch: the executor's data
    group on its mesh, else fleet's data axes."""
    from .executor import current_executor

    ex = current_executor()
    if ex is not None and ex.mesh is mesh:
        return ex.data_group()
    axes = tuple(a for a in ("dp", "data", "sharding") if a in mesh.shape)
    return mesh.group(*axes) if axes else collective.Group([get_rank()])


class ExpertLayout:
    """Where a layer's expert stacks lie, read from a stack's placement:
    this rank's experts ``[e0, e0 + E_loc)``, the expert group (the
    hybrid group's expert-parallel group under fleet, else the stack's
    dim-0 group) and the data group.  Without a placement: every expert
    here, groups of one."""

    def __init__(self, stack, num_experts: int):
        pl = placement_of(stack)
        me = collective.Group([get_rank()])
        self.num_experts = num_experts
        self.placement = pl
        self.tp_axis = None
        if pl is None or pl.replicated:
            self.E_loc, self.e0 = num_experts, 0
            self.group = me
            self.data = me if pl is None else _data_group(pl.mesh)
            return
        from .mesh import get_hybrid_communicate_group, model_axis

        axis = model_axis(pl.mesh)
        self.tp_axis = axis if axis is not None and axis in pl.axes \
            else None
        self.E_loc = pl.local_shape[0]
        self.e0 = pl.index(0) * self.E_loc
        self.group = me
        if self.tp_axis is not None:
            # the expert ranks' and the tp ranks' partial outputs are
            # summed together, in f32, before the one rounding
            self.group = pl.mesh.group(*pl.dims[0], self.tp_axis)
        elif pl.parts(0) > 1:
            hcg = get_hybrid_communicate_group()
            hg = hcg.get_expert_parallel_group() if hcg is not None and \
                getattr(hcg, "_mesh", None) is pl.mesh else None
            self.group = hg if hg is not None and \
                hg.nranks == pl.parts(0) else pl.group(0)
        self.data = _data_group(pl.mesh)

    @property
    def data_ranks(self) -> int:
        return max(1, self.data.nranks)

    @property
    def sharded(self) -> bool:
        return self.placement is not None and not self.placement.replicated

    def gather(self, w):
        """A stack whole along its splits other than the expert dim and
        the tp dim (its ``fsdp`` parts, or fleet's stage-3 ``sharding``
        parts), differentiable (the backward keeps this rank's slice of
        the gradient: the ``fsdp`` group computed it alike; averaged over
        ``sharding``, whose ranks took other rows)."""
        from .parallel_layers import _FSDPGather, _zero_part

        pl = placement_of(w)
        if pl is None:
            return w
        whole = w
        for d in range(1, len(pl.dims)):
            if pl.parts(d) > 1 and self.tp_axis not in pl.dims[d]:
                whole = _FSDPGather.apply(whole, pl.group(d), d,
                                          _zero_part(w, pl, d))
        return whole

    def lower_counts(self, counts):
        """``(sum over the lower data ranks, sum over all)`` of each data
        rank's ``counts`` (an int tensor), all-gathered over the data
        group."""
        if self.data_ranks == 1 or self.data.rank < 0:
            return torch.zeros_like(counts), counts
        dev = collective.comm_device(self.data)
        parts = collective.all_gather(None, counts.to(dev),
                                      group=self.data)
        stack = torch.stack(parts).to(counts.device)
        return stack[:self.data.rank].sum(0), stack.sum(0)


def _counts(eidx, E):
    return torch.bincount(eidx.reshape(-1).long(), minlength=E)


def running_slots(eidx, E):
    """Each choice's running count among the earlier choices of its
    expert, rows major and choices minor (int64 [n, K])."""
    flat = eidx.reshape(-1, 1).long()
    onehot = torch.zeros((flat.shape[0], E), dtype=torch.int64,
                         device=eidx.device).scatter_(1, flat, 1)
    return (onehot.cumsum(0) - onehot).gather(1, flat).reshape(eidx.shape)


def global_slots(eidx, sidx, layout: ExpertLayout):
    """``sidx`` (running counts over this data rank's choices) made the
    counts over the global token order: the lower data ranks' counts of
    each choice's expert added."""
    lower, _ = layout.lower_counts(_counts(eidx, layout.num_experts))
    return sidx.long() + lower[eidx.long()]


# --------------------------------------------------- the routed exchange
class _EPDispatch(torch.autograd.Function):
    """This rank's choices of its own experts into [E_loc, C_loc, M]
    (the dispatch kernel); backward, the tokens' gradient: this rank's
    f32 partial (the combine kernel over f32 rows) summed over the
    expert group and rounded once."""

    @staticmethod
    def forward(ctx, tokens, le, ls, E_loc, C_loc, group):
        ctx.save_for_backward(le, ls)
        ctx.group, ctx.dtype = group, tokens.dtype
        ones = torch.ones(le.shape, dtype=tokens.dtype, device=le.device)
        return _dispatch(tokens, le, ls, ones, E_loc, C_loc)

    @staticmethod
    def backward(ctx, g):
        le, ls = ctx.saved_tensors
        ones = torch.ones(le.shape, dtype=torch.float32, device=le.device)
        part = _combine(g.float().contiguous(), le, ls, ones)
        if ctx.group.nranks > 1:
            collective.all_reduce(part, group=ctx.group)
        return part.to(ctx.dtype), None, None, None, None, None


class _EPCombine(torch.autograd.Function):
    """Each token's output from this rank's expert rows: the f32
    combine (the kernel over f32 rows and gates) summed over the expert
    group, rounded once; backward, the rows' gradient (the dispatch
    kernel) and the gates' (each choice's on its expert's rank, summed
    over the group)."""

    @staticmethod
    def forward(ctx, eo, le, ls, w, group, dtype):
        ctx.save_for_backward(eo, le, ls, w)
        ctx.group = group
        out = _combine(eo.float(), le, ls, w.float())
        if group.nranks > 1:
            collective.all_reduce(out, group=group)
        return out.to(dtype)

    @staticmethod
    def backward(ctx, g):
        eo, le, ls, w = ctx.saved_tensors
        E_loc, C_loc, _ = eo.shape
        g = g.contiguous()
        d_eo = dw = None
        if ctx.needs_input_grad[0]:
            d_eo = _dispatch(g, le, ls, w, E_loc, C_loc).to(eo.dtype)
        if ctx.needs_input_grad[3]:
            dw = _weights_grad(eo, g, le, ls, C_loc).to(w.dtype)
            if ctx.group.nranks > 1:
                collective.sum_rounded_once(dw, ctx.group)
        return d_eo, None, None, dw, None, None


def expert_ffn(tokens, eidx, slot, kept, weights, C, layout: ExpertLayout,
               ffn):
    """The routed FFN of this rank's rows ``tokens`` [n, M] on a mesh:
    the choices ``eidx`` [n, K] of this rank's experts dispatched to
    their data-rank-local ``slot`` (kept where ``kept``: the global slot
    below C), ``ffn`` on the local buffer [E_loc, C_loc, M], and each
    token's K rows combined with ``weights`` (the module docstring).
    With stacks split over tp, ``ffn`` gives this rank's partial rows
    (best in f32), summed with the others' over ``layout.group``; the
    output is in the tokens' dtype."""
    n = tokens.shape[0]
    C_loc = max(1, min(C, n))
    local = (eidx >= layout.e0) & (eidx < layout.e0 + layout.E_loc)
    le = torch.where(local, eidx - layout.e0, 0).int()
    ls = torch.where(local & kept, slot, C_loc).int()
    disp = _EPDispatch.apply(tokens, le, ls, layout.E_loc, C_loc,
                             layout.group)
    return _EPCombine.apply(ffn(disp), le, ls, weights, layout.group,
                            tokens.dtype)


class _DataMean(torch.autograd.Function):
    """The mean over the data group forward; identity backward (each
    data rank's loss holds the mean, and the gradients are averaged
    over the data ranks afterwards)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        collective.all_reduce(out, collective.ReduceOp.AVG, group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_mean(x, layout: ExpertLayout):
    """``x``'s mean over the data ranks (itself with one)."""
    if layout.data_ranks == 1 or layout.data.rank < 0:
        return x
    return _DataMean.apply(x, layout.data)


# ---------------------------------------------------------------- gates
def _aux(probs, first, E, layout):
    """GShard's load-balance loss, E * sum(me * ce), of the global
    token means."""
    me = data_mean(probs.mean(0), layout)
    ce = data_mean(F.one_hot(first, E).float().mean(0), layout)
    return (me * ce).sum() * E


def top2_gating(logits, capacity, layout: ExpertLayout,
                second_policy="all"):
    """GShard top-2 of f32 ``logits`` [T, E]: ``(eidx, slot, local,
    kept, weights, aux)``, each [T, 2] but aux: the global slots (first
    choices' running counts, second choices' after every kept first
    choice), the data-rank-local slots, the kept mask, the combine
    weights (each choice's probability over the two's sum, 0 where
    dropped)."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    g1 = probs.argmax(-1)
    p1 = probs.gather(1, g1[:, None])[:, 0]
    wo1 = probs * (1.0 - F.one_hot(g1, E).to(probs.dtype))
    g2 = wo1.argmax(-1)
    p2 = wo1.gather(1, g2[:, None])[:, 0]
    aux = _aux(probs, g1, E, layout)
    c1, c2 = _counts(g1, E), _counts(g2, E)
    s1 = running_slots(g1[:, None], E)[:, 0]
    s2 = running_slots(g2[:, None], E)[:, 0]
    lower, total = layout.lower_counts(torch.stack([c1, c2]))
    gs1 = s1 + lower[0][g1]
    kept1 = gs1 < capacity
    gs2 = s2 + lower[1][g2] + torch.clamp(total[0], max=capacity)[g2]
    kept2 = gs2 < capacity
    denom = p1 + p2 + 1e-9
    w = torch.stack([(p1 / denom) * kept1.to(p1.dtype),
                     (p2 / denom) * kept2.to(p2.dtype)], 1)
    return (torch.stack([g1, g2], 1), torch.stack([gs1, gs2], 1),
            torch.stack([s1, c1[g2] + s2], 1), torch.stack([kept1, kept2], 1),
            w, aux)


def top1_gating(logits, capacity, layout: ExpertLayout, jitter_eps=0.0):
    """Switch top-1 of f32 ``logits`` [T, E]: the same six, each [T, 1]
    but aux; the weight is the choice's probability, 0 where dropped."""
    T, E = logits.shape
    probs = torch.softmax(logits, dim=-1)
    g = probs.argmax(-1)
    p = probs.gather(1, g[:, None])[:, 0]
    aux = _aux(probs, g, E, layout)
    s = running_slots(g[:, None], E)[:, 0]
    lower, _ = layout.lower_counts(_counts(g, E))
    gs = s + lower[g]
    kept = gs < capacity
    w = p * kept.to(p.dtype)
    return g[:, None], gs[:, None], s[:, None], kept[:, None], w[:, None], aux


# --------------------------------------------------------------- layers
def _mesh_axis(name):
    """The installed mesh (else the executor's) and its axis of the
    role ``name``."""
    from .mesh import _active_mesh, _axis

    mesh = _active_mesh()
    return mesh, _axis(mesh, name)


class _Linear(nn.Module):
    """Bias-free [in, out] projection (the reference's
    ``nn.Linear(..., bias_attr=False)``)."""

    def __init__(self, weight):
        super().__init__()
        self.weight = nn.Parameter(weight)

    def forward(self, x):
        from .parallel_layers import sharded_matmul

        return sharded_matmul(x, self.weight)


class ExpertMLP(nn.Module):
    """Stacked expert FFNs: w1 [E, d_model, d_hidden], b1 [E, 1,
    d_hidden], w2 [E, d_hidden, d_model], b2 [E, 1, d_model] (Xavier
    uniform weights from ``generator``, zero biases), laid out along the
    installed mesh's expert axis (``ep`` or ``expert``) when it has
    one."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu",
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        device = resolve_device(device)
        self.num_experts = num_experts
        self.activation = activation

        def xavier(fan_in, fan_out):
            w = torch.empty((num_experts, fan_in, fan_out), dtype=dtype,
                            device=device)
            bound = math.sqrt(6.0 / (fan_in + fan_out))
            return nn.Parameter(w.uniform_(-bound, bound,
                                           generator=generator))

        def zeros(width):
            return nn.Parameter(torch.zeros((num_experts, 1, width),
                                            dtype=dtype, device=device))

        with torch.no_grad():
            self.w1 = xavier(d_model, d_hidden)
            self.b1 = zeros(d_hidden)
            self.w2 = xavier(d_hidden, d_model)
            self.b2 = zeros(d_model)
        mesh, axis = _mesh_axis("ep")
        if axis is not None:
            for p in (self.w1, self.b1, self.w2, self.b2):
                pl = Placement(mesh, PartitionSpec(axis), p.shape)
                if not pl.replicated:
                    p.data = pl.local(p.data)
                    p.placement = pl

    def _act(self, h):
        if self.activation == "gelu":
            return F.gelu(h, approximate="tanh")
        if self.activation in ("silu", "swish"):
            return F.silu(h)
        return F.relu(h)

    def forward(self, x):
        """x: [E (this rank's experts), C, d_model] -> the same shape."""
        h = self._act(torch.bmm(x, self.w1) + self.b1)
        return torch.bmm(h, self.w2) + self.b2


class MoELayer(nn.Module):
    """The reference's ``MoELayer``: a bias-free gate [d_model, E]
    (``gate.weight``), top-2 GShard gating (``gate="gshard"`` and
    ``top_k >= 2``) or top-1 Switch gating (any other), capacity
    ``max(int(capacity_factor * T * top_k / E), 1)`` over the GLOBAL T,
    dispatch and combine through the MoE kernels; ``aux_loss`` holds
    the load-balance loss of the last forward."""

    def __init__(self, d_model, d_hidden=None, num_experts=8, top_k=2,
                 capacity_factor=1.25, gate: str = "gshard", experts=None,
                 ep_group=None, recompute_interval=0, activation="gelu",
                 name=None, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        device = resolve_device(device)
        self.d_model = d_model
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.gate_type = gate if isinstance(gate, str) else "gshard"
        w = torch.empty((d_model, num_experts), dtype=dtype, device=device)
        bound = 1.0 / math.sqrt(d_model)
        with torch.no_grad():
            w.uniform_(-bound, bound, generator=generator)
        self.gate = _Linear(w)
        self.experts = experts if experts is not None else ExpertMLP(
            num_experts, d_model, d_hidden or 4 * d_model, activation,
            device=device, dtype=dtype, generator=generator)
        self.aux_loss = None

    def forward(self, x):
        shape = x.shape
        flat = x.reshape(-1, self.d_model)
        E = self.num_experts
        layout = ExpertLayout(self.experts.w1, E)
        T = flat.shape[0] * layout.data_ranks
        capacity = max(int(self.capacity_factor * T * self.top_k / E), 1)
        logits = self.gate(flat).float()
        if self.gate_type == "gshard" and self.top_k >= 2:
            eidx, slot, local, kept, w, aux = top2_gating(logits, capacity,
                                                          layout)
        else:
            eidx, slot, local, kept, w, aux = top1_gating(logits, capacity,
                                                          layout)
        self.aux_loss = aux
        w = w.to(x.dtype)
        if not layout.sharded:
            sidx = torch.where(kept, slot, capacity).int()
            eidx = eidx.int()
            disp = moe_dispatch(flat, eidx, sidx, torch.ones_like(w), E,
                                capacity)
            out = moe_combine(self.experts(disp), eidx, sidx, w)
        else:
            out = expert_ffn(flat, eidx, local, kept, w, capacity, layout,
                             self.experts)
        return out.reshape(shape)


class MoEMLP(MoELayer):
    pass
