"""Program-rewrite passes (``paddle_tpu/static/passes.py``; reference:
paddle/fluid/framework/ir/pass.h Pass/PassRegistry and its fusion
passes).

``fuse_linear_act`` substitutes the pattern ``linear`` -> activation
with one ``fused_linear`` op, which calls
``kernels.fused_linear.fused_linear``: on CUDA tensors the hand-written
kernel, on CPU tensors its plain version (the tensor's device decides;
there is no branch on the backend).  ``eliminate_dead_ops`` drops ops
nothing reads.  After every rewrite a structural check of the Program
runs (the JAX package's ``analysis.verify_after_pass``): each Variable an
op reads is fed or produced before it, each name has one producer, and
each backward op's targets are defined.  Because the port's backward op
names its targets and inputs rather than an op index, a pass may run
before or after ``append_backward`` / ``minimize``.
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, List

from ..kernels.fused_linear import fused_linear
from .graph import OpDesc

_REGISTRY: Dict[str, Callable] = {}


class ProgramVerificationError(ValueError):
    pass


def register_pass(name: str):
    """``@register_pass("fuse_linear_act")``: the pass is
    ``fn(block, keep=(), **kwargs) -> number of rewrites``; ``keep``
    names the Variables that must survive (fetch targets)."""

    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_pass(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"no pass named {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_passes() -> List[str]:
    return sorted(_REGISTRY)


def verify(program, pass_name="") -> None:
    """Raise :class:`ProgramVerificationError` unless every Variable an
    op reads is a feed or produced by an earlier op, no name has two
    producers, and every backward op's targets are defined."""
    for block in program.blocks:
        defined = {n for n, v in block.vars.items() if v.is_data}
        for i, op in enumerate(block.ops):
            for v in op.var_inputs():
                if v.name not in defined:
                    what = "target" if op.type == "backward" and any(
                        v is r for _, r in op.inputs[:op.extra["n_targets"]]
                    ) else "input"
                    raise ProgramVerificationError(
                        f"after pass {pass_name!r}: op {i} ({op.type}) reads "
                        f"{what} {v.name!r} before any op defines it")
            for o in op.outputs:
                if o.name in defined:
                    raise ProgramVerificationError(
                        f"after pass {pass_name!r}: {o.name!r} has a second "
                        f"producer, op {i} ({op.type})")
                defined.add(o.name)


def apply_pass(program, name: str, **kwargs) -> int:
    """Apply one pass to every block; returns the number of rewrites.
    The Program is verified after any rewrite."""
    fn = get_pass(name)
    total = sum(fn(block, **kwargs) or 0 for block in program.blocks)
    if total:
        verify(program, name)
    return total


def apply_build_strategy(program, passes=("fuse_linear_act",
                                          "eliminate_dead_ops"),
                         keep=()) -> int:
    """The BuildStrategy bundle.  ``keep`` names the Program's fetch
    targets; without it eliminate_dead_ops cannot tell a fetched terminal
    op from dead code, so that pass is skipped."""
    return sum(apply_pass(program, p, keep=keep) for p in passes
               if keep or p != "eliminate_dead_ops")


def _consumers(block):
    """Variable name -> the ops that read it."""
    out = {}
    for op in block.ops:
        for v in op.var_inputs():
            out.setdefault(v.name, []).append(op)
    return out


# ------------------------------------------------------------------
# fuse_linear_act: linear -> {gelu, relu, silu, swish} => fused_linear
# ------------------------------------------------------------------
_ACT_OPS = {"gelu": "gelu", "relu": "relu", "silu": "silu", "swish": "silu"}


def _fused_linear_op(x, weight, bias=None, *, activation):
    return fused_linear(x, weight, bias, activation=activation)


@register_pass("fuse_linear_act")
def fuse_linear_act(block, keep=()) -> int:
    """Fuse a ``linear`` whose output has a single consumer, a
    gelu / relu / silu / swish of it alone, into one ``fused_linear`` op
    (reference: fc_fuse_pass + fused_gemm_epilogue).  ``keep`` names
    fetch targets: a pre-activation that is fetched survives.  The tanh
    gelu (``gelu_tanh``) is not fused, as in the JAX package."""
    keep = set(keep)
    consumers = _consumers(block)
    fused_acts = set()
    new_ops = []
    rewrites = 0
    for op in block.ops:
        if id(op) in fused_acts:
            continue
        act = None
        if op.type == "linear" and op.writeback is None and op.single \
                and op.outputs[0].name not in keep:
            users = consumers.get(op.outputs[0].name, [])
            if len(users) == 1:
                user = users[0]
                if (user.type in _ACT_OPS and user.writeback is None
                        and user.single and len(user.inputs) == 1):
                    act = user
        if act is None:
            new_ops.append(op)
            continue
        fused_acts.add(id(act))
        new_ops.append(OpDesc(
            "fused_linear", functools.partial(
                _fused_linear_op, activation=_ACT_OPS[act.type]),
            list(op.inputs), op.spec, list(act.outputs), act.out_spec))
        rewrites += 1
    if rewrites:
        block.ops[:] = new_ops
    return rewrites


# ------------------------------------------------------------------
# eliminate_dead_ops
# ------------------------------------------------------------------
@register_pass("eliminate_dead_ops")
def eliminate_dead_ops(block, keep=()) -> int:
    """Drop ops that write no state and whose outputs nobody reads and
    ``keep`` does not name; to a fixed point."""
    keep = set(keep)
    removed_total = 0
    while True:
        consumers = _consumers(block)
        kept = [op for op in block.ops
                if op.writeback is not None or op.type == "backward"
                or any(o.name in keep or consumers.get(o.name)
                       for o in op.outputs)]
        removed = len(block.ops) - len(kept)
        block.ops[:] = kept
        removed_total += removed
        if not removed:
            return removed_total
