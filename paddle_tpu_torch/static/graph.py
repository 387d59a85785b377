"""Static-graph mode of the port: Program / Block / Variable / Executor
(``paddle_tpu/static/graph.py``), in PyTorch's idiom.

* **Recording.**  While static mode is on, a
  ``torch.overrides.TorchFunctionMode`` sees every PyTorch call.  A call
  that touches a :class:`Variable` and returns tensors is appended to the
  current :class:`Block` as an :class:`OpDesc`; its output shapes come
  from running the same call on meta tensors (the InferShape analog of
  ``jax.eval_shape``).  A call whose result holds no tensor (``.shape``,
  ``.dim()``, ``.dtype``) is answered from the meta value and not
  recorded.  A call on concrete tensors alone runs eagerly (constant
  folding).  The port's functionals (``nn.functional``) are one op each,
  by name.  In-place calls on a Variable raise, and so does a concrete
  input that was computed from a parameter while recording (it would go
  stale after the first update).
* **Backward.**  ``append_backward`` / ``gradients`` append one
  ``backward`` op naming its targets and the tensors to differentiate
  (``wrt``), not an op index, so no pass can leave it pointing past its
  own position.  ``Executor.run`` interprets the ops with autograd on:
  the backward op is ``torch.autograd.grad`` of the sum of its targets
  (each contracted with its cotangent when given); an unused input gets
  zeros; ``no_grad_set`` outputs are detached where they are produced.
* **State.**  Ops from :func:`record_writeback_op` (optimizer updates,
  the step count) write live tensors in place under ``torch.no_grad()``,
  PyTorch's counterpart of the JAX executor's writeback.
* **Executor.**  ``Executor.run`` prunes the ops to what the fetches
  (and, unless the Program is a ``clone(for_test=True)``, the state
  writes) need, then interprets them with the recorder switched off, on
  its device (``device.resolve_device``: cuda unless asked for cpu).

Not ported yet (each raises ``NotImplementedError``): control flow
(``cond`` / ``while_loop`` / ``switch_case``), ``Scope`` and
``save/load_inference_model`` (ROADMAP §A4).
"""
from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..device import resolve_device

_DTYPES = {"float32": torch.float32, "float16": torch.float16,
           "bfloat16": torch.bfloat16, "float64": torch.float64,
           "int32": torch.int32, "int64": torch.int64, "bool": torch.bool}


def to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {dtype!r}")
    return _DTYPES[dtype]


# =====================================================================
# Variables
# =====================================================================
class Variable(torch.Tensor):
    """A symbolic tensor of a Program: a meta tensor (shape, strides and
    dtype, no data) with ``name``, ``block``, ``declared_shape`` (a
    feed's dims as declared, None or -1 for free ones), ``is_data`` and
    ``persistable``.  Its ``.device`` is ``meta``."""

    __torch_function__ = torch._C._disabled_torch_function_impl
    name = None          # shadows TensorBase.name, which is read-only

    def numpy(self):
        raise RuntimeError(
            f"Variable '{self.name}' is symbolic; run it through "
            "Executor.run(fetch_list=[var]) to get a value")

    def __repr__(self):
        return (f"Variable(name={self.name}, shape={list(self.shape)}, "
                f"dtype={self.dtype})")

    __str__ = __repr__


def _make_variable(meta, name, block, declared_shape=None, is_data=False):
    v = torch.Tensor._make_subclass(Variable, meta.detach())
    v.name, v.block = name, block
    v.declared_shape = declared_shape
    v.is_data = is_data
    v.persistable = False
    return v


class Parameter(nn.Parameter):
    """A parameter of a static Program (:func:`create_parameter`): an
    ``nn.Parameter`` that carries a ``name``, which
    ``apply_decay_param_fun`` reads."""

    name = None          # shadows TensorBase.name, which is read-only


# =====================================================================
# Program representation
# =====================================================================
class OpDesc:
    """One recorded call.  ``inputs``: the flattened arguments as
    ``(kind, ref)``: ``var`` a Variable, ``const`` a live concrete
    tensor (a parameter: read at run time, so updates are seen), ``raw``
    a Python value.  ``spec`` rebuilds ``(args, kwargs)`` from them;
    ``out_spec`` is the result's tree, None for an op that returns
    nothing.  ``outputs`` are the Variables of the result's tensors.  ``writeback`` is None for a
    pure op, else the live tensors its outputs are copied into after it
    runs (an empty list for an op that only changes state)."""

    __slots__ = ("type", "fn", "inputs", "spec", "outputs", "out_spec",
                 "writeback", "extra")

    def __init__(self, type, fn, inputs, spec, outputs, out_spec=None,
                 writeback=None, extra=None):
        self.type = type
        self.fn = fn
        self.inputs = inputs
        self.spec = spec
        self.outputs = outputs
        self.out_spec = out_spec
        self.writeback = writeback
        self.extra = extra or {}

    @property
    def single(self) -> bool:
        """The op returns one tensor."""
        return len(self.outputs) == 1 and self.out_spec is not None \
            and self.out_spec.num_leaves == 1

    def var_inputs(self):
        return [ref for kind, ref in self.inputs if kind == "var"]


class Block:
    def __init__(self, program: "Program", idx: int = 0):
        self.program = program
        self.idx = idx
        self.ops: List[OpDesc] = []
        self.vars: Dict[str, Variable] = {}

    def create_var(self, meta, name=None, declared_shape=None,
                   is_data=False) -> Variable:
        name = name or self.program._unique_name("tmp")
        v = _make_variable(meta, name, self, declared_shape, is_data)
        self.vars[name] = v
        return v

    def append_op(self, op: OpDesc):
        self.ops.append(op)


class Program:
    """A recorded op list (the ProgramDesc analog).  One block: control
    flow, which would add sub-blocks, is not ported yet."""

    def __init__(self):
        self.blocks: List[Block] = [Block(self)]
        self._for_test = False
        self._name_counter = itertools.count()
        # persistable initializers: [(parameter, init_fn)]
        self._startup_actions: list = []

    def global_block(self) -> Block:
        return self.blocks[0]

    current_block = global_block

    def _unique_name(self, prefix: str) -> str:
        return f"{prefix}_{next(self._name_counter)}"

    def clone(self, for_test: bool = False) -> "Program":
        """A Program sharing this one's ops and parameters;
        ``for_test=True`` makes the Executor prune the backward op and
        every state write, so running it moves no parameter."""
        p = Program()
        p.blocks = self.blocks
        p._startup_actions = self._startup_actions
        p._for_test = for_test
        return p

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx}:")
            for op in b.ops:
                ins = [r.name if k == "var" else k for k, r in op.inputs]
                outs = [o.name for o in op.outputs]
                lines.append(f"  {op.type}({ins}) -> {outs}")
        return "\n".join(lines)


# =====================================================================
# Mode and builder state
# =====================================================================
class _BuilderState(threading.local):
    def __init__(self):
        self.main_program: Optional[Program] = None
        self.startup_program: Optional[Program] = None
        self.recorder: Optional["_Recorder"] = None


_builder = _BuilderState()


def enable_static():
    """Record PyTorch calls on Variables into the current Program."""
    st = _builder
    if st.recorder is None:
        default_main_program()
        st.recorder = _Recorder()
        st.recorder.__enter__()


def disable_static():
    st = _builder
    if st.recorder is not None:
        rec, st.recorder = st.recorder, None
        rec.__exit__(None, None, None)


def in_static_mode() -> bool:
    return _builder.recorder is not None


def default_main_program() -> Program:
    st = _builder
    if st.main_program is None:
        st.main_program = Program()
        st.startup_program = Program()
    return st.main_program


def default_startup_program() -> Program:
    default_main_program()
    return _builder.startup_program


@contextlib.contextmanager
def program_guard(main_program: Program,
                  startup_program: Optional[Program] = None):
    st = _builder
    prev = (st.main_program, st.startup_program)
    st.main_program = main_program
    if startup_program is not None:
        st.startup_program = startup_program
    try:
        yield
    finally:
        st.main_program, st.startup_program = prev


def _not_ported(what):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"paddle_tpu_torch.static: {what} is not ported yet "
            "(ROADMAP §A4, the static frontend's remaining items)")
    fn.__name__ = what.split()[0]
    return fn


cond = _not_ported("cond (control flow)")
while_loop = _not_ported("while_loop (control flow)")
switch_case = _not_ported("switch_case (control flow)")
Scope = _not_ported("Scope")
global_scope = _not_ported("global_scope (Scope)")
save_inference_model = _not_ported("save_inference_model")
load_inference_model = _not_ported("load_inference_model")


# =====================================================================
# Recording
# =====================================================================
def data(name, shape, dtype="float32") -> Variable:
    """A feed placeholder: free dims (None or -1) are recorded as 1 and
    the declared shape is checked at feed time."""
    declared = list(shape)
    concrete = [1 if (d is None or d < 0) else int(d) for d in declared]
    meta = torch.empty(concrete, dtype=to_dtype(dtype), device="meta")
    return default_main_program().global_block().create_var(
        meta, name=name, declared_shape=declared, is_data=True)


_INPLACE_DUNDERS = {"__iadd__", "__isub__", "__imul__", "__itruediv__",
                    "__ifloordiv__", "__imod__", "__ipow__", "__iand__",
                    "__ior__", "__ixor__", "__ilshift__", "__irshift__",
                    "__setitem__", "__imatmul__"}


def _op_name(func) -> str:
    name = getattr(func, "__name__", None) or type(func).__name__
    if name == "__get__":           # a property: Tensor.T, .mT, ...
        name = getattr(getattr(func, "__self__", None), "__name__", name)
    if name.startswith("__") and name.endswith("__"):
        name = name[2:-2]             # __add__ -> add, __getitem__ -> getitem
    return name


def _is_inplace(func, kwargs) -> bool:
    name = getattr(func, "__name__", "")
    return (name in _INPLACE_DUNDERS or "out" in kwargs
            or (name.endswith("_") and not name.endswith("__")))


class _Recorder(TorchFunctionMode):
    """Appends calls on Variables to the current block (see the module
    docstring).  PyTorch pops the mode while this handler runs, so the
    handler's own tensor calls run as they are."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, spec = tree_flatten((args, kwargs))
        if not any(isinstance(leaf, Variable) for leaf in flat):
            return func(*args, **kwargs)      # constant folding
        return record_op(func, flat, spec, _is_inplace(func, kwargs))


def _meta(leaf, op_type):
    """What stands for ``leaf`` when the op runs on meta tensors."""
    if isinstance(leaf, Variable):
        return leaf
    if isinstance(leaf, torch.Tensor):
        if leaf.grad_fn is not None:
            raise ValueError(
                f"static: op '{op_type}' reads a concrete tensor computed "
                f"from a parameter while recording ({leaf.grad_fn.name()}); "
                "it would keep the parameter's value at record time after "
                "every update.  Compute it from a Variable, or pass the "
                "parameter itself")
        return leaf.detach().to("meta")
    if isinstance(leaf, torch.Generator):
        return None                   # random draws do not change shapes
    return leaf


def _entry(leaf):
    if isinstance(leaf, Variable):
        return ("var", leaf)
    if isinstance(leaf, torch.Tensor):
        return ("const", leaf)
    return ("raw", leaf)


def _block_of(leaves, block=None):
    """The block of the first Variable among ``leaves`` (an op goes to
    its inputs' Program, inside ``program_guard`` or not), else
    ``block``, else the default main Program's."""
    for leaf in leaves:
        if isinstance(leaf, Variable):
            return leaf.block
    return block or default_main_program().global_block()


def record_op(func, flat, spec, inplace=False):
    """Append ``func`` called on the flattened arguments ``flat`` (with
    their tree ``spec``) to the block of its Variables; return its
    result with Variables in place of its tensors."""
    op_type = _op_name(func)
    if inplace:
        raise ValueError(
            f"static: in-place op '{op_type}' on a Variable; a Program "
            "records pure ops (use the out-of-place form)")
    metas = [_meta(leaf, op_type) for leaf in flat]
    args, kwargs = tree_unflatten(metas, spec)
    out = func(*args, **kwargs)
    out_flat, out_spec = tree_flatten(out)
    if not any(isinstance(o, torch.Tensor) for o in out_flat):
        return out                    # .shape, .dim(), .dtype, ...
    blk = _block_of(flat)
    leaves = [blk.create_var(o, name=blk.program._unique_name(op_type))
              if isinstance(o, torch.Tensor) else o for o in out_flat]
    outputs = [v for v in leaves if isinstance(v, Variable)]
    blk.append_op(OpDesc(op_type, func, [_entry(leaf) for leaf in flat],
                         spec, outputs, out_spec))
    return tree_unflatten(leaves, out_spec)


def record_writeback_op(name, fn, leaves, targets, block=None):
    """Record an op that changes live state: ``fn(*values of leaves)``
    returns one tensor per target (a tuple, or the tensor for one
    target), copied into ``targets`` in place under ``torch.no_grad()``
    after the op runs (skipped for a returned tensor that is its target,
    which ``fn`` updated itself).  ``leaves``: Variables, live tensors
    or Python values.  The op
    goes to the block of its first Variable, else to ``block``, else to
    the default main Program.  Returns the output Variables."""
    blk = _block_of(leaves, block)
    entries = [_entry(leaf) for leaf in leaves]
    outputs = [blk.create_var(
        torch.empty_like(t, device="meta"),
        name=blk.program._unique_name(name)) for t in targets]
    out_spec = tree_flatten(outputs[0] if len(outputs) == 1
                            else tuple(outputs))[1]
    flat_spec = tree_flatten((tuple(0 for _ in leaves), {}))[1]
    blk.append_op(OpDesc(name, fn, entries, flat_spec, outputs,
                         out_spec if outputs else None,
                         writeback=list(targets)))
    return outputs


# =====================================================================
# append_backward / gradients
# =====================================================================
def _param_name(p) -> str:
    return getattr(p, "name", None) or f"param_{id(p)}"


def _referenced_params(block: Block):
    """Trainable parameters the ops read, in order of first use."""
    seen, out = set(), []
    for op in block.ops:
        for kind, ref in op.inputs:
            if (kind == "const" and isinstance(ref, nn.Parameter)
                    and ref.requires_grad and id(ref) not in seen):
                seen.add(id(ref))
                out.append(ref)
    return out


def _names(no_grad_set):
    return {n if isinstance(n, str) else n.name for n in no_grad_set or ()}


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """Record the gradient of ``loss`` with respect to the parameters
    (``parameter_list``, or every trainable parameter the Program reads)
    minus those named in ``no_grad_set``; returns ``[(param, grad_var)]``
    (reference: fluid/backward.py append_backward)."""
    skip = _names(no_grad_set)
    params = parameter_list or _referenced_params(loss.block)
    params = [p for p in params if _param_name(p) not in skip]
    return list(zip(params, _record_backward([loss], params, None,
                                             no_grad_set)))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Gradients of the sum of ``targets`` (each contracted with its
    cotangent in ``target_gradients`` when given) with respect to
    ``inputs``: Variables or parameters (paddle.static.gradients)."""
    targets = list(targets) if isinstance(targets, (list, tuple)) \
        else [targets]
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and not isinstance(
            target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    return _record_backward(targets, inputs, target_gradients, no_grad_set)


def _record_backward(targets, wrt, target_gradients, no_grad_set):
    blk = targets[0].block
    cots = list(target_gradients or [None] * len(targets))
    if len(cots) != len(targets):
        raise ValueError("one target gradient per target")
    grads = [blk.create_var(
        torch.empty_like(w, device="meta"),
        name=blk.program._unique_name(f"{_param_name(w)}@GRAD"))
        for w in wrt]
    present = [c for c in cots if c is not None]
    blk.append_op(OpDesc(
        "backward", None,
        [_entry(t) for t in targets] + [_entry(w) for w in wrt]
        + [_entry(c) for c in present], None, grads,
        extra={"n_targets": len(targets), "n_wrt": len(wrt),
               "has_cotangent": [c is not None for c in cots],
               "no_grad_names": _names(no_grad_set)}))
    return grads


# =====================================================================
# Executor
# =====================================================================
def _prune_ops(block: Block, fetch_names, include_writebacks: bool):
    """The ops the fetches (and, for training, the state writes) need,
    in order (the reference's program pruning)."""
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if (any(o.name in needed for o in op.outputs)
                or (include_writebacks and op.writeback is not None)):
            keep.append(op)
            needed.update(v.name for v in op.var_inputs())
    return keep[::-1]


def _to_numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


class Executor:
    """Runs Programs on ``place`` (a device; ``None`` means cuda, as
    every entry point of the port: pass ``"cpu"`` for the plain
    versions of the kernels)."""

    def __init__(self, place=None):
        self.device = resolve_device(place)

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, return_numpy=True):
        program = program or default_main_program()
        fetch_list = fetch_list if isinstance(fetch_list, (list, tuple)) \
            else ([] if fetch_list is None else [fetch_list])
        with torch._C.DisableTorchFunction():     # not recorded
            if not program.global_block().ops and program._startup_actions:
                with torch.no_grad():
                    for _, init_fn in program._startup_actions:
                        init_fn()
                return []
            fetches = self._run(program, feed or {}, fetch_list)
            return [_to_numpy(f) for f in fetches] if return_numpy \
                else fetches

    def _feed(self, block, feed):
        env = {}
        for name, value in feed.items():
            t = value if isinstance(value, torch.Tensor) \
                else torch.from_numpy(np.ascontiguousarray(value))
            var = block.vars.get(name)
            decl = None if var is None else var.declared_shape
            if decl is not None and not (
                    t.dim() == len(decl) and all(
                        d is None or d < 0 or d == s
                        for d, s in zip(decl, t.shape))):
                raise ValueError(f"feed '{name}' has shape {tuple(t.shape)} "
                                 f"but the program declares {list(decl)}")
            env[name] = t.to(self.device)
        return env

    def _run(self, program, feed, fetch_list):
        block = program.global_block()
        fetch_names = [f if isinstance(f, str) else f.name
                       for f in fetch_list if not _is_const(f)]
        ops = _prune_ops(block, fetch_names, not program._for_test)
        produced = {o.name for op in ops for o in op.outputs}
        required = {v.name for op in ops for v in op.var_inputs()
                    if v.name not in produced}
        required |= {n for n in fetch_names
                     if n not in produced and n in block.vars
                     and block.vars[n].is_data}
        missing = required - set(feed)
        if missing:
            raise ValueError(f"feed is missing required input(s) "
                             f"{sorted(missing)}; the program consumes "
                             f"feeds {sorted(required)}")
        env = self._feed(block, feed)
        backward = [op for op in ops if op.type == "backward"]
        wrt = {r.name for op in backward
               for k, r in op.inputs[op.extra["n_targets"]:][
                   :op.extra["n_wrt"]] if k == "var"}
        no_grad = set().union(*(op.extra["no_grad_names"]
                                for op in backward))
        for name in wrt & set(env):
            env[name] = env[name].detach().requires_grad_()
        grad_mode = torch.enable_grad() if backward else torch.no_grad()
        with grad_mode:
            for op in ops:
                if op.type == "backward":
                    self._backward(op, env, retain=op is not backward[-1])
                else:
                    self._op(op, env, wrt, no_grad)
        return [f if _is_const(f) else env[f if isinstance(f, str)
                                           else f.name]
                for f in fetch_list]

    @staticmethod
    def _value(kind, ref, env):
        if kind == "var":
            return env[ref.name]
        return ref

    def _op(self, op, env, wrt, no_grad):
        vals = [self._value(k, r, env) for k, r in op.inputs]
        args, kwargs = tree_unflatten(vals, op.spec)
        out = op.fn(*args, **kwargs)
        if op.out_spec is None:
            return
        out_flat = tree_flatten(out)[0]
        tensors = [o for o in out_flat if isinstance(o, torch.Tensor)]
        if len(tensors) != len(op.outputs):
            raise RuntimeError(f"op '{op.type}' returned {len(tensors)} "
                               f"tensors, recorded {len(op.outputs)}")
        for var, t in zip(op.outputs, tensors):
            if var.name in no_grad:
                t = t.detach()
            if var.name in wrt and not t.requires_grad:
                t = t.detach().requires_grad_()
            env[var.name] = t
        if op.writeback:
            with torch.no_grad():
                for target, t in zip(op.writeback, tensors):
                    if t is not target:
                        target.copy_(t)

    def _backward(self, op, env, retain):
        n_t, n_w = op.extra["n_targets"], op.extra["n_wrt"]
        targets = [self._value(k, r, env) for k, r in op.inputs[:n_t]]
        wrt = [self._value(k, r, env) for k, r in op.inputs[n_t:n_t + n_w]]
        cots = iter(self._value(k, r, env) for k, r in op.inputs[n_t + n_w:])
        total = None
        for t, has_cot in zip(targets, op.extra["has_cotangent"]):
            term = t.float() * next(cots).float() if has_cot else t.float()
            term = term.sum()
            total = term if total is None else total + term
        live = [i for i, w in enumerate(wrt) if w.requires_grad]
        grads = [None] * len(wrt)
        if total is not None and total.requires_grad and live:
            found = torch.autograd.grad(total, [wrt[i] for i in live],
                                        retain_graph=retain,
                                        allow_unused=True)
            for i, g in zip(live, found):
                grads[i] = g
        for var, w, g in zip(op.outputs, wrt, grads):
            env[var.name] = (torch.zeros_like(w) if g is None
                             else g.to(w.dtype)).detach()


def _is_const(ref):
    return isinstance(ref, torch.Tensor) and not isinstance(ref, Variable)


# =====================================================================
# Parameters in static mode
# =====================================================================
def xavier_uniform_(t):
    """Glorot uniform on a [fan_in, fan_out] (or longer) tensor, in
    place, as the JAX package's ``XavierUniform``."""
    fan_in = t.shape[0] if t.dim() > 0 else 1
    fan_out = t.shape[1] if t.dim() > 1 else fan_in
    recep = math.prod(t.shape[2:]) if t.dim() > 2 else 1
    limit = math.sqrt(6.0 / ((fan_in + fan_out) * recep))
    return t.uniform_(-limit, limit)


def create_parameter(shape, dtype="float32", name=None, initializer=None,
                     is_bias=False, trainable=True, device=None
                     ) -> Parameter:
    """A named :class:`Parameter` on ``device`` (default cuda), its
    initializer recorded into the startup Program, whose run
    re-initializes it in place.  ``initializer``: None (zeros for a
    bias, else Glorot uniform), a function that fills the tensor in
    place, or a value (array or tensor) to assign."""
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    name = name or default_main_program()._unique_name("param")
    with torch._C.DisableTorchFunction():
        p = Parameter(torch.zeros(shape, dtype=to_dtype(dtype), device=dev),
                      requires_grad=trainable)
    p.name = name

    def init_fn():
        with torch.no_grad(), torch._C.DisableTorchFunction():
            if initializer is None:
                if is_bias:
                    p.zero_()
                else:
                    xavier_uniform_(p)
            elif callable(initializer):
                initializer(p)
            else:
                p.copy_(torch.as_tensor(np.asarray(initializer)))

    init_fn()
    default_startup_program()._startup_actions.append((p, init_fn))
    default_main_program()._startup_actions.append((p, init_fn))
    return p
