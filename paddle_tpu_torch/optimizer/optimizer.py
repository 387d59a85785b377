"""The optimizer base and AdamW, in plain PyTorch.

The port of ``paddle_tpu/optimizer/optimizer.py`` (``Optimizer``,
``AdamW`` and its ``_adamw_rule``).  There each rule is one jitted XLA
computation, not a Pallas kernel; here it is a short sequence of
elementwise PyTorch operations, with the moments updated in place.

``adamw_rule`` computes exactly what ``_adamw_rule`` does: the
gradient and the parameter raised to f32, the decoupled decay
``p * (1 - lr * wd)`` applied BEFORE the Adam step, f32 moments, bias
correction at step + 1, and one rounding back to the parameter's dtype.
Its scalars (``1 - lr * wd``, ``1 - beta ** step``) are formed in f32,
as the jitted rule forms them from its f32 arguments, and its
multiply-adds round once, as XLA fuses them.
``torch.optim.AdamW`` computes another function (it decays the
parameter in its own dtype, a second rounding in bf16) and is not used.

``Optimizer.minimize`` takes a dygraph loss (``backward()`` then
``step()``) or a static-graph ``Variable``: then it records the
backward (``static.append_backward``), one update op per parameter that
writes the parameter and its moments in place under ``torch.no_grad()``
(the counterpart of the JAX package's ``_static_minimize`` writeback
ops), and an op that counts the step.

Not ported yet (each raises ``NotImplementedError``): learning-rate
schedulers (a float learning rate only), ``grad_clip``, ``lr_ratio``
and per-group options in parameter groups.
"""
from __future__ import annotations

import numpy as np
import torch

_f32 = np.float32


def adamw_rule(p, m, v, g, lr, beta1, beta2, eps, step, wd):
    """One AdamW update of parameter ``p`` with gradient ``g``: updates
    the f32 moments ``m`` and ``v`` and the parameter in place, and
    returns ``p``.  ``step`` is the 1-based step the bias correction
    uses.

    The rule's three multiply-adds (the two moments, and the decayed
    parameter minus the update) round once, as XLA compiles
    ``_adamw_rule`` into fused multiply-adds: ``torch.add(c, a,
    alpha=b)`` is one ``c + b * a`` with a single rounding on both
    devices.  The other operations round where the JAX rule does, each
    in place in one of two f32 temporaries.  The bias corrections divide
    by 0-d tensors on ``m``'s device: CUDA divides by a Python scalar
    through its reciprocal, which is not the correctly rounded quotient
    the JAX rule takes."""
    g = g.float()
    decay = float(_f32(1) - _f32(lr) * _f32(wd))

    def bias_correction(beta):
        return torch.full((), float(_f32(1) - np.power(_f32(beta),
                                                       _f32(step))),
                          dtype=torch.float32, device=m.device)

    torch.add(g * float(_f32(1) - _f32(beta1)), m, alpha=float(_f32(beta1)),
              out=m)
    torch.add(g.square().mul_(float(_f32(1) - _f32(beta2))), v,
              alpha=float(_f32(beta2)), out=v)
    den = (v / bias_correction(beta2)).sqrt_().add_(float(_f32(eps)))
    # -(lr * mhat) / den: the negation is exact, so the multiply-add
    # below is the JAX rule's decayed parameter minus its update
    upd = (m / bias_correction(beta1)).mul_(-float(_f32(lr))).div_(den)
    return p.copy_(torch.add(upd, p, alpha=decay, out=upd))


class Optimizer:
    """Parameter list (or groups ``{"params": [...]}``, flattened), a
    float learning rate, f32 accumulators per parameter and the step
    count.  A parameter may come as a ``(name, tensor)`` pair, as
    ``module.named_parameters()`` gives them: PyTorch tensors have no
    writable ``.name``, and the name is what ``apply_decay_param_fun``
    reads (a static Program's parameters carry their own).  Without
    ``parameters``, only ``minimize`` of a static loss works: it takes
    the parameters the Program reads; ``step`` and ``minimize`` of a
    dygraph loss raise.  ``name`` and ``multi_precision`` are taken for
    the Paddle signature and change nothing: the accumulators are f32,
    as the JAX AdamW's are whatever ``multi_precision`` says."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if not isinstance(learning_rate, (float, int)):
            raise NotImplementedError("learning-rate schedulers are not "
                                      "ported yet; pass a float")
        if grad_clip is not None:
            raise NotImplementedError("grad_clip is not ported yet")
        self._learning_rate = float(learning_rate)
        self._names = {}
        self._parameter_list = self._register(parameters or [])
        if weight_decay is None:
            self._weight_decay = 0.0
        elif isinstance(weight_decay, (float, int)):
            self._weight_decay = float(weight_decay)
        else:  # an L2Decay-like object with a coefficient
            self._weight_decay = float(getattr(
                weight_decay, "_coeff", getattr(weight_decay, "coeff", 0.0)))
        self._accumulators: dict = {}      # name -> {id(param): tensor}
        self._step_count = 0

    def _register(self, parameters) -> list:
        """The flat parameter list of ``parameters`` (tensors, ``(name,
        tensor)`` pairs or groups ``{"params": [...]}``), names noted."""
        out = []
        for p in parameters:
            if isinstance(p, dict):
                if set(p) != {"params"}:
                    raise NotImplementedError(
                        "per-group options are not ported yet: "
                        f"{sorted(set(p) - {'params'})}")
                group = p["params"]
            else:
                group = [p]
            for q in group:
                if isinstance(q, tuple):
                    pname, q = q
                    self._names[id(q)] = pname
                out.append(q)
        return out

    def _param_name(self, p) -> str:
        return self._names.get(id(p)) or getattr(p, "name", None) or ""

    def _add_accumulator(self, name, param):
        store = self._accumulators.setdefault(name, {})
        if id(param) not in store:
            store[id(param)] = torch.zeros_like(param, dtype=torch.float32)
        return store[id(param)]

    def get_lr(self) -> float:
        return self._learning_rate

    def set_lr(self, value: float):
        self._learning_rate = float(value)

    def _dygraph_parameters(self) -> list:
        if not self._parameter_list:
            raise ValueError(
                f"{type(self).__name__} was created without parameters; "
                "step() and minimize() of a dygraph loss need them (only "
                "minimize() of a static Variable finds its own)")
        return self._parameter_list

    @torch.no_grad()
    def step(self):
        params = self._dygraph_parameters()
        lr = self.get_lr()
        for p in params:
            if p.grad is not None and p.requires_grad:
                self._update_param(p, p.grad, lr)
        self._step_count += 1

    def _update_param(self, param, grad, lr):
        raise NotImplementedError

    def clear_grad(self, set_to_zero=False):
        for p in self._parameter_list:
            if p.grad is None:
                continue
            if set_to_zero:
                p.grad.zero_()
            else:
                p.grad = None

    clear_gradients = clear_grad

    def minimize(self, loss, parameters=None, no_grad_set=None):
        """Dygraph: ``loss.backward(); step()``.  A static ``Variable``:
        record the backward, the updates and the step count into its
        Program (for ``parameters``, this optimizer's, or every trainable
        parameter the Program reads, less those named in
        ``no_grad_set``); returns ``([], [(param, grad_var)])``."""
        from ..static import graph

        if not isinstance(loss, graph.Variable):
            self._dygraph_parameters()
            loss.backward()
            self.step()
            return None, None
        params = self._register(parameters) if parameters is not None \
            else self._parameter_list or None
        params_grads = graph.append_backward(loss, params, no_grad_set)
        for p, g in params_grads:
            graph.record_writeback_op(f"{type(self).__name__.lower()}_update",
                                      self._static_update, [p, g], [p])
        graph.record_writeback_op("increment_step", self._count_step, [], [],
                                  block=loss.block)
        return [], params_grads

    def _static_update(self, p, g):
        with torch.no_grad():
            self._update_param(p, g, self.get_lr())
        return p

    def _count_step(self):
        self._step_count += 1


class AdamW(Optimizer):
    """AdamW with decoupled weight decay (default 0.01).
    ``apply_decay_param_fun(name) -> bool`` picks the parameters that
    decay by name (parameters given without one are named "")."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            raise NotImplementedError("lr_ratio is not ported yet")
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update_param(self, p, g, lr):
        m = self._add_accumulator("moment1", p)
        v = self._add_accumulator("moment2", p)
        wd = self._weight_decay
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._param_name(p)):
            wd = 0.0
        adamw_rule(p, m, v, g, lr, self._beta1, self._beta2, self._epsilon,
                   self._step_count + 1, wd)
