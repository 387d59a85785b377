"""The optimizer base and every optimizer of the JAX package, in plain
PyTorch.

The port of ``paddle_tpu/optimizer/optimizer.py`` (``Optimizer`` and its
ten optimizers: ``SGD``, ``Momentum``, ``Adam``, ``AdamW``, ``Adagrad``,
``Adadelta``, ``RMSProp``, ``Adamax``, ``Lamb``, ``LarsMomentum``).
There each update rule is one jitted XLA computation, not a Pallas
kernel; here it is a short sequence of elementwise PyTorch operations
(``*_rule``), with the parameter and its accumulators updated in place.

Every rule computes what its JAX rule computes, rounding where XLA
rounds it:
- the scalars (learning rate, betas, epsilon, decay) enter as f32, as
  the jitted rule takes its Python floats, and scalar expressions such
  as ``1 - beta ** step`` are formed in f32;
- the gradient and the parameter are raised to f32, and the result is
  rounded once back to the parameter's dtype.  ``SGD`` alone works in
  the parameter's dtype (``_sgd_rule``): its scalars are rounded to that
  dtype and, for bf16, every operation rounds to bf16, as XLA computes
  it;
- in f32, XLA compiles each ``a * b + c`` into a fused multiply-add, so
  the port forms it as ``torch.add(c, b, alpha=a)`` (or ``addcmul``):
  one rounding, on both devices.  Each rule's docstring names its fused
  steps;
- division by a scalar goes through a 0-d tensor: CUDA divides by a
  Python scalar through its reciprocal, which is not the correctly
  rounded quotient the JAX rule takes.
``torch.optim``'s optimizers compute other functions (``AdamW`` decays
the parameter in its own dtype, a second rounding in bf16) and are not
used.

``learning_rate`` is a number or an ``lr.LRScheduler``: an update reads
``get_lr()`` (the scheduler's current value) when it runs, and the
caller advances the scheduler.  ``grad_clip`` (``nn.ClipGradByValue``,
``ClipGradByNorm``, ``ClipGradByGlobalNorm`` or any callable of
``[(param, grad)]`` pairs) clips the pairs of the trainable parameters
that have a gradient before the updates, and leaves ``p.grad`` alone.

``Optimizer.minimize`` takes a dygraph loss (``backward()`` then
``step()``) or a static-graph ``Variable``: then it records the backward
(``static.append_backward``), with ``grad_clip`` one op over all the
gradients, one update op per parameter that writes the parameter and
its accumulators in place under ``torch.no_grad()`` (the counterpart of
the JAX package's ``_static_minimize`` writeback ops), and an op that
counts the step.

``state_dict()`` / ``set_state_dict()`` use the JAX package's keys:
``"{accumulator}_{index}"`` over the flat parameter order, ``"@step"``,
``"@global_step"`` and, with a scheduler, ``"LR_Scheduler"``; a restored
accumulator is a fresh tensor on its parameter's device, never the
caller's (the rules update accumulators in place).

Per-group options (``{"params": ..., "learning_rate": ...,
"weight_decay": ...}``) and ``AdamW(lr_ratio=...)`` are accepted and, as
in the JAX package, change nothing (its ``step`` drops the group and
never reads ``lr_ratio``); one ``UserWarning`` names the keys ignored.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from ..framework.io import to_tensor
from .lr import LRScheduler

_f32 = np.float32


def _s(x) -> float:
    """``x`` rounded to f32, as a Python float."""
    return float(_f32(x))


def _scalar(x, like):
    """A 0-d f32 tensor of ``x`` on ``like``'s device: a divisor that
    divides exactly on both devices."""
    return torch.full((), _s(x), dtype=torch.float32, device=like.device)


def _bias_correction(beta, step, like):
    """``1 - beta ** step`` formed in f32, as a 0-d tensor."""
    return _scalar(_f32(1) - np.power(_f32(beta), _f32(step)), like)


def _lerp_(acc, beta, x):
    """``acc = beta * acc + (1 - beta) * x`` in place: ``(1 - beta) * x``
    rounds once, then one fused multiply-add, as XLA compiles it."""
    return torch.add(x * _s(_f32(1) - _f32(beta)), acc, alpha=_s(beta),
                     out=acc)


def _decayed_grad(g, p, wd):
    """``g + wd * p`` raised to f32, one fused multiply-add (g itself
    when ``wd`` is 0: the same numbers).  The rules only read it."""
    g = g.float()
    return torch.add(g, p.float(), alpha=_s(wd)) if wd else g


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
    decay = _s(_f32(1) - _f32(lr) * _f32(wd))
    _lerp_(m, beta1, g)
    _lerp_(v, beta2, g.square())
    den = (v / _bias_correction(beta2, step, m)).sqrt_().add_(_s(eps))
    # -(lr * mhat) / den: the negation is exact, so the multiply-add
    # below is the JAX rule's decayed parameter minus its update
    upd = (m / _bias_correction(beta1, step, m)).mul_(-_s(lr)).div_(den)
    return p.copy_(torch.add(upd, p, alpha=decay, out=upd))


def sgd_rule(p, g, lr, wd):
    """``p - lr * (g + wd * p)`` in the parameter's dtype, the JAX
    ``_sgd_rule``: ``lr`` and ``wd`` rounded to that dtype.  An f32
    parameter takes both multiply-adds fused (two roundings in all); a
    bf16 one rounds every operation to bf16, as XLA computes bf16."""
    if p.dtype == torch.float32:
        g = torch.add(g, p, alpha=_s(wd)) if wd else g
        return p.add_(g.to(p.dtype), alpha=-_s(lr))
    lr_, wd_ = (float(torch.tensor(x, dtype=p.dtype)) for x in (lr, wd))
    g = g + wd_ * p
    return p.sub_(lr_ * g.to(p.dtype))


def momentum_rule(p, vel, g, lr, mu, wd, use_nesterov=False):
    """The JAX ``_momentum_rule``: ``g = g + wd * p``, ``vel = mu * vel +
    g`` and (Nesterov) ``g + mu * vel``, ``p - lr * update``: each a
    fused multiply-add in f32, the parameter rounded once."""
    g = _decayed_grad(g, p, wd)
    torch.add(g, vel, alpha=_s(mu), out=vel)
    upd = torch.add(g, vel, alpha=_s(mu)) if use_nesterov else vel
    return p.copy_(torch.add(p.float(), upd, alpha=-_s(lr)))


def adam_rule(p, m, v, g, lr, beta1, beta2, eps, step, wd_l2=None):
    """The JAX ``_adam_rule``: Adam with L2 decay ``g + wd_l2 * p``
    (fused) folded into the gradient; the moments as in
    :func:`adamw_rule`; ``p - lr * mhat / (sqrt(vhat) + eps)`` in f32,
    rounded once."""
    g = _decayed_grad(g, p, wd_l2 or 0.0)
    _lerp_(m, beta1, g)
    _lerp_(v, beta2, g.square())
    den = (v / _bias_correction(beta2, step, m)).sqrt_().add_(_s(eps))
    upd = (m / _bias_correction(beta1, step, m)).mul_(_s(lr)).div_(den)
    return p.copy_(p.float().sub_(upd))


def adagrad_rule(p, moment, g, lr, eps, wd):
    """The JAX ``_adagrad_rule``: ``g = g + wd * p`` and ``moment + g *
    g`` fused; ``p - lr * g / (sqrt(moment) + eps)`` in f32, rounded
    once."""
    g = _decayed_grad(g, p, wd)
    moment.addcmul_(g, g)
    den = moment.sqrt().add_(_s(eps))
    return p.copy_(p.float().sub_(g.mul(_s(lr)).div_(den)))


def adadelta_rule(p, avg_sq_grad, avg_sq_update, g, lr, rho, eps, wd):
    """The JAX ``_adadelta_rule``, classic Adadelta: no learning-rate
    factor (``lr`` is taken and ignored, as the reference's kernel takes
    none).  ``g = g + wd * p`` fused; both averages as in
    :func:`adamw_rule`'s moments; ``update = sqrt(asu + eps) / sqrt(asg
    + eps) * g``; ``p - update`` in f32, rounded once."""
    del lr
    g = _decayed_grad(g, p, wd)
    _lerp_(avg_sq_grad, rho, g.square())
    upd = (avg_sq_update + _s(eps)).sqrt_().div_(
        (avg_sq_grad + _s(eps)).sqrt_()).mul_(g)
    _lerp_(avg_sq_update, rho, upd.square())
    return p.copy_(p.float().sub_(upd))


def rmsprop_rule(p, mean_sq, mom, g, lr, rho, eps, momentum, wd, mean_g,
                 centered=False):
    """The JAX ``_rmsprop_rule``: ``g = g + wd * p`` fused; the averages
    as in :func:`adamw_rule`'s moments; centered, ``sqrt(mean_sq -
    mean_g ** 2 + eps)`` with the square subtracted in one fused step;
    ``mom = momentum * mom + lr * g / denom`` fused; ``p - mom`` in f32,
    rounded once.  ``mean_g`` is updated only when centered."""
    g = _decayed_grad(g, p, wd)
    _lerp_(mean_sq, rho, g.square())
    if centered:
        _lerp_(mean_g, rho, g)
        denom = torch.addcmul(mean_sq, mean_g, mean_g, value=-1.0) \
            .add_(_s(eps)).sqrt_()
    else:
        denom = (mean_sq + _s(eps)).sqrt_()
    torch.add(g.mul(_s(lr)).div_(denom), mom, alpha=_s(momentum), out=mom)
    return p.copy_(p.float().sub_(mom))


def adamax_rule(p, m, u, g, lr, beta1, beta2, eps, step, wd):
    """The JAX ``_adamax_rule``: ``g = g + wd * p`` fused; ``m`` as in
    :func:`adamw_rule`; ``u = max(|g|, beta2 * u + eps)`` (epsilon
    inside the max, one fused step); ``p - lr / (1 - beta1 ** step) * m
    / u`` (the scalar in f32), rounded once."""
    g = _decayed_grad(g, p, wd)
    _lerp_(m, beta1, g)
    torch.maximum(g.abs(), torch.add(torch.full_like(u, _s(eps)), u,
                                     alpha=_s(beta2)), out=u)
    rate = _s(_f32(lr) / (_f32(1) - np.power(_f32(beta1), _f32(step))))
    return p.copy_(p.float().sub_(m.mul(rate).div_(u)))


def _norm(x):
    """The f32 L2 norm of x."""
    return x.float().square().sum().sqrt()


def _norms(p, *xs):
    """The f32 L2 norms of tensors shaped as parameter ``p``, each of
    the whole parameter: a part laid out on a mesh (``p.placement``)
    has its squared sums added over the ranks holding the other parts
    (one collective for all of them)."""
    pl = getattr(p, "placement", None)
    if pl is None or pl.replicated:
        return tuple(_norm(x) for x in xs)
    from ..distributed import collective

    sq = torch.stack([x.float().square().sum() for x in xs])
    collective.all_reduce(sq, group=pl.mesh.group(*pl.axes))
    return tuple(sq.sqrt())


def lamb_rule(p, m, v, g, lr, beta1, beta2, eps, step, wd):
    """The JAX ``_lamb_rule``: the moments and bias corrections of
    :func:`adamw_rule`; ``r = mhat / (sqrt(vhat) + eps) + wd * p``
    (fused); the trust ratio ``||p|| / ||r||`` of two f32 norms (the
    whole parameter's, :func:`_norms`), 1.0 unless both are positive;
    ``p - (lr * trust) * r`` fused, rounded once."""
    g = g.float()
    pf = p.float()
    _lerp_(m, beta1, g)
    _lerp_(v, beta2, g.square())
    den = (v / _bias_correction(beta2, step, m)).sqrt_().add_(_s(eps))
    r = (m / _bias_correction(beta1, step, m)).div_(den)
    if wd:
        r = torch.add(r, pf, alpha=_s(wd), out=r)
    p_norm, r_norm = _norms(p, pf, r)
    trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                        torch.ones_like(p_norm))
    return p.copy_(torch.addcmul(pf, r, trust * -_s(lr)))


def lars_rule(p, vel, g, lr, mu, lars_coeff, lars_wd, eps):
    """The JAX ``_lars_rule`` (layer-wise adaptive rate scaling): with
    both f32 norms positive, ``local_lr = lr * coeff * ||p|| / (||g|| +
    wd * ||p|| + eps)`` (the sum's multiply-add fused), else ``lr``;
    ``vel = mu * vel + local_lr * (g + wd * p)``, the inner and outer
    multiply-adds fused; ``p - vel`` in f32, rounded once.  The norms
    are the whole parameter's (:func:`_norms`) when ``p`` is a part."""
    pf, gf = p.float(), g.float()
    p_norm, g_norm = _norms(p, pf, gf)
    num = p_norm * _s(_f32(lr) * _f32(lars_coeff))
    den = torch.add(g_norm, p_norm, alpha=_s(lars_wd)).add_(_s(eps))
    local_lr = torch.where((p_norm > 0) & (g_norm > 0), num / den,
                           torch.full_like(p_norm, _s(lr)))
    inner = torch.add(gf, pf, alpha=_s(lars_wd))
    torch.add(inner.mul_(local_lr), vel, alpha=_s(mu), out=vel)
    return p.copy_(pf.sub_(vel))


class Optimizer:
    """Parameter list (or groups ``{"params": [...]}``, flattened), a
    learning rate (a number or an ``LRScheduler``), per-parameter
    accumulators, the step count and an optional ``grad_clip``.  A
    parameter may come as a ``(name, tensor)`` pair, as
    ``module.named_parameters()`` gives them: PyTorch tensors have no
    writable ``.name``, and the name is what ``apply_decay_param_fun``
    and ``LarsMomentum``'s exclusions read (a static Program's
    parameters carry their own).  Without ``parameters``, only
    ``minimize`` of a static loss works: it takes the parameters the
    Program reads; ``step`` and ``minimize`` of a dygraph loss raise.
    An accumulator's dtype is the one its optimizer names (f32 for
    every one of them, as in the JAX classes), else f32 under
    ``multi_precision`` and the parameter's dtype without.  ``name`` is
    taken for the Paddle signature and changes nothing."""

    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, name=None,
                 multi_precision=False):
        if isinstance(learning_rate, bool) or not isinstance(
                learning_rate, (float, int, LRScheduler)):
            raise TypeError(f"learning_rate must be a number or an "
                            f"LRScheduler, not "
                            f"{type(learning_rate).__name__}")
        self._learning_rate = learning_rate if isinstance(
            learning_rate, LRScheduler) else float(learning_rate)
        self._grad_clip = grad_clip
        self._multi_precision = multi_precision
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
        # id(param) -> the placement of its slots where it is not the
        # parameter's own (ZeRO stages 1 and 2: whole parameters, slots
        # split over the sharding axis)
        self._slot_placements: dict = {}
        self._step_count = 0

    def _register(self, parameters) -> list:
        """The flat parameter list of ``parameters`` (tensors, ``(name,
        tensor)`` pairs or groups ``{"params": [...]}``), names noted."""
        out, ignored = [], set()
        for p in parameters:
            if isinstance(p, dict):
                ignored |= set(p) - {"params"}
                group = p["params"]
            else:
                group = [p]
            for q in group:
                if isinstance(q, tuple):
                    pname, q = q
                    self._names[id(q)] = pname
                out.append(q)
        if ignored:
            warnings.warn(f"parameter-group option(s) {sorted(ignored)} are "
                          "ignored, as the JAX package ignores them",
                          UserWarning, stacklevel=3)
        return out

    def _param_name(self, p) -> str:
        return self._names.get(id(p)) or getattr(p, "name", None) or ""

    def _add_accumulator(self, name, param, fill=0.0, dtype=None):
        store = self._accumulators.setdefault(name, {})
        if id(param) not in store:
            dt = dtype or (torch.float32 if self._multi_precision
                           else param.dtype)
            store[id(param)] = torch.full_like(param, fill, dtype=dt)
        return store[id(param)]

    def _slot_placement(self, p):
        """The placement of ``p``'s slots: its own (a parameter laid out
        on a mesh holds its part, and so do its slots) unless a ZeRO
        stage set another."""
        return self._slot_placements.get(id(p), getattr(p, "placement",
                                                        None))

    def _reshard_slots(self):
        """Slots of a parameter laid out after they were made (or loaded
        whole) become its part."""
        for store in self._accumulators.values():
            for p in self._parameter_list:
                pl = self._slot_placement(p)
                acc = store.get(id(p))
                if pl is not None and acc is not None and \
                        tuple(acc.shape) == pl.full_shape != pl.local_shape:
                    store[id(p)] = pl.local(acc)

    def get_lr(self) -> float:
        if isinstance(self._learning_rate, LRScheduler):
            return self._learning_rate()
        return self._learning_rate

    def set_lr(self, value: float):
        self._learning_rate = float(value)

    @property
    def _lr_scheduler(self):
        lr = self._learning_rate
        return lr if isinstance(lr, LRScheduler) else None

    def _dygraph_parameters(self) -> list:
        if not self._parameter_list:
            raise ValueError(
                f"{type(self).__name__} was created without parameters; "
                "step() and minimize() of a dygraph loss need them (only "
                "minimize() of a static Variable finds its own)")
        return self._parameter_list

    @torch.no_grad()
    def step(self):
        params_grads = [(p, p.grad) for p in self._dygraph_parameters()
                        if p.grad is not None and p.requires_grad]
        if self._grad_clip is not None:
            params_grads = self._grad_clip(params_grads)
        lr = self.get_lr()
        for p, g in params_grads:
            self._update_param(p, g, lr)
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
        record the backward, the clip (one op over every gradient), the
        updates and the step count into its Program (for ``parameters``,
        this optimizer's, or every trainable parameter the Program
        reads, less those named in ``no_grad_set``); returns ``([],
        [(param, grad_var)])``, the gradients as the updates read them
        (clipped)."""
        from ..static import graph

        if not isinstance(loss, graph.Variable):
            self._dygraph_parameters()
            loss.backward()
            self.step()
            return None, None
        params = self._register(parameters) if parameters is not None \
            else self._parameter_list or None
        params_grads = graph.append_backward(loss, params, no_grad_set)
        if self._grad_clip is not None and params_grads:
            params_grads = self._record_clip(params_grads)
        for p, g in params_grads:
            graph.record_writeback_op(f"{type(self).__name__.lower()}_update",
                                      self._static_update, [p, g], [p])
        graph.record_writeback_op("increment_step", self._count_step, [], [],
                                  block=loss.block)
        return [], params_grads

    def _record_clip(self, params_grads):
        """One recorded op ``grad_clip`` over every gradient Variable,
        returning the clipped ones (the JAX ``_static_minimize``'s clip
        op)."""
        from torch.utils._pytree import tree_flatten

        from ..static import graph

        params = [p for p, _ in params_grads]
        grads = [g for _, g in params_grads]
        clip = self._grad_clip

        def grad_clip(*gvals):
            return tuple(g for _, g in clip(list(zip(params, gvals))))

        flat, spec = tree_flatten((tuple(grads), {}))
        clipped = graph.record_op(grad_clip, flat, spec)
        return list(zip(params, clipped))

    def _static_update(self, p, g):
        with torch.no_grad():
            self._update_param(p, g, self.get_lr())
        return p

    def _count_step(self):
        self._step_count += 1

    def _next_step(self) -> int:
        """The 1-based step a bias correction uses."""
        return self._step_count + 1

    def state_dict(self) -> dict:
        """The JAX package's layout: each accumulator as
        ``"{name}_{index}"`` (the parameter's index in the flat parameter
        list) holding a copy, ``"@step"`` and ``"@global_step"`` (one
        count here: the JAX package keeps a host and a device copy of
        it, always equal in its dygraph and static steps), and with a
        scheduler ``"LR_Scheduler"``.  The slots of a parameter laid out
        on a mesh are gathered whole on rank 0 (None on the other ranks;
        every rank calls this)."""
        index = {id(p): i for i, p in enumerate(self._parameter_list)}
        by_id = {id(p): p for p in self._parameter_list}
        state = {}
        for name, store in self._accumulators.items():
            for pid, acc in store.items():
                pl = self._slot_placement(by_id[pid]) if pid in by_id \
                    else None
                acc = acc.detach()
                state[f"{name}_{index.get(pid, pid)}"] = acc.clone() \
                    if pl is None or pl.replicated \
                    else pl.gather_to_rank0(acc)
        state.update(self._step_state())
        return state

    def _step_state(self) -> dict:
        """The entries of :meth:`state_dict` that are not slots."""
        state = {"@step": self._step_count,
                 "@global_step": self._step_count}
        if self._lr_scheduler is not None:
            state["LR_Scheduler"] = self._lr_scheduler.state_dict()
        return state

    def set_state_dict(self, state: dict):
        """Load a :meth:`state_dict` of either package: the step from
        ``"@global_step"`` (else ``"@step"``), each ``"{name}_{index}"``
        copied into a fresh tensor on that parameter's device (a tensor,
        a numpy array, or a bf16 ``framework.io.TensorPayload``); keys
        that name no parameter are skipped, as in the JAX package.  A
        whole slot of a parameter laid out on a mesh is cut to this
        rank's part (every rank holds it whole, as a JAX state gives it);
        a part is taken as it is."""
        self._step_count = int(state.get("@global_step",
                                         state.get("@step", 0)))
        params = self._parameter_list
        for key, value in state.items():
            if key in ("@step", "@global_step"):
                continue
            if key == "LR_Scheduler":
                if self._lr_scheduler is not None:
                    self._lr_scheduler.set_state_dict(value)
                continue
            name, _, idx = key.rpartition("_")
            if not idx.isdigit() or int(idx) >= len(params):
                continue
            p = params[int(idx)]
            acc = to_tensor(value).to(p.device, copy=True)
            pl = self._slot_placement(p)
            if pl is not None and tuple(acc.shape) == pl.full_shape \
                    != pl.local_shape:
                acc = pl.local(acc)
            self._accumulators.setdefault(name, {})[id(p)] = acc


class SGD(Optimizer):
    def __init__(self, learning_rate=0.001, parameters=None,
                 weight_decay=None, grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)

    def _update_param(self, p, g, lr):
        sgd_rule(p, g, lr, self._weight_decay)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum=0.9, parameters=None,
                 use_nesterov=False, weight_decay=None, grad_clip=None,
                 multi_precision=False, name=None, **kwargs):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _update_param(self, p, g, lr):
        vel = self._add_accumulator("velocity", p, dtype=torch.float32)
        momentum_rule(p, vel, g, lr, self._momentum, self._weight_decay,
                      self._use_nesterov)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, lazy_mode=False, multi_precision=False,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_param(self, p, g, lr):
        m = self._add_accumulator("moment1", p, dtype=torch.float32)
        v = self._add_accumulator("moment2", p, dtype=torch.float32)
        adam_rule(p, m, v, g, lr, self._beta1, self._beta2, self._epsilon,
                  self._next_step(), self._weight_decay or None)


class AdamW(Optimizer):
    """AdamW with decoupled weight decay (default 0.01).
    ``apply_decay_param_fun(name) -> bool`` picks the parameters that
    decay by name (parameters given without one are named "")."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.01,
                 lr_ratio=None, apply_decay_param_fun=None, grad_clip=None,
                 lazy_mode=False, multi_precision=False, name=None):
        if lr_ratio is not None:
            warnings.warn("AdamW's lr_ratio is ignored, as the JAX package "
                          "ignores it", UserWarning, stacklevel=2)
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name, multi_precision)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._apply_decay_param_fun = apply_decay_param_fun

    def _update_param(self, p, g, lr):
        m = self._add_accumulator("moment1", p, dtype=torch.float32)
        v = self._add_accumulator("moment2", p, dtype=torch.float32)
        wd = self._weight_decay
        if self._apply_decay_param_fun is not None and \
                not self._apply_decay_param_fun(self._param_name(p)):
            wd = 0.0
        adamw_rule(p, m, v, g, lr, self._beta1, self._beta2, self._epsilon,
                   self._next_step(), wd)


class Adagrad(Optimizer):
    def __init__(self, learning_rate, epsilon=1e-6, parameters=None,
                 weight_decay=None, grad_clip=None,
                 initial_accumulator_value=0.0, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _update_param(self, p, g, lr):
        mom = self._add_accumulator("moment", p, fill=self._initial,
                                    dtype=torch.float32)
        adagrad_rule(p, mom, g, lr, self._epsilon, self._weight_decay)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon=1e-6, rho=0.95,
                 parameters=None, weight_decay=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._epsilon, self._rho = epsilon, rho

    def _update_param(self, p, g, lr):
        asg = self._add_accumulator("avg_squared_grad", p,
                                    dtype=torch.float32)
        asu = self._add_accumulator("avg_squared_update", p,
                                    dtype=torch.float32)
        adadelta_rule(p, asg, asu, g, lr, self._rho, self._epsilon,
                      self._weight_decay)


class RMSProp(Optimizer):
    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _update_param(self, p, g, lr):
        ms = self._add_accumulator("mean_square", p, dtype=torch.float32)
        mom = self._add_accumulator("momentum", p, dtype=torch.float32)
        mg = self._add_accumulator("mean_grad", p, dtype=torch.float32)
        rmsprop_rule(p, ms, mom, g, lr, self._rho, self._epsilon,
                     self._momentum, self._weight_decay, mg, self._centered)


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _update_param(self, p, g, lr):
        m = self._add_accumulator("moment", p, dtype=torch.float32)
        u = self._add_accumulator("inf_norm", p, dtype=torch.float32)
        adamax_rule(p, m, u, g, lr, self._beta1, self._beta2, self._epsilon,
                    self._next_step(), self._weight_decay)


class Lamb(Optimizer):
    """LAMB.  ``exclude_from_weight_decay_fn(param) -> bool`` takes the
    parameter itself, as in the JAX class."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._exclude_fn = exclude_from_weight_decay_fn

    def _update_param(self, p, g, lr):
        m = self._add_accumulator("moment1", p, dtype=torch.float32)
        v = self._add_accumulator("moment2", p, dtype=torch.float32)
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        lamb_rule(p, m, v, g, lr, self._beta1, self._beta2, self._epsilon,
                  self._next_step(), wd)


class LarsMomentum(Optimizer):
    """LARS.  A parameter whose name contains one of
    ``exclude_from_weight_decay``'s tags takes no decay."""

    def __init__(self, learning_rate=0.001, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, parameters=None, grad_clip=None,
                 epsilon=0.0, multi_precision=False, name=None,
                 exclude_from_weight_decay=None, **kwargs):
        super().__init__(learning_rate, parameters, None, grad_clip, name,
                         multi_precision)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon
        self._exclude = tuple(exclude_from_weight_decay or ())

    def _update_param(self, p, g, lr):
        vel = self._add_accumulator("velocity", p, dtype=torch.float32)
        wd = self._lars_weight_decay
        if any(tag in self._param_name(p) for tag in self._exclude):
            wd = 0.0
        lars_rule(p, vel, g, lr, self._momentum, self._lars_coeff, wd,
                  self._epsilon)
