"""The port's optimizers (paddle_tpu_torch.optimizer) against the JAX
package's, on the same numpy parameters and gradients.

Each of the JAX package's ten optimizers takes 10 steps in both
packages, with f32 and with bf16 parameters, from the same parameters
and the same per-step gradients (set on ``p.grad`` directly, so the two
models' own numerics stay out of it).  Then with a learning-rate
scheduler and a gradient clip, and a static ``minimize`` with
``grad_clip`` against the JAX ``_static_minimize``.

Tolerances, after 10 steps: an f32 parameter or accumulator within
STEP_RTOL of the JAX one relative to its largest entry (the rules round
where the JAX rules round, their multiply-adds fused as XLA fuses them;
what is left is PyTorch's CPU square root, not always correctly
rounded, XLA's CPU rewrite of ``sqrt(a) / sqrt(b)`` into ``sqrt(a) *
rsqrt(b)`` with an approximate reciprocal square root (Adadelta), and
the order of the norms' sums (Lamb, LARS, the clips)); a bf16 parameter
within BF16_RTOL, one bf16 ulp of its largest entry (a last-place
difference in f32 can move a rounding to bf16, and the next steps build
on it: every case but RMSProp's ends bit-equal).  The update rules
alone, one step from the same state, are held tighter in
``test_one_step_rules``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.clip as jclip
from paddle_tpu import static as jstatic
from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.optimizer import optimizer as jopt
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch import static
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 10
STEP_RTOL = 1e-6
BF16_RTOL = 2.0 ** -8
SHAPES = {"w1": (24, 16), "b1": (16,), "w2": (16, 8), "norm": (8,)}

# (name, class, keyword arguments) of each optimizer: its own options set
CASES = [
    ("sgd", "SGD", dict(learning_rate=0.05, weight_decay=0.01)),
    ("momentum", "Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=0.01)),
    ("nesterov", "Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  use_nesterov=True)),
    ("adam", "Adam", dict(learning_rate=0.01, weight_decay=0.01)),
    ("adamw", "AdamW", dict(learning_rate=0.01, beta2=0.95, epsilon=1e-5,
                            weight_decay=0.1)),
    ("adagrad", "Adagrad", dict(learning_rate=0.05, weight_decay=0.01,
                                initial_accumulator_value=0.1)),
    ("adadelta", "Adadelta", dict(learning_rate=0.001, rho=0.9,
                                  weight_decay=0.01)),
    ("rmsprop", "RMSProp", dict(learning_rate=0.01, momentum=0.5)),
    ("rmsprop_centered", "RMSProp", dict(learning_rate=0.01, centered=True,
                                         weight_decay=0.01)),
    ("adamax", "Adamax", dict(learning_rate=0.01, weight_decay=0.01)),
    ("lamb", "Lamb", dict(learning_rate=0.01, lamb_weight_decay=0.01)),
    ("lars", "LarsMomentum", dict(learning_rate=0.1, lars_coeff=0.01,
                                  epsilon=1e-8)),
]


def _init(seed=0):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return {n: (rng.randn(*s) * 0.01 + 0.003).astype(np.float32)
            for n, s in SHAPES.items()}


def _ulps(a, b):
    ia, ib = (torch.from_numpy(np.asarray(x, np.float32).copy()).bfloat16()
              .view(torch.int16).int() for x in (a, b))
    return int((ia - ib).abs().max())


class Pair:
    """The same named parameters in both packages.  The torch tensors
    are copies: the JAX package reads a numpy array into its buffer
    asynchronously, so a torch tensor sharing that array's memory and
    updated in place could be read half-written under load."""

    def __init__(self, dtype, seed=0, frozen=()):
        init = _init(seed)
        self.dtype = dtype
        self.jax = {n: JParameter(jnp.asarray(v, getattr(jnp, dtype)),
                                  name=n, trainable=n not in frozen)
                    for n, v in init.items()}
        self.torch = {n: torch.nn.Parameter(
            torch.from_numpy(v.copy()).to(getattr(torch, dtype)),
            requires_grad=n not in frozen) for n, v in init.items()}

    def set_grads(self, step, skip=()):
        for n, g in _grads(step).items():
            if n in skip:
                self.jax[n].grad = None
                self.torch[n].grad = None
                continue
            self.jax[n].grad = JTensor(jnp.asarray(g, getattr(jnp,
                                                              self.dtype)))
            self.torch[n].grad = torch.from_numpy(g.copy()).to(
                getattr(torch, self.dtype))

    def check(self, what=""):
        for n in SHAPES:
            want = np.asarray(self.jax[n]._value.astype(jnp.float32))
            got = self.torch[n].detach().float().numpy()
            tol = BF16_RTOL if self.dtype == "bfloat16" else STEP_RTOL
            np.testing.assert_allclose(
                got, want, rtol=0, atol=tol * float(np.abs(want).max()),
                err_msg=f"{what} {n}")


def _accumulators_close(jo, to, pair):
    assert sorted(jo._accumulators) == sorted(to._accumulators)
    for name, store in jo._accumulators.items():
        for n in SHAPES:
            jp, tp = pair.jax[n], pair.torch[n]
            if id(jp) not in store:
                assert id(tp) not in to._accumulators[name]
                continue
            want = np.asarray(store[id(jp)])
            got = to._accumulators[name][id(tp)]
            assert got.dtype == torch.float32 and want.dtype == np.float32
            np.testing.assert_allclose(
                got.numpy(), want, rtol=0,
                atol=STEP_RTOL * max(float(np.abs(want).max()), 1e-30),
                err_msg=f"{name} {n}")


def _make(cls, kw, pair, **extra):
    jo = getattr(jopt, cls)(parameters=list(pair.jax.values()),
                            **kw, **extra.get("jax", {}))
    to = getattr(topt, cls)(parameters=list(pair.torch.items()),
                            **kw, **extra.get("torch", {}))
    return jo, to


def _run(jo, to, pair, steps=STEPS, skip=(), scheds=None):
    for i in range(steps):
        pair.set_grads(i, skip)
        jo.step()
        to.step()
        assert to.get_lr() == jo.get_lr()
        if scheds:
            for s in scheds:
                s.step()
        jo.clear_grad()
        to.clear_grad()
        assert all(p.grad is None for p in pair.torch.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,cls,kw", CASES, ids=[c[0] for c in CASES])
def test_ten_steps_match_jax(name, cls, kw, dtype):
    pair = Pair(dtype)
    jo, to = _make(cls, kw, pair)
    _run(jo, to, pair)
    pair.check(name)
    _accumulators_close(jo, to, pair)
    assert to._step_count == jo._step_count == STEPS
    moved = [not np.array_equal(pair.torch[n].detach().float().numpy(),
                                _init()[n]) for n in SHAPES]
    assert all(moved)


def test_every_optimizer_is_covered():
    want = {n for n in vars(jopt) if isinstance(getattr(jopt, n), type)
            and issubclass(getattr(jopt, n), jopt.Optimizer)} - {"Optimizer"}
    assert {c[1] for c in CASES} == want
    assert topt.Lars is topt.LarsMomentum


@pytest.mark.parametrize("name,cls,kw,sched,clip", [
    ("adamw_warmup_cosine_global", "AdamW", dict(
        beta2=0.95, epsilon=1e-5, weight_decay=0.1),
     ("WarmupCosine", dict(learning_rate=0.01, warmup_steps=2,
                           total_steps=10, min_ratio=0.1)),
     ("ClipGradByGlobalNorm", (0.05,))),
    ("momentum_step_decay_norm", "Momentum", dict(momentum=0.9),
     ("StepDecay", dict(learning_rate=0.1, step_size=3, gamma=0.5)),
     ("ClipGradByNorm", (0.02,))),
    ("sgd_piecewise_value", "SGD", dict(),
     ("PiecewiseDecay", dict(boundaries=[4, 7], values=[0.1, 0.05, 0.01])),
     ("ClipGradByValue", (0.01,))),
    ("lamb_cosine_global", "Lamb", dict(),
     ("CosineAnnealingDecay", dict(learning_rate=0.01, T_max=10)),
     ("ClipGradByGlobalNorm", (0.1,))),
    ("rmsprop_exponential_none", "RMSProp", dict(),
     ("ExponentialDecay", dict(learning_rate=0.01, gamma=0.8)), None),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_with_scheduler_and_clip(name, cls, kw, sched, clip, dtype):
    pair = Pair(dtype)
    js, ts = getattr(jlr, sched[0])(**sched[1]), \
        getattr(tlr, sched[0])(**sched[1])
    extra = dict(jax=dict(learning_rate=js), torch=dict(learning_rate=ts))
    if clip:
        extra["jax"]["grad_clip"] = getattr(jclip, clip[0])(*clip[1])
        extra["torch"]["grad_clip"] = getattr(tnn, clip[0])(*clip[1])
    jo, to = _make(cls, kw, pair, **extra)
    assert to._lr_scheduler is ts and jo._lr_scheduler is js
    lrs = []
    for i in range(STEPS):
        pair.set_grads(i)
        jo.step()
        to.step()
        lrs.append(to.get_lr())
        assert to.get_lr() == jo.get_lr() == ts()
        js.step()
        ts.step()
        jo.clear_grad()
        to.clear_grad()
    assert len(set(lrs)) > 1
    pair.check(name)
    _accumulators_close(jo, to, pair)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_reads_trainable_pairs_with_grads_only(dtype):
    # a frozen parameter and one without a gradient take no update and
    # no part in the global norm, in both packages
    pair = Pair(dtype, frozen=("b1",))
    kw = dict(learning_rate=0.01, weight_decay=0.05)
    jo, to = _make("AdamW", kw, pair, jax=dict(
        grad_clip=jclip.ClipGradByGlobalNorm(0.02)), torch=dict(
        grad_clip=tnn.ClipGradByGlobalNorm(0.02)))
    _run(jo, to, pair, steps=4, skip=("norm",))
    pair.check("frozen")
    init = _init()
    for n in ("b1", "norm"):
        np.testing.assert_array_equal(
            pair.torch[n].detach().float().numpy(),
            torch.from_numpy(init[n]).to(getattr(torch, dtype)).float()
            .numpy())
    assert to._grad_clip.last_global_norm is not None


def test_clip_leaves_p_grad_alone():
    pair = Pair("float32")
    to = topt.SGD(0.1, parameters=list(pair.torch.values()),
                  grad_clip=tnn.ClipGradByGlobalNorm(1e-4))
    pair.set_grads(0)
    before = {n: p.grad.clone() for n, p in pair.torch.items()}
    to.step()
    for n, p in pair.torch.items():
        assert torch.equal(p.grad, before[n])


def test_set_lr_replaces_a_scheduler():
    s = tlr.StepDecay(0.1, step_size=1, gamma=0.5)
    p = torch.nn.Parameter(torch.ones(3))
    o = topt.SGD(s, parameters=[p])
    s.step()
    assert o.get_lr() == 0.05 and o._lr_scheduler is s
    o.set_lr(0.3)
    assert o.get_lr() == 0.3 and o._lr_scheduler is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", [1, 4, 60])
@pytest.mark.parametrize("name", ["sgd", "momentum", "nesterov", "adam",
                                  "adamax", "adagrad"])
def test_one_step_rules(name, step, dtype):
    # one update from the same random state: SGD and Momentum bit for
    # bit; Adam, Adamax and Adagrad (a square root, or ``beta ** step``
    # through numpy's power where XLA has its own) within 2^-22 of the
    # parameter's largest entry in f32 and one ulp in bf16; every
    # accumulator bit for bit
    rng = np.random.RandomState(step)
    shape = (64, 48)
    p = (rng.randn(*shape) * 0.05).astype(np.float32)
    g = (rng.randn(*shape) * 0.01).astype(np.float32)
    a = (rng.randn(*shape) * 1e-3).astype(np.float32)
    v = (rng.rand(*shape) * 1e-5).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    st = jnp.asarray(step, jnp.int32)
    J = lambda x, d=jnp.float32: jnp.asarray(x, d)   # noqa: E731
    T = lambda x, d=torch.float32: torch.from_numpy(x.copy()).to(d)  # noqa
    tp, tg, ta, tv = T(p, tdt), T(g, tdt), T(a), T(v)
    if name == "sgd":
        want = [jopt._sgd_rule(J(p, jdt), J(g, jdt), 0.05, 0.01)]
        got = [topt.optimizer.sgd_rule(tp, tg, 0.05, 0.01)]
    elif name in ("momentum", "nesterov"):
        want = jopt._momentum_rule(J(p, jdt), J(a), J(g, jdt), 0.05, 0.9,
                                   0.01, use_nesterov=name == "nesterov")
        got = [topt.optimizer.momentum_rule(tp, ta, tg, 0.05, 0.9, 0.01,
                                            name == "nesterov"), ta]
    elif name == "adam":
        want = jopt._adam_rule(J(p, jdt), J(a), J(v), J(g, jdt), 1e-3, 0.9,
                               0.999, 1e-8, st, 0.01)
        got = [topt.optimizer.adam_rule(tp, ta, tv, tg, 1e-3, 0.9, 0.999,
                                        1e-8, step, 0.01), ta, tv]
    elif name == "adamax":
        want = jopt._adamax_rule(J(p, jdt), J(a), J(np.abs(a)), J(g, jdt),
                                 1e-3, 0.9, 0.999, 1e-8, st, 0.01)
        tu = T(np.abs(a))
        got = [topt.optimizer.adamax_rule(tp, ta, tu, tg, 1e-3, 0.9, 0.999,
                                          1e-8, step, 0.01), ta, tu]
    else:
        want = jopt._adagrad_rule(J(p, jdt), J(v), J(g, jdt), 0.05, 1e-6,
                                  0.01)
        got = [topt.optimizer.adagrad_rule(tp, tv, tg, 0.05, 1e-6, 0.01),
               tv]
    exact = name in ("sgd", "momentum", "nesterov")
    w0 = np.asarray(jnp.asarray(want[0], jnp.float32))
    assert got[0].dtype == tdt
    if exact:
        np.testing.assert_array_equal(got[0].float().numpy(), w0)
    elif dtype == "bfloat16":
        assert _ulps(got[0].float().numpy(), w0) <= 1
    else:
        np.testing.assert_allclose(got[0].numpy(), w0, rtol=0,
                                   atol=2.0 ** -22 * np.abs(w0).max())
    for w, t in zip(want[1:], got[1:]):
        np.testing.assert_array_max_ulp(t.numpy(), np.asarray(w), maxulp=0)


class TestStaticMinimizeWithClip:
    """``minimize`` of a static loss with ``grad_clip``: one recorded
    clip op over every gradient before the update ops, held against the
    JAX ``_static_minimize`` over 8 steps of a regression."""

    @pytest.fixture
    def static_mode(self):
        static.enable_static()
        paddle.enable_static()
        try:
            yield
        finally:
            paddle.disable_static()
            static.disable_static()

    @pytest.mark.parametrize("cls,kw", [
        ("AdamW", dict(learning_rate=0.1)),
        ("Momentum", dict(learning_rate=0.05, momentum=0.9)),
        ("Lamb", dict(learning_rate=0.05))])
    def test_matches_jax(self, static_mode, cls, kw):
        rng = np.random.RandomState(0)
        w0 = rng.rand(3, 2).astype(np.float32)
        b0 = rng.rand(2).astype(np.float32)
        true_w = rng.rand(3, 2).astype(np.float32)
        batches = [rng.rand(16, 3).astype(np.float32) for _ in range(8)]
        main, startup = static.Program(), static.Program()
        with static.program_guard(main, startup):
            x = static.data("x", [None, 3], "float32")
            t = static.data("t", [None, 2], "float32")
            w = static.create_parameter([3, 2], "float32", name="w",
                                        initializer=w0, device="cpu")
            b = static.create_parameter([2], "float32", name="b",
                                        initializer=b0, device="cpu")
            loss = (torch.matmul(x, w) + b - t).square().mean()
            opt = getattr(topt, cls)(
                grad_clip=tnn.ClipGradByGlobalNorm(0.1), **kw)
            _, pgs = opt.minimize(loss)
        ops = [op.type for op in main.global_block().ops]
        assert ops.count("grad_clip") == 1
        assert ops.index("grad_clip") > ops.index("backward")
        assert ops.index("grad_clip") < min(
            i for i, o in enumerate(ops) if o.endswith("_update"))
        assert [p.name for p, _ in pgs] == ["w", "b"]
        jmain, jstartup = jstatic.Program(), jstatic.Program()
        with jstatic.program_guard(jmain, jstartup):
            jx = jstatic.data("x", [None, 3], "float32")
            jt = jstatic.data("t", [None, 2], "float32")
            jw = jstatic.create_parameter(
                [3, 2], "float32", name="w",
                initializer=paddle.nn.initializer.Assign(w0))
            jb = jstatic.create_parameter(
                [2], "float32", name="b",
                initializer=paddle.nn.initializer.Assign(b0))
            jloss = paddle.ops.mean(paddle.ops.square(
                paddle.ops.matmul(jx, jw) + jb - jt))
            getattr(jopt, cls)(grad_clip=jclip.ClipGradByGlobalNorm(0.1),
                               **kw).minimize(jloss)
        exe, jexe = static.Executor("cpu"), jstatic.Executor()
        exe.run(startup)
        jexe.run(jstartup)
        losses, jlosses = [], []
        for xv in batches:
            feed = {"x": xv, "t": xv @ true_w}
            losses.append(float(exe.run(main, feed=feed,
                                        fetch_list=[loss])[0]))
            jlosses.append(float(jexe.run(jmain, feed=feed,
                                          fetch_list=[jloss])[0]))
        np.testing.assert_allclose(losses, jlosses, rtol=STEP_RTOL,
                                   atol=STEP_RTOL)
        np.testing.assert_allclose(w.detach().numpy(), np.asarray(jw._value),
                                   rtol=STEP_RTOL, atol=STEP_RTOL)
        assert opt._step_count == len(batches)
        assert float(opt._grad_clip.last_global_norm) > 0.1


class TestRefusals:
    def test_learning_rate_type(self):
        p = [torch.nn.Parameter(torch.ones(2))]
        for bad in (object(), "0.1", True, None):
            with pytest.raises(TypeError, match="learning_rate"):
                topt.SGD(bad, parameters=p)
