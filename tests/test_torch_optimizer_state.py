"""The port's optimizer state against the JAX package's: ``state_dict``
keys, a round trip through ``set_state_dict``, the carry-over of a JAX
run's moments and step count into the port (``convert.
optimizer_state_from_jax``, by parameter name, with the port listing
its parameters in another order), and parameter groups and
``lr_ratio``, which both packages take and ignore.

Parameters and per-step gradients are numpy arrays from seeds, set on
``.grad`` directly (no model numerics).  Tolerance: after the run, an
f32 parameter within STEP_RTOL of the JAX one relative to its largest
entry, as ``test_torch_optimizers.py`` holds the rules.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core.tensor import Parameter as JParameter
from paddle_tpu.core.tensor import Tensor as JTensor
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.optimizer import optimizer as jopt
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.convert import optimizer_state_from_jax
from paddle_tpu_torch.optimizer import lr as tlr

STEP_RTOL = 1e-6
SHAPES = {"w1": (12, 8), "b1": (8,), "w2": (8, 4), "norm": (4,)}
NAMES = list(SHAPES)
# the port's parameter order in the carry-over: another permutation
PERMUTED = ["norm", "w2", "w1", "b1"]

CASES = [
    ("adamw", "AdamW", dict(learning_rate=0.01, beta2=0.95, epsilon=1e-5,
                            weight_decay=0.1)),
    ("momentum", "Momentum", dict(learning_rate=0.05, momentum=0.9,
                                  weight_decay=0.01)),
    ("adam", "Adam", dict(learning_rate=0.01, weight_decay=0.01)),
]


def _init(seed=0):
    rng = np.random.RandomState(seed)
    return {n: (rng.randn(*s) * 0.1).astype(np.float32)
            for n, s in SHAPES.items()}


def _grads(step):
    rng = np.random.RandomState(100 + step)
    return {n: (rng.randn(*s) * 0.01 + 0.003).astype(np.float32)
            for n, s in SHAPES.items()}


def _jax_params(init):
    return {n: JParameter(jnp.asarray(v), name=n) for n, v in init.items()}


def _torch_params(init):
    return {n: torch.nn.Parameter(torch.from_numpy(v.copy()))
            for n, v in init.items()}


def _jax_step(opt, params, step):
    for n, g in _grads(step).items():
        params[n].grad = JTensor(jnp.asarray(g))
    opt.step()
    opt.clear_grad()


def _torch_step(opt, params, step):
    for n, g in _grads(step).items():
        params[n].grad = torch.from_numpy(g)
    opt.step()
    opt.clear_grad()


def _close(tparams, jparams, what=""):
    for n in SHAPES:
        want = np.asarray(jparams[n]._value)
        got = tparams[n].detach().numpy()
        np.testing.assert_allclose(
            got, want, rtol=0, atol=STEP_RTOL * float(np.abs(want).max()),
            err_msg=f"{what} {n}")


def _jax_state_numpy(opt):
    """The JAX ``state_dict()`` as a checkpoint holds it: numpy arrays
    and Python values."""
    return {k: (np.asarray(v._value) if isinstance(v, JTensor) else v)
            for k, v in opt.state_dict().items()}


@pytest.mark.parametrize("name,cls,kw", CASES, ids=[c[0] for c in CASES])
class TestStateDict:
    def test_keys_are_the_references(self, name, cls, kw):
        init = _init()
        jp, tp = _jax_params(init), _torch_params(init)
        jo = getattr(jopt, cls)(parameters=list(jp.values()), **kw)
        to = getattr(topt, cls)(parameters=list(tp.values()), **kw)
        for step in range(2):
            _jax_step(jo, jp, step)
            _torch_step(to, tp, step)
        jstate, tstate = jo.state_dict(), to.state_dict()
        assert sorted(tstate) == sorted(jstate)
        assert tstate["@step"] == jstate["@step"] == 2
        assert tstate["@global_step"] == jstate["@global_step"] == 2
        for k, v in jstate.items():
            if isinstance(v, JTensor):
                np.testing.assert_allclose(
                    tstate[k].numpy(), np.asarray(v._value), rtol=0,
                    atol=STEP_RTOL * max(float(np.abs(
                        np.asarray(v._value)).max()), 1e-30), err_msg=k)

    def test_round_trip_copies_and_continues(self, name, cls, kw):
        tp = _torch_params(_init())
        to = getattr(topt, cls)(parameters=list(tp.values()), **kw)
        for step in range(3):
            _torch_step(to, tp, step)
        state = to.state_dict()
        tq = {n: torch.nn.Parameter(tp[n].detach().clone()) for n in NAMES}
        tq_opt = getattr(topt, cls)(parameters=list(tq.values()), **kw)
        tq_opt.set_state_dict(state)
        # fresh tensors: the rules update in place, and must not write
        # into the caller's dict or the other optimizer's slots
        saved = {k: v.clone() for k, v in state.items()
                 if isinstance(v, torch.Tensor)}
        for store in tq_opt._accumulators.values():
            for acc in store.values():
                assert not any(acc.data_ptr() == v.data_ptr()
                               for v in state.values()
                               if isinstance(v, torch.Tensor))
        for step in range(3, 6):
            _torch_step(to, tp, step)
            _torch_step(tq_opt, tq, step)
        for n in NAMES:
            assert torch.equal(tp[n], tq[n]), n
        for k, v in saved.items():
            assert torch.equal(state[k], v), k


@pytest.mark.parametrize("name,cls,kw", CASES, ids=[c[0] for c in CASES])
def test_carry_over_from_jax_with_permuted_order(name, cls, kw):
    """k steps in JAX; moments and step go across by name into a port
    optimizer that lists its parameters in another order; both go on n
    steps to the same weights."""
    k, n = 3, 4
    init = _init(1)
    jp = _jax_params(init)
    jo = getattr(jopt, cls)(parameters=list(jp.values()), **kw)
    for step in range(k):
        _jax_step(jo, jp, step)
    carried = {n_: np.asarray(jp[n_]._value) for n_ in NAMES}
    tp = _torch_params(carried)
    to = getattr(topt, cls)(parameters=[(n_, tp[n_]) for n_ in PERMUTED],
                            **kw)
    state = optimizer_state_from_jax(_jax_state_numpy(jo), NAMES, to)
    assert state["@global_step"] == k and to._step_count == k
    # the same accumulator sits under each name's index in each order
    for key in _jax_state_numpy(jo):
        acc, _, i = key.rpartition("_")
        if i.isdigit():
            assert f"{acc}_{PERMUTED.index(NAMES[int(i)])}" in state
    # by network too: the names from named_parameters()
    net = torch.nn.Module()
    for n_ in NAMES:
        net.register_parameter(n_, tp[n_])
    to2 = getattr(topt, cls)(parameters=[tp[n_] for n_ in PERMUTED], **kw)
    optimizer_state_from_jax(_jax_state_numpy(jo), NAMES, to2, network=net)
    assert sorted(to2.state_dict()) == sorted(to.state_dict())
    for step in range(k, k + n):
        _jax_step(jo, jp, step)
        _torch_step(to, tp, step)
    _close(tp, jp, f"{name} after carry-over")


def test_carry_over_refuses_an_unknown_name():
    init = _init()
    jp = _jax_params(init)
    jo = jopt.AdamW(parameters=list(jp.values()))
    _jax_step(jo, jp, 0)
    tp = _torch_params(init)
    to = topt.AdamW(parameters=[(n, tp[n]) for n in NAMES[:-1]])
    with pytest.raises(KeyError, match="norm"):
        optimizer_state_from_jax(_jax_state_numpy(jo), NAMES, to)


def test_scheduler_state_goes_across():
    init = _init()
    jp, tp = _jax_params(init), _torch_params(init)
    jsched = jlr.StepDecay(0.01, step_size=2, gamma=0.5)
    jo = jopt.Adam(jsched, parameters=list(jp.values()))
    for step in range(3):
        _jax_step(jo, jp, step)
        jsched.step()
    tsched = tlr.StepDecay(0.01, step_size=2, gamma=0.5)
    to = topt.Adam(tsched, parameters=[(n, tp[n]) for n in NAMES])
    optimizer_state_from_jax(_jax_state_numpy(jo), NAMES, to)
    assert tsched.last_epoch == jsched.last_epoch == 3
    assert to.get_lr() == jo.get_lr()
    assert to.state_dict()["LR_Scheduler"]["last_epoch"] == 3


class TestGroupsAndLrRatio:
    """Both packages take per-group options and ``lr_ratio`` and compute
    without them; the port warns, naming the keys."""

    def test_group_learning_rate_zero_is_ignored(self):
        init = _init()
        jp, tp = _jax_params(init), _torch_params(init)
        jo = jopt.AdamW(0.01, parameters=[
            {"params": [jp["w1"], jp["b1"]], "learning_rate": 0.0,
             "weight_decay": 0.5},
            {"params": [jp["w2"], jp["norm"]], "weight_decay": 0.0}])
        with pytest.warns(UserWarning, match="learning_rate") as caught:
            to = topt.AdamW(0.01, parameters=[
                {"params": [tp["w1"], tp["b1"]], "learning_rate": 0.0,
                 "weight_decay": 0.5},
                {"params": [tp["w2"], tp["norm"]], "weight_decay": 0.0}])
        # one warning, naming every key ignored
        assert len(caught) == 1
        assert "weight_decay" in str(caught[0].message)
        for step in range(4):
            _jax_step(jo, jp, step)
            _torch_step(to, tp, step)
        _close(tp, jp, "groups")
        # the group at learning rate 0 moved all the same, in both
        assert not np.array_equal(np.asarray(jp["w1"]._value), init["w1"])
        assert sorted(to.state_dict()) == sorted(jo.state_dict())

    def test_lr_ratio_is_ignored(self):
        init = _init()
        jp, tp = _jax_params(init), _torch_params(init)
        ratio = lambda p: 0.0                          # noqa: E731
        jo = jopt.AdamW(0.01, parameters=list(jp.values()), lr_ratio=ratio)
        with pytest.warns(UserWarning, match="lr_ratio"):
            to = topt.AdamW(0.01, parameters=list(tp.values()),
                            lr_ratio=ratio)
        for step in range(4):
            _jax_step(jo, jp, step)
            _torch_step(to, tp, step)
        _close(tp, jp, "lr_ratio")
