"""The port's learning-rate schedulers (paddle_tpu_torch.optimizer.lr)
against the JAX package's (paddle_tpu.optimizer.lr).

Both are plain Python, so the tolerance is zero: every scheduler's
learning rate at each of 40 steps equals the JAX one's exactly (``==``
on Python floats), with ``ReduceOnPlateau`` fed the same metric
sequence, ``LinearWarmup`` wrapping a float and a
``CosineAnnealingDecay``, and a ``state_dict`` / ``set_state_dict``
round trip in the middle of the schedule.  An optimizer that takes a
scheduler is in tests/test_torch_optimizers.py.
"""
import math

import pytest

from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch.optimizer import lr as tlr

STEPS = 40

# (name, class name, keyword arguments): every scheduler of the module,
# several in more than one mode
CASES = [
    ("noam", "NoamDecay", dict(d_model=64, warmup_steps=10,
                               learning_rate=2.0)),
    ("piecewise", "PiecewiseDecay", dict(boundaries=[5, 12, 30],
                                         values=[0.1, 0.05, 0.01, 0.001])),
    ("natural_exp", "NaturalExpDecay", dict(learning_rate=0.5,
                                            gamma=0.1)),
    ("inverse_time", "InverseTimeDecay", dict(learning_rate=0.5,
                                              gamma=0.2)),
    ("polynomial", "PolynomialDecay", dict(learning_rate=0.1,
                                           decay_steps=25, power=2.0)),
    ("polynomial_cycle", "PolynomialDecay", dict(
        learning_rate=0.1, decay_steps=7, end_lr=0.001, cycle=True)),
    ("linear_warmup", "LinearWarmup", dict(learning_rate=0.3,
                                           warmup_steps=8, start_lr=0.0,
                                           end_lr=0.3)),
    ("exponential", "ExponentialDecay", dict(learning_rate=0.2,
                                             gamma=0.93)),
    ("multistep", "MultiStepDecay", dict(learning_rate=0.2,
                                         milestones=[4, 11, 25],
                                         gamma=0.5)),
    ("step", "StepDecay", dict(learning_rate=0.2, step_size=6, gamma=0.7)),
    ("lambda", "LambdaDecay", dict(learning_rate=0.4,
                                   lr_lambda=lambda e: 0.95 ** e)),
    ("cosine", "CosineAnnealingDecay", dict(learning_rate=0.1, T_max=30,
                                            eta_min=0.001)),
    ("cosine_restarts", "CosineAnnealingWarmRestarts", dict(
        learning_rate=0.1, T_0=5, T_mult=2, eta_min=0.0)),
    ("one_cycle", "OneCycleLR", dict(max_learning_rate=0.5,
                                     total_steps=35)),
    ("one_cycle_linear", "OneCycleLR", dict(
        max_learning_rate=0.5, total_steps=35, anneal_strategy="linear",
        phase_pct=0.2)),
    ("cyclic", "CyclicLR", dict(base_learning_rate=0.01,
                                max_learning_rate=0.1, step_size_up=6)),
    ("cyclic_triangular2", "CyclicLR", dict(
        base_learning_rate=0.01, max_learning_rate=0.1, step_size_up=5,
        step_size_down=3, mode="triangular2")),
    ("cyclic_exp_range", "CyclicLR", dict(
        base_learning_rate=0.01, max_learning_rate=0.1, step_size_up=4,
        mode="exp_range", exp_gamma=0.97)),
    ("warmup_cosine", "WarmupCosine", dict(learning_rate=3e-4,
                                           warmup_steps=2, total_steps=10,
                                           min_ratio=0.1)),
    ("warmup_cosine_long", "WarmupCosine", dict(learning_rate=1.0,
                                                warmup_steps=7,
                                                total_steps=33)),
]

# the loss a ReduceOnPlateau watches: falling, then flat, then noisy
METRICS = [2.0 - 0.1 * i for i in range(8)] + [1.3] * 12 + \
    [1.3 + 0.01 * math.sin(i) for i in range(20)]


def _sequence(sched, steps=STEPS, metrics=None):
    out = []
    for i in range(steps):
        out.append(sched())
        if metrics is None:
            sched.step()
        else:
            sched.step(metrics[i])
    return out


def _both(cls, kw):
    return getattr(jlr, cls)(**kw), getattr(tlr, cls)(**kw)


@pytest.mark.parametrize("name,cls,kw", CASES, ids=[c[0] for c in CASES])
def test_sequence_matches_jax(name, cls, kw):
    j, t = _both(cls, kw)
    want = _sequence(j)
    assert _sequence(t) == want
    assert len(set(want)) > 1 or cls == "PiecewiseDecay"


def test_every_scheduler_is_covered():
    names = {n for n in vars(jlr) if isinstance(getattr(jlr, n), type)
             and issubclass(getattr(jlr, n), jlr.LRScheduler)}
    assert names - {"LRScheduler"} == {c[1] for c in CASES} | {
        "ReduceOnPlateau"}
    for n in names:
        assert issubclass(getattr(tlr, n), tlr.LRScheduler)


@pytest.mark.parametrize("mode,threshold_mode", [
    ("min", "rel"), ("min", "abs"), ("max", "rel")])
def test_reduce_on_plateau_matches_jax(mode, threshold_mode):
    kw = dict(learning_rate=0.1, mode=mode, factor=0.5, patience=3,
              threshold=1e-3, threshold_mode=threshold_mode, cooldown=2,
              min_lr=0.004)
    j, t = _both("ReduceOnPlateau", kw)
    want = _sequence(j, metrics=METRICS)
    assert _sequence(t, metrics=METRICS) == want
    assert (t.best, t.num_bad_epochs, t.cooldown_counter, t.last_epoch) == \
        (j.best, j.num_bad_epochs, j.cooldown_counter, j.last_epoch)
    # a step without a metric changes nothing
    before, epoch = t(), t.last_epoch
    t.step()
    assert (t(), t.last_epoch) == (before, epoch)


def test_linear_warmup_over_cosine_matches_jax():
    def make(mod):
        inner = mod.CosineAnnealingDecay(learning_rate=0.2, T_max=25,
                                         eta_min=0.002)
        return mod.LinearWarmup(inner, warmup_steps=6, start_lr=0.01,
                                end_lr=0.2)

    want = _sequence(make(jlr))
    assert _sequence(make(tlr)) == want
    assert want[6] == 0.2 and want[-1] < want[6]


@pytest.mark.parametrize("name,cls,kw", [
    c for c in CASES if c[0] in ("warmup_cosine_long", "cosine_restarts",
                                  "one_cycle", "lambda", "polynomial_cycle")
], ids=lambda c: c if isinstance(c, str) else None)
def test_state_dict_round_trip(name, cls, kw):
    # 17 steps, then a fresh scheduler takes the state and goes on: the
    # whole sequence is the JAX scheduler's uninterrupted one
    j, t = _both(cls, kw)
    want = _sequence(j)
    first = _sequence(t, 17)
    state = t.state_dict()
    assert all(isinstance(v, (int, float, bool, str, list))
               for v in state.values())
    fresh = getattr(tlr, cls)(**kw)
    fresh.set_state_dict(state)
    assert first + _sequence(fresh, STEPS - 17) == want
    other = getattr(tlr, cls)(**kw)
    other.set_dict(state)
    assert _sequence(other, STEPS - 17) == want[17:]


def test_base_scheduler_needs_get_lr():
    with pytest.raises(NotImplementedError):
        tlr.LRScheduler(0.1)
