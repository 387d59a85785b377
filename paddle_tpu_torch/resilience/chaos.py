"""Deterministic fault injection for the serving engine (the serving
half of ``paddle_tpu/resilience/chaos.py``).

Faults are a seeded :class:`FaultPlan`: a *schedule* of injections that
instrumented code consults through module-level hooks.  The hooks are
no-ops unless a plan is ACTIVE (``with FaultPlan(...):``), so the serving
path pays one ``is None`` check.  The same schedule given to this plan
and to the reference's fires at the same attempts with the same log
(``FaultPlan.injected``), so an engine of each package can be held to
the other under one schedule.

Instrumented sites:

- ``maybe_fail_request(request_id)`` — serving prefill (poison request)
- ``maybe_fail_serving_step(label)`` — the serving step watchdog (hung
  or failing step ATTEMPTS: delays register as watchdog stalls,
  exceptions exercise the bounded-retry path)

``burst_prompts`` is the matching ARRIVAL generator: a seeded batch of
random prompts for overload tests, so a shedding/degradation scenario
replays identically every run (the reference's generator, so both
packages see the same prompts).

The reference's training and checkpoint sites (``on_step``,
``on_save``, ``after_save``, ``poison_batch``) wait for ROADMAP item
A5's resilience; their :class:`FaultPlan` arguments raise
``NotImplementedError`` when set.
"""
from __future__ import annotations

import time
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

__all__ = [
    "FaultPlan",
    "ChaosError",
    "active_plan",
    "maybe_fail_request",
    "maybe_fail_serving_step",
    "burst_prompts",
]

# FaultPlan arguments of the reference's training and checkpoint sites,
# with the value at which each is off
_TRAINING_ARGS = {
    "nan_batch_steps": (), "inf_batch_steps": (), "kill_at_step": None,
    "sigterm_at_step": None, "delay_steps": None, "crash_on_save": None,
    "corrupt_after_save": None, "kill_process_at": None,
    "kill_save_site": None, "save_fault_process": None,
    "kill_save_site_ordinal": 1, "kill_hard": False,
}


def _off(value, off) -> bool:
    """Whether a training argument is at its off value (an empty
    collection is off too)."""
    if value == off:
        return True
    return off in ((), None) and hasattr(value, "__len__") \
        and len(value) == 0


class ChaosError(RuntimeError):
    """An injected fault (poisoned request, failed step attempt)."""


_ACTIVE: Optional["FaultPlan"] = None


def active_plan() -> Optional["FaultPlan"]:
    return _ACTIVE


class FaultPlan:
    """A seeded, deterministic schedule of serving fault injections.

    Use as a context manager; entering activates the plan for every
    instrumented site in the process (one plan at a time — nesting
    raises, because two overlapping schedules cannot be deterministic).

    Parameters
    ----------
    seed: kept for the reference's signature (the serving faults draw
        no randomness; ``burst_prompts`` takes its own seed).
    fail_request_ids: serving request ids whose prefill raises
        :class:`ChaosError` (the poison-request case).
    step_delay_s: injected latency into serving step ATTEMPTS
        (``maybe_fail_serving_step``, 1-based attempt ordinal counted
        across prefill and decode, retries included).  Either a plain
        float — every attempt sleeps that long, the sustained-slowdown
        case — or ``{ordinal: seconds}`` for targeted hangs.  The sleep
        lands inside the engine watchdog's timed window, so a big enough
        delay IS a detected stall.
    fail_step_at: 1-based serving-step attempt ordinals that raise
        :class:`ChaosError` instead of running — the transient device
        failure the watchdog's bounded retry must absorb (consecutive
        ordinals exhaust the retries and quarantine the engine).
    step_fault_scope: when set, ONLY serving-step attempts whose label
        contains this substring are counted and faulted — the others
        pass through untouched (their ordinals do not advance the
        schedule).  A named engine labels its steps
        ``serving::decode_step@<name>`` (``ServingConfig(name=...)``).

    The reference's training and checkpoint arguments (``kill_at_step``,
    ``on_save``'s ``crash_on_save``, ``nan_batch_steps``, ...) raise
    ``NotImplementedError`` when set: they wait for A5's resilience.
    """

    def __init__(self, seed: int = 0,
                 fail_request_ids: Iterable[str] = (),
                 step_delay_s: Union[None, float,
                                     Dict[int, float]] = None,
                 fail_step_at: Iterable[int] = (),
                 step_fault_scope: Optional[str] = None,
                 **training):
        unknown = sorted(set(training) - set(_TRAINING_ARGS))
        if unknown:
            raise TypeError(f"FaultPlan got unexpected argument(s) "
                            f"{unknown}")
        later = sorted(k for k, v in training.items()
                       if not _off(v, _TRAINING_ARGS[k]))
        if later:
            raise NotImplementedError(
                f"FaultPlan argument(s) {', '.join(later)} inject training "
                "and checkpoint faults, which wait for A5's resilience "
                "item; they are not ported to paddle_tpu_torch yet")
        self.seed = seed
        self.fail_request_ids = frozenset(fail_request_ids)
        self.step_delay_s = step_delay_s
        self.fail_step_at = frozenset(fail_step_at)
        self.step_fault_scope = step_fault_scope
        # observability: what actually fired (tests assert on these)
        self.injected: list = []
        self._serving_step_calls = 0

    # ------------------------------------------------------------ scope
    def __enter__(self) -> "FaultPlan":
        global _ACTIVE
        if _ACTIVE is not None:
            raise RuntimeError("a FaultPlan is already active; chaos "
                               "schedules do not nest")
        _ACTIVE = self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = None
        return False

    # ------------------------------------------------------------ hooks
    def maybe_fail_request(self, request_id: str):
        if request_id in self.fail_request_ids:
            self.injected.append(("fail_request", request_id))
            raise ChaosError(f"injected prefill failure for {request_id}")

    def maybe_fail_serving_step(self, label: str):
        """One serving step ATTEMPT (prefill chunk or decode iteration,
        retries counted separately) — sleep and/or raise per the
        schedule.  Called inside the engine watchdog's monotonic window,
        before the step runs, so injected delays are observed as stalls
        and an injected failure leaves the pools untouched.  With a
        ``step_fault_scope``, attempts outside the scope pass through
        without advancing the schedule."""
        if self.step_fault_scope is not None \
                and self.step_fault_scope not in label:
            return
        self._serving_step_calls += 1
        n = self._serving_step_calls
        delay = (self.step_delay_s if isinstance(
            self.step_delay_s, (int, float))
            else (self.step_delay_s or {}).get(n))
        if delay:
            self.injected.append(("serving_delay", n, label))
            time.sleep(delay)
        if n in self.fail_step_at:
            self.injected.append(("serving_fail", n, label))
            raise ChaosError(
                f"injected serving step failure at attempt {n} ({label})")


# ---------------------------------------------------------------------------
# module-level hooks (what instrumented code actually calls)
# ---------------------------------------------------------------------------

def maybe_fail_request(request_id: str):
    if _ACTIVE is not None:
        _ACTIVE.maybe_fail_request(request_id)


def maybe_fail_serving_step(label: str):
    if _ACTIVE is not None:
        _ACTIVE.maybe_fail_serving_step(label)


def burst_prompts(seed: int, n: int, min_len: int = 4,
                  max_len: int = 32, vocab: int = 256
                  ) -> List[np.ndarray]:
    """Seeded burst-arrival generator: ``n`` random int32 prompts with
    lengths uniform in ``[min_len, max_len]`` — the deterministic
    traffic spike overload tests replay so shedding-on and shedding-off
    see the IDENTICAL workload (the reference's draws, prompt for
    prompt)."""
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab,
                        size=(int(rng.randint(min_len, max_len + 1)),)
                        ).astype(np.int32)
            for _ in range(n)]
