"""Deterministic fault injection (the port of
``paddle_tpu/resilience/chaos.py``, single-process).

Faults are a seeded :class:`FaultPlan`: a *schedule* of injections that
instrumented code consults through module-level hooks.  The hooks are
no-ops unless a plan is ACTIVE (``with FaultPlan(...):``), so the
training and serving paths pay one ``is None`` check.  The same
schedule given to this plan and to the reference's fires at the same
steps and attempts with the same log (``FaultPlan.injected``; NaN
positions and flipped bits come from the same seeded draws), so a run
of each package can be held to the other under one schedule.

Instrumented sites:

- ``on_step(step)``        — training loop, once a batch (delay, kill,
  SIGTERM)
- ``on_save(site)``        — checkpoint writers, mid-commit (crash)
- ``after_save(path)``     — checkpoint writers, post-commit (disk rot)
- ``poison_batch(step, arrays)`` — data path (NaN/Inf batches)
- ``maybe_fail_request(request_id)`` — serving prefill (poison request)
- ``maybe_fail_serving_step(label)`` — the serving step watchdog (hung
  or failing step ATTEMPTS: delays register as watchdog stalls,
  exceptions exercise the bounded-retry path)

``burst_prompts`` is the matching ARRIVAL generator: a seeded batch of
random prompts for overload tests (the reference's draws, so both
packages see the same prompts).

The reference's faults of other processes (``kill_process_at``,
``kill_save_site``, ``kill_save_site_ordinal``, ``save_fault_process``)
wait for ROADMAP item A3's multi-process runtime: set, they raise
``NotImplementedError``.  ``kill_hard`` only changes how those die, so
it is taken and changes nothing here.
"""
from __future__ import annotations

import os
import signal
import time
from typing import Dict, Iterable, List, Optional, Union

import numpy as np

__all__ = [
    "FaultPlan",
    "ChaosError",
    "SimulatedPreemption",
    "active_plan",
    "on_step",
    "on_save",
    "after_save",
    "maybe_fail_request",
    "maybe_fail_serving_step",
    "poison_batch",
    "burst_prompts",
    "truncate_file",
    "bitflip_file",
]

# FaultPlan arguments of the reference's faults of other processes, with
# the value at which each is off
_PROCESS_ARGS = {
    "kill_process_at": None, "kill_save_site": None,
    "save_fault_process": None, "kill_save_site_ordinal": 1,
}


def _off(value, off) -> bool:
    """Whether an argument is at its off value (an empty collection is
    off too)."""
    if value == off:
        return True
    return off is None and hasattr(value, "__len__") and len(value) == 0


class ChaosError(RuntimeError):
    """An injected fault (crash mid-save, poisoned request, failed step
    attempt)."""


class SimulatedPreemption(ChaosError):
    """An injected kill of the training process at a scheduled step —
    catch it where the real preemption (SIGTERM) would end the run."""


_ACTIVE: Optional["FaultPlan"] = None


def active_plan() -> Optional["FaultPlan"]:
    return _ACTIVE


class FaultPlan:
    """A seeded, deterministic schedule of fault injections.

    Use as a context manager; entering activates the plan for every
    instrumented site in the process (one plan at a time — nesting
    raises, because two overlapping schedules cannot be deterministic).

    Parameters
    ----------
    seed: drives NaN positions and bit-flip offsets.
    nan_batch_steps: global steps whose batch is poisoned with NaN
        (``poison_batch``; float arrays only).
    inf_batch_steps: same, with +inf.
    kill_at_step: raise :class:`SimulatedPreemption` at this step's
        ``on_step`` — the in-process stand-in for SIGKILL.
    sigterm_at_step: deliver a real ``SIGTERM`` to this process at the
        step — exercises the checkpointer's preemption handler.
    delay_steps: {step: seconds} — sleep before the step runs.
    crash_on_save: 1-based ordinal of the ``on_save`` call that raises
        :class:`ChaosError` mid-commit (before the manifest and rename).
    corrupt_after_save: {1-based save ordinal: "truncate" | "bitflip"}
        — damage the largest file of that committed checkpoint on disk.
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
    kill_hard: taken; it changes only the deaths of other processes.

    The reference's faults of other processes (``kill_process_at``,
    ``kill_save_site``, ...) raise ``NotImplementedError`` when set.
    """

    def __init__(self, seed: int = 0,
                 nan_batch_steps: Iterable[int] = (),
                 inf_batch_steps: Iterable[int] = (),
                 kill_at_step: Optional[int] = None,
                 sigterm_at_step: Optional[int] = None,
                 delay_steps: Optional[Dict[int, float]] = None,
                 crash_on_save: Optional[int] = None,
                 corrupt_after_save: Optional[Dict[int, str]] = None,
                 fail_request_ids: Iterable[str] = (),
                 step_delay_s: Union[None, float,
                                     Dict[int, float]] = None,
                 fail_step_at: Iterable[int] = (),
                 step_fault_scope: Optional[str] = None,
                 kill_hard: bool = False,
                 **processes):
        unknown = sorted(set(processes) - set(_PROCESS_ARGS))
        if unknown:
            raise TypeError(f"FaultPlan got unexpected argument(s) "
                            f"{unknown}")
        later = sorted(k for k, v in processes.items()
                       if not _off(v, _PROCESS_ARGS[k]))
        if later:
            raise NotImplementedError(
                f"FaultPlan argument(s) {', '.join(later)} inject faults "
                "into other processes, which wait for ROADMAP item A3's "
                "multi-process runtime; they are not ported to "
                "paddle_tpu_torch yet")
        self.seed = seed
        self.nan_batch_steps = frozenset(nan_batch_steps)
        self.inf_batch_steps = frozenset(inf_batch_steps)
        self.kill_at_step = kill_at_step
        self.sigterm_at_step = sigterm_at_step
        self.delay_steps = dict(delay_steps or {})
        self.crash_on_save = crash_on_save
        self.corrupt_after_save = dict(corrupt_after_save or {})
        for kind in self.corrupt_after_save.values():
            if kind not in ("truncate", "bitflip"):
                raise ValueError(f"unknown corruption kind {kind!r}")
        self.fail_request_ids = frozenset(fail_request_ids)
        self.step_delay_s = step_delay_s
        self.fail_step_at = frozenset(fail_step_at)
        self.step_fault_scope = step_fault_scope
        self.kill_hard = kill_hard
        # observability: what actually fired (tests assert on these)
        self.injected: list = []
        self._save_calls = 0
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
    def on_step(self, step: int):
        delay = self.delay_steps.get(step)
        if delay:
            self.injected.append(("delay", step))
            time.sleep(delay)
        if self.sigterm_at_step == step:
            self.injected.append(("sigterm", step))
            os.kill(os.getpid(), signal.SIGTERM)
        if self.kill_at_step == step:
            self.injected.append(("kill", step))
            raise SimulatedPreemption(f"injected kill at step {step}")

    def on_save(self, site: str):
        self._save_calls += 1
        if self.crash_on_save == self._save_calls:
            self.injected.append(("crash_save", site))
            raise ChaosError(
                f"injected crash during checkpoint save #{self._save_calls} "
                f"({site})")

    def after_save(self, path: str):
        kind = self.corrupt_after_save.get(self._save_calls)
        if kind is None:
            return
        victim = _largest_payload_file(path)
        if victim is None:
            return
        if kind == "truncate":
            truncate_file(victim)
        else:
            bitflip_file(victim, seed=self.seed)
        self.injected.append((kind, victim))

    def poison_batch(self, step: int, arrays):
        """``arrays`` (a list or tuple of numpy arrays) with NaN or Inf
        written into an eighth of each float one's entries when ``step``
        is scheduled; the positions are the reference's seeded draws."""
        bad = (np.nan if step in self.nan_batch_steps
               else np.inf if step in self.inf_batch_steps else None)
        if bad is None:
            return arrays
        rng = np.random.RandomState(self.seed * 100003 + step)
        out = []
        poisoned = False
        for a in arrays:
            a = np.asarray(a)
            if np.issubdtype(a.dtype, np.floating) and a.size:
                a = a.copy()
                flat = a.reshape(-1)
                k = max(1, flat.size // 8)
                flat[rng.choice(flat.size, size=k, replace=False)] = bad
                poisoned = True
            out.append(a)
        if poisoned:
            self.injected.append(("poison", step))
        return out

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

def on_step(step: int):
    if _ACTIVE is not None:
        _ACTIVE.on_step(step)


def on_save(site: str):
    if _ACTIVE is not None:
        _ACTIVE.on_save(site)


def after_save(path: str):
    if _ACTIVE is not None:
        _ACTIVE.after_save(path)


def poison_batch(step: int, arrays):
    if _ACTIVE is None:
        return arrays
    return _ACTIVE.poison_batch(step, arrays)


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


# ---------------------------------------------------------------------------
# disk corruption utilities (also usable directly from tests)
# ---------------------------------------------------------------------------

def _largest_payload_file(path: str) -> Optional[str]:
    """The biggest non-manifest file under ``path`` (or ``path`` itself
    when it is a file) — the state payload a torn write would hit."""
    if os.path.isfile(path):
        return path
    best, best_size = None, -1
    for root, _dirs, files in os.walk(path):
        for f in files:
            if f == "manifest.json":
                continue
            p = os.path.join(root, f)
            size = os.path.getsize(p)
            if size > best_size:
                best, best_size = p, size
    return best


def truncate_file(path: str, keep_frac: float = 0.5):
    """Truncate ``path`` to ``keep_frac`` of its size (a torn write)."""
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(max(0, int(size * keep_frac)))


def bitflip_file(path: str, nbits: int = 8, seed: int = 0):
    """Flip ``nbits`` seeded-random bits in ``path`` (silent bit rot)."""
    size = os.path.getsize(path)
    if size == 0:
        return
    rng = np.random.RandomState(seed)
    with open(path, "r+b") as f:
        for _ in range(nbits):
            off = int(rng.randint(0, size))
            f.seek(off)
            byte = f.read(1)
            f.seek(off)
            f.write(bytes([byte[0] ^ (1 << int(rng.randint(0, 8)))]))
