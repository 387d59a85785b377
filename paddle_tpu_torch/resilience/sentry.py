"""Training-loop guard against numeric poisoning (the port of
``paddle_tpu/resilience/sentry.py``).

One NaN batch poisons every weight through ``backward`` and the
optimizer's step.  :class:`Sentry` classifies each observed step:

- ``OK``     — finite loss and grad-norm; the consecutive-bad counter
  resets.
- ``SKIP``   — non-finite: the batch is dropped and the update rolled
  back (``ResilienceCallback`` restores its in-memory snapshot of the
  pre-step state), after an exponential backoff pause.
- ``REWIND`` — K consecutive bad steps: roll state back to the last
  good on-disk checkpoint.

The sentry only classifies; moving state belongs to the callback.
"""
from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["Sentry", "OK", "SKIP", "REWIND", "is_finite"]

OK = "ok"
SKIP = "skip"
REWIND = "rewind"


def is_finite(value) -> bool:
    """Finiteness of a loss or grad-norm in whatever form the loop has
    it: a tensor (read on the host), a numpy array, a Python float, or
    None (vacuously finite)."""
    if value is None:
        return True
    if isinstance(value, torch.Tensor):
        return bool(torch.isfinite(value.detach()).all())
    try:
        return bool(np.isfinite(np.asarray(value)).all())
    except TypeError:
        return True


class Sentry:
    """Classify steps; after a bad one sleep ``backoff_base_s *
    backoff_factor ** (consecutive_bad - 1)`` seconds (at most
    ``backoff_max_s``; no sleep at base 0)."""

    def __init__(self, max_consecutive_bad: int = 3,
                 backoff_base_s: float = 0.0,
                 backoff_factor: float = 2.0,
                 backoff_max_s: float = 30.0):
        if max_consecutive_bad < 1:
            raise ValueError("max_consecutive_bad must be >= 1")
        self.max_consecutive_bad = max_consecutive_bad
        self.backoff_base_s = backoff_base_s
        self.backoff_factor = backoff_factor
        self.backoff_max_s = backoff_max_s
        self.steps_seen = 0
        self.bad_steps = 0
        self.skips = 0
        self.rewinds = 0
        self.consecutive_bad = 0
        self.last_backoff_s = 0.0

    def observe(self, loss=None, grad_norm=None) -> str:
        """Classify one training step: ``OK``, ``SKIP`` or ``REWIND``."""
        self.steps_seen += 1
        if is_finite(loss) and is_finite(grad_norm):
            self.consecutive_bad = 0
            return OK
        self.bad_steps += 1
        self.consecutive_bad += 1
        self._backoff()
        if self.consecutive_bad >= self.max_consecutive_bad:
            self.rewinds += 1
            self.consecutive_bad = 0
            return REWIND
        self.skips += 1
        return SKIP

    def _backoff(self):
        if self.backoff_base_s <= 0:
            self.last_backoff_s = 0.0
            return
        delay = min(
            self.backoff_base_s
            * self.backoff_factor ** (self.consecutive_bad - 1),
            self.backoff_max_s)
        self.last_backoff_s = delay
        time.sleep(delay)

    def stats(self) -> dict:
        return {
            "steps_seen": self.steps_seen,
            "bad_steps": self.bad_steps,
            "skips": self.skips,
            "rewinds": self.rewinds,
            "consecutive_bad": self.consecutive_bad,
            "last_backoff_s": self.last_backoff_s,
        }
