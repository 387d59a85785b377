"""paddle_tpu_torch.resilience — deterministic fault injection for the
serving engine (the serving half of ``paddle_tpu.resilience``).

- :mod:`chaos` — :class:`FaultPlan`: poisoned serving requests, delayed
  and failing serving-step attempts (the overload controller's watchdog
  sees them), and :func:`chaos.burst_prompts`, the seeded burst of
  arrivals the overload tests replay.

The reference's training and checkpoint halves (NaN/Inf batches, killed
or SIGTERMed steps, crash-mid-save and corrupted checkpoints, the
resilient checkpointer, the sentry and the ``hapi`` callback) belong to
ROADMAP item A5's resilience: :class:`FaultPlan` raises
``NotImplementedError`` for their arguments.
"""
from __future__ import annotations

from . import chaos
from .chaos import ChaosError, FaultPlan

__all__ = ["FaultPlan", "ChaosError", "chaos"]
