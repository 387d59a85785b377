"""paddle_tpu_torch.resilience — fault-injected, checkpoint-recoverable
training and serving (the single-process half of
``paddle_tpu.resilience``).

- :mod:`chaos`      — deterministic, seeded fault injection
  (:class:`FaultPlan`): NaN/Inf batches, crash mid-checkpoint,
  truncated or bit-flipped checkpoint files, delayed, killed or
  SIGTERMed training steps, poisoned serving requests and failing
  serving-step attempts.
- :mod:`checkpoint` — :class:`ResilientCheckpointer`: atomic
  rename-commit saves, per-file sha256 manifests, ``restore_latest``
  that falls back to the newest VALID checkpoint, a bounded async save
  queue, SIGTERM save-and-exit.
- :mod:`sentry`     — :class:`Sentry`: NaN/Inf loss detection,
  skip with exponential backoff, rewind after K consecutive bad steps.
- :mod:`callback`   — :class:`ResilienceCallback` wiring all of the
  above into ``hapi.Model.fit``.

Under injected kills and corruption a resumed run reaches final weights
bit-identical to an uninterrupted one, and a corrupt checkpoint is never
restored.  What waits for ROADMAP item A3: the sharded checkpoint of
several processes (the reference's ``ShardedHostLeaf`` and format 2)
and the faults of other processes.
"""
from __future__ import annotations

from . import chaos
from .callback import ResilienceCallback
from .chaos import ChaosError, FaultPlan, SimulatedPreemption
from .checkpoint import (CheckpointCorruption, ResilientCheckpointer,
                         apply_state, collect_state, host_snapshot)
from .sentry import OK, REWIND, SKIP, Sentry

__all__ = [
    "FaultPlan",
    "ChaosError",
    "SimulatedPreemption",
    "chaos",
    "ResilientCheckpointer",
    "CheckpointCorruption",
    "collect_state",
    "apply_state",
    "host_snapshot",
    "Sentry",
    "OK",
    "SKIP",
    "REWIND",
    "ResilienceCallback",
]
