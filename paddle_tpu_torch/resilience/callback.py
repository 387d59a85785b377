"""``ResilienceCallback`` — checkpoint-recoverable, NaN-guarded,
preemption-aware ``hapi.Model.fit`` (the port of
``paddle_tpu/resilience/callback.py``, line for line).

One callback wires the whole resilience story into the high-level loop:

- **Resume**: on train begin, restore the newest VALID checkpoint
  (``ResilientCheckpointer.restore_latest`` skips corrupt ones), then
  fast-forward the data stream past the ``resume_step`` batches that
  are already baked into the restored weights — the loop replays the
  epoch structure without re-executing trained batches, so a killed run
  that resumes reaches final weights bit-identical to an uninterrupted
  one (tests/test_torch_resilience_train.py holds this under injected
  kills).  A checkpoint directory the JAX package's callback wrote
  resumes here too.
- **Checkpointing**: every ``save_every`` batches, atomically and (with
  ``async_save=True``) off-thread behind a bounded queue.
- **Guard**: after each batch, feed the loss to a :class:`Sentry`; on
  ``SKIP`` roll model+optimizer back to the in-memory snapshot of the
  pre-batch state (the poisoned update is undone, the batch is
  skipped); on ``REWIND`` restore the last good on-disk checkpoint.
  The snapshot is a host copy of the whole state every batch
  (``checkpoint.host_snapshot``): at a large model's width that copy is
  the guard's cost.
- **Preemption**: SIGTERM latches a flag; at the next batch boundary
  the callback saves synchronously and stops training cleanly
  (``model.stop_training``), the fleet-elastic contract.

Chaos hooks (``resilience.chaos``) fire inside this callback's step
path, so every fault above is injectable deterministically from tests.
"""
from __future__ import annotations

import sys
from typing import Optional

from ..hapi.callbacks import Callback
from . import chaos
from .checkpoint import ResilientCheckpointer, apply_state, collect_state
from .sentry import OK, REWIND, SKIP, Sentry

__all__ = ["ResilienceCallback"]


class ResilienceCallback(Callback):
    def __init__(self, checkpoint_dir: str, save_every: int = 1,
                 max_to_keep: int = 3, async_save: bool = False,
                 resume: bool = True, guard: bool = True,
                 sentry: Optional[Sentry] = None,
                 handle_preemption: bool = True, verbose: int = 0):
        super().__init__()
        if save_every < 1:
            raise ValueError("save_every must be >= 1")
        self.checkpoint_dir = checkpoint_dir
        self.save_every = save_every
        self.max_to_keep = max_to_keep
        self.async_save = async_save
        self.resume = resume
        self.guard = guard
        self.sentry = sentry or Sentry()
        self.handle_preemption = handle_preemption
        self.verbose = verbose
        self.checkpointer: Optional[ResilientCheckpointer] = None
        self.global_step = 0          # batches completed (trained/skipped)
        self.resume_step = 0
        self.events = []              # [(kind, step)] — observability
        self._last_good = None

    # ------------------------------------------------------------ state
    def _network(self):
        return self.model.network

    def _optimizer(self):
        return getattr(self.model, "_optimizer", None)

    def _state(self):
        return collect_state(self._network(), self._optimizer(),
                             extra={"meta": {"global_step":
                                             self.global_step}})

    def _apply(self, state):
        apply_state(state, self._network(), self._optimizer())

    def _log(self, msg):
        if self.verbose:
            print(f"[resilience] {msg}", file=sys.stderr)

    # -------------------------------------------------------- lifecycle
    def on_train_begin(self, logs=None):
        self.checkpointer = ResilientCheckpointer(
            self.checkpoint_dir, max_to_keep=self.max_to_keep)
        if self.handle_preemption:
            self.checkpointer.install_preemption_handler()
        self.global_step = 0
        self.resume_step = 0
        if self.resume:
            step, state = self.checkpointer.restore_latest()
            if step is not None:
                self._apply(state)
                self.resume_step = step
                self.events.append(("resume", step))
                self._log(f"resumed from step {step} "
                          f"({self.checkpointer.corrupt_skipped} corrupt "
                          "checkpoint(s) skipped)")
        if self.guard:
            self._last_good = self._state()

    def on_train_batch_begin(self, step, logs=None):
        if self.global_step < self.resume_step:
            # this batch is already baked into the restored weights;
            # consume it from the stream without executing it
            self.model._skip_batch = True
            self.global_step += 1
            return
        try:
            chaos.on_step(self.global_step)
        except chaos.SimulatedPreemption:
            # the run is dying mid-fit, so on_train_end never fires:
            # flush queued async saves and release the signal handler
            # here instead of leaking them past the abort
            self.checkpointer.close()
            raise

    def on_train_batch_end(self, step, logs=None):
        self.global_step += 1
        verdict = self.sentry.observe((logs or {}).get("loss")) \
            if self.guard else OK
        if verdict == OK:
            if self.guard:
                self._last_good = self._state()
            if self.global_step % self.save_every == 0:
                self._save()
        elif verdict == SKIP:
            self.events.append(("skip", self.global_step - 1))
            self._log(f"non-finite loss at step {self.global_step - 1}: "
                      "rolled back, batch skipped")
            self._apply(self._last_good)
        else:  # REWIND
            ckpt_step, state = self.checkpointer.restore_latest()
            self.events.append(("rewind", ckpt_step))
            if state is not None:
                self._apply(state)
                self._last_good = self._state()
                self._log(f"{self.sentry.max_consecutive_bad} consecutive "
                          f"bad steps: rewound to checkpoint {ckpt_step}")
            else:
                self._apply(self._last_good)
                self._log("rewind requested but no valid checkpoint; "
                          "rolled back to last good in-memory state")
        if self.handle_preemption and \
                self.checkpointer.preemption_requested:
            self.checkpointer.wait()
            self.checkpointer.save(self.global_step, self._state())
            self.events.append(("preempt-save", self.global_step))
            self._log(f"preemption signal: saved step {self.global_step}, "
                      "stopping")
            self.model.stop_training = True

    def _save(self):
        state = self._state()
        if self.async_save:
            self.checkpointer.save_async(self.global_step, state)
        else:
            self.checkpointer.save(self.global_step, state)
        self.events.append(("save", self.global_step))

    def on_train_end(self, logs=None):
        if self.checkpointer is not None:
            self.checkpointer.close()
