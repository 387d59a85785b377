"""Crash-safe checkpointing: atomic commits, integrity manifests,
valid-fallback restore, bounded async saves, preemption handling (the
single-process half of ``paddle_tpu/resilience/checkpoint.py``).

The fault model, as the reference's:

- **Torn save** — the process dies mid-write.  Every checkpoint is
  staged in a hidden temp directory and committed with ONE
  ``os.rename`` (atomic on POSIX), so a partial save is invisible to
  restore and reaped by the next save.
- **Disk rot / torn read** — a committed file is truncated or
  bit-flipped later.  Each checkpoint carries a ``manifest.json`` of
  per-file sha256 digests, verified on restore.
- **Corrupt latest** — :meth:`ResilientCheckpointer.restore_latest`
  walks checkpoints newest-first and returns the newest one that
  verifies, counting the corrupt ones it skipped.
- **Slow disk** — :meth:`ResilientCheckpointer.save_async` snapshots
  state to the host synchronously and writes from a worker thread
  behind a BOUNDED queue; a full queue blocks the caller.
- **Preemption** — :meth:`install_preemption_handler` turns SIGTERM
  into a flag the training loop polls at batch boundaries.

The snapshot is where the port differs from the reference.  There a
compiled step *donates* its buffers, so state must be copied before the
next step deletes it.  Here ``optimizer.step()`` *writes parameters and
moments in place*, so a reference to a live tensor would read a later
(or half-written) state.  :func:`host_snapshot` therefore makes a
finished host copy of every tensor (``.detach().to("cpu", copy=True)``,
then numpy; bf16 as a ``framework.io.TensorPayload`` of its ``uint16``
view, since numpy holds no bf16 here) before it returns.

Layout (the reference's format 1): ``directory/step_00000012/{<key>.pkl
..., manifest.json}``, one pickle a top-level state key, the manifest
written last, the directory committed by one rename.  A checkpoint the
JAX package wrote in this format restores here (its leaves are numpy).
The reference's sharded elastic format (format 2, ``ShardedHostLeaf``)
waits for ROADMAP item A3: ``sharded=True``, a process context of more
than one process and restoring a format-2 checkpoint raise
``NotImplementedError``.
"""
from __future__ import annotations

import hashlib
import json
import os
import pickle
import queue
import shutil
import signal
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..framework.io import TensorPayload, to_host
from ..observability import registry as _obsreg
from . import chaos

__all__ = [
    "CheckpointCorruption",
    "ResilientCheckpointer",
    "collect_state",
    "apply_state",
    "host_snapshot",
]

_MANIFEST = "manifest.json"
_FORMAT = 1
_FORMAT_SHARDED = 2
_SHARDED = ("sharded checkpoints (one writer a process, restore with "
            "reshard) wait for ROADMAP item A3's multi-process runtime")


class CheckpointCorruption(RuntimeError):
    """A checkpoint failed integrity verification (missing file, bad
    manifest, sha256 mismatch, unreadable pickle)."""


def host_snapshot(tree: Any) -> Any:
    """Deep-copy a state tree to the host: every tensor a finished numpy
    copy (bf16 a ``TensorPayload``), every array copied, containers
    rebuilt, other leaves as they are.  The caller may write the live
    tensors as soon as this returns."""
    if isinstance(tree, torch.Tensor):
        return to_host(tree)
    if isinstance(tree, dict):
        return {k: host_snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        t = [host_snapshot(v) for v in tree]
        return t if isinstance(tree, list) else tuple(t)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, TensorPayload):
        return TensorPayload(tree.array.copy(), tree.dtype)
    return tree


def collect_state(network=None, optimizer=None,
                  extra: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """One host tree holding everything a resume needs; its top-level
    keys become separate checkpoint files (each with its own digest)."""
    state: Dict[str, Any] = {}
    if network is not None:
        state["model"] = host_snapshot(network.state_dict())
    if optimizer is not None:
        state["optimizer"] = host_snapshot(optimizer.state_dict())
    for k, v in (extra or {}).items():
        state[k] = host_snapshot(v)
    return state


def apply_state(state: Dict[str, Any], network=None, optimizer=None):
    """Restore a :func:`collect_state` tree (of either package) into live
    objects: the network's parameters and persistent buffers copied in
    place by name (``convert.load_named``), the optimizer's state into
    fresh tensors (``Optimizer.set_state_dict``: by index in its
    parameter list, as the reference keys it)."""
    from ..convert import load_named

    if network is not None and "model" in state:
        load_named(network, state["model"])
    if optimizer is not None and "optimizer" in state:
        optimizer.set_state_dict(state["optimizer"])


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class ResilientCheckpointer:
    """Atomic, integrity-checked, preemption-aware checkpoint store of one
    process (the reference's format 1; see the module docstring)."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 max_pending: int = 2, sharded: Optional[bool] = None,
                 reap_age_s: float = 3600.0, process_context=None):
        if sharded or (process_context is not None
                       and process_context.count > 1):
            raise NotImplementedError(_SHARDED)
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.max_pending = max_pending
        self.reap_age_s = reap_age_s
        os.makedirs(self.directory, exist_ok=True)
        # counters (tests and stats() read these)
        self.saves = 0
        self.corrupt_skipped = 0
        # async machinery, started lazily
        self._queue: Optional[queue.Queue] = None
        self._worker: Optional[threading.Thread] = None
        self._async_error: Optional[BaseException] = None
        # preemption
        self._preempted = False
        self._prev_handlers: Dict[int, Any] = {}
        self._reap_stale_tmp()

    # ------------------------------------------------------------ paths
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> List[int]:
        """Committed checkpoint steps, ascending (no integrity check)."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    continue
        return sorted(out)

    def _reap_stale_tmp(self):
        """Remove dead staging directories: this process's own prefix
        (``.tmp-p0-``: a previous incarnation died mid-save), the
        reference's legacy ``.tmp-`` names without an owner, and any
        staging directory older than ``reap_age_s`` by the file
        system's clock."""
        now = self._fs_now()
        for name in os.listdir(self.directory):
            path = os.path.join(self.directory, name)
            if name.startswith(".tmp-"):
                legacy = not name.startswith(".tmp-p")
                if legacy or name.startswith(".tmp-p0-") or \
                        self._age_expired(path, now):
                    shutil.rmtree(path, ignore_errors=True)
            elif name.startswith(".staging-") and \
                    self._age_expired(path, now):
                shutil.rmtree(path, ignore_errors=True)

    def _fs_now(self) -> float:
        """The file system's "now": the mtime of a freshly touched probe
        in the checkpoint directory (ages compare file-system
        timestamps, so a server clock that drifts from this host's
        does not mis-age a directory)."""
        probe = os.path.join(self.directory, ".reap-probe")
        try:
            with open(probe, "w"):
                pass
            return os.path.getmtime(probe)
        except OSError:
            return float("-inf")   # can't tell the time: reap nothing

    def _age_expired(self, path: str, now: float) -> bool:
        try:
            return now - os.path.getmtime(path) > self.reap_age_s
        except OSError:
            return False

    # ------------------------------------------------------------- save
    def save(self, step: int, state: Dict[str, Any]) -> str:
        """Synchronous atomic save; returns the committed directory.
        Everything is staged under a tmp directory, the payloads fsynced,
        the manifest written LAST, then one rename commits it."""
        if not isinstance(state, dict) or not state:
            raise ValueError("state must be a non-empty dict of "
                             "{name: subtree}")
        t0 = time.perf_counter()
        self._reap_stale_tmp()
        tmp = os.path.join(
            self.directory,
            f".tmp-p0-{os.getpid()}-{step}-{uuid.uuid4().hex[:8]}")
        os.makedirs(tmp)
        try:
            files = {}
            for key, sub in state.items():
                fname = f"{key}.pkl"
                fpath = os.path.join(tmp, fname)
                with open(fpath, "wb") as f:
                    pickle.dump(host_snapshot(sub), f, protocol=4)
                    f.flush()
                    os.fsync(f.fileno())
                files[fname] = _sha256(fpath)
                chaos.on_save(f"resilience::write:{key}")
            manifest = {"format": _FORMAT, "step": step, "files": files}
            mpath = os.path.join(tmp, _MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            chaos.on_save("resilience::commit")
            final = self._step_dir(step)
            if os.path.exists(final):      # re-save of the same step
                shutil.rmtree(final)
            os.rename(tmp, final)          # THE commit point (atomic)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self.saves += 1
        if _obsreg.enabled():
            reg = _obsreg.get_registry()
            reg.counter("checkpoint_saves_total",
                        "checkpoints committed (atomic renames)").inc()
            reg.histogram("checkpoint_save_seconds",
                          "stage+fsync+commit wall time per checkpoint"
                          ).observe(time.perf_counter() - t0)
        chaos.after_save(final)
        self._gc()
        return final

    def save_async(self, step: int, state: Dict[str, Any]):
        """Snapshot ``state`` to the host now, write it from the worker
        thread.  Blocks while ``max_pending`` saves are queued.  An
        error of an earlier async save re-raises here (and in
        ``wait``)."""
        self._raise_async_error()
        snap = host_snapshot(state)
        if self._worker is None:
            self._queue = queue.Queue(maxsize=self.max_pending)
            self._worker = threading.Thread(
                target=self._drain, name="resilient-ckpt", daemon=True)
            self._worker.start()
        self._queue.put((step, snap))      # blocks when full

    def _drain(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                step, snap = item
                self.save(step, snap)
            except BaseException as e:  # noqa: BLE001 — surfaced to caller
                self._async_error = e
            finally:
                self._queue.task_done()

    def _raise_async_error(self):
        if self._async_error is not None:
            err, self._async_error = self._async_error, None
            raise err

    def wait(self):
        """Block until every queued async save is committed; re-raise
        the first async failure, if any."""
        if self._queue is not None:
            self._queue.join()
        self._raise_async_error()

    def close(self):
        if self._worker is not None:
            self._queue.join()
            self._queue.put(None)
            self._worker.join()
            self._worker = None
            self._queue = None
        self.uninstall_preemption_handler()
        self._raise_async_error()

    def _gc(self):
        keep = self.steps()
        if self.max_to_keep and len(keep) > self.max_to_keep:
            for step in keep[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def _load_verified(self, step: int) -> Dict[str, Any]:
        d = self._step_dir(step)
        try:
            with open(os.path.join(d, _MANIFEST)) as f:
                manifest = json.load(f)
        except (OSError, ValueError) as e:
            raise CheckpointCorruption(f"{d}: unreadable manifest ({e})")
        fmt = manifest.get("format")
        if fmt == _FORMAT_SHARDED:
            raise NotImplementedError(f"{d}: {_SHARDED}")
        if fmt != _FORMAT:
            raise CheckpointCorruption(
                f"{d}: unknown manifest format {fmt!r}")
        state = {}
        for fname, digest in manifest.get("files", {}).items():
            fpath = os.path.join(d, fname)
            if not os.path.exists(fpath):
                raise CheckpointCorruption(f"{d}: missing file {fname}")
            actual = _sha256(fpath)
            if actual != digest:
                raise CheckpointCorruption(
                    f"{d}: sha256 mismatch for {fname} "
                    f"(manifest {digest[:12]}…, file {actual[:12]}…)")
            try:
                with open(fpath, "rb") as f:
                    state[fname[:-4]] = pickle.load(f)
            except Exception as e:  # noqa: BLE001 — any unpickle failure
                raise CheckpointCorruption(f"{d}: unreadable {fname} ({e})")
        return state

    def restore(self, step: int) -> Dict[str, Any]:
        """Load and VERIFY one checkpoint; raises
        :class:`CheckpointCorruption` instead of returning bad state."""
        return self._load_verified(step)

    def restore_latest(self) -> Tuple[Optional[int], Optional[Dict]]:
        """Newest checkpoint that passes verification, or ``(None,
        None)``.  Corrupt or torn checkpoints are skipped (and counted
        in ``corrupt_skipped``) — never restored."""
        for step in reversed(self.steps()):
            try:
                return step, self._load_verified(step)
            except CheckpointCorruption as e:
                self.corrupt_skipped += 1
                if _obsreg.enabled():
                    _obsreg.get_registry().counter(
                        "checkpoint_corrupt_skipped_total",
                        "corrupt checkpoints skipped during restore"
                    ).inc()
                print(f"[paddle_tpu_torch.resilience] skipping corrupt "
                      f"checkpoint: {e}", file=sys.stderr)
        return None, None

    # ------------------------------------------------------- preemption
    def install_preemption_handler(self, signals=(signal.SIGTERM,)):
        """Latch preemption signals into a flag the training loop polls
        (``preemption_requested``) at batch boundaries.  Main thread
        only (CPython restricts ``signal.signal``)."""
        for s in signals:
            self._prev_handlers[s] = signal.signal(s, self._on_signal)

    def uninstall_preemption_handler(self):
        for s, prev in self._prev_handlers.items():
            signal.signal(s, prev)
        self._prev_handlers.clear()

    def _on_signal(self, signum, frame):
        self._preempted = True

    @property
    def preemption_requested(self) -> bool:
        return self._preempted

    # ------------------------------------------------------------ stats
    def stats(self) -> dict:
        return {
            "directory": self.directory,
            "steps": self.steps(),
            "saves": self.saves,
            "corrupt_skipped": self.corrupt_skipped,
            "pending_async": self._queue.qsize() if self._queue else 0,
            "preemption_requested": self._preempted,
        }
