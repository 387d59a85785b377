"""Runtime compile/retrace accounting (the port of
``paddle_tpu/observability/compile_tracker.py``).

The port compiles a fixed-shape step by capturing it as a CUDA graph
(:class:`paddle_tpu_torch.jit.GraphStep`, the counterpart of a
``jax.jit`` product): a new input signature captures a new graph, as a
new shape retraces a jit.  This module counts those captures the way
the reference counts XLA compiles:

- :func:`track_compiles` wraps a compiled entry point (a ``GraphStep``,
  anything with a ``_cache_size()`` or a ``_cache`` dict) and records,
  per function: compile count, cumulative compile seconds, and live
  cache size.  A compile is detected as cache growth across a call, and
  that call's wall time is attributed to compilation (the warmup, the
  capture and the first replay dominate any call that grows the cache).
- :func:`warn_on_retrace` is the reusable no-retrace guard: it allows
  ``after`` compiles (warmup), then every further compile — a RETRACE —
  warns (:class:`RetraceWarning`) or raises (:class:`RetraceError`).
  The serving engine's strict no-retrace assertion is this primitive
  with ``on_retrace="raise"``.
- :func:`compile_stats` aggregates every live tracked function;
  when :func:`registry.enabled`, each compile also lands in the shared
  registry under the reference's names (``xla_compiles_total`` /
  ``xla_compile_seconds_total`` counters, the ``xla_jit_cache_entries``
  gauge and, past the warmup allowance, ``xla_retraces_total``, each
  labelled by the step's ``fn``), so a dashboard written for the
  reference reads the port.  Here a "compile" is a graph capture (with
  its eager warmup, and on a cold build directory the kernels' build);
  the names keep the reference's ``xla_`` prefix all the same.
"""
from __future__ import annotations

import functools
import threading
import time
import warnings
import weakref
from typing import Callable, Dict, List, Optional

from . import registry as _registry

__all__ = [
    "RetraceError",
    "RetraceWarning",
    "TrackedFunction",
    "track_compiles",
    "warn_on_retrace",
    "jit_cache_size",
    "compile_stats",
]


class RetraceError(RuntimeError):
    """A guarded function retraced past its warmup allowance."""


class RetraceWarning(UserWarning):
    """A guarded function retraced past its warmup allowance."""


def jit_cache_size(fn) -> int:
    """Live cache entries behind ``fn``: a ``GraphStep`` (its captured
    graphs, ``_cache_size()``), a function with a ``_cache`` dict, or an
    already-tracked function (delegates)."""
    probe = getattr(fn, "_cache_size", None)
    if callable(probe):                      # GraphStep / TrackedFunction
        return int(probe())
    cache = getattr(fn, "_cache", None)
    if isinstance(cache, dict):
        return len(cache)
    raise TypeError(
        f"cannot read a jit cache from {type(fn).__name__} — expected a "
        "jit.GraphStep, a function with a _cache dict, or a "
        "TrackedFunction")


# live tracked functions, for compile_stats(); weak so tracking never
# extends a model's lifetime (the serving steps hold whole models)
_tracked: List["weakref.ref[TrackedFunction]"] = []
_tracked_lock = threading.Lock()


class TrackedFunction:
    """Transparent wrapper recording compile events of a compiled entry
    point.

    ``compiles``/``compile_seconds`` count cache-growth calls and their
    wall time; ``calls`` counts everything.  The wrapped function's
    attributes (``__name__``, ``_cache_size``) stay reachable, so a
    TrackedFunction drops in anywhere the raw compiled callable went.
    """

    def __init__(self, fn: Callable, label: Optional[str] = None):
        jit_cache_size(fn)                   # fail fast on untrackable fns
        self._fn = fn
        self.label = label or getattr(fn, "__name__", None) or repr(fn)
        self.calls = 0
        self.compiles = 0
        self.compile_seconds = 0.0
        functools.update_wrapper(self, fn, updated=[])
        with _tracked_lock:
            _tracked.append(weakref.ref(self))

    # the engine and tests read cache sizes through the wrapper
    def cache_size(self) -> int:
        return jit_cache_size(self._fn)

    _cache_size = cache_size

    def __getattr__(self, name):
        # the wrapped function's own attributes (a GraphStep's ``eager``)
        if name == "_fn":
            raise AttributeError(name)
        return getattr(self._fn, name)

    def __call__(self, *args, **kwargs):
        before = jit_cache_size(self._fn)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        self.calls += 1
        after = jit_cache_size(self._fn)
        if after > before:
            dt = time.perf_counter() - t0
            self.compiles += after - before
            self.compile_seconds += dt
            self._on_compile(after, dt)
        return out

    def _on_compile(self, cache_size: int, dt: float):
        if _registry.enabled():
            _mirror_compile(self.label, cache_size, dt)

    def stats(self) -> dict:
        return {"label": self.label, "calls": self.calls,
                "compiles": self.compiles,
                "compile_seconds": self.compile_seconds,
                "cache_size": self.cache_size()}

    def __repr__(self):
        return (f"<TrackedFunction {self.label!r} compiles={self.compiles} "
                f"cache={self.cache_size()}>")


def _mirror_compile(label: str, cache_size: int, dt: float):
    """Land one compile (a graph capture) in the shared registry
    (enabled() only)."""
    reg = _registry.get_registry()
    reg.counter("xla_compiles_total",
                "jit compiles observed per tracked entry point").inc(
                    fn=label)
    reg.counter("xla_compile_seconds_total",
                "cumulative wall seconds of compiling calls").inc(
                    dt, fn=label)
    reg.gauge("xla_jit_cache_entries",
              "live jit-cache entries per tracked entry point").set(
                  cache_size, fn=label)


class _RetraceGuarded(TrackedFunction):
    """TrackedFunction that reacts once ``compiles`` exceeds ``after``."""

    def __init__(self, fn: Callable, after: int = 1,
                 label: Optional[str] = None, on_retrace: str = "warn"):
        if after < 0:
            raise ValueError("after must be >= 0")
        if on_retrace not in ("warn", "raise", "count"):
            raise ValueError("on_retrace must be 'warn', 'raise' or "
                             "'count'")
        super().__init__(fn, label=label)
        self.after = after
        self.on_retrace = on_retrace

    @property
    def retraces(self) -> int:
        """Compiles past the warmup allowance."""
        return max(0, self.compiles - self.after)

    def _on_compile(self, cache_size: int, dt: float):
        super()._on_compile(cache_size, dt)
        if self.compiles <= self.after:
            return
        if _registry.enabled():
            _registry.get_registry().counter(
                "xla_retraces_total",
                "compiles past the warmup allowance (H101 at runtime)",
            ).inc(fn=self.label)
        msg = (f"{self.label}: retraced after warmup (compile "
               f"#{self.compiles}, allowance {self.after}; jit cache now "
               f"{cache_size} entries) — an input changed shape/dtype or "
               "a pool was rebound; on the GPU this captures a new CUDA "
               "graph per call (H101)")
        if self.on_retrace == "raise":
            raise RetraceError(msg)
        if self.on_retrace == "warn":
            warnings.warn(msg, RetraceWarning, stacklevel=4)


def track_compiles(fn: Optional[Callable] = None, *,
                   label: Optional[str] = None):
    """Wrap ``fn`` in a :class:`TrackedFunction`; usable bare or as a
    decorator (``@track_compiles`` / ``@track_compiles(label=...)``)."""
    if fn is None:
        return lambda f: TrackedFunction(f, label=label)
    return TrackedFunction(fn, label=label)


def warn_on_retrace(fn: Callable, after: int = 1,
                    label: Optional[str] = None,
                    on_retrace: str = "warn") -> _RetraceGuarded:
    """The reusable no-retrace guard: returns ``fn`` wrapped so that its
    first ``after`` compiles (warmup) pass silently and every compile
    beyond them triggers ``on_retrace`` — ``"warn"`` (default),
    ``"raise"`` (the serving engine's strict contract), or ``"count"``
    (record only; read ``.retraces``).  Compiles are detected as cache
    growth, so each wrapper counts what THIS call path compiled."""
    return _RetraceGuarded(fn, after=after, label=label,
                           on_retrace=on_retrace)


def compile_stats() -> Dict[str, dict]:
    """Aggregated stats of every live tracked function, by label.
    Labels repeat (two engines' decode steps): counts merge, cache_size
    takes the latest."""
    out: Dict[str, dict] = {}
    with _tracked_lock:
        live = [r() for r in _tracked]
        _tracked[:] = [r for r, t in zip(_tracked, live) if t is not None]
    for t in live:
        if t is None:
            continue
        s = t.stats()
        agg = out.setdefault(s["label"], {
            "calls": 0, "compiles": 0, "compile_seconds": 0.0,
            "cache_size": 0})
        agg["calls"] += s["calls"]
        agg["compiles"] += s["compiles"]
        agg["compile_seconds"] += s["compile_seconds"]
        agg["cache_size"] = s["cache_size"]
    return out
