"""Process-global metrics registry: Counter / Gauge / Histogram (the
port's copy of ``paddle_tpu/observability/registry.py``, stdlib only;
the same names, kinds and snapshots, so a dashboard written for the
reference reads the port).

Every producer of the port (the serving engine and its overload
controller, the compile tracker's graph captures) reports through ONE
registry, and one snapshot-consistent :func:`MetricsRegistry.collect`
feeds every exporter (``observability.exporters``).  The registry is
the port's own: the JAX package's registry is another process global.

Design rules (each earned by a production failure mode):

- **Fixed metric names, labels for dimensions.**  A metric name built
  with an f-string (``Counter(f"requests_{user}")``) creates one series
  per distinct value — unbounded registry growth.  Lint L006
  (``analysis.astlint``) flags exactly that call-site shape; dynamic
  parts belong in labels.
- **Hard label-cardinality cap.**  Labels are bounded too: past
  ``max_series`` distinct label-sets, further observations fold into a
  reserved ``{"overflow": "true"}`` series (warned once) instead of
  growing without bound.
- **Snapshot-consistent collect().**  One registry lock guards every
  mutation; ``collect()`` copies every series under that lock, so an
  exporter never sees a histogram whose ``sum`` and ``count`` disagree.
- **No-op when idle.**  Producers across the framework consult
  :func:`enabled` (a dict read) before touching the registry; until
  :func:`enable` is called — directly or by installing an exporter sink
  — the hot paths pay one boolean check and nothing else.
"""
from __future__ import annotations

import math
import re
import threading
import warnings
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "MetricSnapshot",
    "DEFAULT_BUCKETS",
    "get_registry",
    "collect",
    "enable",
    "disable",
    "enabled",
]

_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_LABEL_RE = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")

# Latency-shaped fixed boundaries (seconds), Prometheus client defaults:
# fixed at metric creation so bucket counts stay comparable across the
# whole process lifetime (a run-time re-bucketing would corrupt rates).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)

# The reserved series every over-cap observation folds into.
_OVERFLOW_KEY: Tuple[Tuple[str, str], ...] = (("overflow", "true"),)


# ---------------------------------------------------------------------------
# global on/off switch (the idle fast path)
# ---------------------------------------------------------------------------

_STATE = {"enabled": False}


def enabled() -> bool:
    """Whether framework producers should record into the registry.
    Hot paths (serving steps and request events, graph captures) check
    this one dict read and skip ALL metric work when off."""
    return _STATE["enabled"]


def enable(on: bool = True) -> bool:
    """Turn framework-wide metric production on (returns the previous
    state).  Installing an exporter sink (``FileSink.start``) calls this
    for you."""
    prev = _STATE["enabled"]
    _STATE["enabled"] = bool(on)
    return prev


def disable() -> bool:
    """``enable(False)``."""
    return enable(False)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

class MetricSnapshot(NamedTuple):
    """One metric at one collect() instant.  ``series`` maps a sorted
    ``((label, value), ...)`` key to a float (counter/gauge) or to a
    ``{"buckets": [int, ...], "sum": float, "count": int}`` dict
    (histogram; ``buckets`` is cumulative-free per-bucket counts aligned
    with ``boundaries`` plus one final +Inf bucket)."""

    name: str
    kind: str
    help: str
    series: Dict[Tuple[Tuple[str, str], ...], object]
    boundaries: Optional[Tuple[float, ...]] = None


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 registry: Optional["MetricsRegistry"] = None,
                 max_series: int = 64):
        if not _NAME_RE.match(name or ""):
            raise ValueError(f"invalid metric name {name!r} (want "
                             "[a-zA-Z_:][a-zA-Z0-9_:]*)")
        if max_series < 1:
            raise ValueError("max_series must be >= 1")
        self.name = name
        self.help = help
        self.max_series = max_series
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}
        self._overflowed = False
        registry = registry if registry is not None else get_registry()
        self._registry = registry
        self._lock = registry._lock          # shared: collect() is atomic
        registry._register(self)

    # -- series bookkeeping
    def _key(self, labels: Dict[str, object]
             ) -> Tuple[Tuple[str, str], ...]:
        if not labels:
            return ()
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        if key not in self._series and len(self._series) >= self.max_series:
            if not self._overflowed:
                self._overflowed = True
                warnings.warn(
                    f"metric {self.name!r} exceeded its label-cardinality "
                    f"cap ({self.max_series} series); further new label "
                    "sets fold into the {'overflow': 'true'} series — "
                    "dynamic values belong in bounded labels (lint L006)",
                    RuntimeWarning, stacklevel=4)
            return _OVERFLOW_KEY
        return key

    def _zero(self):
        return 0.0

    def _cell(self, labels: Dict[str, object]):
        key = self._key(labels)
        cell = self._series.get(key)
        if cell is None:
            cell = self._series[key] = self._zero()
        return key, cell

    def labels_count(self) -> int:
        with self._lock:
            return len(self._series)

    def snapshot(self) -> MetricSnapshot:
        with self._lock:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> MetricSnapshot:
        return MetricSnapshot(self.name, self.kind, self.help,
                              dict(self._series))


class Counter(_Metric):
    """Monotonic counter.  ``inc(value, **labels)``; negative increments
    are a ValueError (rates depend on monotonicity)."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease "
                             f"(inc({value}))")
        with self._lock:
            key, cur = self._cell(labels)
            self._series[key] = cur + value

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Gauge(_Metric):
    """Point-in-time value: ``set``/``inc``/``dec``."""

    kind = "gauge"

    def set(self, value: float, **labels):
        with self._lock:
            key, _ = self._cell(labels)
            self._series[key] = float(value)

    def inc(self, value: float = 1.0, **labels):
        with self._lock:
            key, cur = self._cell(labels)
            self._series[key] = cur + value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return float(self._series.get(self._key(labels), 0.0))


class Histogram(_Metric):
    """Fixed-boundary histogram.  Boundaries are upper bounds (``le``),
    ascending, fixed at creation; one implicit +Inf bucket is appended.
    Each series holds per-bucket counts plus ``sum``/``count``."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_BUCKETS,
                 registry: Optional["MetricsRegistry"] = None,
                 max_series: int = 64):
        bounds = tuple(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram buckets must be strictly "
                             f"ascending, got {bounds}")
        if math.isinf(bounds[-1]):
            bounds = bounds[:-1]            # +Inf is implicit
        self.boundaries = bounds
        super().__init__(name, help, registry=registry,
                         max_series=max_series)

    def _zero(self):
        return {"buckets": [0] * (len(self.boundaries) + 1),
                "sum": 0.0, "count": 0}

    def observe(self, value: float, **labels):
        v = float(value)
        with self._lock:
            _, cell = self._cell(labels)
            i = 0
            for i, bound in enumerate(self.boundaries):
                if v <= bound:
                    break
            else:
                i = len(self.boundaries)    # +Inf bucket
            cell["buckets"][i] += 1
            cell["sum"] += v
            cell["count"] += 1

    def count(self, **labels) -> int:
        with self._lock:
            cell = self._series.get(self._key(labels))
            return int(cell["count"]) if cell else 0

    def sum(self, **labels) -> float:
        with self._lock:
            cell = self._series.get(self._key(labels))
            return float(cell["sum"]) if cell else 0.0

    def _snapshot_locked(self) -> MetricSnapshot:
        series = {k: {"buckets": list(v["buckets"]), "sum": v["sum"],
                      "count": v["count"]}
                  for k, v in self._series.items()}
        return MetricSnapshot(self.name, self.kind, self.help, series,
                              self.boundaries)


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Name -> metric map with get-or-create accessors and an atomic
    :meth:`collect`.  One RLock guards registration, every metric
    mutation, and collection (metrics share the registry's lock), so a
    collect() is a consistent cut across all metrics."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}

    # -- registration
    def _register(self, metric: _Metric):
        with self._lock:
            existing = self._metrics.get(metric.name)
            if existing is not None:
                raise ValueError(
                    f"metric {metric.name!r} already registered as "
                    f"{existing.kind} — use registry."
                    f"{existing.kind}(...) to share it")
            self._metrics[metric.name] = metric

    def _get_or_create(self, cls, name: str, help: str, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise TypeError(
                        f"metric {name!r} is a {existing.kind}, not a "
                        f"{cls.kind}")
                return existing
            return cls(name, help, registry=self, **kwargs)

    def counter(self, name: str, help: str = "",
                max_series: int = 64) -> Counter:
        """Get-or-create a :class:`Counter`."""
        return self._get_or_create(Counter, name, help,
                                   max_series=max_series)

    def gauge(self, name: str, help: str = "",
              max_series: int = 64) -> Gauge:
        """Get-or-create a :class:`Gauge`."""
        return self._get_or_create(Gauge, name, help,
                                   max_series=max_series)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  max_series: int = 64) -> Histogram:
        """Get-or-create a :class:`Histogram`; re-requesting one with
        different boundaries is a ValueError (buckets are fixed)."""
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, Histogram):
                    raise TypeError(f"metric {name!r} is a "
                                    f"{existing.kind}, not a histogram")
                want = tuple(float(b) for b in buckets)
                if math.isinf(want[-1]) if want else False:
                    want = want[:-1]
                if want != existing.boundaries:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"boundaries {existing.boundaries}, requested "
                        f"{want} — buckets are fixed at creation")
                return existing
            return Histogram(name, help, buckets=buckets, registry=self,
                             max_series=max_series)

    # -- access
    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    def unregister(self, name: str) -> bool:
        with self._lock:
            return self._metrics.pop(name, None) is not None

    def clear(self):
        """Drop every metric (tests; exporters of a cleared registry
        emit nothing)."""
        with self._lock:
            self._metrics.clear()

    def collect(self) -> List[MetricSnapshot]:
        """Atomic snapshot of every metric, name-sorted.  Taken under
        the shared lock: no concurrent inc()/observe() can land between
        two metrics' copies."""
        with self._lock:
            return [self._metrics[n]._snapshot_locked()
                    for n in sorted(self._metrics)]


_default: Optional[MetricsRegistry] = None
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global default registry (created on first use)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = MetricsRegistry()
    return _default


def collect() -> List[MetricSnapshot]:
    """``get_registry().collect()``."""
    return get_registry().collect()
