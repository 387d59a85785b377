"""Exporters over :func:`registry.collect` snapshots (the port's copy of
``paddle_tpu/observability/exporters.py``, stdlib only).

Three consumers, one snapshot format:

- :func:`prometheus_text` — the Prometheus text exposition format
  (``# HELP``/``# TYPE`` headers, ``_bucket{le=...}``/``_sum``/
  ``_count`` histogram triplets), scrape-ready;
- :func:`to_json` / :func:`write_json` — structured JSON for log
  pipelines and tests;
- :class:`FileSink` — a periodic background writer dumping both formats
  to a directory (atomic ``os.replace`` so a scraper never reads a torn
  file); ``start()`` also flips the global :func:`registry.enable`
  switch, which is what arms the framework's producers.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from .registry import MetricsRegistry, MetricSnapshot, enable, get_registry

__all__ = ["prometheus_text", "to_json", "write_json",
           "write_prometheus", "FileSink"]


def _escape_label_value(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _label_str(key, extra: Optional[List] = None) -> str:
    pairs = list(key) + list(extra or [])
    if not pairs:
        return ""
    body = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                    for k, v in pairs)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def prometheus_text(registry: Optional[MetricsRegistry] = None) -> str:
    """One snapshot in the Prometheus text exposition format (0.0.4).
    Histogram buckets are emitted CUMULATIVE with an ``+Inf`` terminal
    bucket equal to ``_count``, per the format spec."""
    reg = registry if registry is not None else get_registry()
    lines: List[str] = []
    for snap in reg.collect():
        if snap.help:
            lines.append(f"# HELP {snap.name} {snap.help}")
        lines.append(f"# TYPE {snap.name} {snap.kind}")
        for key in sorted(snap.series):
            val = snap.series[key]
            if snap.kind == "histogram":
                cum = 0
                for bound, n in zip(snap.boundaries, val["buckets"]):
                    cum += n
                    lines.append(
                        f"{snap.name}_bucket"
                        f"{_label_str(key, [('le', _fmt(bound))])} {cum}")
                lines.append(
                    f"{snap.name}_bucket"
                    f"{_label_str(key, [('le', '+Inf')])} {val['count']}")
                lines.append(f"{snap.name}_sum{_label_str(key)} "
                             f"{repr(float(val['sum']))}")
                lines.append(f"{snap.name}_count{_label_str(key)} "
                             f"{val['count']}")
            else:
                lines.append(f"{snap.name}{_label_str(key)} {_fmt(val)}")
    return "\n".join(lines) + ("\n" if lines else "")


def _snap_to_json(snap: MetricSnapshot) -> dict:
    series = []
    for key in sorted(snap.series):
        val = snap.series[key]
        entry: dict = {"labels": dict(key)}
        if snap.kind == "histogram":
            entry.update({"buckets": list(val["buckets"]),
                          "sum": float(val["sum"]),
                          "count": int(val["count"])})
        else:
            entry["value"] = float(val)
        series.append(entry)
    out = {"name": snap.name, "kind": snap.kind, "help": snap.help,
           "series": series}
    if snap.boundaries is not None:
        out["boundaries"] = list(snap.boundaries)
    return out


def to_json(registry: Optional[MetricsRegistry] = None) -> dict:
    """One snapshot as a JSON-ready dict:
    ``{"ts": unix_seconds, "metrics": [...]}``."""
    reg = registry if registry is not None else get_registry()
    return {"ts": time.time(),
            "metrics": [_snap_to_json(s) for s in reg.collect()]}


def _atomic_write(path: str, data: str):
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(data)
    os.replace(tmp, path)


def write_json(path: str, registry: Optional[MetricsRegistry] = None) -> str:
    """Dump :func:`to_json` to ``path`` (atomic replace); returns path."""
    _atomic_write(path, json.dumps(to_json(registry), indent=1))
    return path


def write_prometheus(path: str,
                     registry: Optional[MetricsRegistry] = None) -> str:
    """Dump :func:`prometheus_text` to ``path`` (atomic replace)."""
    _atomic_write(path, prometheus_text(registry))
    return path


class FileSink:
    """Periodic metrics dumper: every ``interval_s`` (and on ``stop()``)
    writes ``<prefix>.prom`` and ``<prefix>.json`` into ``directory``.

    Installing the sink is what turns the framework's telemetry ON:
    ``start()`` calls :func:`registry.enable` (and ``stop()`` restores
    the previous state), so code paths stay no-op until someone actually
    wants the numbers.  ``interval_s=None`` skips the thread — use
    :meth:`dump` for explicit one-shot exports.
    """

    def __init__(self, directory: str, interval_s: Optional[float] = 10.0,
                 prefix: str = "metrics",
                 registry: Optional[MetricsRegistry] = None):
        if interval_s is not None and interval_s <= 0:
            raise ValueError("interval_s must be positive (or None)")
        self.directory = directory
        self.interval_s = interval_s
        self.prefix = prefix
        self._registry = registry
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._prev_enabled: Optional[bool] = None
        self.writes = 0

    # -- paths
    @property
    def prom_path(self) -> str:
        return os.path.join(self.directory, f"{self.prefix}.prom")

    @property
    def json_path(self) -> str:
        return os.path.join(self.directory, f"{self.prefix}.json")

    def dump(self) -> Dict[str, str]:
        """Write both formats once; returns ``{"prom": ..., "json": ...}``."""
        os.makedirs(self.directory, exist_ok=True)
        out = {"prom": write_prometheus(self.prom_path, self._registry),
               "json": write_json(self.json_path, self._registry)}
        self.writes += 1
        return out

    # -- lifecycle
    def start(self) -> "FileSink":
        self._prev_enabled = enable(True)
        if self.interval_s is not None and self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="observability-sink", daemon=True)
            self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.dump()
            except Exception:  # noqa: BLE001 — a full disk must not kill it
                pass

    def stop(self, final_dump: bool = True):
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
        if final_dump:
            self.dump()
        if self._prev_enabled is not None:
            enable(self._prev_enabled)
            self._prev_enabled = None

    def __enter__(self) -> "FileSink":
        return self.start()

    def __exit__(self, *a):
        self.stop()
        return False
