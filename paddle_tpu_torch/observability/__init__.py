"""paddle_tpu_torch.observability — the port's telemetry (the port of
``paddle_tpu.observability``).

One process-global :class:`MetricsRegistry` is the single pane of glass
over the port's producers:

- the serving engine and its overload controller (TTFT/TPOT/occupancy,
  preemptions, sheds, timeouts, watchdog stalls and retries, the
  degradation ladder and health gauges, mirrored from
  ``serving.metrics`` under the reference's ``serving_*`` names);
- any compiled entry point wrapped with :func:`track_compiles` /
  :func:`warn_on_retrace` (graph captures and retraces of the serving
  steps, under the reference's ``xla_*`` names).

Telemetry is OFF by default: every producer checks :func:`enabled`
first.  Turning it on is one line — ``FileSink(dir).start()`` (periodic
Prometheus + JSON dumps), or :func:`enable` plus an explicit
:func:`prometheus_text` / :func:`to_json` export.  The reference's
``StepTimer`` belongs to its ``hapi`` training loop, which is not
ported.

Pure stdlib; importable from anywhere in the port without cycles.
"""
from .registry import (  # noqa: F401
    DEFAULT_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricSnapshot,
    MetricsRegistry,
    collect,
    disable,
    enable,
    enabled,
    get_registry,
)
from .exporters import (  # noqa: F401
    FileSink,
    prometheus_text,
    to_json,
    write_json,
    write_prometheus,
)
from .compile_tracker import (  # noqa: F401
    RetraceError,
    RetraceWarning,
    TrackedFunction,
    compile_stats,
    jit_cache_size,
    track_compiles,
    warn_on_retrace,
)

__all__ = [
    # registry
    "DEFAULT_BUCKETS", "Counter", "Gauge", "Histogram", "MetricSnapshot",
    "MetricsRegistry", "collect", "disable", "enable", "enabled",
    "get_registry",
    # exporters
    "FileSink", "prometheus_text", "to_json", "write_json",
    "write_prometheus",
    # compile tracking
    "RetraceError", "RetraceWarning", "TrackedFunction", "compile_stats",
    "jit_cache_size", "track_compiles", "warn_on_retrace",
]
