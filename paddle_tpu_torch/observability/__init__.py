"""paddle_tpu_torch.observability — compile and retrace accounting (the
part of ``paddle_tpu.observability`` that the serving engine's
no-retrace contract needs).

- :mod:`compile_tracker` — :func:`track_compiles`, :func:`warn_on_retrace`
  and :func:`compile_stats` over the port's compiled steps
  (``paddle_tpu_torch.jit.GraphStep``)
"""
from .compile_tracker import (RetraceError, RetraceWarning, TrackedFunction,
                              compile_stats, jit_cache_size, track_compiles,
                              warn_on_retrace)

__all__ = ["RetraceError", "RetraceWarning", "TrackedFunction",
           "compile_stats", "jit_cache_size", "track_compiles",
           "warn_on_retrace"]
