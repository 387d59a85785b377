"""Step-level training telemetry: the :class:`StepTimer` (the port of
``paddle_tpu/observability/step_metrics.py``).

``hapi.Model.fit`` drives batches through two alternating waits: the
host waiting on the DATA pipeline (``next(loader)``) and the host
waiting on the DEVICE (the train step).  The timer splits them.  CUDA
launches return before the card has run them, so the device phase ends
in a synchronize: ``Model.train_batch`` reads the loss as a Python
float, which waits for the card, so the split is the card's time and
not the launches'.

Usage (how ``Model.fit`` wires it)::

    timer = StepTimer()
    for i, batch in timer.timed_enumerate(loader):   # data-wait measured
        loss = train_batch(batch)                    # device-wait
        timer.step(loss=loss, inputs=batch)

The metric names are the reference's, with the wait as a ``phase``
label: histogram ``train_step_seconds{phase=data|device|total}``,
counters ``train_steps_total`` and ``train_tokens_total``, gauges
``train_loss``, ``train_steps_per_sec`` and ``train_tokens_per_sec``.
Every registry write is behind :func:`registry.enabled`.
"""
from __future__ import annotations

import time
from typing import Iterable, Iterator, Optional, Tuple

from . import registry as _registry

__all__ = ["StepTimer", "count_tokens"]


def count_tokens(inputs) -> int:
    """Token count of one batch: the element count of its first
    array-like (batch x seq_len for token models): ``numel()`` of a
    tensor, ``size`` of an array.  Unrecognizable structures count 0."""
    x = inputs
    while isinstance(x, (list, tuple)) and x:
        x = x[0]
    if isinstance(x, dict) and x:
        x = next(iter(x.values()))
    numel = getattr(x, "numel", None)
    if callable(numel):
        return int(numel())
    size = getattr(x, "size", None)
    if size is None or callable(size):
        return 0
    try:
        return int(size)
    except (TypeError, ValueError):
        return 0


class StepTimer:
    """Per-step wall-clock accounting with a data/device split.

    ``steps``, ``tokens``, ``last_loss``, ``data_seconds``,
    ``device_seconds``, :meth:`steps_per_sec` and :meth:`tokens_per_sec`
    are always live; the registry is mirrored only while
    :func:`registry.enabled`."""

    def __init__(self, registry: Optional["_registry.MetricsRegistry"] = None):
        self._registry = registry
        self.steps = 0
        self.tokens = 0
        self.data_seconds = 0.0
        self.device_seconds = 0.0
        self.last_loss: Optional[float] = None
        self._started = time.perf_counter()
        self._mark = self._started        # end of the last accounted span
        self._last_data = 0.0             # data-wait of the current step
        self._handles = None              # metric handles, made once

    def timed_enumerate(self, iterable: Iterable
                        ) -> Iterator[Tuple[int, object]]:
        """``enumerate(iterable)`` with each ``next()``'s wall time
        recorded as that step's data-wait."""
        it = iter(iterable)
        i = 0
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self._last_data = time.perf_counter() - t0
            yield i, batch
            i += 1

    def step(self, loss=None, inputs=None) -> None:
        """Close out one step: everything since the end of data-wait is
        device-wait.  Call after the step's result is on the host."""
        now = time.perf_counter()
        data = self._last_data
        device = max(0.0, now - self._mark - data)
        self._mark = now
        self._last_data = 0.0
        self.steps += 1
        self.data_seconds += data
        self.device_seconds += device
        ntok = count_tokens(inputs) if inputs is not None else 0
        self.tokens += ntok
        if loss is not None:
            try:
                self.last_loss = float(loss)
            except (TypeError, ValueError):
                pass
        if _registry.enabled():
            self._mirror(data, device, ntok)

    def elapsed(self) -> float:
        return time.perf_counter() - self._started

    def steps_per_sec(self) -> float:
        dt = self.elapsed()
        return self.steps / dt if dt > 0 else 0.0

    def tokens_per_sec(self) -> float:
        dt = self.elapsed()
        return self.tokens / dt if dt > 0 else 0.0

    def summary(self) -> dict:
        busy = self.data_seconds + self.device_seconds
        return {
            "steps": self.steps,
            "tokens": self.tokens,
            "steps_per_sec": self.steps_per_sec(),
            "tokens_per_sec": self.tokens_per_sec(),
            "data_seconds": self.data_seconds,
            "device_seconds": self.device_seconds,
            "data_fraction": self.data_seconds / busy if busy > 0 else 0.0,
            "last_loss": self.last_loss,
        }

    def _mirror(self, data: float, device: float, ntok: int) -> None:
        if self._handles is None:
            reg = (self._registry if self._registry is not None
                   else _registry.get_registry())
            self._handles = (
                reg.histogram("train_step_seconds",
                              "per-step wall time by wait phase"),
                reg.counter("train_steps_total", "train steps completed"),
                reg.counter("train_tokens_total",
                            "tokens consumed by training"),
                reg.gauge("train_loss", "last observed training loss"),
                reg.gauge("train_steps_per_sec",
                          "training throughput (steps/s, run average)"),
                reg.gauge("train_tokens_per_sec",
                          "training throughput (tokens/s, run average)"),
            )
        hist, c_steps, c_tok, g_loss, g_sps, g_tps = self._handles
        hist.observe(data, phase="data")
        hist.observe(device, phase="device")
        hist.observe(data + device, phase="total")
        c_steps.inc()
        if ntok:
            c_tok.inc(ntok)
        if self.last_loss is not None:
            g_loss.set(self.last_loss)
        g_sps.set(self.steps_per_sec())
        g_tps.set(self.tokens_per_sec())
