"""CUDA graphs of fixed-shape steps: the port's counterpart of ``jax.jit``
for the serving engine's steps.

The JAX engine runs each serving step as one compiled program; here one
host call replays a captured CUDA graph of the whole step.
:class:`GraphStep` keeps one graph for each input signature it has
seen, as a jit keeps one executable a signature:

- the key is each input's kind (a tensor, or host data: numpy or a
  Python number), shape and dtype, and for every BOUND argument (the KV
  pools, updated in place) the ``data_ptr``, device, shape and dtype of
  each of its tensors.  A graph bakes in the addresses it read and
  wrote, so a rebound pool is a new key (a retrace that
  ``observability.warn_on_retrace`` sees), never a replay over stale
  memory;
- on first sight of a key it allocates static input buffers, runs the
  step eagerly once on the device's capture stream (the warmup: the
  kernels' one-time state, cuBLAS's handle and workspace, paged
  decode's ticket buffer for that stream), then captures it on the same
  stream into a ``torch.cuda.CUDAGraph``.  Every graph is captured on
  that one stream, so they share its ticket buffer and its cuBLAS
  workspace: graphs replay one after another on a caller's stream, as
  the engine's do, never two at once.  The
  warmup and the capture read the static buffers while they hold zeros:
  all-zero block tables, lengths and chunk starts address only the
  pools' reserved garbage block 0 and token 0 embeds, whatever the bound
  tensors (the pools, the engine's per-slot sampling state) hold;
- every call copies its inputs into the static buffers (host data
  packed into one pinned buffer and copied with ONE non-blocking
  host-to-device copy; tensors one device copy each), replays, and
  returns the graph's static output.  A caller consumes that output
  before the next replay of any graph of the same pool, which may
  reuse its memory.

The same path runs on the CPU without capture: the inputs are copied
into the static buffers and the step runs eagerly on them, so the CPU
tests exercise the copies, the keys and the counts.  The device alone
decides: a capture that fails raises, and nothing falls back to eager
on the card.  ``eager`` is the step itself, for checks that hold a
replay against it.

A graph's replay launches kernels without running their wrappers, so
the launch counters (``kernels._build.launches``) take the launches
its capture recorded at every replay, and the warmup and the capture
count nothing.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Iterable

import numpy as np
import torch

from ..kernels._build import launches

ALIGN = 256      # byte alignment of each host input in the packed buffer

# the side stream of each device on which every graph is warmed up and
# captured (a stream of its own would keep a cuBLAS workspace each)
_capture_streams: dict = {}


def _host_array(a) -> np.ndarray:
    """A host input as numpy: Python numbers in the types a jit gives
    them (int -> int32, float -> float32), numpy data as it is."""
    if isinstance(a, bool):
        return np.asarray(a)
    if isinstance(a, int):
        return np.asarray(a, np.int32)
    if isinstance(a, float):
        return np.asarray(a, np.float32)
    return np.asarray(a)


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


def _leaves(tree) -> Iterable[torch.Tensor]:
    """The tensors of a bound argument (a tensor, or lists and tuples of
    them: the pools)."""
    if isinstance(tree, torch.Tensor):
        yield tree
        return
    for t in tree:
        yield from _leaves(t)


class _Entry:
    """One signature's static buffers and, on the card, its graph."""

    __slots__ = ("call", "host", "tensors", "packed", "staging", "copied",
                 "graph", "out", "delta")

    def __init__(self):
        self.graph = self.out = self.delta = self.copied = None


class GraphStep:
    """``fn`` captured as one CUDA graph per input signature and replayed
    (the module docstring).  ``bound`` names the positions of the
    arguments passed by reference (the pools): their addresses are part
    of the key and their contents are never copied.  ``pool`` is a
    ``torch.cuda.graph_pool_handle()`` shared by graphs that replay one
    after another (an engine's steps); None gives each graph its own.
    ``_cache_size()`` counts the signatures captured, so
    ``observability.warn_on_retrace`` reads it as it reads a jit."""

    def __init__(self, fn: Callable, device, bound: Iterable[int] = (),
                 pool=None):
        self.eager = fn
        self.device = torch.device(device)
        self.bound = frozenset(bound)
        self.pool = pool
        self._entries: dict = {}

    @property
    def captures(self) -> bool:
        """Whether this step captures graphs: on a CUDA device only."""
        return self.device.type == "cuda"

    def _cache_size(self) -> int:
        return len(self._entries)

    def _signature(self, args) -> tuple:
        """The cache key of a call's arguments."""
        sig = []
        for i, a in enumerate(args):
            if i in self.bound:
                sig.append(tuple((t.data_ptr(), t.device, tuple(t.shape),
                                  t.dtype) for t in _leaves(a)))
            elif isinstance(a, torch.Tensor):
                sig.append(("tensor", tuple(a.shape), a.dtype))
            else:
                h = _host_array(a)
                sig.append(("host", h.shape, h.dtype.str))
        return tuple(sig)

    def __call__(self, *args):
        key = self._signature(args)
        entry = self._entries.get(key)
        if entry is None:
            entry = self._new_entry(args)
            if self.captures:
                self._capture(entry, self._call_args(entry, args))
            self._entries[key] = entry
        self._copy_in(entry, args)
        if entry.graph is None:
            return self.eager(*self._call_args(entry, args))
        launches.replay(entry.delta)
        entry.graph.replay()
        return entry.out

    # ------------------------------------------------------ static inputs
    def _new_entry(self, args) -> _Entry:
        """Zeroed static buffers for a new signature: the host inputs
        packed into one device buffer (each at an ALIGN-byte offset) with
        a pinned twin on the card's host, each tensor input a buffer of
        its own."""
        e, layout, size = _Entry(), [], 0
        for i, a in enumerate(args):
            if i in self.bound or isinstance(a, torch.Tensor):
                continue
            h = _host_array(a)
            layout.append((i, size, h.nbytes, h.shape, h.dtype))
            size += -(-h.nbytes // ALIGN) * ALIGN
        e.packed = torch.zeros(max(size, ALIGN), dtype=torch.uint8,
                               device=self.device)
        e.staging = e.packed
        if self.device.type == "cuda":
            e.staging = torch.zeros(e.packed.shape, dtype=torch.uint8,
                                    pin_memory=True)
            e.copied = torch.cuda.Event()
        host = e.staging.numpy()
        e.call, e.host, e.tensors = list(args), [], []
        for i, off, n, shape, dtype in layout:
            e.host.append((i, host[off:off + n].view(dtype).reshape(shape)))
            e.call[i] = e.packed[off:off + n].view(
                _torch_dtype(dtype)).view(shape)
        for i, a in enumerate(args):
            if i not in self.bound and isinstance(a, torch.Tensor):
                e.call[i] = torch.zeros(a.shape, dtype=a.dtype,
                                        device=self.device)
                e.tensors.append((i, e.call[i]))
        return e

    def _call_args(self, e: _Entry, args) -> list:
        call = list(e.call)
        for i in self.bound:
            call[i] = args[i]
        return call

    def _copy_in(self, e: _Entry, args):
        if e.copied is not None:
            # the last call's copy out of the pinned buffer must be done
            # before the host writes it again
            e.copied.synchronize()
        for i, view in e.host:
            np.copyto(view, _host_array(args[i]))
        if e.staging is not e.packed:
            e.packed.copy_(e.staging, non_blocking=True)
            e.copied.record(torch.cuda.current_stream(self.device))
        for i, buf in e.tensors:
            buf.copy_(args[i])

    # ------------------------------------------------------------ capture
    def _capture(self, e: _Entry, call: list):
        """Warm up and capture ``call`` while the static buffers hold
        zeros.  The launches the captured pass recorded become the
        entry's delta; the counts go back to where they stood."""
        mark = launches.mark()
        try:
            with self._capture_stream():
                self.eager(*call)
                captured = launches.mark()
                e.graph, e.out = self._record(call)
                e.delta = launches.since(captured)
        finally:
            launches.restore(mark)

    @contextlib.contextmanager
    def _capture_stream(self):
        """The device's capture stream, ordered after the caller's stream
        and before its next work: the warmup and the capture run on it,
        so paged decode's ticket buffer for it exists before capture."""
        current = torch.cuda.current_stream(self.device)
        stream = _capture_streams.get(current.device)
        if stream is None:
            stream = _capture_streams[current.device] = torch.cuda.Stream(
                current.device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            yield
        current.wait_stream(stream)

    def _record(self, call: list):
        """(graph, static output) of ``call`` captured into the pool, on
        the current (capture) stream."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              stream=torch.cuda.current_stream(self.device)):
            out = self.eager(*call)
        return graph, out
