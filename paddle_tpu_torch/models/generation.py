"""Serving steps over the paged KV cache, and the stop-sequence rules.

The port of the parts of ``paddle_tpu/models/generation.py`` that the
continuous-batching engine uses.  There the steps are ``jax.jit``
programs whose shapes never change; here each is a
:class:`~paddle_tpu_torch.jit.GraphStep`: captured as a CUDA graph at
its first call on the card and replayed at every later call, with the
pools bound by address (updated in place, so a step returns only the
logits).  A step's ``eager`` is the function itself.

Each maker takes ``fused``, as the reference's do: True (or None, the
mode the JAX engine picks on its accelerator) serves through the fused
kernels, False through the reference's unfused path
(``models.llama.LlamaAttention._unfused``).  The mode is baked into the
step when it is made, so fused and unfused steps are distinct graphs.

:func:`make_ring_sp_step` is the no-grad full-sequence forward of a
sequence- or context-parallel model on an ``sp`` mesh (the reference's
``make_ring_sp_step``), a plain function with the reference's
no-retrace bookkeeping: one cache entry per input signature, tracked
under the label ``"ring_sp"`` (``observability.compile_tracker``).
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..jit import GraphStep
from ..kernels.kv_quant import resolve_kv_cache_dtype
from .llama import PagedKVCache


def _cache_dims(model):
    """(kv_heads, head_dim, dtype) of the model's KV cache."""
    cfg = model.config
    kv_heads = cfg.num_key_value_heads or cfg.num_attention_heads
    return kv_heads, cfg.head_dim, cfg.torch_dtype


def resolve_fused(fused) -> bool:
    """A step's serving mode: None is the fused one (module docstring)."""
    return fused is None or bool(fused)


def _paged_caches(pools, block_tables, kv_dtype, fused=True):
    """Pool entries → per-layer :class:`PagedKVCache` views: ``(k, v)``
    for full-precision pools, ``(k, v, k_scale, v_scale)`` for quantized
    ones (``serving.cache.BlockKVPool.layers``); ``fused`` the path."""
    if kv_dtype is not None:
        return [PagedKVCache(k, v, block_tables, ks, vs, kv_dtype, fused)
                for k, v, ks, vs in pools]
    return [PagedKVCache(k, v, block_tables, fused=fused) for k, v in pools]


def paged_decode(model, kv_cache_dtype=None, fused=None):
    """The decode step's function, run eagerly: ``decode(tok [B, 1],
    pools, block_tables, lengths) -> last_logits [B, V] f32`` (see
    :func:`make_paged_decode_step`)."""
    kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype)
    fused = resolve_fused(fused)

    @torch.inference_mode()
    def decode(tok, pools, block_tables, lengths):
        caches = _paged_caches(pools, block_tables, kv_cache_dtype, fused)
        logits = model(tok, caches, lengths)
        return logits[:, -1].float()

    return decode


def make_paged_decode_step(model, kv_cache_dtype=None, pool=None,
                           fused=None):
    """The continuous-batching decode step: one token for every slot of
    the bucket, each at its own position.  ``step(tok [B, 1], pools
    [(k, v)] per layer, block_tables [B, max_blocks] int32, lengths [B]
    int32) -> last_logits [B, V] f32``; writes each token's k/v at
    ``lengths[b]``.  ``kv_cache_dtype`` (None / "int8" / "fp8") makes
    each pool entry ``(k, v, k_scale, v_scale)``.  A
    :class:`~paddle_tpu_torch.jit.GraphStep` on the model's device
    (``pool``: its graph memory pool); ``fused`` the serving mode (the
    module docstring)."""
    return GraphStep(paged_decode(model, kv_cache_dtype, fused),
                     model.device, bound=(1,), pool=pool)


def make_chunked_prefill_step(model, kv_cache_dtype=None, pool=None,
                              fused=None):
    """Chunked prefill straight into the paged pool: ``step(ids [1, C],
    pools, block_table [1, max_blocks] int32, start [1] int32,
    last_index) -> logits [1, V] f32`` of the chunk's last REAL token
    (``last_index``, an int or a one-element int tensor); positions past
    it are padding, written to the garbage block and never returned.
    Only that token's row goes through the final norm and the head.
    ``start`` and ``last_index`` are data, as the reference traces them,
    so every chunk of every prompt replays ONE graph.
    ``kv_cache_dtype``, ``pool`` and ``fused`` as in
    :func:`make_paged_decode_step`."""
    kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype)
    fused = resolve_fused(fused)

    @torch.inference_mode()
    def step(ids, pools, block_table, start, last_index):
        caches = _paged_caches(pools, block_table, kv_cache_dtype, fused)
        last_index = torch.as_tensor(last_index, device=ids.device)
        valid = (torch.arange(ids.shape[1], device=ids.device)
                 <= last_index)[None, :]
        logits = model(ids, caches, start, write_mask=valid,
                       last_index=last_index)
        return logits[:, 0].float()

    return GraphStep(step, model.device, bound=(1,), pool=pool)


def make_ring_sp_step(model, mesh=None):
    """The full-sequence forward through the sequence-parallel attention
    path (``LlamaConfig.context_parallel`` / ``sequence_parallel``):
    ``step(ids [B, T]) -> logits [B, T/sp, V]`` f32, this rank's rows
    (positions ``rank * T/sp`` on) of the global ``ids``, without grad;
    on a mesh without an ``sp`` axis (the dense fallback, the CPU parity
    path) all T rows.  ``mesh`` is installed around the call
    (``distributed.use_mesh``); None keeps the active one.  One step per
    model and mesh (made once, then returned again), one cache entry per
    signature of ``ids`` (shape and dtype): a
    ``TrackedFunction`` labelled ``"ring_sp"`` (``compile_stats``)."""
    step = getattr(model, "_ring_sp_step", None)
    if step is not None and getattr(model, "_ring_sp_step_mesh",
                                    None) is mesh:
        return step
    from ..distributed.mesh import sequence_group, use_mesh
    from ..distributed.sequence_parallel import (sequence_part,
                                                 uses_sequence_parallel)
    from ..observability.compile_tracker import track_compiles

    def ring_sp(ids):
        ctx = use_mesh(mesh) if mesh is not None else contextlib.nullcontext()
        with torch.no_grad(), ctx:
            ids = torch.as_tensor(ids, device=model.device)
            ring_sp._cache.setdefault((tuple(ids.shape), ids.dtype), True)
            group = sequence_group()
            if uses_sequence_parallel(model.config) and group is not None \
                    and group.nranks > 1:
                ids = sequence_part(ids, group)
            return model(ids).float()

    ring_sp._cache = {}
    step = track_compiles(ring_sp, label="ring_sp")
    model._ring_sp_step = step
    model._ring_sp_step_mesh = mesh
    return step


def normalize_stop_sequences(stop_sequences, tokenizer=None):
    """Normalize user-facing stop specs to ``list[list[int]]``: None, a
    single token id, one token-id sequence, a list of either, or strings
    (with a ``tokenizer`` that has ``encode`` or is callable)."""
    if stop_sequences is None:
        return []
    if isinstance(stop_sequences, (int, np.integer, str)):
        stop_sequences = [stop_sequences]
    elif stop_sequences and all(
            isinstance(t, (int, np.integer)) for t in stop_sequences):
        stop_sequences = [list(stop_sequences)]
    out = []
    for s in stop_sequences:
        if isinstance(s, str):
            if tokenizer is None:
                raise ValueError(
                    "string stop sequences need a tokenizer= with an "
                    "encode method (generation works on token ids)")
            enc = getattr(tokenizer, "encode", tokenizer)
            s = enc(s)
            ids = getattr(s, "ids", s)
            s = list(np.asarray(ids).reshape(-1))
        elif isinstance(s, (int, np.integer)):
            s = [s]
        s = [int(t) for t in s]
        if not s:
            raise ValueError("empty stop sequence")
        out.append(s)
    return out


def match_stop(generated, stop_sequences) -> bool:
    """True when ``generated`` (oldest to newest) ends with any of the
    normalized stop sequences."""
    for s in stop_sequences:
        n = len(s)
        if n <= len(generated) and list(generated[-n:]) == s:
            return True
    return False
