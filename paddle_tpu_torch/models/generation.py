"""Serving steps over the paged KV cache, and the stop-sequence rules.

The port of the parts of ``paddle_tpu/models/generation.py`` that the
continuous-batching engine uses.  There the steps are ``jax.jit``
programs whose shapes never change; here they are plain functions over
the model (PyTorch runs eagerly), still with fixed shapes per engine.
The pools are updated in place, so a step returns only the logits.
"""
from __future__ import annotations

import numpy as np
import torch

from .llama import PagedKVCache


def _cache_dims(model):
    """(kv_heads, head_dim, dtype) of the model's KV cache."""
    cfg = model.config
    kv_heads = cfg.num_key_value_heads or cfg.num_attention_heads
    return kv_heads, cfg.head_dim, cfg.torch_dtype


def make_paged_decode_step(model):
    """The continuous-batching decode step: one token for every slot of
    the bucket, each at its own position.  ``step(tok [B, 1], pools
    [(k, v)] per layer, block_tables [B, max_blocks] int32, lengths [B]
    int32) -> last_logits [B, V] f32``; writes each token's k/v at
    ``lengths[b]``."""

    @torch.inference_mode()
    def step(tok, pools, block_tables, lengths):
        caches = [PagedKVCache(k, v, block_tables) for k, v in pools]
        logits = model(tok, caches, lengths)
        return logits[:, -1].float()

    return step


def make_chunked_prefill_step(model):
    """Chunked prefill straight into the paged pool: ``step(ids [1, C],
    pools, block_table [1, max_blocks] int32, start [1] int32,
    last_index) -> logits [1, V] f32`` of the chunk's last REAL token
    (``last_index``); positions past it are padding, written to the
    garbage block and never returned.  Only that token's row goes
    through the final norm and ``lm_head``."""

    @torch.inference_mode()
    def step(ids, pools, block_table, start, last_index):
        caches = [PagedKVCache(k, v, block_table) for k, v in pools]
        C = ids.shape[1]
        valid = (torch.arange(C, device=ids.device) <= last_index)[None, :]
        logits = model(ids, caches, start, write_mask=valid,
                       last_index=int(last_index))
        return logits[:, 0].float()

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
