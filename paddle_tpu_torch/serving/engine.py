"""Continuous-batching inference engine (the port of
``paddle_tpu/serving/engine.py``: Orca's iteration-level scheduling over
vLLM's paged KV cache, with Sarathi-style chunked prefill).

The engine keeps a fixed bucket of ``max_batch_size`` decode slots.
Every iteration it admits waiting requests into free slots (attaching
prefix-cached blocks of the prompt and allocating the rest), advances
admitted prompts by fixed-size prefill chunks under a per-iteration
token budget, then runs ONE decode step over the whole bucket: token ids
[S, 1], the shared block pools, block tables [S, max_blocks] and
per-slot frontiers [S].  Idle and mid-prefill slots decode into the
reserved garbage block instead of branching.  Requests enter and leave
at token granularity.

This slice serves greedy decoding through the fused steps (the mode the
JAX engine picks on its accelerator).  Options of later slices raise
``NotImplementedError`` when set: speculative decoding, sampling,
quantized KV or weights, a mesh, the startup X-ray / shard-plan audits,
streaming callbacks, and the overload controls (request deadlines,
priorities and load shedding; the watchdog and degradation ladder are
not part of this engine yet).

Correctness contract: greedy outputs are token-exact with the JAX
engine on the same weights (tests/test_torch_serving.py), across
preemption and with the prefix cache on or off.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..models.generation import (_cache_dims, make_chunked_prefill_step,
                                 make_paged_decode_step,
                                 normalize_stop_sequences)
from .cache import BlockKVPool, PoolExhausted
from .metrics import ServingMetrics
from .scheduler import (FINISHED, PREFILLING, RUNNING, AdmissionError,
                        Request, Scheduler)

# ServingConfig fields of later slices: each must stay at its default
LATER_SLICE_OPTIONS = ("speculative", "kv_cache_dtype", "weight_dtype",
                       "mesh", "xray_on_start", "shardplan")


@dataclass
class ServingConfig:
    """Engine knobs (the reference's names and defaults)."""

    max_batch_size: int = 8       # decode-bucket slots
    block_size: int = 16          # KV-cache tokens per block
    num_blocks: int = 128         # pool size incl. reserved block 0
    max_queue_len: int = 64       # bounded wait queue (backpressure)
    max_model_len: Optional[int] = None   # default: model max positions
    chunk_tokens: int = 256       # prefill chunk [1, chunk_tokens]
    enable_prefix_cache: bool = True
    # max prefill tokens per iteration before decode runs again; None =
    # one chunk's worth
    prefill_token_budget: Optional[int] = None
    # the port serves the fused steps only: None or True
    fused_kernels: Optional[bool] = None
    # ---- later slices: setting any of these raises NotImplementedError
    speculative: Any = None
    kv_cache_dtype: Optional[str] = None
    weight_dtype: Optional[str] = None
    mesh: Any = None
    xray_on_start: bool = False
    shardplan: Any = None


class Engine:
    """Continuous-batching engine over a ``LlamaForCausalLM`` of this
    package; runs on the model's device."""

    def __init__(self, model, config: Optional[ServingConfig] = None):
        self.model = model
        self.config = cfg = config or ServingConfig()
        later = [name for name in LATER_SLICE_OPTIONS
                 if getattr(cfg, name) not in (None, False)]
        if cfg.fused_kernels is False:
            later.append("fused_kernels=False (the unfused path)")
        if later:
            raise NotImplementedError(
                f"ServingConfig option(s) {', '.join(later)} are not "
                "ported to paddle_tpu_torch yet")
        self.device = model.device
        kv_heads, head_dim, dtype = _cache_dims(model)
        model_max = model.config.max_position_embeddings
        self.max_model_len = min(cfg.max_model_len or model_max, model_max)
        self.max_blocks_per_seq = -(-self.max_model_len // cfg.block_size)
        self.chunk_tokens = max(1, min(cfg.chunk_tokens, self.max_model_len))
        self.pool = BlockKVPool(
            model.config.num_hidden_layers, cfg.num_blocks, cfg.block_size,
            kv_heads, head_dim, dtype, device=self.device,
            enable_prefix_cache=cfg.enable_prefix_cache)
        self.scheduler = Scheduler(self.pool,
                                   max_queue_len=cfg.max_queue_len)
        self.metrics = ServingMetrics()
        S = cfg.max_batch_size
        self._slots: List[Optional[Request]] = [None] * S
        self._block_tables = np.zeros((S, self.max_blocks_per_seq),
                                      np.int32)
        self._lengths = np.zeros((S,), np.int32)
        self._pending = np.zeros((S,), np.int32)  # next token to decode
        self._decode_step = make_paged_decode_step(model)
        self._prefill_step = make_chunked_prefill_step(model)
        self._finished: Dict[str, Request] = {}
        self._ids = itertools.count()
        self._evictions_seen = 0

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.tensor(a, device=self.device)

    # ----------------------------------------------------------- submit
    def submit(self, prompt, max_new_tokens: int = 32,
               eos_token_id: Optional[int] = None, stop_sequences=None,
               tokenizer=None, request_id: Optional[str] = None,
               temperature: float = 0.0, do_sample: bool = False,
               top_k: int = 0, top_p: float = 1.0,
               seed: Optional[int] = None, sampling=None,
               on_token=None, token_deadline_s: Optional[float] = None,
               deadline_s: Optional[float] = None, priority: int = 0
               ) -> Request:
        """Queue one request and return its :class:`Request` handle.
        Raises :class:`AdmissionError` when the queue is full or the
        sequence can never fit the pool.  Sampling arguments, streaming
        callbacks, deadlines and priorities belong to later slices and
        raise ``NotImplementedError``."""
        if (temperature or do_sample or top_k or top_p != 1.0
                or seed is not None or sampling is not None):
            raise NotImplementedError(
                "sampled decoding is not ported to paddle_tpu_torch yet; "
                "this engine decodes greedily")
        if on_token is not None or token_deadline_s is not None:
            raise NotImplementedError(
                "streaming (on_token, token_deadline_s) is not ported to "
                "paddle_tpu_torch yet")
        if deadline_s is not None or priority != 0:
            raise NotImplementedError(
                "overload control (deadline_s, priority) is not ported to "
                "paddle_tpu_torch yet")
        prompt = np.asarray(
            prompt.cpu().numpy() if isinstance(prompt, torch.Tensor)
            else prompt, np.int32).reshape(-1)
        req = Request(
            prompt=prompt, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id,
            stop_sequences=normalize_stop_sequences(stop_sequences,
                                                    tokenizer),
            request_id=request_id or f"req-{next(self._ids)}")
        if req.prompt_len + req.max_new_tokens > self.max_model_len:
            self.metrics.on_reject()
            raise AdmissionError(
                f"{req.request_id}: prompt ({req.prompt_len}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_model_len ({self.max_model_len})")
        try:
            self.scheduler.enqueue(req)
        except AdmissionError:
            self.metrics.on_reject()
            raise
        self.metrics.on_submit(req.request_id)
        return req

    # ------------------------------------------------------------- step
    def step(self) -> bool:
        """One engine iteration: admit, advance prefill chunks under the
        token budget, then one decode step over the bucket.  Returns
        True while there is work left."""
        self._admit()
        self._prefill_tick()
        if any(r is not None and r.state == RUNNING for r in self._slots):
            self._decode_iteration()
        self._sync_pool_metrics()
        return self.has_work()

    def has_work(self) -> bool:
        return bool(self.scheduler.waiting) or \
            any(r is not None for r in self._slots)

    def run_until_complete(self) -> Dict[str, Request]:
        """Drain queue and bucket; returns {request_id: Request} of every
        request finished during this drain."""
        while self.step():
            pass
        done, self._finished = self._finished, {}
        return done

    def generate(self, prompts, **submit_kwargs) -> List[np.ndarray]:
        """Submit every prompt, drain, return prompt + generated ids."""
        reqs = [self.submit(p, **submit_kwargs) for p in prompts]
        self.run_until_complete()
        return [r.output_ids() for r in reqs]

    # -------------------------------------------------------- admission
    def _admit(self):
        free_slots = [i for i, r in enumerate(self._slots) if r is None]
        while free_slots:
            req = self.scheduler.next_admittable()
            if req is None:
                break
            if not self._begin_prefill(req, free_slots[0]):
                break
            free_slots.pop(0)

    def _begin_prefill(self, req: Request, slot: int) -> bool:
        """Admit ``req`` into ``slot``: attach prefix-cached blocks of its
        prompt, allocate the rest, mark it PREFILLING.  The prompt's last
        token is always recomputed: its logits give the first token."""
        matched, _, _ = self.pool.admission_plan(req.prompt, extra_tokens=0)
        bs = self.config.block_size
        cached_len = min(len(matched) * bs, req.prompt_len - 1)
        matched = matched[:self.pool.blocks_for(cached_len)] \
            if cached_len else []
        self.pool.acquire(req.request_id, matched)
        n = self.pool.blocks_for(req.prompt_len)
        try:
            suffix = self.pool.allocate(req.request_id, n - len(matched))
        except PoolExhausted:
            self.pool.free_request(req.request_id)
            self.scheduler.requeue_preempted(req)
            return False
        blocks = matched + suffix
        req.state = PREFILLING
        req.slot = slot
        req.blocks = blocks
        req.prefill_pos = cached_len
        req.prefill_chunks = 0
        self.scheduler.running.append(req)
        self._slots[slot] = req
        self._block_tables[slot] = 0
        self._block_tables[slot, :len(blocks)] = blocks
        self._lengths[slot] = 0
        self._pending[slot] = 0
        self.metrics.on_admit(req.request_id)
        self.metrics.on_prefix_lookup(cached_len, req.prompt_len)
        return True

    def _prefill_tick(self):
        """Advance PREFILLING requests by fixed-shape chunks, oldest
        first, until the token budget runs out (at least one chunk runs
        each iteration)."""
        budget = self.config.prefill_token_budget or self.chunk_tokens
        prefilling = sorted(
            (r for r in self.scheduler.running if r.state == PREFILLING),
            key=lambda r: r.ordinal)
        for req in prefilling:
            if budget <= 0:
                break
            while budget > 0 and req.state == PREFILLING:
                self._prefill_chunk(req)
                budget -= self.chunk_tokens

    def _prefill_chunk(self, req: Request):
        """Run ONE [1, chunk_tokens] prefill chunk for ``req`` at its
        prompt position, copy-on-write-protecting the blocks it writes."""
        bs = self.config.block_size
        C = self.chunk_tokens
        start = req.prefill_pos
        n_tok = min(C, req.prompt_len - start)
        for bi in range(start // bs, self.pool.blocks_for(start + n_tok)):
            new = self.pool.ensure_writable(req.request_id, req.blocks[bi])
            if new != req.blocks[bi]:
                req.blocks[bi] = new
                self._block_tables[req.slot, bi] = new
        ids = np.zeros((1, C), np.int32)
        ids[0, :n_tok] = req.prompt[start:start + n_tok]
        bt = self._block_tables[req.slot:req.slot + 1]
        last = self._prefill_step(
            self._dev(ids), self.pool.layers, self._dev(bt),
            self._dev(np.asarray([start], np.int32)), n_tok - 1)
        req.prefill_pos = start + n_tok
        req.prefill_chunks += 1
        if req.prefill_pos < req.prompt_len:
            return
        # prompt complete: the last chunk's logits row is the first token
        first_tok = int(torch.argmax(last[0]).item())
        req.state = RUNNING
        req.generated = [first_tok]
        self._lengths[req.slot] = req.prompt_len
        self._pending[req.slot] = first_tok
        self.metrics.on_first_token(req.request_id)
        self.metrics.on_prefill_complete(req.prefill_chunks)
        self.pool.register_prefix(req.request_id, req.prompt, req.blocks)
        self._maybe_retire(req)

    # ---------------------------------------------------------- decode
    def _ensure_blocks(self):
        """Every RUNNING slot needs a WRITABLE block for its next write
        position: allocate when the frontier crosses into a new block,
        copy-on-write a shared one.  A dry pool preempts youngest-first
        (oldest requests are served first, so a starving old request
        evicts young ones; a young one preempts itself)."""
        for req in sorted(self.scheduler.running, key=lambda r: r.ordinal):
            if req.slot is None or req.state != RUNNING:
                continue
            pos = int(self._lengths[req.slot])
            need = self.pool.blocks_for(pos + 1)
            preempted = False
            while len(req.blocks) < need:
                try:
                    new = self.pool.allocate(req.request_id, 1)
                except PoolExhausted:
                    victim = self.scheduler.pick_victim()
                    self._preempt(victim)
                    if victim is req:
                        preempted = True
                        break
                    continue
                self._block_tables[req.slot, len(req.blocks)] = new[0]
                req.blocks.extend(new)
            if preempted:
                continue
            for fi in range(pos // self.config.block_size, need):
                while True:
                    try:
                        new = self.pool.ensure_writable(req.request_id,
                                                        req.blocks[fi])
                    except PoolExhausted:
                        victim = self.scheduler.pick_victim()
                        self._preempt(victim)
                        if victim is req:
                            preempted = True
                            break
                        continue
                    break
                if preempted:
                    break
                if new != req.blocks[fi]:
                    req.blocks[fi] = new
                    self._block_tables[req.slot, fi] = new

    def _preempt(self, victim: Request):
        """Evict and requeue (recompute mode) at the queue head."""
        slot = victim.slot
        self.scheduler.running.remove(victim)
        self.pool.free_request(victim.request_id)
        victim.preemptions += 1
        self.metrics.on_preempt(victim.request_id)
        self._clear_slot(slot)
        self.scheduler.requeue_preempted(victim)

    def _clear_slot(self, slot: int):
        self._slots[slot] = None
        self._block_tables[slot] = 0
        self._lengths[slot] = 0
        self._pending[slot] = 0

    def _decode_block_view(self):
        """Block tables with mid-prefill slots masked to the garbage
        block, so the bucket-wide step never writes into their blocks."""
        bt = self._block_tables
        if any(r is not None and r.state == PREFILLING
               for r in self._slots):
            bt = bt.copy()
            for i, r in enumerate(self._slots):
                if r is not None and r.state == PREFILLING:
                    bt[i] = 0
        return bt

    def _decode_iteration(self):
        self._ensure_blocks()
        active = [r for r in self._slots
                  if r is not None and r.state == RUNNING]
        if not active:
            return
        logits = self._decode_step(
            self._dev(self._pending[:, None]), self.pool.layers,
            self._dev(self._decode_block_view()), self._dev(self._lengths))
        next_toks = torch.argmax(logits, dim=-1).cpu().numpy()
        self.metrics.on_decode_iteration(
            len(active), self.config.max_batch_size,
            self.pool.utilization())
        for req in active:
            slot = req.slot
            self._lengths[slot] += 1   # the pending token is now in KV
            tok = int(next_toks[slot])
            req.generated.append(tok)
            self._pending[slot] = tok
            self._maybe_retire(req)

    # ----------------------------------------------------------- retire
    def _maybe_retire(self, req: Request):
        reason = self.scheduler.finish_reason(req)
        if reason is not None:
            self._retire(req, reason)

    def _retire(self, req: Request, reason: str):
        """Finish ``req`` from any state; its prompt blocks may park in
        the prefix LRU rather than free (that is the cache, not a leak)."""
        slot = req.slot
        req.state = FINISHED
        req.finish_reason = reason
        if req in self.scheduler.running:
            self.scheduler.running.remove(req)
        self.pool.free_request(req.request_id)
        req.slot = None
        if slot is not None:
            self._clear_slot(slot)
        self.metrics.on_finish(req.request_id, req.num_generated, reason)
        self._finished[req.request_id] = req

    # ------------------------------------------------------------ misc
    def _sync_pool_metrics(self):
        d = self.pool.evictions - self._evictions_seen
        if d:
            self._evictions_seen = self.pool.evictions
            self.metrics.on_evictions(d)

    def stats(self) -> dict:
        d = self.metrics.as_dict()
        d["pool"] = self.pool.stats()
        d["queue_depth"] = len(self.scheduler.waiting)
        return d
