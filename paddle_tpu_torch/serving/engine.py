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

This engine serves through the fused steps (the mode the JAX engine
picks on its accelerator) or, with ``fused_kernels=False``, through the
reference's unfused path (plain products, the gathered full-buffer
attention; ``models/llama.py``), from full-precision or quantized KV pools
(``kv_cache_dtype`` ``"int8"``/``"fp8"``, sized by ``num_blocks`` or by
a ``kv_pool_bytes`` budget) and with full-precision or int8 weights
(``weight_dtype``).  Requests decode greedily or sample (temperature,
top-k, top-p, a per-request seed: ``serving/sampling.py``), and stream
their tokens through ``on_token``.

With ``ServingConfig(speculative=...)`` a draft model proposes K tokens
an iteration and the target verifies all K+1 positions in one batched
forward with the acceptance on the device (``serving/speculative.py``).
One pool holds the target's layers followed by the draft's, addressed
by the same block tables: the draft prefills every chunk into its own
layer slice of the prompt's blocks, every RUNNING slot gets writable
blocks for K+1 positions, and after the commit the blocks wholly past
each slot's new frontier are freed.  Greedy tokens are the plain
engine's; sampled ones are the reference's rejection sampling under the
request's key.

The overload controller (``serving/overload.py``) is the reference's:
request and rolling token deadlines on the monotonic clock, priorities
(admission prefers high, preemption and queue-full shedding take low),
load shedding at ``submit`` on an estimated TTFT, the KV-pressure
degradation ladder ticked before each admission, and a watchdog around
every step call with bounded retries, ``health()`` and ``revive()``.
Each watched call ends with the step's output on the host (or a
synchronize), so its time covers the device's work; a call that
captured a graph is its step's compile observation.  The engine moves
its host state only after a watched call returns, so a retried step
writes the same KV rows again.  Options of later slices raise
``NotImplementedError`` when set: a mesh and the startup X-ray /
shard-plan audits.

Each step (decode, sampled decode, prefill chunk, and under speculation
the draft's prefill chunk, the draft's proposals and the verify) is a
``jit.GraphStep``: on the card it is captured once as a CUDA graph and
replayed with the iteration's inputs copied into its static buffers,
as the JAX engine compiles each step once.  The engine's graphs share
one memory pool and replay one after another on one stream; a
step's output is the graph's static tensor, read before the next
replay.  The steps carry the reference's no-retrace contract
(``observability.warn_on_retrace``): a second graph of a step (an input
of another shape, or a rebound pool) raises ``RetraceError`` under
``strict_no_retrace`` and is counted otherwise.

Correctness contract: outputs are token-exact with the JAX engine on
the same weights (tests/test_torch_serving.py,
tests/test_torch_sampled_serving.py, tests/test_torch_speculative.py),
greedy and sampled under the same seeds, with and without speculation,
across preemption and with the prefix cache on or off; under the
same fault schedule (``resilience.FaultPlan``) the finish reasons,
ladder transitions, counters and health states are the JAX engine's too
(tests/test_torch_overload.py).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..kernels.kv_quant import (KV_DTYPE_CODES, kv_scale_bytes_per_block,
                                resolve_kv_cache_dtype)
from ..models.generation import (_cache_dims, make_chunked_prefill_step,
                                 make_paged_decode_step,
                                 normalize_stop_sequences)
from ..observability import RetraceError, warn_on_retrace
from ..quantization.serving import quantize_model_weights
from ..resilience import chaos
from .cache import BlockKVPool, PoolExhausted
from .metrics import ServingMetrics
from .overload import EngineQuarantined, OverloadController
from .sampling import make_sampled_decode_step, resolve_sampling, sample_at
from .scheduler import (FINISHED, PREFILLING, RUNNING, AdmissionError,
                        QueueFull, Request, Scheduler)
from .speculative import (SpeculativeConfig, make_draft_propose_step,
                          make_spec_verify_step)

# ServingConfig fields of later slices, each with the ROADMAP item that
# ports it: a value other than the field's default raises
LATER_SLICE_OPTIONS = {
    "mesh": "A3's mesh runtime",
    "xray_on_start": "A5's xray", "hbm_budget_bytes": "A5's xray",
    "xray_chip": "A5's xray", "shardplan": "A5's shard-plan audit",
}


@dataclass
class ServingConfig:
    """Engine knobs (the reference's names and defaults)."""

    # the engine's name: tags its watchdog and chaos step labels as
    # "serving::decode_step@<name>" (the reference's fleets name their
    # replicas so); empty keeps the bare labels
    name: str = ""
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
    # raise (observability.RetraceError) if a step captures a second CUDA
    # graph after its first (an input changed shape or a pool was
    # rebound); when False, such retraces are only counted
    # (engine._decode_step.retraces)
    strict_no_retrace: bool = True
    # the serving path: None or True the fused kernels (the mode the JAX
    # engine picks on its accelerator), False the reference's unfused
    # path; baked into the steps when they are made
    fused_kernels: Optional[bool] = None
    # KV pool storage: None full precision; "int8"/"fp8" int8 codes plus
    # one f32 absmax scale per (block, token) row, quantized as each row
    # is written and dequantized by the attention kernels
    kv_cache_dtype: Optional[str] = None
    # weight-only quantization: "int8" quantizes every linear weight in
    # place (per-output-channel absmax) before the engine's steps are made
    weight_dtype: Optional[str] = None
    # a KV byte budget: when set, num_blocks is derived from it and the
    # pool's block bytes (dtype-aware, scale rows included)
    kv_pool_bytes: Optional[int] = None
    # ---- overload control (serving/overload.py) ----
    # shed at submit() (finish_reason "shed") when the estimated TTFT
    # (pending prefill tokens over the chunk and decode EWMAs) busts the
    # deadline; never while the EWMAs are cold
    enable_load_shedding: bool = True
    shed_safety_factor: float = 1.0   # shed when est > deadline * factor
    # KV byte-pressure watermarks of the degradation ladder, with
    # hysteresis: one level up per iteration STRICTLY above high, one
    # down below low.  The default high of 1.0 cannot be exceeded, so
    # the ladder is opt-in
    kv_high_watermark: float = 1.0
    kv_low_watermark: float = 0.75
    # step watchdog: budget = watchdog_budget_mult x the step's EWMA,
    # floored by watchdog_floor_s; a stall or a step exception gets
    # step_max_retries retries with backoff from step_retry_backoff_s,
    # then the engine is DEGRADED (stalls) or FAILED (exceptions,
    # EngineQuarantined)
    watchdog_budget_mult: float = 20.0
    watchdog_floor_s: float = 30.0
    step_max_retries: int = 2
    step_retry_backoff_s: float = 0.05
    # consecutive in-budget steps before DEGRADED heals to SERVING
    health_recovery_steps: int = 3
    # a SpeculativeConfig, or a bare draft model (K = 4): the draft
    # proposes, the target verifies (serving/speculative.py)
    speculative: Any = None
    # ---- later slices (LATER_SLICE_OPTIONS): only the defaults are taken
    mesh: Any = None
    xray_on_start: bool = False
    hbm_budget_bytes: Optional[int] = None
    xray_chip: str = "v5e"
    shardplan: Any = None


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(ServingConfig)}


class Engine:
    """Continuous-batching engine over a ``LlamaForCausalLM`` of this
    package; runs on the model's device.  ``generator`` is the CPU
    ``torch.Generator`` from which a sampled request without a seed
    draws its key (None: a ``torch.Generator()`` at its fixed default
    seed, so such runs repeat).

    The steps' graphs bake in the weights' addresses, as the reference
    bakes its weights in as jit constants: changing a weight in place
    shows in the next step, rebinding one after construction needs a
    new engine (``weight_dtype`` quantizes in place before the steps
    are made)."""

    def __init__(self, model, config: Optional[ServingConfig] = None,
                 generator: Optional[torch.Generator] = None):
        self.model = model
        self.config = cfg = config or ServingConfig()
        later = [f"{name} ({item})"
                 for name, item in LATER_SLICE_OPTIONS.items()
                 if getattr(cfg, name) != _DEFAULTS[name]]
        if later:
            raise NotImplementedError(
                f"ServingConfig option(s) {', '.join(later)} are not "
                "ported to paddle_tpu_torch yet")
        self.generator = generator if generator is not None \
            else torch.Generator()
        self.device = model.device
        self.kv_cache_dtype = resolve_kv_cache_dtype(cfg.kv_cache_dtype)
        if cfg.weight_dtype:
            # in place and idempotent, before the steps are made
            quantize_model_weights(model, cfg.weight_dtype)
        kv_heads, head_dim, dtype = _cache_dims(model)
        model_max = model.config.max_position_embeddings
        self.max_model_len = min(cfg.max_model_len or model_max, model_max)
        self.max_blocks_per_seq = -(-self.max_model_len // cfg.block_size)
        self.chunk_tokens = max(1, min(cfg.chunk_tokens, self.max_model_len))
        # speculative decoding: one pool holds the target's layers
        # followed by the draft's, addressed by the same block tables
        spec = cfg.speculative
        if spec is not None and not isinstance(spec, SpeculativeConfig):
            spec = SpeculativeConfig(draft_model=spec)
        self.spec = spec
        self._n_target_layers = num_layers = model.config.num_hidden_layers
        if spec is not None:
            spec.validate_against(model)
            draft_max = spec.draft_model.config.max_position_embeddings
            if draft_max < self.max_model_len:
                raise ValueError(
                    f"draft max_position_embeddings ({draft_max}) < "
                    f"max_model_len ({self.max_model_len})")
            if self.kv_cache_dtype is not None:
                raise ValueError(
                    "speculative decoding with a quantized KV cache is not "
                    "supported yet (the draft/verify rollback paths assume "
                    "full-precision pool entries); drop kv_cache_dtype or "
                    "speculative")
            num_layers += spec.draft_model.config.num_hidden_layers
        self.num_blocks = cfg.num_blocks
        if cfg.kv_pool_bytes is not None:
            per_block = BlockKVPool.block_bytes_for(
                num_layers, cfg.block_size, kv_heads, head_dim, dtype,
                self.kv_cache_dtype)
            self.num_blocks = int(cfg.kv_pool_bytes) // per_block
            if self.num_blocks < 2:
                raise ValueError(
                    f"kv_pool_bytes={cfg.kv_pool_bytes} fits only "
                    f"{self.num_blocks} block(s) of {per_block} bytes; "
                    "need >= 2 (block 0 is the reserved garbage sink)")
        self.pool = BlockKVPool(
            num_layers, self.num_blocks, cfg.block_size, kv_heads, head_dim,
            dtype, device=self.device,
            enable_prefix_cache=cfg.enable_prefix_cache,
            kv_cache_dtype=self.kv_cache_dtype)
        self.scheduler = Scheduler(self.pool,
                                   max_queue_len=cfg.max_queue_len)
        self.metrics = ServingMetrics()
        self.metrics.on_kv_cache_config(
            KV_DTYPE_CODES[self.kv_cache_dtype],
            kv_scale_bytes_per_block(cfg.block_size, self.kv_cache_dtype))
        self.overload = OverloadController(cfg, self.metrics)
        S = cfg.max_batch_size
        self._slots: List[Optional[Request]] = [None] * S
        self._block_tables = np.zeros((S, self.max_blocks_per_seq),
                                      np.int32)
        self._lengths = np.zeros((S,), np.int32)
        self._pending = np.zeros((S,), np.int32)  # next token to decode
        # per-slot sampling state, fixed-shape inputs of the sampled step
        # on the device: written at a sampled request's first token and
        # cleared when it leaves its slot.  Greedy slots keep temperature
        # 0 (the step's argmax lane), so a mixed bucket is one step
        dev = self.device
        self._temps = torch.zeros((S,), dtype=torch.float32, device=dev)
        self._top_ks = torch.zeros((S,), dtype=torch.int64, device=dev)
        self._top_ps = torch.ones((S,), dtype=torch.float32, device=dev)
        self._keys = torch.zeros((S, 2), dtype=torch.int64, device=dev)
        self._counters = torch.zeros((S,), dtype=torch.int64, device=dev)
        # the reference's compiled steps, each under its no-retrace guard:
        # its one allowed compile is this engine's capture.  The graphs
        # share one memory pool: they replay one after another
        graphs = torch.cuda.graph_pool_handle() \
            if self.device.type == "cuda" else None
        on_retrace = "raise" if cfg.strict_no_retrace else "count"
        kv, fused = self.kv_cache_dtype, cfg.fused_kernels
        steps = {
            "decode_step": make_paged_decode_step(model, kv, graphs, fused),
            "prefill_step": make_chunked_prefill_step(model, kv, graphs,
                                                      fused),
            "sampled_decode_step": make_sampled_decode_step(model, kv,
                                                            graphs, fused)}
        if spec is not None:
            draft, K = spec.draft_model, spec.num_draft_tokens
            steps.update(
                draft_prefill_step=make_chunked_prefill_step(
                    draft, None, graphs, fused),
                draft_propose_step=make_draft_propose_step(
                    draft, K, None, graphs, fused),
                spec_verify_step=make_spec_verify_step(
                    model, K, None, graphs, fused))
        self._steps = {
            name: warn_on_retrace(step, after=1, label=f"serving::{name}",
                                  on_retrace=on_retrace)
            for name, step in steps.items()}
        for name, step in self._steps.items():
            setattr(self, "_" + name, step)
        # one watchdog a step, each with its own EWMA; a call that grew
        # its step's graphs is that EWMA's compile observation.  The
        # counts are read from _steps: spies may replace the attributes
        watchdogs = {"decode_step": self.overload.decode_watchdog,
                     "prefill_step": self.overload.prefill_watchdog}
        for name in self._steps:
            if name not in watchdogs:
                watchdogs[name] = self.overload.extra_watchdog(name)
            watchdogs[name].compiles = \
                lambda step=self._steps[name]: step.compiles
        self._sampled_wd = watchdogs["sampled_decode_step"]
        if spec is not None:
            self._draft_prefill_wd = watchdogs["draft_prefill_step"]
            self._draft_propose_wd = watchdogs["draft_propose_step"]
            self._spec_verify_wd = watchdogs["spec_verify_step"]
        self._finished: Dict[str, Request] = {}
        self._ids = itertools.count()
        self._evictions_seen = 0

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
        Raises :class:`AdmissionError` when the queue is full, the
        sequence can never fit the pool, or the engine is quarantined
        FAILED.

        ``deadline_s`` is an SLO on the monotonic clock from submission:
        once past it the request retires with ``finish_reason="timeout"``
        (partial tokens kept), queued, mid-prefill or mid-decode.  When
        load shedding is on and the latency EWMAs are warm, a request
        whose estimated time to first token already busts its deadline
        retires at once with ``finish_reason="shed"`` (returned, not
        raised).  ``token_deadline_s`` is a rolling inter-token SLO: it
        moves on at every token, times out a stalled stream, and the
        shedder takes it as a bound on the first token too.
        ``priority`` (higher wins) orders overload decisions: admission
        prefers high, shedding and preemption take the lowest first, and
        a higher-priority arrival at a FULL queue sheds the
        lowest-priority waiting request instead of being refused.

        Sampling: ``sampling=SamplingParams(...)`` (or a dict of its
        fields), or ``temperature``/``do_sample``/``top_k``/``top_p``/
        ``seed``; temperature 0 stays greedy.  A sampled request's key
        comes from its seed (or the engine's generator) and is folded
        with the token index on the device, so its tokens do not depend
        on batching or preemption.  ``on_token`` fires once per token,
        in order; a callback that raises retires only its request, with
        ``finish_reason="error"``."""
        if self.overload.health.failed:
            self.metrics.on_reject()
            raise AdmissionError(
                "engine quarantined FAILED "
                f"({self.overload.health.last_error}); revive() after "
                "operator intervention")
        params = resolve_sampling(sampling, temperature=temperature,
                                  do_sample=do_sample, top_k=top_k,
                                  top_p=top_p, seed=seed)
        prompt = np.asarray(
            prompt.cpu().numpy() if isinstance(prompt, torch.Tensor)
            else prompt, np.int32).reshape(-1)
        req = Request(
            prompt=prompt, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id,
            stop_sequences=normalize_stop_sequences(stop_sequences,
                                                    tokenizer),
            request_id=request_id or f"req-{next(self._ids)}",
            deadline_s=deadline_s, priority=priority,
            sampling=params,
            sampling_key=None if params is None
            else params.base_key(self.generator),
            on_token=on_token, token_deadline_s=token_deadline_s)
        # speculation writes K positions past the frontier an iteration:
        # the bound keeps even the deepest (rolled back) write inside
        # max_model_len
        limit = self.max_model_len - (
            self.spec.num_draft_tokens if self.spec is not None else 0)
        if req.prompt_len + req.max_new_tokens > limit:
            self.metrics.on_reject()
            raise AdmissionError(
                f"{req.request_id}: prompt ({req.prompt_len}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds "
                f"max_model_len ({limit})")
        # load shedding: when even an optimistic TTFT estimate busts the
        # SLO, retire now; the caller gets the handle back, "shed"
        effective_deadline = deadline_s
        if token_deadline_s is not None:
            effective_deadline = token_deadline_s \
                if effective_deadline is None \
                else min(effective_deadline, token_deadline_s)
        if self.overload.should_shed(self, req.prompt, effective_deadline):
            self.metrics.on_submit(req.request_id)
            if req.on_token is not None:
                self.metrics.on_stream_start()
            self._retire(req, "shed")
            return req
        try:
            self.scheduler.enqueue(req)
        except QueueFull:
            victim = self.scheduler.shed_candidate(req.priority)
            if victim is None:
                self.metrics.on_reject()
                raise
            # a full queue and a higher-priority arrival: the lowest-
            # priority waiting request is shed and gives up its place
            self.scheduler.waiting.remove(victim)
            self._retire(victim, "shed")
            self.scheduler.enqueue(req)
        except AdmissionError:
            self.metrics.on_reject()
            raise
        self.metrics.on_submit(req.request_id)
        if req.on_token is not None:
            self.metrics.on_stream_start()
        return req

    # ------------------------------------------------------------- step
    def step(self) -> bool:
        """One engine iteration: a tick of the degradation ladder, admit,
        advance prefill chunks under the token budget, then one decode
        step over the bucket.  Returns True while there is work left.
        Raises :class:`EngineQuarantined` while the engine is FAILED
        (``revive()`` first)."""
        if self.overload.health.failed:
            raise EngineQuarantined(
                f"engine quarantined FAILED "
                f"({self.overload.health.last_error}); revive() first")
        # before admission, so pause_admissions takes effect this
        # iteration
        self.overload.ladder.tick(self)
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
        # deadline sweep over the wait queue: an expired request must not
        # take a prefill and a slot it can no longer use
        for req in [r for r in self.scheduler.waiting if r.expired()]:
            self.scheduler.waiting.remove(req)
            self._retire(req, "timeout")
        if self.overload.ladder.admissions_paused:
            return
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
        req.cached_tokens = cached_len
        req.prefill_chunks = 0
        self.scheduler.running.append(req)
        self._slots[slot] = req
        self._block_tables[slot] = 0
        self._block_tables[slot, :len(blocks)] = blocks
        self._lengths[slot] = 0
        self._pending[slot] = 0
        self.metrics.on_admit(req.request_id)
        self.metrics.on_prefix_lookup(req.request_id, cached_len,
                                      req.prompt_len)
        return True

    def _prefill_tick(self):
        """Advance PREFILLING requests by fixed-shape chunks, oldest
        first, until the token budget (the ladder's) runs out; at least
        one chunk runs each iteration.  An expired request retires
        "timeout"; a request whose chunk raises retires "error" and the
        engine serves the rest (poison isolation), but a quarantine or a
        retrace is the engine's fault, not the request's, and
        propagates."""
        budget = self.overload.ladder.effective_prefill_budget(
            self.config.prefill_token_budget or self.chunk_tokens)
        prefilling = sorted(
            (r for r in self.scheduler.running if r.state == PREFILLING),
            key=lambda r: r.ordinal)
        for req in prefilling:
            if budget <= 0:
                break
            while budget > 0 and req.state == PREFILLING:
                if req.expired():
                    self._retire(req, "timeout")
                    break
                try:
                    chaos.maybe_fail_request(req.request_id)
                    self._prefill_chunk(req)
                except (EngineQuarantined, RetraceError):
                    raise
                except Exception as e:  # noqa: BLE001 (poison isolation)
                    req.error = f"{type(e).__name__}: {e}"
                    self._retire(req, "error")
                    break
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
        starts = np.asarray([start], np.int32)
        final = start + n_tok == req.prompt_len
        params = req.sampling
        if final and params is not None:
            # the first token's sampling lane, at token index 0 of the
            # request's key: the slot's own state is written only after
            # the watched call, so a retry sees what the first try saw
            lane = (torch.tensor([params.temperature], dtype=torch.float32),
                    torch.tensor([params.top_k], dtype=torch.int64),
                    torch.tensor([params.top_p], dtype=torch.float32),
                    torch.from_numpy(req.sampling_key)[None],
                    torch.zeros((1,), dtype=torch.int64))
            lane = tuple(t.to(self.device) for t in lane)

        def watched():
            # the step by attribute (spies replace it), then its result
            # on the host: the first token, or for a chunk that is not
            # the prompt's last a synchronize, so the watchdog's time
            # covers the device's work and not the replay's launch
            last = self._prefill_step(ids, self._target_pools(), bt,
                                      starts, n_tok - 1)
            if not final:
                if last.is_cuda:
                    torch.cuda.current_stream(last.device).synchronize()
                return None
            if params is not None:
                return int(sample_at(last, *lane)[0].item())
            return int(torch.argmax(last[0]).item())

        first_tok = self.overload.prefill_watchdog.call(watched)
        if self.spec is not None:
            # the draft prefills the same chunk into its own layer slice
            # of the same (already writable) blocks, so the prefix cache
            # serves both models from one block table
            def draft_watched():
                last = self._draft_prefill_step(ids, self._draft_pools(), bt,
                                                starts, n_tok - 1)
                if last.is_cuda:
                    torch.cuda.current_stream(last.device).synchronize()

            self._draft_prefill_wd.call(draft_watched)
        req.prefill_pos = start + n_tok
        req.prefill_chunks += 1
        if not final:
            return
        # prompt complete: the slot takes the request's sampling state,
        # its counter at the next token index (1)
        slot = req.slot
        if params is not None:
            self._temps[slot] = params.temperature
            self._top_ks[slot] = params.top_k
            self._top_ps[slot] = params.top_p
            self._keys[slot] = torch.from_numpy(req.sampling_key)
            self._counters[slot] = 1
        req.state = RUNNING
        req.generated = [first_tok]
        self._lengths[slot] = req.prompt_len
        self._pending[slot] = first_tok
        self.metrics.on_first_token(req.request_id)
        self.metrics.on_prefill_complete(req.request_id, req.prefill_chunks)
        self.pool.register_prefix(req.request_id, req.prompt, req.blocks)
        if not self._emit_token(req, first_tok):
            self._retire(req, "error")
            return
        self._maybe_retire(req)

    # ---------------------------------------------------------- decode
    def _ensure_blocks(self, horizon: int = 1):
        """Every RUNNING slot needs WRITABLE blocks for its next
        ``horizon`` write positions (1 for a decode step, K+1 for a
        verify): allocate when they cross into a new block, copy-on-write
        a shared one.  A dry pool preempts youngest-first (oldest
        requests are served first, so a starving old request evicts
        young ones; a young one preempts itself)."""
        for req in sorted(self.scheduler.running, key=lambda r: r.ordinal):
            if req.slot is None or req.state != RUNNING:
                continue
            pos = int(self._lengths[req.slot])
            need = self.pool.blocks_for(pos + horizon)
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
        self._clear_slot(slot, victim)
        self.scheduler.requeue_preempted(victim)

    def _clear_slot(self, slot: int, req: Request):
        self._slots[slot] = None
        self._block_tables[slot] = 0
        self._lengths[slot] = 0
        self._pending[slot] = 0
        if req.sampling is not None:
            self._clear_sampling_slot(slot)

    def _clear_sampling_slot(self, slot: int):
        self._temps[slot] = 0.0
        self._top_ks[slot] = 0
        self._top_ps[slot] = 1.0
        self._keys[slot] = 0
        self._counters[slot] = 0

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

    def _emit_token(self, req: Request, tok: int) -> bool:
        """Move the request's rolling token deadline on and fire its
        streaming callback with ``tok``.  Returns False when the
        callback raised: the consumer failed, so the caller retires that
        request as an error and the engine keeps serving the others."""
        if req.token_deadline_s is not None:
            req.token_deadline_t = time.monotonic() + req.token_deadline_s
        if req.on_token is None:
            return True
        try:
            req.on_token(tok)
        except Exception as e:  # noqa: BLE001 (consumer isolation)
            req.error = f"on_token callback: {type(e).__name__}: {e}"
            return False
        return True

    # the pool lists the target's layers, then the draft's; each step
    # takes its model's slice (the steps write the pools in place)
    def _target_pools(self):
        return self.pool.layers[:self._n_target_layers]

    def _draft_pools(self):
        return self.pool.layers[self._n_target_layers:]

    def _decode_iteration(self):
        if self.spec is not None:
            self._spec_iteration()
            return
        self._ensure_blocks()
        active = [r for r in self._slots
                  if r is not None and r.state == RUNNING]
        if not active:
            return
        # host arrays: the step copies them into its static buffers
        tokens = self._pending[:, None]
        tables = self._decode_block_view()
        lengths = self._lengths
        if any(r.sampling is not None for r in active):
            next_toks = self._sampled_iteration(tokens, tables, lengths)
        else:
            def watched():
                # the step by attribute, its tokens read to the host
                # inside the watchdog's window (the device's work timed)
                logits = self._decode_step(tokens, self._target_pools(),
                                           tables, lengths)
                return torch.argmax(logits, dim=-1).cpu().numpy()

            next_toks = self.overload.decode_watchdog.call(watched)
        self.metrics.on_decode_iteration(
            len(active), self.config.max_batch_size,
            self.pool.utilization())
        for req in active:
            slot = req.slot
            self._lengths[slot] += 1   # the pending token is now in KV
            tok = int(next_toks[slot])
            req.generated.append(tok)
            self._pending[slot] = tok
            if not self._emit_token(req, tok):
                self._retire(req, "error")
                continue
            self._maybe_retire(req)

    def _sampled_iteration(self, tokens, tables, lengths) -> np.ndarray:
        """The bucket's decode step with the fold, the filter and the
        Gumbel argmax on the device, run whenever an active slot
        samples: greedy slots ride along on the temperature-0 argmax
        lane.  Each sampled slot's counter then moves to its next token
        index on the device, after the watched call: a retried step
        draws at the same index.  Returns the [S] next tokens."""
        def watched():
            toks = self._sampled_decode_step(
                tokens, self._target_pools(), tables, lengths, self._temps,
                self._top_ks, self._top_ps, self._keys, self._counters)
            return toks.cpu().numpy()

        next_toks = self._sampled_wd.call(watched)
        self._counters += self._temps > 0
        return next_toks

    def _spec_iteration(self):
        """One speculative iteration: the draft proposes K tokens (one
        graph over its layer slice), the target verifies the K+1
        positions with the acceptance on the device, the host commits
        each slot's accepted tokens, and the blocks past each new
        frontier are freed.  The proposals go from the propose call to
        the verify call on the device; only the committed tokens and
        accepted lengths come to the host.  Host state (frontiers,
        pending tokens, counters, blocks) moves only after the verify
        call, so a retried propose or verify runs on the same inputs."""
        K = self.spec.num_draft_tokens
        self._ensure_blocks(horizon=K + 1)
        active = [r for r in self._slots
                  if r is not None and r.state == RUNNING]
        if not active:
            return
        tables = self._decode_block_view()
        state = (self._temps, self._top_ks, self._top_ps, self._keys,
                 self._counters)

        def propose():
            out = self._draft_propose_step(self._pending[:, None],
                                           self._draft_pools(), tables,
                                           self._lengths, *state)
            # out of the graph's static outputs: the verify's replay may
            # reuse their memory, and a retried verify reads them again
            props, probs = (t.clone() for t in out)
            if props.is_cuda:
                torch.cuda.current_stream(props.device).synchronize()
            return props, probs

        props, probs = self._draft_propose_wd.call(propose)

        def verify():
            committed, accepted = self._spec_verify_step(
                self._pending, props, probs, self._target_pools(), tables,
                self._lengths, *state)
            return committed.cpu().numpy(), accepted.cpu().numpy()

        committed, accepted = self._spec_verify_wd.call(verify)
        self.metrics.on_decode_iteration(
            len(active), self.config.max_batch_size,
            self.pool.utilization())
        advance = np.zeros((self.config.max_batch_size,), np.int64)
        accepted_drafts = 0
        for req in active:
            slot = req.slot
            n_new = int(accepted[slot])          # 1..K+1 committed tokens
            accepted_drafts += n_new - 1
            self.metrics.on_spec_commit(n_new)
            taken, finished = 0, False
            for tok in committed[slot, :n_new]:
                tok = int(tok)
                req.generated.append(tok)
                taken += 1
                if not self._emit_token(req, tok):
                    self._retire(req, "error")
                    finished = True
                    break
                reason = self.scheduler.finish_reason(req)
                if reason is not None:
                    # an eos, stop or length in mid-commit drops the
                    # tokens after it, where sequential decoding stops
                    self._retire(req, reason)
                    finished = True
                    break
            if finished:
                continue
            self._lengths[slot] += taken
            self._pending[slot] = int(committed[slot, taken - 1])
            if req.sampling is not None:
                advance[slot] = taken
            self._rollback_blocks(req)
        if advance.any():
            # each sampled slot's counter to its next token index
            self._counters += torch.from_numpy(advance).to(self.device)
        self.metrics.on_spec_step(K * len(active), accepted_drafts)

    def _rollback_blocks(self, req: Request):
        """Cut ``req``'s KV back to its accepted frontier: the blocks
        wholly past its next write position held only rejected drafts'
        KV and are freed (``_ensure_blocks`` made them writable, so the
        request owns them alone).  Rows past the frontier in kept blocks
        need no scrub: the attention masks them, and the next iteration
        overwrites them."""
        keep = self.pool.blocks_for(int(self._lengths[req.slot]) + 1)
        if len(req.blocks) > keep:
            tail = req.blocks[keep:]
            del req.blocks[keep:]
            self.pool.free(tail, req.request_id)
            self._block_tables[req.slot, keep:] = 0

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
            self._clear_slot(slot, req)
        self.metrics.on_finish(req.request_id, req.num_generated, reason)
        if req.on_token is not None:
            self.metrics.on_stream_end()
        self._finished[req.request_id] = req

    # ------------------------------------------------------------ misc
    def _sync_pool_metrics(self):
        d = self.pool.evictions - self._evictions_seen
        if d:
            self._evictions_seen = self.pool.evictions
            self.metrics.on_evictions(d)

    def decode_cache_size(self) -> int:
        """Graphs of the decode step: 1 after warmup, forever (the
        no-retrace contract)."""
        return self._steps["decode_step"]._cache_size()

    def prefill_cache_size(self) -> int:
        """Graphs of the chunked-prefill step: 1 after warmup, for
        EVERY prompt length and chunk position."""
        return self._steps["prefill_step"]._cache_size()

    def sampled_decode_cache_size(self) -> int:
        """Graphs of the sampled decode step: 0 for a greedy-only
        workload (the step never runs), 1 after the first sampled
        iteration, forever."""
        return self._steps["sampled_decode_step"]._cache_size()

    def spec_cache_sizes(self) -> Dict[str, int]:
        """Graphs of the speculative steps (each 1 after its first
        call, forever); an empty dict without speculation."""
        if self.spec is None:
            return {}
        return {name: self._steps[f"{name}_step"]._cache_size()
                for name in ("draft_prefill", "draft_propose",
                             "spec_verify")}

    def health(self) -> dict:
        """Engine health snapshot (``serving/overload.py``): state
        (``"serving"`` / ``"degraded"`` / ``"failed"``), the degradation
        ladder's level, the watchdogs' stall and retry totals, the
        latency EWMAs, queue depth and KV pressure; host-side, cheap to
        poll."""
        return self.overload.snapshot(self)

    def revive(self):
        """Operator override after a FAILED quarantine (a watchdog out
        of retries): health back to SERVING, so ``submit`` and ``step``
        take work again.  The caller decides the fault is gone."""
        self.overload.health.revive()

    def pending_prefill_tokens(self) -> int:
        """Prompt tokens admitted but not yet computed plus every
        waiting prompt's: the prefill backlog a new arrival queues
        behind (the TTFT estimate's numerator)."""
        pending = sum(r.prompt_len - r.prefill_pos
                      for r in self.scheduler.running
                      if r.state == PREFILLING)
        pending += sum(r.prompt_len for r in self.scheduler.waiting)
        return pending

    def stats(self) -> dict:
        d = self.metrics.as_dict()
        d["pool"] = self.pool.stats()
        d["queue_depth"] = len(self.scheduler.waiting)
        d["pending_prefill_tokens"] = self.pending_prefill_tokens()
        d["prefix_index"] = self.pool.prefix_summary()
        d["health"] = self.health()
        # compile_stats()'s fields for this engine's steps
        d["compiles"] = {}
        for step in self._steps.values():
            s = step.stats()
            d["compiles"][s.pop("label")] = s
        return d
