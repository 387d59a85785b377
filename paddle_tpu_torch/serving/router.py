"""Serving fleet router: prefix- and load-aware placement over N engine
replicas (the port of ``paddle_tpu/serving/router.py``).

A :class:`Router` owns N :class:`~paddle_tpu_torch.serving.engine.Engine`
replicas and places every ``submit()`` by a scored policy:

* **prefix-cache affinity**: the prompt's block hashes are chained as
  ``BlockKVPool.match_prefix`` chains them (``hash_chain``, seeded by
  the pool's KV dtype tag, so one chain per storage format in a
  mixed-dtype fleet), then walked against each replica's
  ``pool.prefix_summary()`` hashes and the prompts already placed
  there, up to the first miss: the leading matches times block_size are
  the tokens expected cached on that replica;
* **load**: the signals ``Engine.stats()``/``health()`` export, the
  prefill backlog (``pending_prefill_tokens``), the queue depth, the
  chunk and decode latency EWMAs and the degradation level.  Cold EWMAs
  take one constant cost a token, so a fresh fleet scores by token
  counts alone.

The cost (lower wins)::

    cost(r) = (pending_prefill_tokens(r) + uncached_tokens(r, prompt))
                  * t_prefill_token(r)
            + queue_depth(r) * t_decode(r)
            - affinity_weight * cached_tokens(r, prompt) * t_prefill_token(r)
            + penalty(r)          # degradation ladder + DEGRADED health

Equal costs break by a seeded rng, the only randomness in placement,
so a trace and a seed give the same placement log on a cold fleet.
Policy ``"round_robin"`` ignores the scores.

**Fleet shedding**: a request whose deadline every healthy replica's
warmed TTFT estimate busts is retired ``finish_reason="shed"`` before
any replica spends queue space or KV blocks; each engine's own shedding
stays as the backstop.

**Failover**: a DEGRADED replica keeps serving at a penalty; a replica
whose ``step()`` raises :class:`EngineQuarantined` (FAILED) is drained
in place: its stranded requests release their blocks and are
resubmitted to healthy replicas with their remaining deadline, and
re-prefill what the new replica's prefix cache does not hold.  Greedy
decoding makes the retry's tokens those of an undisturbed run.  With no
healthy replica left, stranded requests retire ``"error"``.

The router does no device work: it reads the engines' host state and
calls their public methods, on ``time.monotonic`` only.  On the card a
drained replica keeps its captured graphs, whose static inputs are the
engine's host arrays, reset in place and never rebound.
"""
from __future__ import annotations

import itertools
import logging
import random
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..observability import registry as _obsreg
from .engine import Engine
from .overload import DEGRADED, FAILED, SERVING, EngineQuarantined
from .scheduler import FINISHED, AdmissionError, Request

log = logging.getLogger("paddle_tpu_torch.serving")

ROUTER_POLICIES = ("affinity", "round_robin")

# cost a prefill token when a replica's EWMAs are cold: every cold
# replica uses the same value, so their order is by token counts alone
_COLD_SEC_PER_TOKEN = 1e-3
# penalty a degradation-ladder level / for DEGRADED health, in prefill
# tokens (times the replica's cost a token)
_LADDER_PENALTY_TOKENS = 256
_DEGRADED_PENALTY_TOKENS = 1024
# bound on a replica's remembered in-flight placement hashes, oldest
# forgotten first
_PENDING_HASH_CAP = 1024


class RouterMetrics:
    """Fleet counters, mirrored as ``router_*`` into the observability
    registry (handles looked up at each event, so ``registry.clear()``
    strands no mirror)."""

    def __init__(self):
        self.submitted = 0
        self.rejected = 0
        self.shed_global = 0
        self.resubmits = 0
        self.quarantines = 0
        self.placements: Dict[str, int] = {}
        self._affinity_tokens_sum = 0   # expected cached at placement
        self._prompt_tokens_sum = 0

    @staticmethod
    def _obs():
        return _obsreg.get_registry() if _obsreg.enabled() else None

    def on_submit(self):
        self.submitted += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("router_requests_submitted_total",
                        "requests submitted to the fleet router").inc()

    def on_reject(self):
        self.rejected += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("router_requests_rejected_total",
                        "requests no replica would admit").inc()

    def on_place(self, replica: str, affinity_tokens: int,
                 prompt_tokens: int):
        self.placements[replica] = self.placements.get(replica, 0) + 1
        self._affinity_tokens_sum += affinity_tokens
        self._prompt_tokens_sum += prompt_tokens
        reg = self._obs()
        if reg is not None:
            reg.counter("router_placements_total",
                        "requests placed, by replica").inc(replica=replica)
            reg.gauge("router_affinity_token_ratio",
                      "prompt tokens expected cached at placement, "
                      "cumulative ratio").set(
                          self._affinity_tokens_sum
                          / max(self._prompt_tokens_sum, 1))

    def on_shed_global(self):
        self.shed_global += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("router_requests_shed_global_total",
                        "requests shed at the fleet boundary (every "
                        "healthy replica's estimated TTFT busts the "
                        "deadline)").inc()

    def on_quarantine(self, replica: str):
        self.quarantines += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("router_replica_quarantines_total",
                        "replicas drained after a FAILED quarantine"
                        ).inc(replica=replica)

    def on_resubmit(self, replica: str):
        self.resubmits += 1
        reg = self._obs()
        if reg is not None:
            reg.counter("router_requests_resubmitted_total",
                        "stranded requests resubmitted after a replica "
                        "failure, by NEW replica").inc(replica=replica)

    def set_fleet_gauges(self, serving: int, total: int,
                         queue_depth: int, pending_tokens: int):
        reg = self._obs()
        if reg is not None:
            reg.gauge("router_serving_replicas",
                      "replicas in SERVING health").set(serving)
            reg.gauge("router_replicas", "replicas owned").set(total)
            reg.gauge("router_queue_depth",
                      "waiting requests across the fleet").set(queue_depth)
            reg.gauge("router_pending_prefill_tokens",
                      "prefill backlog across the fleet").set(
                          pending_tokens)

    def as_dict(self) -> dict:
        return {
            "requests_submitted": self.submitted,
            "requests_rejected": self.rejected,
            "requests_shed_global": self.shed_global,
            "requests_resubmitted": self.resubmits,
            "replica_quarantines": self.quarantines,
            "placements": dict(self.placements),
            "affinity_token_ratio": round(
                self._affinity_tokens_sum
                / max(self._prompt_tokens_sum, 1), 4),
        }


@dataclass
class _Replica:
    name: str
    engine: Engine
    # chain hashes (hex, insertion-ordered, bounded) of prompts placed
    # here whose prefill may not have registered yet: the affinity walk
    # credits them beside the pool's index, so a burst of one prefix
    # sticks to one replica from its first placement
    pending_hashes: "OrderedDict[str, None]" = field(
        default_factory=OrderedDict)


@dataclass
class _Tracked:
    """One placed request: what it takes to resubmit it elsewhere if its
    replica fails, and its live handle."""

    replica: str
    handle: Request
    kwargs: dict = field(default_factory=dict)
    resubmits: int = 0


class Router:
    """Engine-shaped front door over N replicas: ``submit`` / ``step`` /
    ``run_until_complete`` / ``generate`` / ``health`` / ``stats`` as
    :class:`Engine` has them, so an
    :class:`~paddle_tpu_torch.serving.endpoint.Endpoint` takes a router
    as it takes an engine.

    ``replicas``: the engines (at least one, one block_size, since
    affinity chains hashes a block); an unnamed engine
    (``ServingConfig(name="")``) is ``replica-<i>``.  ``policy``:
    ``"affinity"`` (scored, the default) or ``"round_robin"``.
    ``seed``: the tie-break rng's.  ``affinity_weight``: how many
    prefill tokens of load one cached token outweighs (:meth:`_cost`).
    ``enable_global_shedding`` / ``shed_safety_factor``: shed at the
    fleet boundary when the least estimated TTFT exceeds deadline x
    factor (as ``ServingConfig.shed_safety_factor``)."""

    def __init__(self, replicas: Sequence[Engine], *,
                 policy: str = "affinity", seed: int = 0,
                 affinity_weight: float = 3.0,
                 enable_global_shedding: bool = True,
                 shed_safety_factor: float = 1.0):
        if not replicas:
            raise ValueError("Router needs at least one Engine replica")
        if policy not in ROUTER_POLICIES:
            raise ValueError(f"unknown policy {policy!r}; choose from "
                             f"{ROUTER_POLICIES}")
        sizes = {e.config.block_size for e in replicas}
        if len(sizes) != 1:
            raise ValueError(
                "prefix-affinity routing chains hashes per block, so "
                f"every replica needs ONE block_size; got {sorted(sizes)}")
        self.replicas: List[_Replica] = []
        for i, eng in enumerate(replicas):
            name = eng.config.name or f"replica-{i}"
            if any(r.name == name for r in self.replicas):
                raise ValueError(f"duplicate replica name {name!r}")
            self.replicas.append(_Replica(name, eng))
        self.policy = policy
        self.seed = seed
        self.affinity_weight = affinity_weight
        self.enable_global_shedding = enable_global_shedding
        self.shed_safety_factor = shed_safety_factor
        self.metrics = RouterMetrics()
        self._rng = random.Random(seed)     # tie-breaks only
        self._rr_next = 0                   # round-robin cursor
        self._ids = itertools.count()
        self._tracked: Dict[str, _Tracked] = {}
        self._finished: Dict[str, Request] = {}
        # one line a placement decision: the same for a trace and a seed
        # on a cold fleet
        self.placement_log: List[str] = []

    # ---------------------------------------------------------- scoring
    def _healthy(self) -> List[_Replica]:
        return [r for r in self.replicas
                if not r.engine.overload.health.failed]

    def _affinity_tokens(self, rep: _Replica, prompt: np.ndarray,
                         chain_hex: Dict[str, List[str]]) -> int:
        """Tokens of ``prompt`` expected cached on ``rep``: the leading
        chain hashes in its pool's prefix index or among the prompts
        already placed there (in-flight prefills register on
        completion), capped at prompt_len - 1 (the last token is always
        recomputed: its logits give the first token)."""
        idx = set(rep.engine.pool.prefix_summary()["hashes"])
        n = 0
        for h in self._replica_chain(rep, chain_hex):
            if h not in idx and h not in rep.pending_hashes:
                break
            n += 1
        bs = rep.engine.pool.block_size
        return min(n * bs, int(prompt.size) - 1) if n else 0

    def _cost(self, rep: _Replica, prompt: np.ndarray,
              affinity_tokens: int) -> float:
        """Placement cost in estimated seconds (module docstring): the
        prefill queued ahead plus this prompt's uncached part, decode
        contention and lifecycle penalties, less ``affinity_weight``
        times the cached tokens.  A cache hit is worth more than the
        prefill it skips: it spends no blocks on a duplicate prefix and
        keeps a prompt family on one replica, which loses it only when
        its load exceeds the bonus."""
        eng = rep.engine
        ov = eng.overload
        per_tok = (ov.chunk_ewma.value / eng.chunk_tokens
                   if ov.chunk_ewma.warmed else _COLD_SEC_PER_TOKEN)
        t_decode = ov.decode_ewma.value if ov.decode_ewma.warmed else 0.0
        uncached = max(1, int(prompt.size) - affinity_tokens)
        cost = (eng.pending_prefill_tokens() + uncached) * per_tok
        cost += len(eng.scheduler.waiting) * t_decode
        cost -= self.affinity_weight * affinity_tokens * per_tok
        penalty = ov.ladder.level * _LADDER_PENALTY_TOKENS
        if ov.health.state == DEGRADED:
            penalty += _DEGRADED_PENALTY_TOKENS
        return cost + penalty * per_tok

    def _chain_hex(self, prompt: np.ndarray) -> Dict[str, List[str]]:
        """The prompt's chained block hashes (hex) for each KV dtype tag
        in the fleet: chains are seeded by the tag (an int8 pool never
        matches a bf16 one's block), so a mixed-dtype fleet walks one
        chain a tag, each computed once a prompt."""
        chains: Dict[str, List[str]] = {}
        for rep in self.replicas:
            pool = rep.engine.pool
            if pool.kv_dtype_tag not in chains:
                chains[pool.kv_dtype_tag] = [
                    h.hex() for h in pool.hash_chain(prompt)]
        return chains

    @staticmethod
    def _replica_chain(rep: _Replica,
                       chain_hex: Dict[str, List[str]]) -> List[str]:
        """The chain of ``rep``'s pool dtype (empty when absent: a
        replica added after the chains were computed scores no
        affinity)."""
        return chain_hex.get(rep.engine.pool.kv_dtype_tag, [])

    def _rank(self, prompt: np.ndarray, chain_hex: Dict[str, List[str]]
              ) -> List[Tuple[_Replica, int, float]]:
        """Healthy replicas best first, ``(replica, affinity tokens,
        cost)``; each group of equal cost shuffled by the seeded rng."""
        healthy = self._healthy()
        if self.policy == "round_robin":
            order = [healthy[(self._rr_next + i) % len(healthy)]
                     for i in range(len(healthy))]
            self._rr_next += 1
            return [(r, 0, 0.0) for r in order]
        scored = []
        for r in healthy:
            aff = self._affinity_tokens(r, prompt, chain_hex)
            scored.append((r, aff, self._cost(r, prompt, aff)))
        scored.sort(key=lambda t: round(t[2], 9))
        out: List[Tuple[_Replica, int, float]] = []
        i = 0
        while i < len(scored):
            j = i + 1
            while j < len(scored) and \
                    round(scored[j][2], 9) == round(scored[i][2], 9):
                j += 1
            group = scored[i:j]
            if len(group) > 1:
                self._rng.shuffle(group)
            out.extend(group)
            i = j
        return out

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
        """Place one request on the best replica, with ``Engine.submit``'s
        arguments and result: the handle, ``finish_reason="shed"`` for a
        hopeless deadline, ``AdmissionError`` when no replica takes it.
        A request resubmitted after a replica failure keeps its
        request_id under a new handle: ``run_until_complete()``'s dict
        holds the handles that finished."""
        healthy = self._healthy()
        if not healthy:
            self.metrics.on_reject()
            raise AdmissionError(
                f"all {len(self.replicas)} replicas quarantined FAILED; "
                "revive() one after operator intervention")
        p = np.asarray(
            prompt.cpu().numpy() if isinstance(prompt, torch.Tensor)
            else prompt, np.int32).reshape(-1)
        rid = request_id or f"rq-{next(self._ids)}"
        kwargs = dict(max_new_tokens=max_new_tokens,
                      eos_token_id=eos_token_id,
                      stop_sequences=stop_sequences, tokenizer=tokenizer,
                      temperature=temperature, do_sample=do_sample,
                      top_k=top_k, top_p=top_p, seed=seed,
                      sampling=sampling, on_token=on_token,
                      token_deadline_s=token_deadline_s,
                      priority=priority)
        self.metrics.on_submit()
        # fleet shedding: before any replica spends queue space or KV
        if self._should_shed_globally(p, deadline_s, healthy):
            req = Request(prompt=p, request_id=rid, deadline_s=deadline_s,
                          priority=priority,
                          max_new_tokens=max_new_tokens,
                          eos_token_id=eos_token_id)
            req.state = FINISHED
            req.finish_reason = "shed"
            self._finished[rid] = req
            self.metrics.on_shed_global()
            self.placement_log.append(f"{rid} -> SHED policy=global")
            log.info("router shed %s at the fleet boundary "
                     "(deadline %.3fs hopeless on every replica)",
                     rid, deadline_s)
            return req
        return self._place(rid, p, kwargs, deadline_s, resubmit_of=None)

    def _should_shed_globally(self, prompt: np.ndarray,
                              deadline_s: Optional[float],
                              healthy: List[_Replica]) -> bool:
        if deadline_s is None or not self.enable_global_shedding:
            return False
        estimates = []
        for rep in healthy:
            ov = rep.engine.overload
            if not ov.can_estimate():
                return False    # a cold replica might serve it: admit
            estimates.append(ov.estimate_ttft_s(rep.engine, prompt))
        return min(estimates) > deadline_s * self.shed_safety_factor

    def _place(self, rid: str, prompt: np.ndarray, kwargs: dict,
               deadline_s: Optional[float],
               resubmit_of: Optional[_Tracked]) -> Request:
        """Submit to the first ranked replica that admits; the next ones
        take a replica's backpressure (``QueueFull`` and the like)."""
        last_err: Optional[Exception] = None
        chain_hex = self._chain_hex(prompt)
        for rep, aff, cost in self._rank(prompt, chain_hex):
            try:
                handle = rep.engine.submit(
                    prompt, request_id=rid, deadline_s=deadline_s,
                    **kwargs)
            except AdmissionError as e:
                last_err = e
                continue
            # the placement's hashes as in-flight affinity (bounded,
            # oldest forgotten): follow-ups of the prefix stick here
            # before its prefill registers it
            for h in self._replica_chain(rep, chain_hex):
                rep.pending_hashes.pop(h, None)
                rep.pending_hashes[h] = None
            while len(rep.pending_hashes) > _PENDING_HASH_CAP:
                rep.pending_hashes.popitem(last=False)
            tracked = resubmit_of or _Tracked(rep.name, handle, kwargs)
            tracked.replica = rep.name
            tracked.handle = handle
            tracked.kwargs = kwargs
            self._tracked[rid] = tracked
            tag = f" resubmit={tracked.resubmits}" \
                if tracked.resubmits else ""
            self.placement_log.append(
                f"{rid} -> {rep.name} policy={self.policy} aff={aff} "
                f"cost={cost:.6f}{tag}")
            self.metrics.on_place(rep.name, aff, int(prompt.size))
            if resubmit_of is not None:
                self.metrics.on_resubmit(rep.name)
            # an engine's own shed retires the handle at once
            if handle.state == FINISHED:
                self._drain_finished(rep)
            return handle
        self.metrics.on_reject()
        raise last_err if last_err is not None else AdmissionError(
            f"{rid}: no replica admitted the request")

    # ------------------------------------------------------------- step
    def step(self) -> bool:
        """One fleet iteration: each healthy replica steps once, finished
        requests are collected, and a FAILED quarantine becomes a drain
        and resubmission instead of an exception.  True while any
        replica has work."""
        for rep in self.replicas:
            eng = rep.engine
            if eng.overload.health.failed:
                self._drain_replica(rep)
                continue
            if eng.has_work():
                try:
                    eng.step()
                except EngineQuarantined as e:
                    log.warning("router: replica %s quarantined (%s); "
                                "draining and resubmitting", rep.name, e)
                    self.metrics.on_quarantine(rep.name)
                    self._drain_replica(rep)
            self._drain_finished(rep)
        self._publish_gauges()
        return self.has_work()

    def has_work(self) -> bool:
        return any(r.engine.has_work() for r in self._healthy())

    def run_until_complete(self) -> Dict[str, Request]:
        """Drain the fleet; returns {request_id: Request} of every
        request finished during this drain (a failover's handle replaces
        the one ``submit`` returned)."""
        while self.step():
            pass
        done, self._finished = self._finished, {}
        return done

    def generate(self, prompts, **submit_kwargs) -> List[np.ndarray]:
        """``Engine.generate`` over the fleet: submit every prompt,
        drain, prompt + generated ids in order."""
        reqs = [self.submit(p, **submit_kwargs) for p in prompts]
        done = self.run_until_complete()
        return [done[r.request_id].output_ids() for r in reqs]

    # ------------------------------------------------ replica lifecycle
    def _drain_finished(self, rep: _Replica):
        eng = rep.engine
        if not eng._finished:
            return
        for rid, req in eng._finished.items():
            self._finished[rid] = req
            t = self._tracked.get(rid)
            if t is not None:
                t.replica = rep.name
                t.handle = req
        eng._finished.clear()

    def _drain_replica(self, rep: _Replica):
        """Drain a FAILED replica: free its stranded requests' blocks,
        clear its slots and resubmit the requests to healthy replicas
        with their remaining deadline.  The engine's host arrays are
        reset in place: its captured graphs copy from them, and its
        per-slot sampling tensors, bound to the sampled graph by
        address, are cleared in place."""
        eng = rep.engine
        self._drain_finished(rep)
        rep.pending_hashes.clear()  # in-flight prefills died with it
        stranded = list(eng.scheduler.waiting) + list(eng.scheduler.running)
        if not stranded:
            return
        eng.scheduler.waiting.clear()
        eng.scheduler.running.clear()
        for i in range(len(eng._slots)):
            if eng._slots[i] is not None and \
                    eng._slots[i].sampling is not None:
                eng._clear_sampling_slot(i)
            eng._slots[i] = None
        eng._block_tables[:] = 0
        eng._lengths[:] = 0
        eng._pending[:] = 0
        for req in stranded:
            eng.pool.free_request(req.request_id)
        log.warning("router: drained %d stranded request(s) from %s",
                    len(stranded), rep.name)
        for req in sorted(stranded, key=lambda r: r.ordinal):
            self._resubmit(req)

    def _resubmit(self, req: Request):
        rid = req.request_id
        tracked = self._tracked.get(rid)
        kwargs = tracked.kwargs if tracked is not None else dict(
            max_new_tokens=req.max_new_tokens,
            eos_token_id=req.eos_token_id)
        # the remaining budget on the monotonic clock: a failover does
        # not extend the caller's deadline
        deadline_s: Optional[float] = None
        if req.deadline_t is not None:
            deadline_s = req.deadline_t - time.monotonic()
            if deadline_s <= 0:
                self._retire_router_side(req, "timeout")
                return
        if not self._healthy():
            req.error = "all replicas quarantined FAILED"
            self._retire_router_side(req, "error")
            return
        if tracked is not None:
            tracked.resubmits += 1
        try:
            self._place(rid, req.prompt, kwargs, deadline_s,
                        resubmit_of=tracked)
        except AdmissionError as e:
            req.error = f"failover resubmission rejected: {e}"
            self._retire_router_side(req, "error")

    def _retire_router_side(self, req: Request, reason: str):
        """Finish a request the router could not place again: retired,
        never lost."""
        req.state = FINISHED
        req.finish_reason = reason
        req.slot = None
        req.blocks = []
        self._finished[req.request_id] = req

    def revive(self, name: Optional[str] = None):
        """``Engine.revive()`` of one replica by name, or of every one
        when ``name`` is None."""
        for rep in self.replicas:
            if name is None or rep.name == name:
                rep.engine.revive()

    # ------------------------------------------------------ observation
    def _publish_gauges(self):
        states = [r.engine.overload.health.state for r in self.replicas]
        self.metrics.set_fleet_gauges(
            serving=sum(s == SERVING for s in states),
            total=len(self.replicas),
            queue_depth=sum(len(r.engine.scheduler.waiting)
                            for r in self.replicas),
            pending_tokens=sum(r.engine.pending_prefill_tokens()
                               for r in self.replicas))

    def health(self) -> dict:
        """Fleet health: the worst of the replicas' states (all FAILED:
        failed; any not SERVING: degraded) and each replica's snapshot,
        what ``Endpoint.health()`` forwards."""
        per = {r.name: r.engine.health() for r in self.replicas}
        states = [h["state"] for h in per.values()]
        if all(s == FAILED for s in states):
            state = FAILED
        elif any(s != SERVING for s in states):
            state = DEGRADED
        else:
            state = SERVING
        return {
            "state": state,
            "serving_replicas": sum(s == SERVING for s in states),
            "failed_replicas": sum(s == FAILED for s in states),
            "queue_depth": sum(h["queue_depth"] for h in per.values()),
            "pending_prefill_tokens": sum(
                r.engine.pending_prefill_tokens() for r in self.replicas),
            "replicas": per,
        }

    def stats(self) -> dict:
        """The router's counters, every replica's ``Engine.stats()``, and
        the fleet's cached-token ratio (prompt tokens served from the
        prefix caches)."""
        cached = sum(r.engine.metrics._cached_tokens_sum
                     for r in self.replicas)
        prompts = sum(r.engine.metrics._prompt_tokens_sum
                      for r in self.replicas)
        self._publish_gauges()
        return {
            "router": {
                "policy": self.policy,
                "seed": self.seed,
                "replicas": [r.name for r in self.replicas],
                "cached_token_ratio": round(cached / max(prompts, 1), 4),
                **self.metrics.as_dict(),
            },
            "replicas": {r.name: r.engine.stats()
                         for r in self.replicas},
        }

    def placement_log_text(self) -> str:
        """The placement decisions, one line a request: the same bytes
        for a trace and a seed on a cold fleet."""
        return "\n".join(self.placement_log)


__all__ = ["Router", "RouterMetrics", "ROUTER_POLICIES"]
