"""Multi-tenant trace replay for the serving fleet router (the port of
``paddle_tpu/serving/replay.py``).

A trace is a seeded arrival schedule over a few tenant archetypes, the
mixes a fleet sees at once:

* **chat**: many short requests sharing one long system prompt (after
  the first request lands, each follow-up re-prefills only its tail on
  a replica that holds the prefix);
* **long**: few requests with long, mostly unique prompts (prefill
  pressure; affinity helps only within the tenant's shared preamble);
* **burst**: a clump of near-simultaneous short arrivals (queueing
  pressure, where the load terms decide).

``build_trace`` materializes the schedule, all its randomness from ONE
``numpy.random.RandomState(seed)``, so a seed gives the JAX package's
trace byte for byte: prompts, steps, ids and per-request seeds.
``replay_trace`` feeds it through a :class:`Router` step by step and
reports per-tenant goodput and TTFT tails and the fleet's placement and
cache counters.  One trace through an affinity fleet and a round-robin
fleet should show affinity ahead on the cached-token ratio.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from .router import Router
from .scheduler import AdmissionError


@dataclass
class Tenant:
    """One workload archetype in the replayed mix."""

    name: str
    kind: str = "chat"                # "chat" | "long" | "burst"
    requests: int = 8
    shared_prefix_tokens: int = 48    # tokens every request shares
    tail_tokens: tuple = (4, 16)      # unique suffix length range
    max_new_tokens: int = 8
    deadline_s: Optional[float] = None
    priority: int = 0
    # a sampled tenant: temperature > 0 takes the seeded sampling path,
    # each request with a per-request seed drawn from the trace's rng,
    # so a trace replays the same token streams
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0


def default_tenants() -> List[Tenant]:
    """The stock four-tenant mix (module docstring): chat with a long
    shared system prompt, long prompts, a burst that clumps its
    arrivals, and a sampled tenant on the seeded temperature / top-k /
    top-p decode."""
    return [
        Tenant("chat", kind="chat", requests=10,
               shared_prefix_tokens=48, tail_tokens=(4, 12),
               max_new_tokens=8),
        Tenant("long", kind="long", requests=4,
               shared_prefix_tokens=16, tail_tokens=(40, 72),
               max_new_tokens=6),
        Tenant("burst", kind="burst", requests=8,
               shared_prefix_tokens=24, tail_tokens=(2, 8),
               max_new_tokens=4),
        Tenant("sampled", kind="chat", requests=4,
               shared_prefix_tokens=32, tail_tokens=(4, 10),
               max_new_tokens=6, temperature=0.8, top_k=16, top_p=0.95),
    ]


@dataclass
class Arrival:
    """One request of the trace: submit at router-iteration ``step``."""

    step: int
    tenant: str
    prompt: np.ndarray
    max_new_tokens: int
    deadline_s: Optional[float]
    priority: int
    request_id: str = ""
    # seeded sampling (0.0 temperature = greedy, seed ignored)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: Optional[int] = None


def build_trace(tenants: Optional[Sequence[Tenant]] = None, *,
                seed: int = 0, horizon: int = 24, vocab: int = 256
                ) -> List[Arrival]:
    """Materialize the deterministic arrival schedule.

    Every tenant gets a seeded shared prefix; each of its requests is
    that prefix plus a seeded unique tail.  chat/long arrivals spread
    uniformly over ``horizon`` router iterations; a burst tenant clumps
    ALL its arrivals into a two-iteration window.  Token id 0 is
    avoided (tiny test models use 0 as pad/eos)."""
    tenants = list(tenants) if tenants is not None else default_tenants()
    rng = np.random.RandomState(seed)

    def toks(n):
        return rng.randint(1, vocab, size=n).astype(np.int32)

    arrivals: List[Arrival] = []
    for t in tenants:
        shared = toks(t.shared_prefix_tokens)
        if t.kind == "burst":
            start = int(rng.randint(0, max(1, horizon - 2)))
            steps = start + rng.randint(0, 2, size=t.requests)
        else:
            steps = rng.randint(0, horizon, size=t.requests)
        lo, hi = t.tail_tokens
        for i in range(t.requests):
            tail = toks(int(rng.randint(lo, hi + 1)))
            arrivals.append(Arrival(
                step=int(steps[i]), tenant=t.name,
                prompt=np.concatenate([shared, tail]),
                max_new_tokens=t.max_new_tokens,
                deadline_s=t.deadline_s, priority=t.priority,
                request_id=f"{t.name}-{i}",
                temperature=t.temperature, top_k=t.top_k, top_p=t.top_p,
                seed=(int(rng.randint(0, 2**31 - 1))
                      if t.temperature > 0 else None)))
    # by arrival step, tenant name, then index: the submit order
    arrivals.sort(key=lambda a: (a.step, a.tenant, a.request_id))
    return arrivals


def _pctl(values: List[float], q: float) -> Optional[float]:
    vals = sorted(v for v in values if v is not None)
    if not vals:
        return None
    return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]


@dataclass
class _TenantTally:
    submitted: int = 0
    finished: Dict[str, int] = field(default_factory=dict)
    goodput_tokens: int = 0
    ttfts: List[float] = field(default_factory=list)


def replay_trace(router: Router, trace: Sequence[Arrival]) -> dict:
    """Feed ``trace`` through ``router`` (each arrival submits at its
    iteration, between ``router.step()`` calls, then the fleet drains)
    and report per-tenant outcomes and fleet counters.

    Goodput follows metrics.py: tokens of requests finishing inside
    their SLO (eos/stop/length).  TTFTs come from the finishing
    replica's request timelines (captures excluded when the caller
    warmed the fleet's graphs first)."""
    pending = sorted(trace, key=lambda a: a.step)
    tallies: Dict[str, _TenantTally] = {}
    by_rid: Dict[str, str] = {}
    i = 0
    step = 0
    results: Dict[str, object] = {}
    while i < len(pending) or router.has_work():
        while i < len(pending) and pending[i].step <= step:
            a = pending[i]
            i += 1
            tally = tallies.setdefault(a.tenant, _TenantTally())
            tally.submitted += 1
            by_rid[a.request_id] = a.tenant
            try:
                router.submit(a.prompt,
                              max_new_tokens=a.max_new_tokens,
                              deadline_s=a.deadline_s,
                              priority=a.priority,
                              request_id=a.request_id,
                              temperature=a.temperature,
                              do_sample=a.temperature > 0,
                              top_k=a.top_k, top_p=a.top_p,
                              seed=a.seed)
            except AdmissionError:
                # a full queue's backpressure is an outcome of an
                # overload trace: tallied, not raised
                tally.finished["rejected"] = \
                    tally.finished.get("rejected", 0) + 1
        router.step()
        step += 1
    results.update(router.run_until_complete())
    # each finished request's timeline from the replica that finished
    # it (a resubmitted request has one on each replica it visited; the
    # finishing one has finished_ns set)
    timelines: Dict[str, dict] = {}
    for rep in router.replicas:
        for rid, t in rep.engine.metrics.requests.items():
            if t.finished_ns:
                timelines[rid] = t.to_dict()
    for rid, req in results.items():
        tenant = by_rid.get(rid)
        if tenant is None:
            continue
        tally = tallies[tenant]
        reason = req.finish_reason or "unknown"
        tally.finished[reason] = tally.finished.get(reason, 0) + 1
        if reason in ("eos", "stop", "length"):
            tally.goodput_tokens += req.num_generated
        tl = timelines.get(rid)
        if tl is not None and tl["ttft_s"] is not None:
            tally.ttfts.append(tl["ttft_s"])
    fleet_ttfts = [t for tally in tallies.values() for t in tally.ttfts]
    stats = router.stats()
    return {
        "tenants": {
            name: {
                "submitted": tally.submitted,
                "finished": dict(sorted(tally.finished.items())),
                "goodput_tokens": tally.goodput_tokens,
                "mean_ttft_s": (sum(tally.ttfts) / len(tally.ttfts)
                                if tally.ttfts else None),
                "p99_ttft_s": _pctl(tally.ttfts, 0.99),
            }
            for name, tally in sorted(tallies.items())
        },
        "fleet": {
            "policy": router.policy,
            "requests": len(results),
            "cached_token_ratio": stats["router"]["cached_token_ratio"],
            "placements": stats["router"]["placements"],
            "shed_global": stats["router"]["requests_shed_global"],
            "quarantines": stats["router"]["replica_quarantines"],
            "resubmits": stats["router"]["requests_resubmitted"],
            "p99_ttft_s": _pctl(fleet_ttfts, 0.99),
            "mean_ttft_s": (sum(fleet_ttfts) / len(fleet_ttfts)
                            if fleet_ttfts else None),
        },
    }


__all__ = ["Tenant", "Arrival", "default_tenants", "build_trace",
           "replay_trace"]
