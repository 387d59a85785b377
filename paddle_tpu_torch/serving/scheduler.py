"""Request lifecycle and scheduling policy (the port of
``paddle_tpu/serving/scheduler.py``).

Admission is FCFS by arrival ordinal over a bounded wait queue (a full
queue rejects at submit time), highest priority class first.  A request
is admitted only when the block pool can hold its prompt plus one
decode block.  When a running sequence needs a block and the pool is
dry, the lowest-priority running request, youngest within its class, is
preempted: evicted and requeued at the head with its original ordinal,
recomputed from its prompt on re-admission, which under greedy decoding
leaves its output unchanged.  With every priority at 0 this is plain
FCFS and the youngest victim.  Termination uses the same ``match_stop``
as generation, plus eos, max_new_tokens and the request's deadlines
(``deadline_s`` from submission, the rolling ``token_deadline_s``), both
on ``time.monotonic()``.  A sampled request's tokens are drawn from its
own key at each token index, so recomputing it after preemption gives
the same tokens too.
"""
from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

from ..models.generation import match_stop


class AdmissionError(Exception):
    """Request rejected at submit time (backpressure or impossible fit)."""


class QueueFull(AdmissionError):
    """The bounded wait queue is at capacity.  Distinguished from the
    impossible-fit AdmissionError so the engine's overload layer can
    respond differently: a higher-priority arrival may shed the
    lowest-priority waiting request instead of being turned away."""


QUEUED = "queued"
PREFILLING = "prefilling"   # admitted; prompt chunks still being computed
RUNNING = "running"
PREEMPTED = "preempted"
FINISHED = "finished"

_ordinal = itertools.count()


@dataclass(eq=False)
class Request:
    """One generation request and its runtime state (identity
    equality: requests are mutable objects living in scheduler lists)."""

    prompt: np.ndarray                      # 1-D int32 token ids
    max_new_tokens: int = 32
    eos_token_id: Optional[int] = None
    stop_sequences: List[List[int]] = field(default_factory=list)
    request_id: str = ""
    # per-request SLO on the monotonic clock: retired with finish_reason
    # "timeout" once deadline_s seconds have passed since submission,
    # queued, mid-prefill or mid-decode (partial tokens kept)
    deadline_s: Optional[float] = None
    # priority class (serving/overload.py): higher wins.  Admission
    # prefers the highest class, preemption and queue-full shedding take
    # the lowest first (youngest within a class)
    priority: int = 0
    # sampling spec (serving/sampling.SamplingParams) or None for greedy;
    # sampling_key is the request's base key ([2] int64 of uint32 words),
    # fixed at submit so that a preempted request draws the same tokens
    sampling: Optional[object] = None
    sampling_key: Optional[np.ndarray] = field(default=None, repr=False)
    # streaming (serving/stream.py): called with each token, in order;
    # token_deadline_s is a rolling inter-token SLO: token_deadline_t
    # moves on at every token, and a stream that stalls past it times out
    on_token: Optional[object] = field(default=None, repr=False)
    token_deadline_s: Optional[float] = None
    token_deadline_t: Optional[float] = field(default=None, repr=False)
    # runtime (engine-owned)
    ordinal: int = field(default_factory=lambda: next(_ordinal))
    state: str = QUEUED
    slot: Optional[int] = None
    blocks: List[int] = field(default_factory=list)
    generated: List[int] = field(default_factory=list)
    # "eos" | "stop" | "length" | "timeout" | "shed" | "error"
    finish_reason: Optional[str] = None
    error: Optional[str] = None             # set with finish_reason error
    preemptions: int = 0
    deadline_t: Optional[float] = field(default=None, repr=False)
    # chunked-prefill progress: prompt tokens already in KV, how many of
    # them came from the prefix cache, chunks this admission ran
    prefill_pos: int = 0
    cached_tokens: int = 0
    prefill_chunks: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if not self.request_id:
            self.request_id = f"req-{self.ordinal}"
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.deadline_s is not None:
            if self.deadline_s < 0:
                raise ValueError("deadline_s must be >= 0")
            self.deadline_t = time.monotonic() + self.deadline_s
        if self.token_deadline_s is not None:
            if self.token_deadline_s < 0:
                raise ValueError("token_deadline_s must be >= 0")
            self.token_deadline_t = time.monotonic() + self.token_deadline_s

    def expired(self) -> bool:
        """Past the per-request deadline or the rolling inter-token
        deadline (both on the monotonic clock)."""
        if self.deadline_t is not None \
                and time.monotonic() >= self.deadline_t:
            return True
        return self.token_deadline_t is not None \
            and time.monotonic() >= self.token_deadline_t

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.size)

    @property
    def num_generated(self) -> int:
        return len(self.generated)

    def output_ids(self) -> np.ndarray:
        """prompt + generated tokens (terminator included)."""
        return np.concatenate(
            [self.prompt, np.asarray(self.generated, np.int32)])


class Scheduler:
    """Decides admission, victims and termination; the engine executes."""

    def __init__(self, pool, max_queue_len: int = 64):
        self.pool = pool
        self.max_queue_len = max_queue_len
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []

    def enqueue(self, req: Request):
        """Accept into the wait queue, or raise AdmissionError (a request
        that can never fit the pool would deadlock the queue head)."""
        total = self.pool.blocks_for(req.prompt_len + req.max_new_tokens)
        if total > self.pool.capacity_blocks:
            raise AdmissionError(
                f"{req.request_id}: needs {total} blocks at full length, "
                f"pool capacity is {self.pool.capacity_blocks}")
        if len(self.waiting) >= self.max_queue_len:
            raise QueueFull(
                f"wait queue full ({self.max_queue_len}); retry later")
        self.waiting.append(req)

    def shed_candidate(self, priority: int) -> Optional[Request]:
        """The waiting request a ``priority``-class arrival may displace
        when the queue is full: the lowest-priority waiting request
        (youngest within its class), and only when its priority is
        strictly below the arrival's; None otherwise (same-priority
        traffic keeps the plain bounded-queue rejection)."""
        if not self.waiting:
            return None
        victim = min(self.waiting, key=lambda r: (r.priority, -r.ordinal))
        return victim if victim.priority < priority else None

    def requeue_preempted(self, req: Request):
        req.state = PREEMPTED
        req.slot = None
        req.blocks = []
        req.generated = []
        req.prefill_pos = 0
        req.cached_tokens = 0
        req.prefill_chunks = 0
        self.waiting.appendleft(req)

    def next_admittable(self) -> Optional[Request]:
        """The waiting request of the highest priority class, oldest
        within it, if the pool can hold its uncached prompt blocks plus
        the first decode position now; None otherwise (a blocked head
        blocks the tail).  With every priority at 0 this is the oldest
        waiting request."""
        if not self.waiting:
            return None
        head = min(self.waiting, key=lambda r: (-r.priority, r.ordinal))
        _, _, feasible = self.pool.admission_plan(head.prompt,
                                                  extra_tokens=1)
        if not feasible:
            return None
        self.waiting.remove(head)
        return head

    def pick_victim(self) -> Optional[Request]:
        """The lowest-priority running request, youngest within its
        class (with every priority at 0: the youngest)."""
        if not self.running:
            return None
        return max(self.running, key=lambda r: (-r.priority, r.ordinal))

    @staticmethod
    def finish_reason(req: Request) -> Optional[str]:
        """Termination over the request's tokens, as generation's, after
        the monotonic deadline: a hard SLO that wins over eos and stop
        and fires even before the first token."""
        if req.expired():
            return "timeout"
        if not req.generated:
            return None
        if req.eos_token_id is not None \
                and req.generated[-1] == req.eos_token_id:
            return "eos"
        if req.stop_sequences and match_stop(req.generated,
                                             req.stop_sequences):
            return "stop"
        if req.num_generated >= req.max_new_tokens:
            return "length"
        return None
