"""Request lifecycle and scheduling policy (the port of
``paddle_tpu/serving/scheduler.py``).

Admission is FCFS by arrival ordinal over a bounded wait queue (a full
queue rejects at submit time).  A request is admitted only when the
block pool can hold its prompt plus one decode block.  When a running
sequence needs a block and the pool is dry, the youngest running request
is preempted: evicted and requeued at the head with its original
ordinal, recomputed from its prompt on re-admission, which under greedy
decoding leaves its output unchanged.  Termination uses the same
``match_stop`` as generation, plus eos and max_new_tokens.  A sampled
request's tokens are drawn from its own key at each token index, so
recomputing it after preemption gives the same tokens too.  The
reference's priorities and deadlines belong to its overload controls,
which a later slice ports.
"""
from __future__ import annotations

import itertools
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np

from ..models.generation import match_stop


class AdmissionError(Exception):
    """Request rejected at submit time (backpressure or impossible fit)."""


class QueueFull(AdmissionError):
    """The bounded wait queue is at capacity."""


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
    # sampling spec (serving/sampling.SamplingParams) or None for greedy;
    # sampling_key is the request's base key ([2] int64 of uint32 words),
    # fixed at submit so that a preempted request draws the same tokens
    sampling: Optional[object] = None
    sampling_key: Optional[np.ndarray] = field(default=None, repr=False)
    # streaming (serving/stream.py): called with each token, in order
    on_token: Optional[object] = field(default=None, repr=False)
    # runtime (engine-owned)
    ordinal: int = field(default_factory=lambda: next(_ordinal))
    state: str = QUEUED
    slot: Optional[int] = None
    blocks: List[int] = field(default_factory=list)
    generated: List[int] = field(default_factory=list)
    finish_reason: Optional[str] = None     # eos/stop/length/error
    error: Optional[str] = None             # set with finish_reason error
    preemptions: int = 0
    prefill_pos: int = 0                    # prompt tokens already in KV
    prefill_chunks: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if not self.request_id:
            self.request_id = f"req-{self.ordinal}"
        if self.prompt.size == 0:
            raise ValueError("empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")

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

    def requeue_preempted(self, req: Request):
        req.state = PREEMPTED
        req.slot = None
        req.blocks = []
        req.generated = []
        req.prefill_pos = 0
        req.prefill_chunks = 0
        self.waiting.appendleft(req)

    def next_admittable(self) -> Optional[Request]:
        """The oldest waiting request if the pool can hold its uncached
        prompt blocks plus the first decode position now; None otherwise
        (a blocked head blocks the tail)."""
        if not self.waiting:
            return None
        head = min(self.waiting, key=lambda r: r.ordinal)
        _, _, feasible = self.pool.admission_plan(head.prompt,
                                                  extra_tokens=1)
        if not feasible:
            return None
        self.waiting.remove(head)
        return head

    def pick_victim(self) -> Optional[Request]:
        """The youngest running request."""
        if not self.running:
            return None
        return max(self.running, key=lambda r: r.ordinal)

    @staticmethod
    def finish_reason(req: Request) -> Optional[str]:
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
