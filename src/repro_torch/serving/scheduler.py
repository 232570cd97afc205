"""Continuous-batching scheduler: admission, growth, preemption (a copy
of ``repro.serving.scheduler``; host-side only, no framework in it).

Per-request state machine::

    QUEUED --admit--> PREFILL --first token--> DECODE --done/eos--> DONE
                         ^                        |
                         |                     evict (blocks exhausted)
                         +------- EVICTED <-------+

Admission (:meth:`Scheduler.schedule_admissions`) pops the waiting queue
FIFO while three budgets hold: the decode batch has a free row
(``max_batch``), the admission batch's prompt tokens fit the per-tick
``token_budget``, and the allocator can supply every prompt block.
Evicted requests resume at the *front* of the queue (oldest-first
fairness) with their generated tokens folded into the resume prompt —
greedy decode is deterministic, so recompute-on-resume reproduces the
exact continuation.

Growth (:meth:`ensure_block`) allocates a request's next block lazily
when its length crosses a block boundary. When the free list is empty
the *youngest* active request is preempted (blocks freed, state
EVICTED, re-queued at the front); the oldest request is never starved —
it is only ever evicted when it is the sole active request, in which
case it resumes immediately and, by the engine's submit-time capacity
check, always fits alone.
"""
from __future__ import annotations

import enum
import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..obs.spans import instant as _obs_instant

from .kvcache import BlockAllocator, OutOfBlocks


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    EVICTED = "evicted"


@dataclass
class ServingRequest:
    """One request's full lifecycle: identity, budget, streaming hook,
    cache bookkeeping, and latency timestamps."""
    rid: int
    prompt: np.ndarray                      # (prompt_len,) int32
    max_new_tokens: int = 16
    eos_id: int | None = None
    stream: Callable[[int, int], None] | None = None  # (rid, token)

    state: RequestState = RequestState.QUEUED
    output: list = field(default_factory=list)   # generated tokens
    blocks: list = field(default_factory=list)   # allocated block ids
    length: int = 0                          # tokens with cached KV
    admit_seq: int = -1                      # admission order (youngest=max)
    admissions: int = 0                      # prefill passes (1 + resumes)
    evictions: int = 0

    # latency timestamps (perf_counter seconds)
    arrival_s: float = 0.0
    first_token_s: float | None = None
    token_times: list = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.state == RequestState.DONE

    def resume_prompt(self) -> np.ndarray:
        """Prompt for (re-)prefill: the original prompt plus everything
        generated so far. Prefill therefore always emits exactly one
        *new* token — the first for a fresh request, the next for a
        resumed one — and greedy determinism makes the recomputed
        continuation identical to the un-evicted run."""
        if not self.output:
            return np.asarray(self.prompt, dtype=np.int32)
        return np.concatenate([
            np.asarray(self.prompt, dtype=np.int32),
            np.asarray(self.output, dtype=np.int32)])

    def ttft_s(self) -> float | None:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    def inter_token_s(self) -> list:
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]

    def emit(self, token: int, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        self.output.append(int(token))
        self.token_times.append(now)
        if self.first_token_s is None:
            self.first_token_s = now
        if self.stream is not None:
            self.stream(self.rid, int(token))

    def hit_stop(self) -> bool:
        """Generation stops when the budget is spent or the last emitted
        token is EOS (the EOS token itself is part of the output)."""
        if len(self.output) >= self.max_new_tokens:
            return True
        return (self.eos_id is not None and self.output
                and self.output[-1] == self.eos_id)


@dataclass
class Admission:
    """One scheduled prefill: the request plus its resume prompt (fixed
    at admission time so eviction bookkeeping cannot race with it)."""
    req: ServingRequest
    prompt: np.ndarray


class Scheduler:
    """Owns the waiting queue, the active set, and the block allocator.

    Pure host-side mechanics — the engine drives the model; the
    scheduler decides *which* requests run and *where* their cache
    blocks live in the pool.
    """

    def __init__(self, allocator: BlockAllocator, *, block_size: int,
                 max_batch: int, token_budget: int):
        self.allocator = allocator
        self.block_size = int(block_size)
        self.max_batch = int(max_batch)
        self.token_budget = int(token_budget)
        self.waiting: deque[ServingRequest] = deque()
        self.active: list[ServingRequest] = []   # PREFILL/DECODE
        self._admit_counter = itertools.count()
        # optional eviction observer (the engine's trace recorder);
        # called with the victim right after it is re-queued
        self.on_evict: Callable[[ServingRequest], None] | None = None

    # -- queue ----------------------------------------------------------
    def submit(self, req: ServingRequest) -> None:
        req.state = RequestState.QUEUED
        self.waiting.append(req)

    def _requeue_front(self, req: ServingRequest) -> None:
        self.waiting.appendleft(req)

    # -- admission ------------------------------------------------------
    def blocks_for(self, tokens: int) -> int:
        return -(-int(tokens) // self.block_size)

    def schedule_admissions(self) -> list[Admission]:
        """Pop waiting requests into this tick's prefill batch under the
        row / token-budget / free-block constraints. Allocates each
        admitted request's prompt blocks."""
        admits: list[Admission] = []
        tokens = 0
        while self.waiting:
            req = self.waiting[0]
            prompt = req.resume_prompt()
            # admitted requests join self.active immediately, so the
            # active count alone is the row occupancy
            if len(self.active) >= self.max_batch:
                break
            if admits and tokens + len(prompt) > self.token_budget:
                break
            need = self.blocks_for(len(prompt))
            if need > self.allocator.num_free:
                break
            self.waiting.popleft()
            req.blocks = self.allocator.alloc_many(need)
            req.state = RequestState.PREFILL
            req.length = len(prompt)
            req.admit_seq = next(self._admit_counter)
            req.admissions += 1
            tokens += len(prompt)
            self.active.append(req)
            admits.append(Admission(req=req, prompt=prompt))
        return admits

    # -- decode growth / preemption -------------------------------------
    def decoding(self) -> list[ServingRequest]:
        return [r for r in self.active
                if r.state == RequestState.DECODE]

    def ensure_block(self, req: ServingRequest) -> bool:
        """Make sure the block holding position ``req.length`` exists.
        Returns False when the request was itself evicted to make room
        (caller must drop it from this tick's decode batch)."""
        if req not in self.active:
            # already evicted (e.g. by an earlier ensure_block this
            # tick) — allocating for it would orphan the block
            return False
        need_idx = req.length // self.block_size
        while need_idx >= len(req.blocks):
            try:
                req.blocks.append(self.allocator.alloc())
            except OutOfBlocks:
                victim = self.evict_youngest()
                if victim is None or victim is req:
                    return False
        return True

    def evict_youngest(self) -> ServingRequest | None:
        """Preempt the youngest active request: free its blocks, keep
        its generated tokens, and re-queue it at the front for
        recompute-on-resume."""
        candidates = [r for r in self.active
                      if r.state in (RequestState.DECODE,
                                     RequestState.PREFILL)]
        if not candidates:
            return None
        victim = max(candidates, key=lambda r: r.admit_seq)
        self.allocator.free_many(victim.blocks)
        victim.blocks = []
        victim.state = RequestState.EVICTED
        victim.evictions += 1
        victim.length = 0
        self.active.remove(victim)
        self._requeue_front(victim)
        _obs_instant("serving/evict", "serving", rid=victim.rid,
                     evictions=victim.evictions,
                     generated=len(victim.output))
        if self.on_evict is not None:
            self.on_evict(victim)
        return victim

    # -- completion ------------------------------------------------------
    def finish(self, req: ServingRequest) -> None:
        self.allocator.free_many(req.blocks)
        req.blocks = []
        req.state = RequestState.DONE
        self.active.remove(req)

    # -- introspection ---------------------------------------------------
    @property
    def drained(self) -> bool:
        return not self.waiting and not self.active

    def check_invariants(self) -> None:
        self.allocator.check()
        held = [b for r in self.active for b in r.blocks]
        assert len(held) == len(set(held)), "block shared across requests"
        assert set(held) <= set(self.allocator._allocated), \
            "request holds an unallocated block"
        if self.drained:
            assert self.allocator.num_in_use == 0, \
                f"{self.allocator.num_in_use} blocks leaked at drain"


__all__ = ["RequestState", "ServingRequest", "Admission", "Scheduler"]
