"""Continuous-batching serving engine (port of ``repro.serving.engine``:
the local path, and :func:`partition_for_serving`, which traces and
partitions the paged decode step; serving from a plan is not ported
yet).

The engine composes the paged KV storage (:mod:`.kvcache`), the
admission / growth / preemption policy (:mod:`.scheduler`) and the model
loop: one padded batched prefill per tick for all admitted prompts (one
host sync for the batch argmax, prefill attention through the
flash-attention kernel), then one paged decode step over the block
tables for every DECODE request.

Correctness anchor: continuously-batched, paged greedy decode is
token-for-token equal to the sequential reference for every request,
under any admission order and any eviction/resume schedule.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import obs as _obs
from .. import resolve_device
from ..configs.base import ModelConfig
from ..models import decode_step, prefill_batched
from ..obs.stats import latency_summary
from . import kvcache
from .kvcache import BlockAllocator
from .scheduler import RequestState, Scheduler, ServingRequest

# public alias: the request type users construct and submit
Request = ServingRequest


def _ceil_pow2(n: int, floor: int = 1) -> int:
    p = max(int(floor), 1)
    while p < n:
        p *= 2
    return p


@dataclass
class ServingStats:
    """Engine counters + latency samples."""
    submitted: int = 0
    admitted: int = 0              # prefill admissions (incl. resumes)
    preempted: int = 0             # eviction events
    evicted_requests: int = 0      # distinct requests evicted >= once
    completed: int = 0
    rejected: int = 0              # refused at submit()
    ticks: int = 0
    prefill_calls: int = 0
    prefill_tokens: int = 0
    decode_steps: int = 0
    generated_tokens: int = 0
    peak_active: int = 0
    peak_blocks_in_use: int = 0
    leaked_blocks: int = 0
    ttft_s: list = field(default_factory=list)
    inter_token_s: list = field(default_factory=list)

    def record_request(self, req: ServingRequest) -> None:
        t = req.ttft_s()
        if t is not None:
            self.ttft_s.append(float(t))
        self.inter_token_s.extend(float(d) for d in req.inter_token_s())
        if req.evictions:
            self.evicted_requests += 1
        self.preempted += req.evictions

    def to_dict(self) -> dict:
        return {
            "submitted": self.submitted, "admitted": self.admitted,
            "preempted": self.preempted,
            "evicted_requests": self.evicted_requests,
            "completed": self.completed, "rejected": self.rejected,
            "ticks": self.ticks, "prefill_calls": self.prefill_calls,
            "prefill_tokens": self.prefill_tokens,
            "decode_steps": self.decode_steps,
            "generated_tokens": self.generated_tokens,
            "peak_active": self.peak_active,
            "peak_blocks_in_use": self.peak_blocks_in_use,
            "leaked_blocks": self.leaked_blocks,
            **latency_summary(self.ttft_s, prefix="ttft_"),
            **latency_summary(self.inter_token_s, prefix="inter_token_"),
        }


class ServingEngine:
    """Continuous-batching engine over a paged KV cache.

    Args:
        cfg, params: the model (attention-family archs; recurrent/
            encoder-only configs raise ``NotImplementedError`` — see
            :func:`kvcache.supported_reason`). ``params`` must already
            live on ``device``.
        block_size: tokens per KV block.
        num_blocks: pool size in blocks (one block is reserved as the
            null block).
        max_batch: decode batch width (rows of the block-table batch).
        max_len: per-request token ceiling (prompt + generated); must be
            a multiple of ``block_size``. Fixes the gathered dense view
            at ``max_len``.
        token_budget: max prompt tokens admitted per tick (an admission
            batch always takes at least one request regardless).
        device: where the pools and the steps live; ``None`` means
            ``cuda``, which raises on a machine without one.
    """

    def __init__(self, cfg: ModelConfig, params, *, block_size: int = 16,
                 num_blocks: int = 64, max_batch: int = 8,
                 max_len: int = 256, token_budget: int | None = None,
                 device=None):
        self.device = resolve_device(device)
        if max_len % block_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"block_size {block_size}")
        reason = kvcache.supported_reason(cfg)
        if reason is not None:
            raise NotImplementedError(
                f"{cfg.name}: paged serving unsupported — {reason}")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.cfg = cfg
        self.params = params
        self.block_size = int(block_size)
        self.max_len = int(max_len)
        self.max_blocks_per_req = self.max_len // self.block_size
        self.max_batch = int(max_batch)
        self.allocator = BlockAllocator(num_blocks)
        if self.max_blocks_per_req > self.allocator.capacity:
            raise ValueError(
                f"max_len {max_len} needs up to {self.max_blocks_per_req} "
                f"blocks per request but the pool only has "
                f"{self.allocator.capacity} allocatable blocks — raise "
                f"num_blocks or lower max_len")
        self.scheduler = Scheduler(
            self.allocator, block_size=self.block_size,
            max_batch=self.max_batch,
            token_budget=int(token_budget) if token_budget else
            self.max_batch * self.max_len)
        self.pools = kvcache.init_pools(cfg, num_blocks, self.block_size,
                                        self.device)
        self.stats = ServingStats()
        self.completed: dict[int, ServingRequest] = {}

    # ------------------------------------------------------------- model
    def _decode_impl(self, params, pools, block_tables, tokens, lengths):
        """The paged decode step (also the traced/partitioned function):
        gather pages → dense decode at per-row positions → scatter the
        one new token per row back into its block. Writes ``pools`` in
        place and returns ``(logits, pools)``; the tracer functionalizes
        the writes, so in the traced graph the new pools are node
        outputs."""
        dense = kvcache.gather_pages(pools, block_tables)
        logits, dense = decode_step(self.cfg, params, dense, tokens,
                                    lengths)
        pools = kvcache.scatter_token(pools, dense, block_tables, lengths)
        return logits, pools

    def _decode(self, block_tables, tokens, lengths) -> torch.Tensor:
        logits, self.pools = self._decode_impl(
            self.params, self.pools, block_tables, tokens, lengths)
        return logits

    def _decode_example_args(self):
        """Example inputs fixing the decode step's (static) shapes."""
        bt = torch.zeros((self.max_batch, self.max_blocks_per_req),
                         dtype=torch.int32, device=self.device)
        toks = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                           device=self.device)
        lens = torch.zeros((self.max_batch,), dtype=torch.int32,
                           device=self.device)
        return (self.params, self.pools, bt, toks, lens)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ------------------------------------------------------------ intake
    def submit(self, req: ServingRequest) -> None:
        """Queue a request, refusing inputs that could never complete
        (a KV overflow is rejected here, not discovered in a live
        cache)."""
        plen = len(req.prompt)
        if plen < 1:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: max_new_tokens "
                             f"{req.max_new_tokens} < 1")
        if plen + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({plen} tokens) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds the "
                f"engine's max_len ({self.max_len}) — the KV cache would "
                f"overflow; shorten the prompt, lower max_new_tokens, or "
                f"raise max_len")
        req.arrival_s = time.perf_counter()
        self.stats.submitted += 1
        _obs.instant("serving/submit", "serving", rid=req.rid,
                     prompt_tokens=plen)
        self.scheduler.submit(req)

    # ------------------------------------------------------------- steps
    def _run_prefill(self, admits) -> None:
        """One padded prefill for every admission: a single device call
        and a single host sync for the whole batch."""
        B = _ceil_pow2(len(admits))
        S = _ceil_pow2(max(len(a.prompt) for a in admits), floor=8)
        tokens = np.zeros((B, S), dtype=np.int32)
        plens = np.ones((B,), dtype=np.int32)
        for j, a in enumerate(admits):
            tokens[j, :len(a.prompt)] = a.prompt
            plens[j] = len(a.prompt)
        logits, caches = prefill_batched(self.cfg, self.params,
                                         self._tensor(tokens),
                                         self._tensor(plens))
        nxt = logits[:, -1].argmax(-1).cpu().numpy()      # one host sync
        now = time.perf_counter()
        self.stats.prefill_calls += 1
        self.stats.prefill_tokens += int(sum(len(a.prompt) for a in admits))
        self.stats.admitted += len(admits)
        for j, a in enumerate(admits):
            req = a.req
            kvcache.write_prompt(self.pools, req.blocks, caches, j,
                                 len(a.prompt), self.block_size)
            req.emit(int(nxt[j]), now)
            self.stats.generated_tokens += 1
            req.state = RequestState.DECODE
            if req.hit_stop():
                self._finish(req)

    def _finish(self, req: ServingRequest) -> None:
        self.scheduler.finish(req)
        self.completed[req.rid] = req
        self.stats.completed += 1
        self.stats.record_request(req)

    def _run_decode(self) -> int:
        """One decode step over the block tables for every DECODE-state
        request (rows beyond the active set are padding aimed at the
        null block)."""
        sched = self.scheduler
        batch = []
        for req in sorted(sched.decoding(), key=lambda r: r.admit_seq):
            if req.state != RequestState.DECODE:
                continue        # evicted by an earlier ensure_block
            if sched.ensure_block(req):
                batch.append(req)
        # ensure_block may have evicted members picked earlier
        batch = [r for r in batch if r.state == RequestState.DECODE]
        if not batch:
            return 0
        B, W = self.max_batch, self.max_blocks_per_req
        bt = np.zeros((B, W), dtype=np.int32)
        toks = np.zeros((B, 1), dtype=np.int32)
        lens = np.zeros((B,), dtype=np.int32)
        for i, req in enumerate(batch):
            bt[i, :len(req.blocks)] = req.blocks
            toks[i, 0] = req.output[-1]
            lens[i] = req.length
        logits = self._decode(self._tensor(bt), self._tensor(toks),
                              self._tensor(lens))
        nxt = logits[:, -1].argmax(-1).cpu().numpy()      # one host sync
        now = time.perf_counter()
        self.stats.decode_steps += 1
        for i, req in enumerate(batch):
            req.length += 1
            req.emit(int(nxt[i]), now)
            self.stats.generated_tokens += 1
            if req.hit_stop():
                self._finish(req)
        return len(batch)

    def tick(self) -> int:
        """One engine step: admit+prefill, then decode every active
        request by one token. Returns the number of requests advanced."""
        self.stats.ticks += 1
        admits = self.scheduler.schedule_admissions()
        if admits:
            with _obs.span("serving/prefill_batch"):
                self._run_prefill(admits)
        with _obs.span("serving/decode_step"):
            decoded = self._run_decode()
        self.stats.peak_active = max(self.stats.peak_active,
                                     len(self.scheduler.active))
        self.stats.peak_blocks_in_use = self.allocator.peak_in_use
        if _obs.enabled():
            _obs.counter("serving/pool", "serving",
                         blocks_in_use=self.allocator.num_in_use,
                         active=len(self.scheduler.active),
                         waiting=len(self.scheduler.waiting))
        return decoded + len(admits)

    def run_until_drained(self, max_ticks: int = 100000
                          ) -> dict[int, ServingRequest]:
        while not self.scheduler.drained:
            if self.tick() == 0:
                raise RuntimeError(
                    "serving engine stalled: queued requests cannot be "
                    "admitted (prompt larger than the pool?)")
            if self.stats.ticks >= max_ticks:
                raise RuntimeError(f"exceeded max_ticks={max_ticks}")
        self.scheduler.check_invariants()
        self.stats.leaked_blocks = self.allocator.num_in_use
        return self.completed


# ---------------------------------------------------------------------------
# plan construction
# ---------------------------------------------------------------------------
def serving_geometry(block_size: int = 16, num_blocks: int = 64,
                     max_batch: int = 8, max_len: int = 256) -> dict:
    return {"block_size": int(block_size), "num_blocks": int(num_blocks),
            "max_batch": int(max_batch), "max_len": int(max_len)}


def partition_for_serving(cfg: ModelConfig, params, *, devices,
                          memory=None, options=None, meta=None,
                          device=None, **geometry):
    """Trace the paged decode step for ``(cfg, params)`` at the given
    serving geometry and partition it into a
    :class:`~repro_torch.api.PartitionPlan`.

    ``params`` live on ``device`` (``None`` means ``cuda``), where the
    engine allocates its pools; the trace runs no step. The geometry is
    recorded in ``plan.meta["serving"]`` and the graph fingerprint
    ties the plan to it.
    """
    from .. import api
    geo = serving_geometry(**geometry)
    eng = ServingEngine(cfg, params, device=device, **geo)
    traced = api.trace(eng._decode_impl, *eng._decode_example_args(),
                       record=True)
    meta = dict(meta or {})
    meta["serving"] = dict(geo)
    meta.setdefault("arch", cfg.name)
    return api.partition(traced, devices=devices, memory=memory,
                         options=options, meta=meta)


__all__ = ["Request", "ServingRequest", "ServingEngine", "ServingStats",
           "partition_for_serving", "serving_geometry"]
