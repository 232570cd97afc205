"""ParDNN-planned pipeline parallelism: the planners (port of
``repro.pipeline.pardnn_pp``).

The paper's partitioner decides where operator clusters live; at pod
scale the realizable form of that decision is the layer -> pipeline
stage map. This module has:

  * :func:`plan_stages` — ParDNN specialised to the layer chain:
    minimise the pipeline bottleneck (the makespan of the steady-state
    schedule) under a per-stage memory cap, by binary search over the
    bottleneck and greedy packing (optimal for contiguous chain
    partitioning), with the memory model of ParDNN's Step 2 (weights
    plus in-flight microbatch activations, 90% of the cap);
  * :func:`plan_stages_emulated` — the plan checked on the
    microbatch-expanded stage graph by the paper's FIFO emulator (the
    port's :func:`repro_torch.core.emulator.emulate`);
  * :func:`stack_stage_params` — a layer-stacked parameter tree packed
    into per-stage slots with an active mask, so unequal boundaries keep
    static shapes;
  * :func:`pipeline_apply` — the runtime: GPipe over the ``stage`` axis
    of a :class:`~repro_torch.distributed.ProcessMesh`, one stage a
    rank, activations handed to the next stage by ``ppermute``;
  * :func:`layer_flops` and :func:`config_stage_plan` — the coarse
    per-layer cost model of a config's layer chain, and its plan.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core.emulator import emulate
from ..core.graph import CostGraph
from ..tree import tree_map


@dataclass
class StagePlan:
    boundaries: list[tuple[int, int]]     # per stage [start, end)
    bottleneck: float                     # max stage compute
    stage_mem: list[float]
    feasible: bool

    @property
    def layers_per_stage(self) -> list[int]:
        return [e - s for s, e in self.boundaries]


def plan_stages(layer_costs, layer_mem, act_bytes: float, num_stages: int,
                mem_cap: float | None = None, inflight: int | None = None,
                mem_fraction: float = 0.9) -> StagePlan:
    """Contiguous chain partition minimising the bottleneck stage cost
    subject to memory. ``inflight`` microbatch activations are resident
    per stage in the GPipe steady state (default: ``num_stages``)."""
    costs = np.asarray(layer_costs, dtype=np.float64)
    mems = np.asarray(layer_mem, dtype=np.float64)
    L = len(costs)
    num_stages = min(num_stages, L)
    inflight = inflight if inflight is not None else num_stages
    cap = (mem_cap * mem_fraction) if mem_cap is not None else np.inf
    act_resident = act_bytes * inflight

    def feasible(T: float) -> list[tuple[int, int]] | None:
        bounds = []
        s = 0
        for _ in range(num_stages):
            if s >= L:
                break
            c = 0.0
            m = act_resident
            e = s
            while e < L and c + costs[e] <= T and m + mems[e] <= cap:
                c += costs[e]
                m += mems[e]
                e += 1
            if e == s:
                return None     # one layer exceeds T or the cap
            bounds.append((s, e))
            s = e
        return bounds if s >= L else None

    lo = float(np.max(costs))
    # headroom: the greedy packer sums in another order than np.sum, so
    # a target equal to the sum can fail spuriously
    hi = float(np.sum(costs)) * (1.0 + 1e-9) + 1e-12
    best = feasible(hi)
    if best is None:
        # memory-infeasible even serially: the degenerate plan
        per = max(L // num_stages, 1)
        bounds = [(i * per, min((i + 1) * per, L))
                  for i in range(num_stages)]
        bounds[-1] = (bounds[-1][0], L)
        sm = [float(np.sum(mems[s:e]) + act_resident) for s, e in bounds]
        return StagePlan(bounds, float("inf"), sm, feasible=False)
    for _ in range(48):
        mid = 0.5 * (lo + hi)
        b = feasible(mid)
        if b is not None:
            best, hi = b, mid
        else:
            lo = mid
    sm = [float(np.sum(mems[s:e]) + act_resident) for s, e in best]
    bot = max(float(np.sum(costs[s:e])) for s, e in best)
    ok = all(m <= cap for m in sm)
    return StagePlan(best, bot, sm, feasible=ok)


def uniform_plan(L: int, num_stages: int) -> list[tuple[int, int]]:
    """The L / P split: the first ``L % num_stages`` stages take one
    layer more."""
    per = L // num_stages
    extra = L % num_stages
    bounds = []
    s = 0
    for i in range(num_stages):
        e = s + per + (1 if i < extra else 0)
        bounds.append((s, e))
        s = e
    return bounds


def plan_stages_emulated(g_layers: CostGraph, plan: StagePlan,
                         num_micro: int) -> float:
    """The plan's pipeline makespan by the paper's FIFO emulator on the
    microbatch-expanded stage graph (``g_layers.comp[i]`` is layer i's
    cost)."""
    P_ = len(plan.boundaries)
    stage_cost = [sum(g_layers.comp[s:e]) for s, e in plan.boundaries]
    g = CostGraph()
    ids = {}
    for m in range(num_micro):
        for p in range(P_):
            ids[(m, p)] = g.add_node(comp=stage_cost[p],
                                     name=f"mb{m}_st{p}")
    for m in range(num_micro):
        for p in range(P_ - 1):
            g.add_edge(ids[(m, p)], ids[(m, p + 1)], comm=0.0)
    g.finalize()
    assign = np.array([p for m in range(num_micro) for p in range(P_)])
    return emulate(g, assign, P_).makespan


def stack_stage_params(layer_params, boundaries: list[tuple[int, int]]):
    """``layer_params``: a tree of tensors stacked on the layer dim (L,
    ...). Returns (stage_params, a tree of (P, Lmax, ...) tensors with
    each stage's layers first and zeros after; mask, a float32 (P, Lmax)
    tensor with 1 where a slot holds a layer)."""
    Lmax = max(e - s for s, e in boundaries)
    P_ = len(boundaries)

    def pack(x: torch.Tensor) -> torch.Tensor:
        out = x.new_zeros((P_, Lmax) + tuple(x.shape[1:]))
        for i, (s, e) in enumerate(boundaries):
            out[i, :e - s] = x[s:e]
        return out

    mask = torch.zeros((P_, Lmax), dtype=torch.float32)
    for i, (s, e) in enumerate(boundaries):
        mask[i, :e - s] = 1.0
    return tree_map(pack, layer_params), mask


def pipeline_apply(mesh, layer_fn, stage_params, mask, x_micro,
                   *, stage_axis: str = "stage"):
    """GPipe forward over ``stage_axis`` of ``mesh``, run by every rank
    for its stage (the body of the reference's ``shard_map``).

    ``layer_fn(layer_params, h) -> h`` is one layer; ``stage_params`` is
    this rank's row of :func:`stack_stage_params` (a tree of (Lmax, ...)
    tensors) and ``mask`` its (Lmax,) row; ``x_micro`` (M, mb, ...) the
    microbatched input, the same on every rank. Over ``T = M + P - 1``
    ticks stage 0 reads microbatch ``clip(t, 0, M-1)``, the others what
    the stage before sent at the tick before (every rank computes every
    tick, as the reference does), and each stage's output goes to the
    next by ``ppermute``; the last stage's outputs reach every rank by a
    masked ``psum``. Returns the (M, mb, ...) outputs.

    Autograd through it is the GPipe backward, as ``jax.grad`` is
    through the reference's: each ppermute's gradient runs back along
    the inverse permutation. As ``shard_map`` transposes its replicated
    output and input (``P()``), the output's incoming gradient is divided
    by the stage count before the psum's own psum, and ``x_micro``'s
    gradient is summed over the stages."""
    P_ = mesh.axis_size(stage_axis)
    M = x_micro.shape[0]
    T = M + P_ - 1
    sid = mesh.axis_index(stage_axis)
    Lmax = mask.shape[0]
    perm = [(i, i + 1) for i in range(P_ - 1)]
    layers = [tree_map(lambda a, j=j: a[j], stage_params)
              for j in range(Lmax)]
    mask = mask.to(x_micro.device)
    x_micro = _ReplicatedIn.apply(x_micro, mesh, stage_axis)
    first = torch.tensor(sid == 0, device=x_micro.device)

    def run_stage(h):
        for j in range(Lmax):
            h = torch.where(mask[j] > 0, layer_fn(layers[j], h), h)
        return h

    recv = torch.zeros_like(x_micro[0])
    ys = []
    for t in range(T):
        # the received tensor enters every rank's graph (stage 0's too,
        # masked out), so that every rank runs each ppermute's backward
        h_out = run_stage(torch.where(first, x_micro[min(t, M - 1)], recv))
        ys.append(h_out)
        if t < T - 1 and P_ > 1:   # the last tick's send reaches no one
            recv = mesh.ppermute(h_out, stage_axis, perm)
    outs = torch.stack(ys[P_ - 1:P_ - 1 + M])
    is_last = float(sid == P_ - 1)
    return _ReplicatedOut.apply(mesh.psum(outs * is_last, stage_axis), P_)


class _ReplicatedOut(torch.autograd.Function):
    """Identity; the gradient divided by ``n`` (``shard_map``'s transpose
    of an output replicated over ``n`` devices)."""

    @staticmethod
    def forward(ctx, x, n):
        ctx.n = n
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


class _ReplicatedIn(torch.autograd.Function):
    """Identity; the gradient summed over ``axis`` (``shard_map``'s
    transpose of an input replicated over it)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, ctx.axis, "sum"), None, None


# ----------------------------------------------------------- cost model
def layer_flops(cfg, kind: str, tokens: float, seq: int = 4096) -> float:
    """One layer's forward FLOPs at ``tokens`` tokens (coarse, analytic):
    the cost model behind :func:`config_stage_plan`, whose heterogeneity
    (mamba, attention, MoE) is what ParDNN's boundaries exploit."""
    D = cfg.d_model
    f = 0.0
    if kind.startswith(("attn", "swa")):
        f += 2 * tokens * D * (2 * cfg.q_dim + 2 * cfg.kv_dim)
        kv_eff = (min(cfg.sliding_window, seq) if kind.startswith("swa")
                  else seq / 2)          # causal average vs window
        f += 4 * tokens * kv_eff * cfg.head_dim * cfg.num_heads
    elif kind.startswith("mla"):
        qk = cfg.qk_nope_dim + cfg.qk_rope_dim
        f += 2 * tokens * D * (cfg.num_heads * qk + cfg.kv_lora_rank * 4)
    elif kind.startswith("mamba"):
        di = D * cfg.mamba.expand
        f += 2 * tokens * D * 2 * di + 2 * tokens * di * D
        f += 6 * tokens * di * cfg.mamba.d_state
    elif kind == "rwkv":
        f += 2 * tokens * D * 4 * D
    if kind.endswith("moe"):
        m = cfg.moe
        f += 2 * tokens * m.experts_per_token * 3 * D * m.d_ff
        f += 2 * tokens * (3 if cfg.gated_mlp else 2) * D * m.d_ff \
            * m.num_shared_experts
    elif not kind.startswith("rwkv"):
        f += 2 * tokens * (3 if cfg.gated_mlp else 2) * D * cfg.d_ff
    else:
        f += 2 * tokens * 2 * D * cfg.d_ff
    return f


def config_stage_plan(cfg, num_stages: int, *, tokens: float = 1e6,
                      act_bytes: float = 1e8,
                      mem_cap: float | None = None) -> StagePlan:
    """The ParDNN pipeline plan of a config's whole layer chain: per-layer
    costs from :func:`layer_flops`, per-layer memory from the parameter
    count (bf16), the embedding table with the first layer and an
    untied head with the last; the pipeline side of
    :meth:`repro_torch.api.PartitionPlan.to_pipeline_stages`."""
    kinds = list(cfg.prelude) + list(cfg.block_pattern) * cfg.num_periods
    costs = [layer_flops(cfg, k, tokens) for k in kinds]
    per_layer = cfg.param_count() / max(cfg.num_layers, 1)
    mems = [per_layer * 2.0] * len(costs)
    embed_b = cfg.vocab_size * cfg.d_model * 2.0
    if mems:
        mems[0] += embed_b
        if not cfg.tie_embeddings:
            mems[-1] += embed_b
    return plan_stages(costs, mems, act_bytes=act_bytes,
                       num_stages=num_stages, mem_cap=mem_cap)


__all__ = ["StagePlan", "config_stage_plan", "layer_flops", "pipeline_apply",
           "plan_stages", "plan_stages_emulated", "stack_stage_params",
           "uniform_plan"]
