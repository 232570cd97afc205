"""AdamW with float32 master weights (port of ``repro.train.optimizer``).

State = ``{"mu", "nu", "count"}`` plus ``"master"`` when any parameter is
of lower precision than float32: float32 trees of the parameters' shape
and a 0-d int32 step count, the reference's tree (so a checkpoint of
``{"params", "opt"}`` has the same leaves in both packages).

:func:`apply_updates` is the reference's step line for line: clip the
gradient to ``grad_clip`` by its global norm; advance ``count`` only on
a finite step; the learning rate from the count after the increment;
decoupled weight decay on every leaf; a non-finite step changes nothing
and reports ``skipped = 1``. Unlike the reference's functional update it
writes ``mu``, ``nu``, the masters and the parameters **in place** (and
returns the same trees): at full width a second copy of the optimizer
state would cost 12 bytes a parameter. Whether the step is finite is
read on the host, once per step, before anything is written.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import tree_flatten, tree_map


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``: float32."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_state(cfg: AdamWConfig, params) -> dict:
    """Zero moments (float32), a zero count on the parameters' device, and
    float32 master copies when any parameter is of lower precision."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaves = tree_flatten(params)[0]
    state = {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
             "count": torch.zeros((), dtype=torch.int32,
                                  device=leaves[0].device)}
    if any(p.dtype != torch.float32 for p in leaves):
        state["master"] = tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params)
    return state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    leaves = tree_flatten(tree)[0]
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state: dict):
    """One AdamW step, in place. Returns (params, state, metrics) — the
    trees it was given — with metrics ``grad_norm``, ``lr`` and
    ``skipped`` (0-d tensors)."""
    gnorm = global_norm(grads)
    finite = bool(torch.isfinite(gnorm))
    scale = torch.where(gnorm > cfg.grad_clip,
                        cfg.grad_clip / (gnorm + 1e-9),
                        torch.ones_like(gnorm))
    count = state["count"]
    if finite:
        count.add_(1)
    lr = schedule(cfg, count)
    t = count.to(torch.float32)
    bc1 = 1 - cfg.b1 ** t
    bc2 = 1 - cfg.b2 ** t
    masters = state.get("master", params)
    if finite:
        flat = zip(*(tree_flatten(x)[0] for x in (
            params, masters, grads, state["mu"], state["nu"])))
        for p, pm, g, mu, nu in flat:
            g = g.to(torch.float32) * scale
            mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
            nu.mul_(cfg.b2).add_(torch.square(g), alpha=1 - cfg.b2)
            step_v = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            pm.sub_(lr * (step_v + cfg.weight_decay * pm))
            if pm is not p:
                p.copy_(pm)
    metrics = {"grad_norm": gnorm, "lr": lr,
               "skipped": torch.tensor(0 if finite else 1,
                                       dtype=torch.int32)}
    return params, state, metrics


__all__ = ["AdamWConfig", "apply_updates", "global_norm", "init_state",
           "schedule"]
