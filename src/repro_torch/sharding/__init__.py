"""Sharding rules over a mesh shape (port of ``repro.sharding``):
parameter paths to per-dimension mesh axes, activation plans, batch and
cache specs, ZeRO-1 optimizer-state specs (:mod:`.rules`)."""
from .rules import (activation_plan, batch_axes, batch_specs, cache_specs,
                    param_specs, spec_leaves, zero1_specs)

__all__ = ["activation_plan", "batch_axes", "batch_specs", "cache_specs",
           "param_specs", "spec_leaves", "zero1_specs"]
