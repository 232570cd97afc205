"""ParDNN core: the paper's computational-graph partitioning algorithm.

The partitioner modules and the segment cutter (``segments``) are
numpy-only copies of the reference's ``repro/core``; the tracer
(``tracing``) builds their ``CostGraph`` from an aten-level FX graph of a
PyTorch function. ``tracing``, ``executor`` and ``runtime`` import torch
and are left to the facade (``repro_torch.api``) to import.
"""
from .costmodel import H100, V100, DeviceModel
from .emulator import (Schedule, emulate, emulate_scalar, emulate_vectorized,
                       resolve_engine)
from .errors import PlanValidationError
from .fenwick import Fenwick, MaxPrefixTree
from .graph import CostGraph, Placement, random_dag, NORMAL, RESIDUAL, REF
from .memops import (IncrementalMemoryTracker, MemoryProfile, compute_profile,
                     compute_profile_scalar, compute_profile_vectorized,
                     memory_potentials)
from .partitioner import PardnnOptions, pardnn_partition
from .slicing import Slicing, slice_graph
from .mapping import Mapping, map_clusters, glb_map

__all__ = [
    "CostGraph", "Placement", "random_dag", "NORMAL", "RESIDUAL", "REF",
    "DeviceModel", "H100", "V100",
    "Schedule", "emulate", "emulate_scalar", "emulate_vectorized",
    "resolve_engine", "Fenwick", "MaxPrefixTree",
    "MemoryProfile", "compute_profile", "compute_profile_scalar",
    "compute_profile_vectorized", "memory_potentials",
    "IncrementalMemoryTracker",
    "PardnnOptions", "pardnn_partition", "PlanValidationError",
    "Slicing", "slice_graph", "Mapping", "map_clusters", "glb_map",
]
