"""Mamba's selective scan: the CUDA kernels' wrapper and its plain
versions."""
from .ops import STATES, selective_scan, selective_scan_bwd
from .ref import selective_scan_bwd_ref, selective_scan_ref

__all__ = ["STATES", "selective_scan", "selective_scan_bwd",
           "selective_scan_bwd_ref", "selective_scan_ref"]
