"""RWKV6 recurrence: the CUDA kernels' wrapper and its plain versions."""
from .ops import (HEAD_DIMS, MAX_CHUNK, MMA_HEAD_DIMS, VARIANTS, wkv6,
                  wkv6_bwd)
from .ref import wkv_bwd_ref, wkv_ref, wkv_step_ref

__all__ = ["HEAD_DIMS", "MAX_CHUNK", "MMA_HEAD_DIMS", "VARIANTS", "wkv6",
           "wkv6_bwd", "wkv_bwd_ref", "wkv_ref", "wkv_step_ref"]
