"""Flash attention: the CUDA kernels' wrappers (forward and backward)
and their plain versions."""
from .ops import HEAD_DIMS, flash_attention, flash_attention_bwd
from .ref import flash_attention_bwd_ref, flash_attention_ref

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_ref", "flash_attention_ref"]
