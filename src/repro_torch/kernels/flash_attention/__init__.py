"""Flash attention: the CUDA kernel's wrapper and its plain version."""
from .ops import HEAD_DIMS, flash_attention
from .ref import flash_attention_ref

__all__ = ["HEAD_DIMS", "flash_attention", "flash_attention_ref"]
