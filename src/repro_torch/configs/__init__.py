"""Architecture registry — every config of the reference: the dense
granite-8b, gemma3-1b, qwen2.5-14b, starcoder2-7b and repro-lm-100m, the
recurrent rwkv6-7b, the MoE mixtral-8x7b, the MLA + MoE
deepseek-v2-lite-16b, the Mamba + attention + MoE hybrid jamba-v0.1-52b,
the vision-language internvl2-1b (its vision frontend stubbed: it takes
patch embeddings) and the encoder-only audio hubert-xlarge (its
feature extractor stubbed: it takes frame embeddings)."""
from .base import (SHAPES, REGISTRY, ModelConfig, MoEConfig, MambaConfig,
                   RWKVConfig, ShapeConfig, get_config, reduced, register,
                   shape_skip_reason, torch_dtype)

# registration side-effects
from . import (deepseek_v2_lite_16b, gemma3_1b,  # noqa: F401
               granite_8b, hubert_xlarge, internvl2_1b, jamba_v0_1_52b,
               mixtral_8x7b, qwen2_5_14b, repro_lm_100m, rwkv6_7b,
               starcoder2_7b)

#: the assignment's ten archs (the registry adds repro-lm-100m)
ASSIGNED_ARCHS = [
    "mixtral-8x7b", "deepseek-v2-lite-16b", "gemma3-1b", "starcoder2-7b",
    "granite-8b", "qwen2.5-14b", "rwkv6-7b", "internvl2-1b",
    "jamba-v0.1-52b", "hubert-xlarge",
]

__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "RWKVConfig",
           "ShapeConfig", "SHAPES", "REGISTRY", "get_config", "reduced",
           "register", "shape_skip_reason", "torch_dtype", "ASSIGNED_ARCHS"]
