"""Architecture registry — the configs the port runs so far: the dense
granite-8b, gemma3-1b, qwen2.5-14b, starcoder2-7b and repro-lm-100m, the
recurrent rwkv6-7b, the MoE mixtral-8x7b, the MLA + MoE
deepseek-v2-lite-16b and the Mamba + attention + MoE hybrid
jamba-v0.1-52b."""
from .base import (ModelConfig, MoEConfig, MambaConfig, RWKVConfig,
                   REGISTRY, get_config, reduced, register, torch_dtype)

# registration side-effects
from . import (deepseek_v2_lite_16b, gemma3_1b,  # noqa: F401
               granite_8b, jamba_v0_1_52b, mixtral_8x7b, qwen2_5_14b,
               repro_lm_100m, rwkv6_7b, starcoder2_7b)

__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "RWKVConfig",
           "REGISTRY", "get_config", "reduced", "register", "torch_dtype"]
