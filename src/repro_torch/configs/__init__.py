"""Architecture registry — the configs the port runs so far: the dense
granite-8b and repro-lm-100m, the recurrent rwkv6-7b and the MoE
mixtral-8x7b."""
from .base import (ModelConfig, MoEConfig, MambaConfig, RWKVConfig,
                   REGISTRY, get_config, reduced, register, torch_dtype)

# registration side-effects
from . import (granite_8b, mixtral_8x7b, repro_lm_100m,  # noqa: F401
               rwkv6_7b)

__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "RWKVConfig",
           "REGISTRY", "get_config", "reduced", "register", "torch_dtype"]
