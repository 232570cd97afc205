"""Architecture registry — the configs the port serves so far."""
from .base import (ModelConfig, MoEConfig, MambaConfig, RWKVConfig,
                   REGISTRY, get_config, reduced, register, torch_dtype)

# registration side-effects
from . import granite_8b, repro_lm_100m, rwkv6_7b  # noqa: F401

__all__ = ["ModelConfig", "MoEConfig", "MambaConfig", "RWKVConfig",
           "REGISTRY", "get_config", "reduced", "register", "torch_dtype"]
