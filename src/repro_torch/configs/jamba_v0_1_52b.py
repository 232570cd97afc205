"""Jamba v0.1 (52B) — hybrid Mamba+attention 7:1 interleave with 16-expert
top-2 MoE on every other layer. Period of 8: attention at index 4, MoE on
odd indices. [arXiv:2403.19887; hf:ai21labs/Jamba-v0.1]"""
from .base import MambaConfig, ModelConfig, MoEConfig, register

JAMBA_V0_1 = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("mamba", "mamba_moe", "mamba", "mamba_moe",
                   "attn", "mamba_moe", "mamba", "mamba_moe"),
    moe=MoEConfig(num_experts=16, experts_per_token=2, d_ff=14336),
    mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
    rope_theta=1e4,
    source="arXiv:2403.19887",
))
