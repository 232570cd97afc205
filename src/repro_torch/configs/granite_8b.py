"""Granite-8B (code) — llama-architecture: GQA kv=8, SwiGLU, RMSNorm.
[arXiv:2405.04324; hf:ibm-granite/granite-8b-code-base]"""
from .base import ModelConfig, register

GRANITE_8B = register(ModelConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=49152,
    block_pattern=("attn",),
    rope_theta=1e4,
    source="arXiv:2405.04324",
))
