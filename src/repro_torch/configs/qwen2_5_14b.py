"""Qwen2.5-14B — GQA kv=8 with QKV bias, SwiGLU, 152k vocab.
[hf:Qwen/Qwen2.5-14B]"""
from .base import ModelConfig, register

QWEN2_5_14B = register(ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    block_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1e6,
    source="hf:Qwen/Qwen2.5-14B",
))
