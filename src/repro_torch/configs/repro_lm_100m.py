"""~100M-parameter llama-style LM, the reference's integration-test
model. Not an assigned arch."""
from .base import ModelConfig, register

REPRO_LM_100M = register(ModelConfig(
    name="repro-lm-100m",
    family="dense",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=2048,
    vocab_size=32000,
    block_pattern=("attn",),
    rope_theta=1e4,
    dtype="float32",
    source="(ours)",
))
