"""Gemma 3 1B — 5:1 local:global attention, 1024-token sliding window,
qk-norm, sandwich norms, tied embeddings, 262k vocab.
[hf:google/gemma-3-1b-pt]

26 layers = 2 local prelude + 4 periods of (5 local : 1 global).
Local layers use rope_theta=10k, global layers 1M."""
from .base import ModelConfig, register

GEMMA3_1B = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    prelude=("swa", "swa"),
    block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
    sliding_window=1024,
    rope_theta=1e4,
    rope_theta_global=1e6,
    qk_norm=True,
    post_norm=True,
    tie_embeddings=True,
    scale_embeddings=True,
    act="gelu",
    source="hf:google/gemma-3-1b-pt",
))
