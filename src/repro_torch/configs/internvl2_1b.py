"""InternVL2-1B — InternViT-300M frontend (STUBBED per assignment:
``input_specs`` feeds precomputed patch embeddings) + Qwen2-0.5B-family
LM backbone: 24L, d=896, 14H GQA kv=2, QKV bias.
[arXiv:2404.16821; hf:OpenGVLab/InternVL2-1B]"""
from .base import ModelConfig, register

INTERNVL2_1B = register(ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    block_pattern=("attn",),
    qkv_bias=True,
    rope_theta=1e6,
    frontend="vision",
    tie_embeddings=True,
    source="arXiv:2404.16821",
))
