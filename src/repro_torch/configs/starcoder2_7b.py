"""StarCoder2-7B — GQA(kv=4) + RoPE, non-gated GELU MLP, biases, LN.
[arXiv:2402.19173; hf:bigcode/starcoder2-7b]"""
from .base import ModelConfig, register

STARCODER2_7B = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    block_pattern=("attn",),
    qkv_bias=True,
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    rope_theta=1e5,
    source="arXiv:2402.19173",
))
