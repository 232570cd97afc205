"""RWKV-6 (Finch) 7B — attention-free, data-dependent decay linear
recurrence; 64 heads × 64 head-dim time-mixing + 3.5x channel-mixing.
[arXiv:2404.05892; hf:RWKV/rwkv-6-world-7b]"""
from .base import ModelConfig, RWKVConfig, register

RWKV6_7B = register(ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,                 # 4096 / 64 head_dim
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    block_pattern=("rwkv",),
    rwkv=RWKVConfig(head_dim=64, lora_w=64, ff_mult=3.5),
    source="arXiv:2404.05892",
))
