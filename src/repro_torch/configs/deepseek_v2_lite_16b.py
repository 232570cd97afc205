"""DeepSeek-V2-Lite (16B) — MLA (kv_lora_rank=512) + fine-grained MoE.
[arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2-Lite]

The published Lite config, as the reference has it: the first layer
dense (d_ff 10944), the remaining 26 layers MoE with 64 routed experts
(top-6) + 2 shared experts of d_ff 1408.
"""
from .base import ModelConfig, MoEConfig, register

DEEPSEEK_V2_LITE = register(ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=10944,                      # dense prelude layer
    vocab_size=102400,
    prelude=("mla",),
    block_pattern=("mla_moe",),
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    rope_theta=1e4,
    moe=MoEConfig(num_experts=64, experts_per_token=6,
                  num_shared_experts=2, d_ff=1408),
    source="arXiv:2405.04434",
))
