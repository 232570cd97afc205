"""HuBERT X-Large — encoder-only audio transformer (wav2vec2 arch):
48L, d=1280, 16 heads, LN + GELU non-gated MLP; conv feature extractor
STUBBED per assignment (``input_specs`` feeds precomputed frame
embeddings); masked-prediction loss over 504 cluster targets.
[arXiv:2106.07447; hf:facebook/hubert-xlarge-ll60k]"""
from .base import ModelConfig, register

HUBERT_XLARGE = register(ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("attn",),
    encoder_only=True,
    causal=False,
    frontend="audio",
    gated_mlp=False,
    act="gelu",
    norm="layernorm",
    source="arXiv:2106.07447",
))
