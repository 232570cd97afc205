"""Model configuration system (port of ``repro.configs.base``).

One ``ModelConfig`` describes an architecture through a per-period
``block_pattern`` of layer kinds; the model stacks ``num_periods``
periods of it after an optional ``prelude``. The port runs every kind
below. ``ShapeConfig``, ``SHAPES`` and ``shape_skip_reason`` are the
assignment's shape table and its skip rules.

Layer kinds (entries of ``block_pattern``):
  "attn"        — global attention (GQA) + dense MLP
  "attn_moe"    — global attention + MoE MLP
  "swa"         — sliding-window attention + dense MLP
  "swa_moe"     — sliding-window attention + MoE
  "mla"         — multi-head latent attention (DeepSeek) + dense MLP
  "mla_moe"     — MLA + MoE
  "mamba"       — Mamba SSM + dense MLP (Jamba style: mlp optional)
  "mamba_moe"   — Mamba + MoE
  "rwkv"        — RWKV6 time-mix + channel-mix
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

REGISTRY: dict[str, "ModelConfig"] = {}

_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype a config's ``dtype`` string names."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown dtype '{name}'; have "
                         f"{sorted(_TORCH_DTYPES)}") from None


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    experts_per_token: int = 2
    num_shared_experts: int = 0
    d_ff: int = 0                      # expert hidden size
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    chunk: int = 256                   # scan chunk (memory/compile knob)


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    lora_w: int = 64                   # decay LoRA rank
    ff_mult: float = 3.5


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense|moe|ssm|hybrid|vlm|audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...] = ("attn",)
    prelude: tuple[str, ...] = ()      # layers before the stacked periods
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    rope_theta_global: float | None = None   # gemma3: different global theta
    sliding_window: int = 4096
    post_norm: bool = False            # gemma3 sandwich norm
    softcap: float = 0.0
    # MLA (DeepSeek)
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # sub-configs
    moe: MoEConfig | None = None
    mamba: MambaConfig | None = None
    rwkv: RWKVConfig | None = None
    # IO
    frontend: str | None = None        # None|"vision"|"audio" (stubbed)
    encoder_only: bool = False
    causal: bool = True
    tie_embeddings: bool = False
    scale_embeddings: bool = False     # gemma: x *= sqrt(d_model)
    norm_eps: float = 1e-6
    norm: str = "rmsnorm"              # rmsnorm|layernorm
    act: str = "silu"                  # silu|gelu
    gated_mlp: bool = True             # SwiGLU (3 mats) vs plain MLP (2)
    # numerics
    dtype: str = "bfloat16"
    source: str = ""

    # ------------------------------------------------------------------
    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_periods(self) -> int:
        return (self.num_layers - len(self.prelude)) // self.period

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a 256 multiple, as in the reference (the
        padding columns are masked out of the logits)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def validate(self) -> "ModelConfig":
        assert (self.num_layers - len(self.prelude)) % self.period == 0, \
            f"{self.name}: layers {self.num_layers} != prelude " \
            f"{len(self.prelude)} + k*{self.period}"
        if any("moe" in b for b in self.block_pattern + self.prelude):
            assert self.moe is not None
        if any(b == "mamba" or b == "mamba_moe"
               for b in self.block_pattern + self.prelude):
            assert self.mamba is not None
        if "rwkv" in self.block_pattern:
            assert self.rwkv is not None
        return self

    def param_count(self) -> float:
        """Analytic parameter count, the reference's function as it is.

        For ``rwkv`` blocks it leaves out ``w_g`` and ``cm_r``: 6.46 B
        for rwkv6-7b, whose tensors hold 7.53 B. Count the tensors where
        the true size matters."""
        D, dff, V = self.d_model, self.d_ff, self.vocab_size
        total = V * D * (1 if self.tie_embeddings else 2)
        kinds = list(self.prelude) + list(self.block_pattern) * self.num_periods
        for kind in kinds:
            total += 2 * D  # norms
            if kind.startswith(("attn", "swa")):
                total += D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
            elif kind.startswith("mla"):
                r = self.kv_lora_rank
                qk = self.qk_nope_dim + self.qk_rope_dim
                total += D * self.num_heads * qk            # q proj
                total += D * (r + self.qk_rope_dim)          # down kv + rope
                total += r * self.num_heads * (self.qk_nope_dim
                                               + self.v_head_dim)
                total += self.num_heads * self.v_head_dim * D
            elif kind.startswith("mamba"):
                di = D * self.mamba.expand
                total += 2 * D * di + di * self.mamba.d_conv
                total += di * (2 * self.mamba.d_state + 2) + di * D
            elif kind == "rwkv":
                total += 4 * D * D + D * self.rwkv.lora_w * 2
                total += 2 * D * int(D * self.rwkv.ff_mult)
                continue
            mlp_mats = 3 if self.gated_mlp else 2
            if kind.endswith("moe"):
                m = self.moe
                e_all = m.num_experts + m.num_shared_experts
                total += e_all * mlp_mats * D * m.d_ff + D * m.num_experts
            elif not kind.startswith("rwkv"):
                total += mlp_mats * D * dff
        return float(total)

    def active_param_count(self) -> float:
        """Per-token active params (MoE: only routed-to experts); the
        reference's function as it is (``MODEL_FLOPS`` of the dry run)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        m = self.moe
        kinds = list(self.prelude) + list(self.block_pattern) * self.num_periods
        n_moe = sum(1 for kk in kinds if kk.endswith("moe"))
        inactive = n_moe * (m.num_experts - m.experts_per_token) \
            * (3 if self.gated_mlp else 2) * self.d_model * m.d_ff
        return float(full - inactive)


def register(cfg: ModelConfig) -> ModelConfig:
    cfg = cfg.validate()
    REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registration side-effects)
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def reduced(cfg: ModelConfig, layers: int | None = None) -> ModelConfig:
    """Tiny same-family variant for CPU tests (the reference's sizes)."""
    period = cfg.period
    n_prelude = len(cfg.prelude)
    nl = layers if layers is not None else (n_prelude + period)
    nl = n_prelude + max((nl - n_prelude) // period, 1) * period
    small_heads = 4
    small_kv = 1 if cfg.num_kv_heads == 1 else \
        (4 if cfg.num_kv_heads >= cfg.num_heads else 2)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=nl,
        d_model=64,
        num_heads=small_heads,
        num_kv_heads=small_kv,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sliding_window=16,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_nope_dim=16 if cfg.kv_lora_rank else cfg.qk_nope_dim,
        qk_rope_dim=8 if cfg.kv_lora_rank else cfg.qk_rope_dim,
        v_head_dim=16 if cfg.kv_lora_rank else cfg.v_head_dim,
        dtype="float32",
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4,
            experts_per_token=min(cfg.moe.experts_per_token, 2),
            num_shared_experts=min(cfg.moe.num_shared_experts, 1),
            d_ff=64, capacity_factor=2.0)
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, d_state=8, chunk=8)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=16, lora_w=8)
    return dataclasses.replace(cfg, **kw).validate()


# ---------------------------------------------------------------- shapes
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> str | None:
    """Why the (arch, shape) cell is skipped, or None: an encoder-only
    arch has no decode step, and a 500k context needs sub-quadratic
    attention (the reference's rules, word for word)."""
    if cfg.encoder_only and shape.kind == "decode":
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        sub_quadratic = any(
            b.startswith(("swa", "mamba", "rwkv"))
            for b in cfg.block_pattern + cfg.prelude)
        if not sub_quadratic:
            return "pure full-attention arch; 500k needs sub-quadratic attention"
    return None
