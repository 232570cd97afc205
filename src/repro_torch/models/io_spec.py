"""input_specs(): stand-ins for every model input, with shapes and
dtypes and no storage (port of ``repro.models.io_spec``).

The reference returns ``jax.ShapeDtypeStruct`` leaves from
``jax.eval_shape``; the port's counterpart is a tensor on PyTorch's
``meta`` device, which has a shape and a dtype and allocates nothing.
:func:`params_spec` and :func:`cache_spec` run the port's own
``init_params`` and ``init_cache`` on ``meta``, so their trees are the
ones a real call builds.

Shapes come from the assignment's shape table (``configs.SHAPES``);
archs with a stubbed modality frontend (``[vlm]``/``[audio]``) receive
precomputed patch/frame *embeddings* of shape (B, S, D) instead of
token ids.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig, torch_dtype

META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


class _MetaGenerator(torch.Generator):
    """A CPU generator that names ``meta`` as its device. The init
    functions draw with ``device=generator.device``, and a draw on
    ``meta`` only records its shape and dtype, so ``init_params`` run
    with one builds the parameter tree without storage."""

    @property
    def device(self) -> torch.device:
        return META


def train_batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    if cfg.frontend is not None:
        return {"embeds": _spec((batch, seq, cfg.d_model),
                                torch_dtype(cfg.dtype)),
                "targets": _spec((batch, seq), torch.int32)}
    return {"tokens": _spec((batch, seq), torch.int32),
            "targets": _spec((batch, seq), torch.int32)}


def prefill_batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    if cfg.frontend is not None:
        return {"embeds": _spec((batch, seq, cfg.d_model),
                                torch_dtype(cfg.dtype))}
    return {"tokens": _spec((batch, seq), torch.int32)}


def decode_token_spec(cfg: ModelConfig, batch: int) -> torch.Tensor:
    return _spec((batch, 1), torch.int32)


def cache_spec(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    from .transformer import init_cache
    return init_cache(cfg, batch, max_len, device=META)


def params_spec(cfg: ModelConfig) -> dict:
    from .transformer import init_params
    return init_params(cfg, _MetaGenerator(), device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """All abstract inputs for the (arch × shape) cell's step function."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return {"batch": train_batch_spec(cfg, B, S)}
    if shape.kind == "prefill":
        return {"batch": prefill_batch_spec(cfg, B, S)}
    if shape.kind == "decode":
        return {"tokens": decode_token_spec(cfg, B),
                "caches": cache_spec(cfg, B, S),
                "cache_pos": _spec((), torch.int32)}
    raise ValueError(shape.kind)


__all__ = ["cache_spec", "decode_token_spec", "input_specs", "params_spec",
           "prefill_batch_spec", "train_batch_spec"]
