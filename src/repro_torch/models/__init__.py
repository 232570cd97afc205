"""Model substrate: dense and RWKV layers and the model assembly."""
from .transformer import (decode_step, embed_inputs, forward, init_cache,
                          init_params, lm_head_weight, mask_pad_logits,
                          prefill, prefill_batched)

__all__ = ["decode_step", "embed_inputs", "forward", "init_cache",
           "init_params", "lm_head_weight", "mask_pad_logits", "prefill",
           "prefill_batched"]
