"""Model substrate: dense and RWKV layers and the model assembly."""
from .transformer import (check_remat_policy, chunked_cross_entropy,
                          decode_step, embed_inputs, forward, init_cache,
                          init_params, lm_head_weight, loss_fn,
                          mask_pad_logits, prefill, prefill_batched,
                          unstack_periods)

__all__ = ["check_remat_policy", "chunked_cross_entropy",
           "decode_step", "embed_inputs", "forward", "init_cache",
           "init_params", "lm_head_weight", "loss_fn", "mask_pad_logits",
           "prefill", "prefill_batched", "unstack_periods"]
