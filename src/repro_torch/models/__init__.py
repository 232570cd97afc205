"""Model substrate: layers, MoE, SSM, RWKV, assembly, IO specs."""
import torch

from .io_spec import cache_spec, input_specs, params_spec
from .transformer import (check_remat_policy, chunked_cross_entropy,
                          decode_step, embed_inputs, encoder_logits, forward,
                          init_cache, init_params, lm_head_weight, loss_fn,
                          mask_pad_logits, prefill, prefill_batched,
                          unstack_periods)


def smoke_batch(cfg, batch: int = 2, seq: int = 32, device=None) -> dict:
    """Tiny all-zeros training batch matching the config's frontend —
    the example input shared by the tracing examples and dry-run.
    Embeds are float32, as the reference's ``jnp.zeros`` are;
    ``device`` as for the other entry points (``None``: cuda)."""
    from .. import resolve_device
    dev = resolve_device(device)
    zeros = torch.zeros((batch, seq), dtype=torch.int32, device=dev)
    if cfg.frontend is not None:
        return {"embeds": torch.zeros((batch, seq, cfg.d_model),
                                      dtype=torch.float32, device=dev),
                "targets": zeros}
    return {"tokens": zeros, "targets": zeros.clone()}


__all__ = ["cache_spec", "check_remat_policy", "chunked_cross_entropy",
           "decode_step", "embed_inputs", "encoder_logits", "forward",
           "init_cache", "init_params", "input_specs", "lm_head_weight",
           "loss_fn", "mask_pad_logits", "params_spec", "prefill",
           "prefill_batched", "smoke_batch", "unstack_periods"]
