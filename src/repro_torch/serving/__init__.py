"""Serving: continuous batching over a paged KV cache.

    from repro_torch.serving import ServingEngine, Request
    eng = ServingEngine(cfg, params, block_size=16, num_blocks=64,
                        max_batch=8, max_len=128)        # on cuda
    eng.submit(Request(rid=0, prompt=prompt_ids, max_new_tokens=32))
    done = eng.run_until_drained()
"""
from .kvcache import (NULL_BLOCK, BlockAllocator, OutOfBlocks,
                      gather_pages, init_pools, scatter_token,
                      supported_reason, write_prompt)
from .scheduler import Admission, RequestState, Scheduler, ServingRequest
from .engine import Request, ServingEngine, ServingStats

__all__ = [
    "NULL_BLOCK", "BlockAllocator", "OutOfBlocks", "supported_reason",
    "init_pools", "gather_pages", "scatter_token", "write_prompt",
    "RequestState", "ServingRequest", "Admission", "Scheduler",
    "Request", "ServingEngine", "ServingStats",
]
