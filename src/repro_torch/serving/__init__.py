"""Placement-aware serving: continuous batching over a paged KV cache.

Local::

    from repro_torch.serving import ServingEngine, Request
    eng = ServingEngine(cfg, params, block_size=16, num_blocks=64,
                        max_batch=8, max_len=128)        # on cuda
    eng.submit(Request(rid=0, prompt=prompt_ids, max_new_tokens=32))
    done = eng.run_until_drained()

Plan-backed::

    from repro_torch.serving import partition_for_serving
    plan = partition_for_serving(cfg, params, devices=4, memory=40e9,
                                 block_size=16, num_blocks=64,
                                 max_batch=8, max_len=128)
    eng = plan.serve(cfg, params, device_map=[0] * 4)   # PEs on one card
"""
from .kvcache import (NULL_BLOCK, BlockAllocator, OutOfBlocks,
                      gather_pages, init_pools, place_pools,
                      resolve_pool_devices, scatter_token,
                      supported_reason, write_prompt)
from .scheduler import Admission, RequestState, Scheduler, ServingRequest
from .engine import (Request, ServingEngine, ServingStats,
                     partition_for_serving, serving_geometry)
from .loadgen import Workload, poisson_workload, run_workload, summarize

__all__ = [
    "NULL_BLOCK", "BlockAllocator", "OutOfBlocks", "supported_reason",
    "init_pools", "gather_pages", "scatter_token", "write_prompt",
    "resolve_pool_devices", "place_pools",
    "RequestState", "ServingRequest", "Admission", "Scheduler",
    "Request", "ServingEngine", "ServingStats",
    "partition_for_serving", "serving_geometry",
    "Workload", "poisson_workload", "run_workload", "summarize",
]
