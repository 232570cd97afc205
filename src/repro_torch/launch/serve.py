"""Serving launcher: initializes a model from a seed and serves seeded
requests through the paged continuous-batching engine.

    python -m repro_torch.launch.serve --arch granite-8b \
        --requests 8 --max-batch 4 --max-new 16          # on cuda
    python -m repro_torch.launch.serve --arch granite-8b --reduced \
        --device cpu
"""
import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.serving import Request, ServingEngine

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    eng = ServingEngine(cfg, params, block_size=args.block_size,
                        num_blocks=args.num_blocks,
                        max_batch=args.max_batch, max_len=args.max_len,
                        device=dev)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        plen = int(rng.integers(3, 12))
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(1, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=args.max_new))
    done = eng.run_until_drained(max_ticks=10000)
    s = eng.stats
    toks = sum(len(r.output) for r in done.values())
    print(f"[serve] {len(done)} requests, {toks} tokens, {s.ticks} ticks, "
          f"{s.prefill_calls} prefill calls, {s.preempted} preemptions, "
          f"peak {s.peak_blocks_in_use}/{eng.allocator.capacity} blocks "
          f"on {dev}")


if __name__ == "__main__":
    main()
