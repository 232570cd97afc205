"""Serving launcher: initializes a model from a seed and serves seeded
requests through the paged continuous-batching engine.

    python -m repro_torch.launch.serve --arch granite-8b \
        --requests 8 --max-batch 4 --max-new 16          # on cuda
    python -m repro_torch.launch.serve --arch granite-8b --reduced \
        --device cpu

With ``--plan-devices K`` the decode step is partitioned first
(:func:`repro_torch.serving.partition_for_serving`) and served through
the plan (``plan.serve``); ``--fold`` aliases the K PEs onto the
available devices (every visible card, or the CPU with ``--device
cpu``). ``--ckpt-dir DIR`` serves the parameters of the newest
checkpoint there (one written by ``launch.train`` of the same config, or
by the reference's), restored against an AdamW template as the
reference restores them. ``--trace PATH`` writes the engine's Perfetto
trace, ``--metrics PATH`` the final serving stats as a
``repro-metrics`` envelope.
"""
import argparse

import numpy as np
import torch


def main(argv=None, cfg=None):
    """The CLI. ``cfg``: a :class:`~repro_torch.configs.base.ModelConfig`
    to serve in place of ``--arch``'s (a depth-cut one: ``chip_smoke.py``
    serves what ``launch.train`` trained at the depth the card holds).
    Returns the drained engine."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=128)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--plan-devices", type=int, default=0,
                    help="partition the decode step for K devices and "
                         "serve through the plan (0 = local, eager)")
    ap.add_argument("--fold", action="store_true",
                    help="alias plan PEs onto the available devices")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Perfetto trace of the serving run "
                         "(request lanes + engine lane + pool counters)")
    ap.add_argument("--metrics", default=None, metavar="PATH",
                    help="write the final ServingStats as a versioned "
                         "repro-metrics envelope JSON")
    args = ap.parse_args(argv)

    from repro_torch import api, resolve_device
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    from repro_torch.serving import (Request, ServingEngine,
                                     partition_for_serving)

    dev = resolve_device(args.device)
    if cfg is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = reduced(cfg)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, gen, dev)
    if args.ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.train import AdamWConfig, init_state
        ck = CheckpointManager(args.ckpt_dir)
        opt_template = init_state(AdamWConfig(), params)
        restored, _ = ck.restore({"params": params, "opt": opt_template})
        params = restored["params"]
        del opt_template
        print(f"[serve] restored step {ck.latest_step()} from "
              f"{args.ckpt_dir}")
    geo = dict(block_size=args.block_size, num_blocks=args.num_blocks,
               max_batch=args.max_batch, max_len=args.max_len)
    if args.plan_devices:
        plan = partition_for_serving(cfg, params, devices=args.plan_devices,
                                     device=dev, **geo)
        # PEs run on the cards, or on the CPU when it serves
        devices = ["cpu"] if dev.type == "cpu" else None
        device_map = api.fold_device_map(plan.k, devices) if args.fold \
            else None
        eng = plan.serve(cfg, params, devices=devices,
                         device_map=device_map, trace=args.trace,
                         device=dev)
        print(f"[serve] {plan.summary()}")
    else:
        eng = ServingEngine(cfg, params, trace=args.trace, device=dev,
                            **geo)
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
    if args.trace:
        print(f"[serve] wrote trace {args.trace}")
    if args.metrics:
        from repro_torch.obs.metrics import MetricsRegistry
        reg = MetricsRegistry("launch_serve",
                              meta={"arch": args.arch,
                                    "reduced": bool(args.reduced),
                                    "plan_devices": args.plan_devices,
                                    "device": str(dev)})
        reg.update(s.to_dict())
        reg.save(args.metrics)
        print(f"[serve] wrote metrics {args.metrics}")
    return eng


if __name__ == "__main__":
    main()
