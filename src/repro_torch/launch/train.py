"""Training launcher (port of ``repro.launch.train``), one device:

    python -m repro_torch.launch.train --arch granite-8b --steps 1000 \\
        --batch 8 --seq 2048 --ckpt-dir /path/to/ckpts --resume auto
    python -m repro_torch.launch.train --arch rwkv6-7b --reduced \\
        --device cpu --steps 3 --ckpt-dir /tmp/ckpt

AdamW with float32 master weights, global-norm clipping and non-finite
step skipping (``train/optimizer.py``); async atomic checkpoints every
``--ckpt-every`` steps and a synchronous final one, ``--resume auto``,
SIGTERM-safe, a straggler watchdog (``train/loop.py``). The flags are the
reference's, plus ``--device`` (default ``cuda``). The reference's mesh
flags take only 1: a step over a mesh of several devices waits for
``pipeline_apply``, ``train/compression.py`` and the process group
(ROADMAP M4.1b; the mesh shapes and sharding rules are ported).
Parameters are drawn from ``--seed`` with the port's generator, not the
reference's ``jax.random`` stream.
"""
import argparse


def train(cfg, *, steps: int = 1000, batch: int = 8, seq: int = 512,
          lr: float = 3e-4, remat: str = "full", ckpt_dir=None,
          ckpt_every: int = 200, resume: str = "auto", seed: int = 0,
          device="cuda", log_every: int = 10):
    """Train ``cfg`` (any :class:`~repro_torch.configs.base.ModelConfig`,
    a depth-cut one included) for ``steps`` steps; the body of the CLI.
    Returns the :class:`~repro_torch.train.TrainLoop` after its run (its
    ``params``, ``opt_state`` and ``state``)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, LoopConfig, TrainLoop,
                                   build_train_step, init_state)

    dev = resolve_device(device)
    print(f"[launch] {cfg.name}: {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f}B params on {dev}")
    ocfg = AdamWConfig(lr=lr, total_steps=steps)
    step_fn = build_train_step(cfg, ocfg, remat_policy=remat, device=dev)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    opt = init_state(ocfg, params)
    dc = DataConfig(batch_size=batch, seq_len=seq,
                    vocab_size=cfg.vocab_size, seed=seed,
                    embed_dim=cfg.d_model if cfg.frontend else None)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    loop = TrainLoop(step_fn=step_fn, params=params, opt_state=opt,
                     data=DataIterator(dc), ckpt=ckpt,
                     cfg=LoopConfig(total_steps=steps,
                                    checkpoint_every=ckpt_every,
                                    log_every=log_every, resume=resume))
    resumed = loop.maybe_resume()
    if resumed:
        print(f"[launch] resumed from step {resumed}")
    st = loop.run()
    print(f"[launch] done at step {st.step}; preempted={st.preempted}; "
          f"stragglers={st.stragglers}; skipped={st.skipped}")
    return loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", default="full")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=200)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-size variant of the arch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.model_parallel != 1 or args.pods != 1:
        raise NotImplementedError(
            f"--model-parallel {args.model_parallel} --pods {args.pods}: "
            f"the port trains on one device; a step over a mesh waits "
            f"for pipeline_apply, train/compression.py and the process "
            f"group (ROADMAP M4.1b)")

    from repro_torch.configs import get_config, reduced
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, remat=args.remat, ckpt_dir=args.ckpt_dir,
                 ckpt_every=args.ckpt_every, resume=args.resume,
                 seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
