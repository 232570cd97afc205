"""Training launcher (port of ``repro.launch.train``):

    python -m repro_torch.launch.train --arch granite-8b --steps 1000 \\
        --batch 8 --seq 2048 --ckpt-dir /path/to/ckpts --resume auto
    python -m repro_torch.launch.train --arch rwkv6-7b --reduced \\
        --device cpu --steps 3 --ckpt-dir /tmp/ckpt
    python -m repro_torch.distributed --nproc 4 -m repro_torch.launch.train \\
        --arch granite-8b --reduced --pods 2 --device cpu --steps 3
    python -m repro_torch.distributed --nproc 4 -m repro_torch.launch.train \\
        --arch mixtral-8x7b --reduced --model-parallel 2 --device cpu \\
        --steps 3

AdamW with float32 master weights, global-norm clipping and non-finite
step skipping (``train/optimizer.py``); async atomic checkpoints every
``--ckpt-every`` steps and a synchronous final one (unless the last
periodic one holds the final step), ``--resume auto``,
SIGTERM-safe, a straggler watchdog (``train/loop.py``). The flags are the
reference's, plus ``--device`` (default ``cuda``). Started as N ranks
(``python -m repro_torch.distributed --nproc N``, or ``torchrun``), it
trains over the mesh (pod, data, model) of the reference's
``make_host_mesh(model=--model-parallel, pod=--pods)`` with data = N /
(pods x model): each rank holds its blocks of the parameters
(``train.step.shard_params``), draws its slice of every batch over pod x
data (the ranks of one model group the same rows; ``data/pipeline.py``),
the step is the ZeRO-1 one, tensor parallel over ``model``
(``train/step.py``), and rank 0 writes the checkpoints. A config with
MLA, RWKV or Mamba blocks refuses ``--model-parallel`` above 1, naming
the ROADMAP item. Parameters are drawn from ``--seed`` with the port's
generator, not the reference's ``jax.random`` stream.
"""
import argparse
import os


def train(cfg, *, steps: int = 1000, batch: int = 8, seq: int = 512,
          lr: float = 3e-4, remat: str = "full", ckpt_dir=None,
          ckpt_every: int = 200, resume: str = "auto", seed: int = 0,
          device="cuda", log_every: int = 10, mesh=None):
    """Train ``cfg`` (any :class:`~repro_torch.configs.base.ModelConfig`,
    a depth-cut one included) for ``steps`` steps; the body of the CLI.
    With ``mesh`` (a :class:`~repro_torch.distributed.ProcessMesh`) every
    rank calls it, and ``batch`` is the global batch. Returns the
    :class:`~repro_torch.train.TrainLoop` after its run (its ``params``,
    ``opt_state`` and ``state``; under a mesh the optimizer state holds
    this rank's blocks)."""
    import torch

    from repro_torch import resolve_device
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, DataIterator
    from repro_torch.models import init_params, params_spec
    from repro_torch.train import (AdamWConfig, LoopConfig, TrainLoop,
                                   build_train_step, init_state)
    from repro_torch.train.step import (init_zero1_state, rules_total_dp,
                                        shard_params, train_state_shardings)

    dev = resolve_device(device)
    where = "" if mesh is None else \
        f", rank {mesh.rank} of mesh {mesh.shape}"
    print(f"[launch] {cfg.name}: {cfg.num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f}B params on {dev}{where}")
    if mesh is not None and batch % rules_total_dp(mesh):
        raise ValueError(f"--batch {batch} does not split over the "
                         f"{rules_total_dp(mesh)} data-parallel ranks")
    ocfg = AdamWConfig(lr=lr, total_steps=steps)
    step_fn = build_train_step(cfg, ocfg, remat_policy=remat, device=dev,
                               mesh=mesh)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                         dev)
    model = 1 if mesh is None else mesh.shape.get("model", 1)
    if mesh is None:
        opt = init_state(ocfg, params)
    else:
        opt = init_zero1_state(ocfg, params, mesh)
        params = shard_params(params, mesh)
    dc = DataConfig(batch_size=batch, seq_len=seq,
                    vocab_size=cfg.vocab_size, seed=seed,
                    embed_dim=cfg.d_model if cfg.frontend else None,
                    model_parallel=model)
    ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
    loop = TrainLoop(step_fn=step_fn, params=params, opt_state=opt,
                     data=DataIterator(dc), ckpt=ckpt,
                     cfg=LoopConfig(total_steps=steps,
                                    checkpoint_every=ckpt_every,
                                    log_every=log_every, resume=resume),
                     shardings=None if mesh is None else
                     train_state_shardings(params, opt, mesh,
                                           params_spec(cfg)))
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
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import check_tensor_parallel
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.model_parallel > 1:
        check_tensor_parallel(cfg)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world % (args.pods * args.model_parallel):
        raise ValueError(f"--pods {args.pods} x --model-parallel "
                         f"{args.model_parallel} does not divide {world} "
                         f"ranks: start them with `python -m "
                         f"repro_torch.distributed --nproc N` or torchrun")
    run = dict(steps=args.steps, batch=args.batch, seq=args.seq,
               lr=args.lr, remat=args.remat, ckpt_dir=args.ckpt_dir,
               ckpt_every=args.ckpt_every, resume=args.resume,
               seed=args.seed, device=args.device)
    if world == 1:
        return train(cfg, **run)
    from repro_torch.distributed import ProcessMesh, process_group
    from repro_torch.launch.mesh import mesh_over
    with process_group(args.device):
        mesh = ProcessMesh(mesh_over(world, model=args.model_parallel,
                                     pod=args.pods), args.device)
        return train(cfg, mesh=mesh, **run)


if __name__ == "__main__":
    main()
