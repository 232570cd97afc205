"""The port's training substrate against the JAX reference's: AdamW
(``train/optimizer.py``), the data pipeline, the checkpoint manager, the
one-device train step, the loop and the ``launch.train`` CLI.

Counterparts of ``tests/test_train_substrate.py``'s optimizer, data and
checkpoint tests, then the same functions held to the reference's on the
same inputs (numpy seeds, bridged weights): ``apply_updates`` on random
trees, bf16 master weights included, within 2e-6 (float32 elementwise
arithmetic in another fusion); ``make_batch`` bit-equal; checkpoints
restored across the two packages bit-equal; one AdamW step of reduced
granite-8b and rwkv6-7b through ``build_train_step`` against the
reference's on a one-device mesh within 2e-4 (the model tolerance:
products summed in other orders); the loop's resume equal to an
uninterrupted run bit for bit (the reference's own resume test fails,
ROADMAP queue 3).
"""
import inspect
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
from repro.checkpoint.manager import \
    CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.data.pipeline import DataConfig as JaxDataConfig  # noqa: E402
from repro.data.pipeline import make_batch as jax_make_batch  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data import DataConfig, DataIterator, make_batch  # noqa
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.train import (AdamWConfig, LoopConfig, TrainLoop,  # noqa
                               apply_updates, build_train_step, global_norm,
                               init_state, schedule)
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _assert_trees_close(got, want, **tol):
    g = tree_flatten(got)[0]
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) > 0
    for i, (a, b) in enumerate(zip(g, w)):
        assert tuple(a.shape) == tuple(np.shape(b)), i
        np.testing.assert_allclose(_np(a), _np(b), err_msg=f"leaf {i}",
                                   **tol)


# ---------------------------------------------------------------- optimizer
def test_adamw_converges_on_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0, grad_clip=100.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_state(cfg, params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.2


def test_grad_clip_applied():
    cfg = AdamWConfig(grad_clip=1.0, warmup_steps=0)
    params = {"w": torch.zeros(4)}
    state = init_state(cfg, params)
    _, _, m = apply_updates(cfg, params, {"w": torch.full((4,), 100.0)},
                            state)
    assert float(m["grad_norm"]) == pytest.approx(200.0)


def test_nonfinite_step_skipped():
    cfg = AdamWConfig(warmup_steps=0)
    params = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = init_state(cfg, params)
    before = tree_map(torch.clone, {"p": params, "s": state})
    p2, s2, m = apply_updates(cfg, params,
                              {"w": torch.full((4,), float("nan"))}, state)
    assert int(m["skipped"]) == 1 and int(s2["count"]) == 0
    for a, b in zip(tree_flatten({"p": p2, "s": s2})[0],
                    tree_flatten(before)[0]):
        assert torch.equal(a, b)


def test_lr_schedule_warmup_and_decay():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    for step, lr in ((5, 0.5), (10, 1.0), (100, 0.1)):
        got = schedule(cfg, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(lr)
        assert float(got) == float(jopt.schedule(
            jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_ratio=0.1), jnp.int32(step)))


def test_master_weights_for_bf16():
    state = init_state(AdamWConfig(), {"w": torch.ones(4,
                                                       dtype=torch.bfloat16)})
    assert state["master"]["w"].dtype == torch.float32
    assert "master" not in init_state(AdamWConfig(), {"w": torch.ones(4)})
    assert state["count"].dtype == torch.int32 and state["count"].shape == ()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference_on_random_trees(dtype):
    """Five steps on a random tree (a clipped step, warm-up and decay in
    the schedule): new parameters, moments, masters, count and metrics
    against the reference's."""
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 2, 3)}}
    params_np = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=6, grad_clip=2.0)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params_np)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    js = jopt.init_state(jopt.AdamWConfig(**cfg), jp)
    ts = init_state(AdamWConfig(**cfg), tp)
    for step in range(5):
        grads_np = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * (3.0 if step == 1
                                                       else 0.3)
                       ).astype(np.float32), params_np)
        jp, js, jm_ = jopt.apply_updates(
            jopt.AdamWConfig(**cfg), jp,
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                   grads_np), js)
        tp, ts, tm_ = apply_updates(
            AdamWConfig(**cfg), tp, params_from_numpy(
                jax.tree_util.tree_map(
                    lambda a: np.asarray(jnp.asarray(a, dtype)), grads_np),
                "cpu"), ts)
        tol = dict(atol=2e-6, rtol=2e-6)
        _assert_trees_close(tp, jp, **tol)
        _assert_trees_close(ts, js, **tol)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm_[k]), float(jm_[k]), **tol)
        assert int(tm_["skipped"]) == int(jm_["skipped"]) == 0
    assert int(ts["count"]) == 5
    assert float(global_norm(tp)) == pytest.approx(
        float(jopt.global_norm(jp)), rel=1e-6)


# --------------------------------------------------------------------- data
def test_data_deterministic_and_resumable():
    dc = DataConfig(batch_size=4, seq_len=8, vocab_size=100, seed=7)
    np.testing.assert_array_equal(make_batch(dc, 5)["tokens"],
                                  make_batch(dc, 5)["tokens"])
    assert not np.array_equal(make_batch(dc, 6)["tokens"],
                              make_batch(dc, 5)["tokens"])


def test_data_targets_are_next_tokens():
    b = make_batch(DataConfig(batch_size=2, seq_len=16, vocab_size=100,
                              seed=1), 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_data_iterator_prefetch():
    dc = DataConfig(batch_size=2, seq_len=4, vocab_size=10, seed=0)
    it = DataIterator(dc, start_step=3)
    bs = [next(it) for _ in range(3)]
    it.close()
    assert not it._thread.is_alive() and it.state()["step"] == 6
    for i, b in enumerate(bs):
        np.testing.assert_array_equal(b["tokens"],
                                      make_batch(dc, 3 + i)["tokens"])


@pytest.mark.parametrize("embed_dim", [None, 8])
@pytest.mark.parametrize("step", [0, 17])
def test_make_batch_bit_equal_to_reference(embed_dim, step):
    kw = dict(batch_size=3, seq_len=12, vocab_size=1000, seed=5,
              embed_dim=embed_dim)
    got = make_batch(DataConfig(**kw), step)
    want = jax_make_batch(JaxDataConfig(**kw), step)
    assert sorted(got) == sorted(want)
    for k in got:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# --------------------------------------------------------------- checkpoint
def _tree():
    return {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.linspace(-2, 2, 4).to(torch.bfloat16),
                  "n": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def test_checkpoint_roundtrip_and_gc(tmp_path):
    ck = CheckpointManager(str(tmp_path), keep_last=2)
    tree = _tree()
    for step in (10, 20, 30):
        ck.save(step, tree, extra={"step": step})
    assert ck.all_steps() == [20, 30]
    target = _zeros_like(tree)
    restored, extra = ck.restore(target)
    assert extra["step"] == 30 and restored is target
    for a, b in zip(tree_flatten(restored)[0], tree_flatten(tree)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_async_then_wait(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    tree = {"w": torch.ones(8)}
    ck.save_async(5, tree)
    tree["w"].add_(1)             # the host copy was taken before
    ck.wait()
    assert ck.latest_step() == 5
    restored, _ = ck.restore({"w": torch.zeros(8)})
    assert torch.equal(restored["w"], torch.ones(8))


def test_checkpoint_rejects_wrong_tree(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"a": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        ck.restore({"a": torch.ones(3), "b": torch.ones(2)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore({"a": torch.ones(4)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({"a": None})


def test_checkpoint_crash_leaves_no_corruption(tmp_path):
    ck = CheckpointManager(str(tmp_path))
    ck.save(1, {"a": torch.ones(3)})
    os.makedirs(tmp_path / "step_00000002.tmp")
    assert ck.latest_step() == 1
    ck.save(3, {"a": torch.ones(3)})
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))


def _jax_tree():
    return {"a": jnp.arange(6.0).reshape(2, 3),
            "b": {"c": jnp.linspace(-2, 2, 4).astype(jnp.bfloat16),
                  "n": jnp.int32(7)}}


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    JaxCheckpointManager(str(tmp_path)).save(4, _jax_tree(),
                                             extra={"step": 4})
    restored, extra = CheckpointManager(str(tmp_path)).restore(
        _zeros_like(_tree()))
    assert extra == {"step": 4}
    for a, b in zip(tree_flatten(restored)[0], tree_flatten(_tree())[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    CheckpointManager(str(tmp_path)).save(4, _tree(), extra={"step": 4})
    want = _jax_tree()
    restored, extra = JaxCheckpointManager(str(tmp_path)).restore(
        jax.tree_util.tree_map(jnp.zeros_like, want))
    assert extra == {"step": 4}
    for a, b in zip(jax.tree_util.tree_leaves(restored),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -------------------------------------------------------------- train step
@pytest.fixture(scope="module", params=["granite-8b", "mixtral-8x7b",
                                              "rwkv6-7b"])
def model(request):
    name = request.param
    jc = jcfg.reduced(jcfg.get_config(name), layers=2)
    tc = tcfg.reduced(tcfg.get_config(name), layers=2)
    jp = jm.init_params(jc, jax.random.PRNGKey(3))
    rng = np.random.default_rng(4)
    batch = {"tokens": rng.integers(0, jc.vocab_size, (2, 16), np.int32),
             "targets": rng.integers(0, jc.vocab_size, (2, 16), np.int32)}
    return jc, tc, jax.tree_util.tree_map(np.asarray, jp), batch


def _reference_step(jc, jp_np, batch, ocfg, remat="full"):
    from jax.sharding import AxisType

    from repro.train.step import build_train_step as jax_build
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    built = jax_build(jc, mesh, jopt.AdamWConfig(**ocfg),
                      remat_policy=remat, donate=False)
    jp = jax.tree_util.tree_map(jnp.asarray, jp_np)
    return built.fn(jp, jopt.init_state(jopt.AdamWConfig(**ocfg), jp),
                    batch)


@pytest.mark.parametrize("remat", ["none", "full", "dots", "dots_no_batch"])
def test_build_train_step_matches_reference(model, remat):
    """One AdamW step: loss, metrics, new parameters and the optimizer
    state against the reference's ``build_train_step`` under the same
    remat policy."""
    jc, tc, jp_np, batch = model
    ocfg = dict(lr=1e-3, warmup_steps=0)
    jnew, jstate, jmet = _reference_step(jc, jp_np, batch, ocfg, remat)
    tp = params_from_numpy(jp_np, "cpu")
    ts = init_state(AdamWConfig(**ocfg), tp)
    step = build_train_step(tc, AdamWConfig(**ocfg), remat_policy=remat,
                            device="cpu")
    tnew, tstate, tmet = step(tp, ts, batch)
    assert tnew is tp and tstate is ts
    tol = dict(atol=2e-4, rtol=2e-4)
    for k in ("loss", "ce", "aux", "grad_norm", "lr", "skipped"):
        np.testing.assert_allclose(float(tmet[k]), float(jmet[k]), **tol,
                                   err_msg=k)
    _assert_trees_close(tnew, jnew, **tol)
    _assert_trees_close(tstate, jstate, **tol)


def test_unknown_remat_policy_raises():
    """An unknown policy raises and names the policies there are; the
    default is the reference's, "dots"."""
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    with pytest.raises(ValueError, match="'dots', 'dots_no_batch'"):
        build_train_step(cfg, remat_policy="bogus", device="cpu")
    assert inspect.signature(build_train_step).parameters[
        "remat_policy"].default == "dots"


# -------------------------------------------------------------------- loop
def _loop(cfg, ckpt_dir, steps, every=2, resume="auto", init_seed=0):
    """A loop of ``steps`` steps of a 4-step schedule."""
    from repro_torch.models import init_params
    ocfg = AdamWConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    params = init_params(cfg, torch.Generator().manual_seed(init_seed),
                         "cpu")
    return TrainLoop(
        step_fn=build_train_step(cfg, ocfg, device="cpu"), params=params,
        opt_state=init_state(ocfg, params),
        data=DataIterator(DataConfig(batch_size=2, seq_len=16,
                                     vocab_size=cfg.vocab_size, seed=0)),
        ckpt=None if ckpt_dir is None else CheckpointManager(str(ckpt_dir)),
        cfg=LoopConfig(total_steps=steps, checkpoint_every=every,
                       resume=resume))


def test_loop_resume_equals_uninterrupted_run(tmp_path):
    """4 steps straight against 2 steps, then a fresh loop that resumes
    from the step-2 checkpoint for 2 more: parameters, optimizer state
    and the last losses bit-equal."""
    cfg = tcfg.reduced(tcfg.get_config("rwkv6-7b"), layers=2)
    full = _loop(cfg, None, 4)
    st = full.run()
    assert st.step == 4 and len(st.history) == 4 and st.skipped == 0
    first = _loop(cfg, tmp_path, 2)
    first.run()
    assert CheckpointManager(str(tmp_path)).all_steps() == [2]
    resumed = _loop(cfg, tmp_path, 4, init_seed=1)  # other weights at init
    assert resumed.maybe_resume() == 2
    st2 = resumed.run()
    assert st2.step == 4 and [h["step"] for h in st2.history] == [3, 4]
    assert [h["loss"] for h in st2.history] == \
        [h["loss"] for h in st.history[2:]]
    for a, b in zip(tree_flatten({"p": resumed.params,
                                  "o": resumed.opt_state})[0],
                    tree_flatten({"p": full.params,
                                  "o": full.opt_state})[0]):
        assert torch.equal(a, b)
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 4]


def test_loop_sigterm_ends_with_a_final_checkpoint(tmp_path):
    """SIGTERM during a step: the loop finishes that step, writes a
    synchronous checkpoint of it and stops, preempted."""
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    loop = _loop(cfg, tmp_path, 10, every=5)
    inner = loop.step_fn

    def step_fn(params, opt, batch):
        if loop.state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return inner(params, opt, batch)
    loop.step_fn = step_fn
    previous = signal.getsignal(signal.SIGTERM)
    st = loop.run()
    assert st.preempted and st.step == 3
    assert CheckpointManager(str(tmp_path)).all_steps() == [3]
    assert signal.getsignal(signal.SIGTERM) is previous


def test_launch_train_runs_and_resumes_in_process(tmp_path):
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"), layers=2)
    loop = train(cfg, steps=3, batch=2, seq=16, ckpt_dir=str(tmp_path),
                 ckpt_every=2, device="cpu", log_every=1)
    assert loop.state.step == 3 and not loop.state.preempted
    again = train(cfg, steps=5, batch=2, seq=16, ckpt_dir=str(tmp_path),
                  ckpt_every=2, device="cpu")
    assert [h["step"] for h in again.state.history] == [4, 5]
    assert CheckpointManager(str(tmp_path)).all_steps() == [2, 3, 4, 5][-3:]


def test_launch_train_mixtral_loss_carries_the_aux_loss():
    """``launch.train``'s body on reduced mixtral (AdamW): the first
    step's loss is ce + router_aux_weight x the routers' load-balancing
    loss of the same weights and batch."""
    from repro_torch.models import init_params, loss_fn
    cfg = tcfg.reduced(tcfg.get_config("mixtral-8x7b"), layers=2)
    loop = train(cfg, steps=2, batch=2, seq=16, device="cpu", log_every=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = make_batch(DataConfig(batch_size=2, seq_len=16,
                                  vocab_size=cfg.vocab_size, seed=0), 0)
    loss, parts = loss_fn(cfg, params,
                          {k: torch.as_tensor(v) for k, v in batch.items()},
                          remat_policy="full")
    assert float(parts["aux"]) > 0
    want = float(parts["ce"] + cfg.moe.router_aux_weight * parts["aux"])
    assert float(loss) == pytest.approx(want, rel=1e-6)
    assert loop.state.history[0]["loss"] == pytest.approx(want, rel=1e-6)
    assert loop.state.step == 2


def _cli(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_launch_train_cli_then_resume(tmp_path):
    """``python -m repro_torch.launch.train --reduced --device cpu``
    writes checkpoints and a second run resumes from the newest;
    ``--model-parallel 2`` in one process is refused: the ranks do not
    divide into model groups of 2 (RWKV blocks themselves train tensor
    parallel, ``tests/test_torch_tensor_parallel.py``)."""
    ck = str(tmp_path / "ckpt")
    base = ("repro_torch.launch.train", "--arch", "rwkv6-7b", "--reduced",
            "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-dir", ck, "--ckpt-every", "2")
    res = _cli(*base, "--steps", "3", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "done at step 3" in res.stdout
    res = _cli(*base, "--steps", "4", "--resume", "auto", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "resumed from step 3" in res.stdout and "done at step 4" in \
        res.stdout
    assert CheckpointManager(ck).all_steps() == [2, 3, 4]
    res = _cli(*base, "--steps", "1", "--model-parallel", "2", cwd=tmp_path)
    assert res.returncode != 0 and "--model-parallel 2 does not divide " \
        "1 ranks" in res.stderr


def test_launch_train_cli_hubert_trains_on_frames(tmp_path):
    """``python -m repro_torch.launch.train --arch hubert-xlarge --reduced
    --device cpu`` runs 2 steps: the data pipeline hands the stubbed
    frontend frame embeddings, and the token embedding they leave unused
    takes a zero gradient, as ``jax.grad`` gives it."""
    res = _cli("repro_torch.launch.train", "--arch", "hubert-xlarge",
               "--reduced", "--device", "cpu", "--steps", "2", "--batch",
               "2", "--seq", "16", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert "done at step 2" in res.stdout


def test_launch_serve_restores_checkpoint_params(tmp_path):
    """``launch.serve --ckpt-dir`` serves the checkpoint's parameters,
    not the seed's."""
    from repro_torch.launch.serve import main as serve_main
    cfg = tcfg.reduced(tcfg.get_config("granite-8b"))
    loop = train(cfg, steps=2, batch=2, seq=16, ckpt_dir=str(tmp_path),
                 device="cpu")
    eng = serve_main(["--arch", "granite-8b", "--reduced", "--device", "cpu",
                      "--ckpt-dir", str(tmp_path), "--requests", "2",
                      "--max-new", "4"])
    for a, b in zip(tree_flatten(eng.params)[0],
                    tree_flatten(loop.params)[0]):
        assert torch.equal(a, b)
