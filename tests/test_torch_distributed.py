"""The port's collective parts against the reference's, over gloo ranks on
the CPU: ``pipeline_apply`` (forward and gradient), ``param_shardings``,
the ZeRO-1 data-parallel train step, the elastic checkpoint restore and
the data pipeline's host slice.

The reference runs once, in a child process on 4 forced host devices
(``repro.conformance.subproc.run_py(code, devices=4)``), on meshes of
Auto axes: under JAX 0.9 ``jax.make_mesh`` gives Explicit axes, on which
the reference's own ``test_multidevice.py`` tests fail (ROADMAP F8). The
port runs in two launches of ranks (``repro_torch.conformance.subproc.
run_ranks``, each with a ``file://`` store of its own): 4 ranks, then 2,
which restores what the 4 saved. The ranks write their results to files
that the tests below compare. Inputs come from numpy seeds; weights are
the reference's, carried across as numpy.

Tolerances: ``pipeline_apply`` 1e-5 (the reference's own test's); the
ZeRO-1 step's loss 1e-5 against the reference's, its parameters after
one and two steps 2e-4 against the port's one-rank step (the model
tolerance: the mean gradient is summed in another order); shard shapes,
round trips, the restore and the host slices exact.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import repro.configs as jcfg  # noqa: E402
import repro.models as jm  # noqa: E402
from repro.conformance.subproc import run_py as jax_run_py  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy, params_to_numpy  # noqa
from repro_torch.conformance.subproc import (SubprocessError,  # noqa: E402
                                             run_ranks)
from repro_torch.distributed import ProcessMesh  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.train import (AdamWConfig, build_train_step,  # noqa
                               init_state)
from repro_torch.train.step import init_zero1_state  # noqa: E402
from repro_torch.tree import tree_flatten  # noqa: E402

#: (pipeline_apply's case, as tests/test_multidevice.py has it)
L, D, M, MB = 8, 8, 4, 2
#: the ZeRO-1 step: reduced granite-8b at 2 layers, a global batch
B, S = 4, 32
OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
#: meshes of the step, by launch size; (1, 1) runs in this process
STEP_MESHES = {4: [((4, 1), ("data", "model")),
                   ((2, 2, 1), ("pod", "data", "model"))],
               2: [((2, 1), ("data", "model"))]}
#: the meshes whose placements are compared, by launch size
PLACE_MESHES = {4: [((2, 2, 1), ("pod", "data", "model")),
                    ((4, 1), ("data", "model")),
                    ((1, 4), ("data", "model")),
                    ((2, 2), ("data", "model"))],
                2: [((2, 1), ("data", "model")),
                    ((1, 2), ("data", "model"))]}
#: the host-slice case
HOST = dict(batch_size=8, seq_len=16, vocab_size=512, seed=3)
HOST_STEP = 5


def _key(shape) -> str:
    return "x".join(map(str, shape))


REFERENCE = """
import json, os, warnings
warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding
from repro.configs import get_config, reduced
from repro.pipeline.pardnn_pp import (pipeline_apply, plan_stages,
                                      stack_stage_params)
from repro.sharding import rules
from repro.train.optimizer import AdamWConfig, init_state
from repro.train.step import build_train_step

d = os.environ["TEST_DIR"]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
out, shapes = {}, {}

def mesh(shape, names):
    n = int(np.prod(shape))
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])

# pipeline_apply: tests/test_multidevice.py's case
m = mesh((4,), ("stage",))
W, x = jnp.asarray(inp["W"]), jnp.asarray(inp["x"])
plan = plan_stages(np.ones(8), np.ones(8), 0.0, 4)
def loss(Wf):
    sp, mask = stack_stage_params(Wf, plan.boundaries)
    return jnp.sum(pipeline_apply(m, lambda w, h: jnp.tanh(h @ w), sp, mask,
                                  x) ** 2)
sp, mask = stack_stage_params(W, plan.boundaries)
out["pp_out"] = np.asarray(pipeline_apply(m, lambda w, h: jnp.tanh(h @ w),
                                          sp, mask, x))
out["pp_loss"] = np.asarray(loss(W))
out["pp_grad"] = np.asarray(jax.grad(loss)(W))

# placements: param_shardings and the ZeRO-1 state's, shard shapes
cfg = reduced(get_config("granite-8b"), layers=2)
params = jax.tree_util.tree_map(jnp.asarray, dict(np.load(
    os.path.join(d, "params.npz"), allow_pickle=True))["tree"].item())
for shape, names in json.loads(os.environ["PLACE_MESHES"]):
    mm = mesh(tuple(shape), tuple(names))
    ps = rules.param_specs(params, mm)
    z = jax.tree_util.tree_map(
        lambda s: NamedSharding(mm, s), rules.zero1_specs(ps, params, mm),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    key = "x".join(map(str, shape)) + "/" + ",".join(names)
    shapes[key] = {
        "params": [list(s.shard_shape(p.shape)) for s, p in zip(
            jax.tree_util.tree_leaves(rules.param_shardings(params, mm)),
            jax.tree_util.tree_leaves(params))],
        "zero1": [list(s.shard_shape(p.shape)) for s, p in zip(
            jax.tree_util.tree_leaves(z), jax.tree_util.tree_leaves(params))]}

# the data-parallel step: two AdamW steps on one global batch
ocfg = AdamWConfig(**json.loads(os.environ["OPT"]))
batch = {"tokens": jnp.asarray(inp["tokens"]),
         "targets": jnp.asarray(inp["targets"])}
for shape, names in json.loads(os.environ["STEP_MESHES"]):
    mm = mesh(tuple(shape), tuple(names))
    built = build_train_step(cfg, mm, ocfg, remat_policy="full",
                             donate=False)
    p, o = params, init_state(ocfg, params)
    key = "x".join(map(str, shape))
    for k in (1, 2):
        p, o, met = built.fn(p, o, batch)
        out[f"step_loss_{key}_{k}"] = np.asarray(met["loss"])

# the host slice, as process_index / process_count give it
import repro.data.pipeline as dp
for pc in (4, 2):
    for pi in range(pc):
        dp.jax.process_count = lambda pc=pc: pc
        dp.jax.process_index = lambda pi=pi: pi
        b = dp.make_batch(dp.DataConfig(**json.loads(os.environ["HOST"])),
                          int(os.environ["HOST_STEP"]))
        for k, v in b.items():
            out[f"host_{pc}_{pi}_{k}"] = v
np.savez(os.path.join(d, "reference.npz"), **out)
with open(os.path.join(d, "reference_shapes.json"), "w") as f:
    json.dump(shapes, f)
print("OK")
"""

RANKS = """
import json, os
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.data import DataConfig, make_batch
from repro_torch.distributed import (NamedSharding, ProcessMesh,
                                     process_group, world_size)
from repro_torch.launch.mesh import MeshShape
from repro_torch.pipeline.pardnn_pp import (pipeline_apply, plan_stages,
                                            stack_stage_params)
from repro_torch.sharding import rules
from repro_torch.train import AdamWConfig, build_train_step
from repro_torch.train.step import (init_zero1_state, train_state_shardings,
                                    zero1_shardings)
from repro_torch.tree import tree_flatten

d = os.environ["TEST_DIR"]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
host_params = dict(np.load(os.path.join(d, "params.npz"),
                           allow_pickle=True))["tree"].item()
cfg = reduced(get_config("granite-8b"), layers=2)
ocfg = AdamWConfig(**json.loads(os.environ["OPT"]))
out, shapes = {}, {}

def flat(tree):
    # copies: the step updates the parameters in place
    return [t.detach().numpy().copy() for t in tree_flatten(tree)[0]]

with process_group("cpu") as backend:
    n, r = world_size(), torch.distributed.get_rank()
    out["backend"] = np.array(backend)
    if n == 4:
        m = ProcessMesh(MeshShape((4,), ("stage",)), "cpu")
        W = torch.tensor(inp["W"], requires_grad=True)
        plan = plan_stages(np.ones(8), np.ones(8), 0.0, 4)
        sp, mask = stack_stage_params(W, plan.boundaries)
        y = pipeline_apply(m, lambda w, h: torch.tanh(h @ w), sp[r],
                           mask[r], torch.tensor(inp["x"]))
        loss = (y ** 2).sum()
        loss.backward()
        out.update(pp_out=y.detach().numpy(), pp_loss=loss.detach().numpy(),
                   pp_grad=m.psum(W.grad, "stage").numpy(),
                   pp_rows=np.flatnonzero(W.grad.abs().sum((1, 2)).numpy()))

    # placements and their round trips
    params = params_from_numpy(host_params, "cpu")
    for shape, names in json.loads(os.environ["PLACE_MESHES"]):
        m = ProcessMesh(MeshShape(tuple(shape), tuple(names)), "cpu")
        key = "x".join(map(str, shape)) + "/" + ",".join(names)
        ps = tree_flatten(rules.param_shardings(params, m))[0]
        z = tree_flatten(zero1_shardings(params, m))[0]
        leaves = tree_flatten(params)[0]
        shapes[key] = {
            "params": [list(s.shard_shape(p.shape))
                       for s, p in zip(ps, leaves)],
            "zero1": [list(s.shard_shape(p.shape)) for s, p in zip(z, leaves)],
            "blocks": [list(s.shard(p).shape) for s, p in zip(z, leaves)],
            "round_trip": all(torch.equal(s.gather(s.shard(p).clone()), p)
                              for s, p in zip(ps + z, leaves + leaves))}

    # the host-staged path (gloo on a shared card) forced on the CPU:
    # the same results, also from reused buffers
    if n == 4:
        m = ProcessMesh(MeshShape((2, 2), ("pod", "data")), "cpu")
        x = torch.arange(24.0).reshape(4, 6) * (r + 1)

        def calls():
            return [m.psum(x, ("pod", "data")), m.all_gather(x, "data", 1),
                    m.ppermute(x, "pod", [(0, 1)]),
                    m.all_reduce_start(x, "pod").wait(lambda t: t[1:3]),
                    m.pmax(x, "data"), m.reduce_scatter(x, "data", 1)]
        plain = calls()
        m.staged = True
        again = [calls(), calls()]
        out["staged_equal"] = np.array(all(
            torch.equal(a, b) for c in again for a, b in zip(c, plain)))
        out["staged_pool"] = np.array(sum(len(v) for v in m._free.values()))

    # the ZeRO-1 step, two steps on one global batch, each rank its slice
    for shape, names in json.loads(os.environ["STEP_MESHES"]):
        m = ProcessMesh(MeshShape(tuple(shape), tuple(names)), "cpu")
        key = "x".join(map(str, shape))
        p = params_from_numpy(host_params, "cpu")
        o = init_zero1_state(ocfg, p, m)
        step = build_train_step(cfg, ocfg, remat_policy="full", device="cpu",
                                mesh=m)
        per = inp["tokens"].shape[0] // n
        local = {k: inp[k][r * per:(r + 1) * per]
                 for k in ("tokens", "targets")}
        for k in (1, 2):
            m.reset_moved()
            p, o, met = step(p, o, local)
            out[f"step_loss_{key}_{k}"] = met["loss"].numpy()
            out[f"step_gnorm_{key}_{k}"] = met["grad_norm"].numpy()
            for i, a in enumerate(flat(p)):
                out[f"step_params_{key}_{k}_{i}"] = a
        out[f"step_moved_{key}"] = np.array(json.dumps(dict(m.moved)))
        sh = train_state_shardings(p, o, m)
        whole = [s.gather(t) for s, t in zip(tree_flatten(sh)[0],
                                             tree_flatten({"params": p,
                                                           "opt": o})[0])]
        out[f"state_sum_{key}"] = np.array([float(t.double().sum())
                                            for t in whole])
        if n == 4 and len(shape) == 3:
            CheckpointManager(os.path.join(d, "ck_zero")).save(
                2, {"params": p, "opt": o}, shardings=sh)

    # the elastic checkpoint: x (4, 4) over "model", saved on 4 ranks and
    # restored onto 2; and the ZeRO-1 state of the (2, 2, 1) step
    m = ProcessMesh(MeshShape((n,), ("model",)), "cpu")
    sh = {"x": NamedSharding(m, ("model", None))}
    ck = CheckpointManager(os.path.join(d, "ck"))
    full = torch.arange(16.0).reshape(4, 4)
    if n == 4:
        ck.save(1, {"x": sh["x"].shard(full).clone()}, shardings=sh)
        out["ck_steps"] = np.array(ck.all_steps())
    else:
        x = torch.zeros(sh["x"].shard_shape((4, 4)))
        ck.restore({"x": x}, shardings=sh)
        out["ck_local"] = x.numpy()
        out["ck_whole"] = sh["x"].gather(x).numpy()
        m = ProcessMesh(MeshShape((2, 1), ("data", "model")), "cpu")
        p = params_from_numpy(host_params, "cpu")
        o = init_zero1_state(ocfg, p, m)
        sh = train_state_shardings(p, o, m)
        _, extra = CheckpointManager(os.path.join(d, "ck_zero")).restore(
            {"params": p, "opt": o}, shardings=sh)
        whole = [s.gather(t) for s, t in zip(tree_flatten(sh)[0],
                                             tree_flatten({"params": p,
                                                           "opt": o})[0])]
        out["restored_sum"] = np.array([float(t.double().sum())
                                        for t in whole])

    # the host slice
    b = make_batch(DataConfig(**json.loads(os.environ["HOST"])),
                   int(os.environ["HOST_STEP"]))
    for k, v in b.items():
        out[f"host_{k}"] = v

np.savez(os.path.join(d, f"ranks{n}_{r}.npz"), **out)
with open(os.path.join(d, f"ranks{n}_{r}.json"), "w") as f:
    json.dump(shapes, f)
print("OK", r)
"""


def _env(d, meshes: dict, n: int) -> dict:
    return {"TEST_DIR": str(d), "OPT": json.dumps(OPT),
            "HOST": json.dumps(HOST), "HOST_STEP": str(HOST_STEP),
            "STEP_MESHES": json.dumps(meshes["step"].get(n, [])),
            "PLACE_MESHES": json.dumps(meshes["place"].get(n, []))}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the reference's results and both launches' results."""
    d = tmp_path_factory.mktemp("distributed")
    rng = np.random.default_rng(0)
    jc = jcfg.reduced(jcfg.get_config("granite-8b"), layers=2)
    jp = jax.tree_util.tree_map(np.asarray,
                                jm.init_params(jc, jax.random.PRNGKey(3)))
    np.savez(d / "inputs.npz",
             W=(rng.standard_normal((L, D, D)) * 0.3).astype(np.float32),
             x=rng.standard_normal((M, MB, D)).astype(np.float32),
             tokens=rng.integers(0, jc.vocab_size, (B, S), np.int32),
             targets=rng.integers(0, jc.vocab_size, (B, S), np.int32))
    np.savez(d / "params.npz", tree=np.array(jp, dtype=object))
    everything = {
        "step": {4: STEP_MESHES[4] + STEP_MESHES[2]},
        "place": {4: PLACE_MESHES[4] + PLACE_MESHES[2]}}
    setup = (f"import json, os\nos.environ.update(json.loads("
             f"{json.dumps(json.dumps(_env(d, everything, 4)))}))\n")
    assert "OK" in jax_run_py(setup + REFERENCE, devices=4, timeout=600)
    meshes = {"step": STEP_MESHES, "place": PLACE_MESHES}
    for n in (4, 2):
        outs = run_ranks(RANKS, n, timeout=300, env=_env(d, meshes, n))
        assert all(f"OK {r}" in o for r, o in enumerate(outs)), outs
    res = {"ref": dict(np.load(d / "reference.npz")),
           "ref_shapes": json.loads((d / "reference_shapes.json").read_text()),
           "params": params_from_numpy(jp, "cpu"), "inputs":
           dict(np.load(d / "inputs.npz")), "cfg": tcfg.reduced(
               tcfg.get_config("granite-8b"), layers=2)}
    for n in (4, 2):
        res[n] = [dict(np.load(d / f"ranks{n}_{r}.npz")) for r in range(n)]
        res[f"{n}_shapes"] = [json.loads((d / f"ranks{n}_{r}.json")
                                         .read_text()) for r in range(n)]
    return res


# ------------------------------------------------------------ launches
def test_ranks_run_over_gloo_on_the_cpu(run):
    """Every rank of both launches ran under gloo (ranks on the CPU)."""
    assert all(str(o["backend"]) == "gloo" for n in (4, 2) for o in run[n])


def test_host_staged_collectives_match_and_reuse_buffers(run):
    """The path that stages every payload through host buffers (gloo
    with the ranks sharing a card), forced on the CPU: psum, all_gather,
    ppermute, a started all-reduce's part, pmax and reduce_scatter equal
    the unstaged ones, twice, the second time from buffers the first
    gave back."""
    for o in run[4]:
        assert bool(o["staged_equal"]) and int(o["staged_pool"]) > 0


def test_a_failing_rank_fails_the_launch_and_ends_the_others():
    """A rank that raises ends the launch with an error naming it, and
    the ranks that wait on it in a collective are ended, not left
    hanging."""
    code = """
import torch
from repro_torch.distributed import process_group, ProcessMesh
from repro_torch.launch.mesh import MeshShape
with process_group("cpu"):
    m = ProcessMesh(MeshShape((2,), ("data",)), "cpu")
    if m.rank == 1:
        raise SystemExit(3)
    m.psum(torch.ones(2), "data")
"""
    with pytest.raises(SubprocessError, match="rank 1 of 2 exited 3"):
        run_ranks(code, 2, timeout=120)


# ------------------------------------------------------- pipeline_apply
def test_pipeline_apply_forward_matches_reference(run):
    for o in run[4]:
        np.testing.assert_allclose(o["pp_out"], run["ref"]["pp_out"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(o["pp_loss"], run["ref"]["pp_loss"],
                                   rtol=1e-5)


def test_pipeline_apply_gradient_matches_reference(run):
    """The GPipe backward: each stage's rows of the gradient on its own
    rank, the whole gradient once summed over the stages."""
    for r, o in enumerate(run[4]):
        np.testing.assert_allclose(o["pp_grad"], run["ref"]["pp_grad"],
                                   atol=1e-5)
        assert list(o["pp_rows"]) == [2 * r, 2 * r + 1]


# ---------------------------------------------------------- placements
@pytest.mark.parametrize("n", [4, 2])
def test_param_shardings_shard_shapes_match_reference(run, n):
    """``param_shardings`` and the ZeRO-1 placement give every leaf the
    block shape ``NamedSharding(mesh, spec).shard_shape`` gives, on every
    mesh; ``shard`` cuts blocks of that shape."""
    for got in run[f"{n}_shapes"]:
        assert set(got) == {f"{_key(s)}/{','.join(a)}"
                            for s, a in PLACE_MESHES[n]}
        for key, g in got.items():
            want = run["ref_shapes"][key]
            assert g["params"] == want["params"], key
            assert g["zero1"] == want["zero1"], key
            assert g["blocks"] == want["zero1"], key


@pytest.mark.parametrize("n", [4, 2])
def test_param_shardings_gather_round_trip(run, n):
    """Every leaf cut to this rank's block and gathered back is the leaf,
    bit for bit, under both placements on every mesh."""
    for got in run[f"{n}_shapes"]:
        assert all(g["round_trip"] for g in got.values())


# ---------------------------------------------------------- ZeRO-1 step
def _one_rank_params(run):
    """The port's one-rank step (no mesh), twice: the parameters after
    each step, and each step's metrics."""
    cfg, inp = run["cfg"], run["inputs"]
    p = params_from_numpy(_np(run["params"]), "cpu")
    ocfg = AdamWConfig(**OPT)
    o = init_state(ocfg, p)
    step = build_train_step(cfg, ocfg, remat_policy="full", device="cpu")
    batch = {k: inp[k] for k in ("tokens", "targets")}
    out = []
    for _ in range(2):
        p, o, met = step(p, o, batch)
        out.append(([t.detach().numpy().copy()
                     for t in tree_flatten(p)[0]], met))
    return out


def _np(tree):
    return params_to_numpy(tree)


@pytest.fixture(scope="module")
def one_rank(run):
    return _one_rank_params(run)


@pytest.mark.parametrize("mesh", ["4x1", "2x2x1", "2x1"])
def test_zero1_step_loss_matches_reference(run, mesh):
    """The loss of each of two steps, averaged over the ranks, against
    the reference's ``build_train_step`` on the same mesh's shape."""
    n = 2 if mesh == "2x1" else 4
    for o in run[n]:
        for k in (1, 2):
            np.testing.assert_allclose(
                o[f"step_loss_{mesh}_{k}"],
                run["ref"][f"step_loss_{mesh}_{k}"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mesh", ["4x1", "2x2x1", "2x1"])
def test_zero1_step_params_match_one_rank(run, one_rank, mesh):
    """Every rank's whole parameters after one and two ZeRO-1 steps
    against the port's one-rank step on the global batch, and the grad
    norm the same on every rank."""
    n = 2 if mesh == "2x1" else 4
    for o in run[n]:
        for k in (1, 2):
            want, met = one_rank[k - 1]
            for i, w in enumerate(want):
                np.testing.assert_allclose(
                    o[f"step_params_{mesh}_{k}_{i}"], w, atol=2e-4,
                    rtol=2e-4, err_msg=f"{mesh} step {k} leaf {i}")
            np.testing.assert_allclose(o[f"step_gnorm_{mesh}_{k}"],
                                       float(met["grad_norm"]), rtol=1e-5)
    for a, b in zip(run[n], run[n][1:]):
        for k in (1, 2):
            assert a[f"step_gnorm_{mesh}_{k}"] == b[f"step_gnorm_{mesh}_{k}"]


def test_zero1_step_on_one_device_mesh_matches_one_rank(run, one_rank):
    """A mesh of one device runs the ZeRO-1 step with no process group
    and no collective: the one-rank step's parameters within float32
    rounding (the gradient's norm is summed over whole stacks there, over
    each period's slice in the one-rank step)."""
    cfg, inp = run["cfg"], run["inputs"]
    m = ProcessMesh(MeshShape((1, 1), ("data", "model")), "cpu")
    p = params_from_numpy(_np(run["params"]), "cpu")
    ocfg = AdamWConfig(**OPT)
    o = init_zero1_state(ocfg, p, m)
    step = build_train_step(cfg, ocfg, remat_policy="full", device="cpu",
                            mesh=m)
    for k in range(2):
        p, o, _ = step(p, o, {k: inp[k] for k in ("tokens", "targets")})
        for got, want in zip(tree_flatten(p)[0], one_rank[k][0]):
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
    assert not m.moved


def test_zero1_step_moves_gradients_and_gathers_parameters(run):
    """The (2, 2, 1) step reduce-scatters every float32 gradient over
    ``data`` (a rank sends the other its half), all-reduces its half over
    ``pod``, and gives the all-gather over ``data`` its half of every
    (float32) parameter: every leaf of reduced granite splits in two."""
    n_params = sum(a.size for a in tree_flatten(_np(run["params"]))[0])
    for o in run[4]:
        moved = json.loads(str(o["step_moved_2x2x1"]))
        # psum: the halves, the squares of the blocks, and the loss, ce
        # and aux (4 bytes each)
        assert moved == {"reduce_scatter": 4 * n_params // 2,
                         "psum": 4 * (n_params // 2 + 4),
                         "all_gather": 4 * n_params // 2}


# ----------------------------------------------------------- checkpoint
def test_elastic_checkpoint_saved_on_4_restored_on_2(run):
    """x (4, 4) over ``model``: saved by 4 ranks (rank 0 writes the
    whole), restored onto 2, each rank its two rows."""
    assert list(run[4][0]["ck_steps"]) == [1]
    whole = np.arange(16.0).reshape(4, 4)
    for r, o in enumerate(run[2]):
        np.testing.assert_array_equal(o["ck_local"], whole[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["ck_whole"], whole)


def test_zero1_state_restored_onto_fewer_ranks(run):
    """The (2, 2, 1) step's parameters and ZeRO-1 state, saved by 4
    ranks, restored into the ZeRO-1 layout of 2: every leaf gathered
    back equal to the saved one (sums in float64, exact)."""
    saved = run[4][0]["state_sum_2x2x1"]
    for o in run[2]:
        np.testing.assert_array_equal(o["restored_sum"], saved)


# ----------------------------------------------------------- host slice
@pytest.mark.parametrize("n", [4, 2])
def test_host_slice_matches_reference(run, n):
    """Each rank's batch is the reference's for that process index and
    count: the same rows of the same stream, bit for bit."""
    for r, o in enumerate(run[n]):
        for k in ("tokens", "targets"):
            got = o[f"host_{k}"]
            assert got.shape == (HOST["batch_size"] // n, HOST["seq_len"])
            np.testing.assert_array_equal(got, run["ref"][f"host_{n}_{r}_{k}"])


# ------------------------------------------------------------ launch.train
def _launch(*args, cwd):
    import subprocess
    import sys

    from repro_torch.conformance.subproc import child_env
    return subprocess.run([sys.executable, "-m", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=child_env())


def test_launch_train_pods_under_ranks_then_elastic_resume(tmp_path):
    """``launch.train --pods 2`` under 4 ranks (data 2, the port's
    launcher) trains with ZeRO-1 and rank-0 checkpoints; 2 ranks resume
    from its newest one (``--pods 1``, data 2) and train a step more;
    ``--pods 2`` without ranks is refused, naming the launcher."""
    ck = str(tmp_path / "ck")
    train = ("repro_torch.launch.train", "--arch", "granite-8b",
             "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
             "--ckpt-dir", ck, "--ckpt-every", "2")
    res = _launch("repro_torch.distributed", "--nproc", "4", "-m", *train,
                  "--steps", "3", "--pods", "2", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("done at step 3") == 4
    assert "mesh {'pod': 2, 'data': 2, 'model': 1}" in res.stdout
    from repro_torch.checkpoint import CheckpointManager
    assert CheckpointManager(ck).all_steps() == [2, 3]
    res = _launch("repro_torch.distributed", "--nproc", "2", "-m", *train,
                  "--steps", "4", cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("resumed from step 3") == 2
    assert res.stdout.count("done at step 4") == 2
    assert CheckpointManager(ck).all_steps() == [2, 3, 4]
    res = _launch(*train, "--steps", "1", "--pods", "2", cwd=tmp_path)
    assert res.returncode != 0 and "repro_torch.distributed" in res.stderr
