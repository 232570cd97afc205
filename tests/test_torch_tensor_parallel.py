"""Tensor parallelism over ``model`` (every block kind: the dense and MoE
families, MLA, RWKV6 and Mamba) against the reference, over gloo ranks
on the CPU: the ZeRO-1 step's losses, every gradient gathered whole,
expert parallelism and its hidden-dim fallback, the tied head, the
``shard`` kinds, the region functions, the data slice, the RWKV channel
mix's whole branch, Mamba's ``w_in`` halves, the refusal of a cache and
``launch.train --model-parallel``.

The reference runs in two child processes on one host device (the
weights, then, beside the port's 4 ranks, the losses), on a one-device
mesh of Auto axes: under GSPMD its loss is the same on every
mesh (ROADMAP F8 lists 6.626987 on the reference test's four), so its
one-device loss is what each of the port's meshes is held to. The port
runs in two launches of ranks (``run_ranks``): 4 ranks on the meshes
(2, 2), (4, 1) and (1, 4) over ("data", "model"), then 2 on (1, 2); the
mesh (1, 1) runs in this process. Weights are the reference's, carried
across as numpy; inputs come from numpy seeds.

Tolerances: the first loss 2e-4 against the reference's one-device loss
(the model tolerance) and 2e-5 between the port's meshes; every gradient
1e-4 of its leaf's largest magnitude against the port's one-rank
gradient; the second step's loss 2e-4 against the reference's.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.configs as jcfg  # noqa: E402
from repro.conformance.subproc import forced_mesh_env  # noqa: E402
from repro.conformance.subproc import run_py as jax_run_py  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.conformance.subproc import run_ranks  # noqa: E402
from repro_torch.distributed import ProcessMesh, TracingMesh  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import unstack_periods  # noqa: E402
from repro_torch.models.transformer import _logits  # noqa: E402
from repro_torch.sharding.rules import _paths  # noqa: E402
from repro_torch.train import AdamWConfig, build_train_step  # noqa: E402
from repro_torch.train.step import (_stacked_grad,  # noqa: E402
                                    init_zero1_state, loss_and_grads)

OPT = dict(lr=1e-3, warmup_steps=0, total_steps=10)
#: per case: the arch, its reduced depth, overrides of the config and of
#: its MoE, the global batch (rows, length) and the meshes (data, model)
#: by launch size. mixtral's rows hold whole routing groups of 1024
#: tokens on every data rank, so that its groups (and their capacity)
#: are the reference's
CASES = {
    "granite": dict(arch="granite-8b", layers=2, over={}, moe={}, B=4, S=32,
                    meshes={"4": [[2, 2], [4, 1], [1, 4]], "2": [[1, 2]]}),
    "mixtral": dict(arch="mixtral-8x7b", layers=None, over={}, moe={}, B=4,
                    S=512, meshes={"4": [[1, 4], [2, 2]]}),
    # 6 experts over 4 ranks: the hidden dim splits
    "moe6": dict(arch="mixtral-8x7b", layers=None, over={},
                 moe={"num_experts": 6}, B=4, S=32, meshes={"4": [[1, 4]]}),
    # nor does d_ff 66: w_down splits on D, the stacks gathered
    "moe_odd": dict(arch="mixtral-8x7b", layers=None, over={},
                    moe={"num_experts": 6, "d_ff": 66}, B=4, S=32,
                    meshes={"4": [[1, 4]]}),
    # 6 query heads over 2 ranks read KV heads 0, 0, 1 and 1, 2, 2
    "gqa63": dict(arch="granite-8b", layers=2,
                  over={"num_heads": 6, "num_kv_heads": 3}, moe={}, B=4,
                  S=32, meshes={"2": [[1, 2]]}),
    "gemma3": dict(arch="gemma3-1b", layers=None, over={}, moe={}, B=4, S=32,
                   meshes={"4": [[1, 4], [2, 2]], "2": [[1, 2]]}),
    # the MLA prelude layer and one mla_moe layer; 4 heads, 4 experts
    "deepseek": dict(arch="deepseek-v2-lite-16b", layers=None, over={},
                     moe={}, B=4, S=512,
                     meshes={"4": [[1, 4], [2, 2]], "2": [[1, 2]]}),
    "rwkv6": dict(arch="rwkv6-7b", layers=2, over={}, moe={}, B=4, S=32,
                  meshes={"4": [[1, 4], [2, 2]], "2": [[1, 2]]}),
    # one period: 6 mamba and 1 attention layer, MoE on 4 of them
    "jamba": dict(arch="jamba-v0.1-52b", layers=None, over={}, moe={}, B=4,
                  S=512, meshes={"4": [[1, 4], [2, 2]], "2": [[1, 2]]}),
}
#: the reference's layout boundaries these families pass through
KIND_CASES = ("granite", "mixtral", "deepseek", "rwkv6", "jamba")
#: per case, the leaves whose whole gradient every rank holds (not only
#: its block): the RWKV channel mix's whole branch
WHOLE_GRAD_LEAVES = {"rwkv6": ("tm/cm_r", "tm/cm_mu")}
#: the case whose loss after one AdamW step is held to the reference's
STEP_CASES = ("granite",)

#: the case's config, in the reference's package or the port's (``mod``)
CFG = """
import dataclasses
def make_cfg(mod, case):
    cfg = mod.reduced(mod.get_config(case["arch"]), layers=case["layers"])
    if case["moe"]:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    return dataclasses.replace(cfg, **case["over"]).validate()
"""
exec(CFG)


def _cfg(mod, case):
    return make_cfg(mod, case)  # noqa: F821 (defined by CFG)


def _key(name, shape) -> str:
    return f"{name}_{shape[0]}x{shape[1]}"


INIT = CFG + """
import json, os, warnings
from functools import partial
warnings.filterwarnings("ignore")
import jax, numpy as np
import repro.configs as jcfg
import repro.models as jm

d = os.environ["TEST_DIR"]
for i, (name, case) in enumerate(json.loads(os.environ["CASES"]).items()):
    cfg = make_cfg(jcfg, case)
    params = jax.jit(partial(jm.init_params, cfg))(jax.random.PRNGKey(3 + i))
    np.savez(os.path.join(d, f"params_{name}.npz"), tree=np.array(
        jax.tree_util.tree_map(np.asarray, params), dtype=object))
print("OK")
"""

REFERENCE = CFG + """
import json, os, warnings
from functools import partial
warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
import repro.configs as jcfg
import repro.models as jm
import repro.models.layers as JL
from repro.train.optimizer import AdamWConfig, init_state
from repro.train.step import build_train_step

d = os.environ["TEST_DIR"]
cases = json.loads(os.environ["CASES"])
ocfg = AdamWConfig(**json.loads(os.environ["OPT"]))
mesh = jax.make_mesh((1, 1), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2,
                     devices=jax.devices()[:1])

class Seen(dict):
    # an activation plan with no specs that records what shard() asks for
    def __init__(self):
        super().__init__()
        self.kinds = set()
    def get(self, key, default=None):
        self.kinds.add(key)
        return default

out, kinds = {}, {}
for name, case in cases.items():
    cfg = make_cfg(jcfg, case)
    params = jax.tree_util.tree_map(jnp.asarray, dict(np.load(
        os.path.join(d, f"params_{name}.npz"),
        allow_pickle=True))["tree"].item())
    batch = {k: jnp.asarray(v) for k, v in np.load(
        os.path.join(d, f"inputs_{name}.npz")).items()}
    loss, parts = jax.jit(partial(jm.loss_fn, cfg))(params, batch)
    out[f"{name}_loss_1"] = np.asarray(loss)
    out[f"{name}_aux_1"] = np.asarray(parts["aux"])
    if name in json.loads(os.environ["STEP_CASES"]):
        # the loss after one AdamW step
        built = build_train_step(cfg, mesh, ocfg, remat_policy="none",
                                 donate=False)
        p, o, _ = built.fn(params, init_state(ocfg, params), batch)
        out[f"{name}_loss_2"] = np.asarray(jax.jit(partial(
            jm.loss_fn, cfg))(p, batch)[0])
    if name in json.loads(os.environ["KIND_CASES"]):
        seen = JL._ACT_PLAN = Seen()
        jax.eval_shape(partial(jm.loss_fn, cfg), params, batch)
        JL._ACT_PLAN = {}
        kinds[name] = sorted(seen.kinds)
np.savez(os.path.join(d, "reference.npz"), **out)
with open(os.path.join(d, "reference_kinds.json"), "w") as f:
    json.dump(kinds, f)
print("OK")
"""

RANKS = CFG + """
import json, os
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.bridge import params_from_numpy
import repro_torch.configs as tcfg
from repro_torch.data import DataConfig, make_batch
from repro_torch.distributed import ProcessMesh, process_group, world_size
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import unstack_periods
from repro_torch.models.layers import activation_sharding
import repro_torch.models.transformer as T
from repro_torch.sharding import rules
from repro_torch.sharding.rules import _paths
from repro_torch.train import AdamWConfig, build_train_step
from repro_torch.train.step import (_stacked_grad, init_zero1_state,
                                    loss_and_grads, shard_params)
from repro_torch.tree import tree_flatten

d = os.environ["TEST_DIR"]
cases = json.loads(os.environ["CASES"])
ocfg = AdamWConfig(**json.loads(os.environ["OPT"]))
WHOLE_GRAD_LEAVES = {k: tuple(v) for k, v in json.loads(
    os.environ["WHOLE_GRAD_LEAVES"]).items()}
out = {}

with process_group("cpu") as backend:
    n, r = world_size(), torch.distributed.get_rank()
    out["backend"] = np.array(backend)
    for name, case in cases.items():
        cfg = make_cfg(tcfg, case)
        host = dict(np.load(os.path.join(d, f"params_{name}.npz"),
                            allow_pickle=True))["tree"].item()
        inp = dict(np.load(os.path.join(d, f"inputs_{name}.npz")))
        for shape in case["meshes"].get(str(n), []):
            m = ProcessMesh(MeshShape(tuple(shape), ("data", "model")),
                            "cpu")
            key = f"{name}_{shape[0]}x{shape[1]}"
            per = case["B"] // shape[0]
            di = m.axis_index("data")
            batch = {k: torch.as_tensor(v[di * per:(di + 1) * per])
                     for k, v in inp.items()}
            params = params_from_numpy(host, "cpu")
            blocks = shard_params(params, m)
            out[f"{key}_block_shapes"] = np.array(json.dumps(
                [list(t.shape) for t in tree_flatten(blocks)[0]]))
            plan = rules.activation_plan(m, cfg, kind="train")
            with activation_sharding(plan, m) as kinds:
                loss, parts, g = loss_and_grads(
                    cfg, unstack_periods(cfg, blocks), batch, "full")
            out[f"{key}_kinds"] = np.array(json.dumps(sorted(set(kinds))))
            out[f"{key}_aux"] = (m.all_reduce(parts["aux"], "data")
                                 / shape[0]).numpy()
            # the serving head: the ranks' vocab blocks gathered, or the
            # tied table's partial products summed
            hidden = torch.randn((2, 3, cfg.d_model),
                                 generator=torch.Generator().manual_seed(1))
            with activation_sharding(plan, m):
                out[f"{key}_logits"] = T._logits(cfg, blocks, hidden).numpy()
            places = tree_flatten(rules.param_shardings(params, m))[0]
            keep = WHOLE_GRAD_LEAVES.get(name, ())
            for i, (path, sh) in enumerate(zip(_paths(params), places)):
                gl = m.all_reduce(_stacked_grad(g, path), "data") / shape[0]
                whole = sh.gather(gl)
                if r == 0:
                    out[f"{key}_grad_{i}"] = whole.numpy()
                if "/".join(map(str, path)).endswith(keep):
                    out[f"{key}_local_grad_{i}"] = gl.numpy()
            if name == "jamba":
                # the first mamba block's w_in: this rank's block, and the
                # whole tensor gathered back from the blocks
                path = ("periods", "b0", "mix", "w_in")
                sh = dict(zip(_paths(params), places))[path]
                w = blocks["periods"]["b0"]["mix"]["w_in"]
                # a copy: the steps below update the blocks in place
                out[f"{key}_w_in_block"] = w.clone().numpy()
                out[f"{key}_w_in_gathered"] = sh.gather(w).numpy()
            del g
            o = init_zero1_state(ocfg, params, m)
            step = build_train_step(cfg, ocfg, remat_policy="full",
                                    device="cpu", mesh=m)
            for k in (1, 2):
                blocks, o, met = step(blocks, o, batch)
                out[f"{key}_loss_{k}"] = met["loss"].numpy()

    # the region functions' gradients over a model axis of all the ranks
    m = ProcessMesh(MeshShape((n,), ("model",)), "cpu")
    x = torch.arange(4.0, requires_grad=True)
    (m.copy_to(x, "model") * (r + 1)).sum().backward()
    out["f_grad"] = x.grad.numpy()
    x.grad = None
    y = m.reduce_from(x * (r + 1), "model")
    (y * torch.arange(4.0)).sum().backward()
    out["g_out"], out["g_grad"] = y.detach().numpy(), x.grad.numpy()
    for partial in (False, True):
        x.grad = None
        z = m.gather_from(x + r, "model", 0, partial=partial)
        (z * torch.arange(4.0 * n)).sum().backward()
        out[f"gather_{partial}"] = z.detach().numpy()
        out[f"gather_grad_{partial}"] = x.grad.numpy()
    # bf16 partials (r + 1) / 8, whose sums are exact in bf16
    c = (r + 1) / 8
    xb = torch.ones(3, dtype=torch.bfloat16, requires_grad=True)
    m.reset_moved()
    g = m.reduce_from(xb * c, "model")
    out["g_bf16_dtype"] = np.array(str(g.dtype))
    out["g_bf16"] = g.detach().float().numpy()
    (m.copy_to(xb, "model") * c).sum().backward()
    out["f_grad_bf16_dtype"] = np.array(str(xb.grad.dtype))
    out["f_grad_bf16"] = xb.grad.float().numpy()
    out["bf16_sum_bytes"] = np.array(m.moved["psum"])

    # the data slice: a model group of 2 ranks reads the same rows
    if n == 4:
        b = make_batch(DataConfig(batch_size=4, seq_len=8, vocab_size=97,
                                  seed=1, model_parallel=2), 3)
        out["slice_tokens"] = b["tokens"]

np.savez(os.path.join(d, f"ranks{n}_{r}.npz"), **out)
print("OK", r)
"""


def _env(d) -> dict:
    return {"TEST_DIR": str(d), "OPT": json.dumps(OPT),
            "CASES": json.dumps(CASES), "KIND_CASES": json.dumps(KIND_CASES),
            "STEP_CASES": json.dumps(STEP_CASES),
            "WHOLE_GRAD_LEAVES": json.dumps(WHOLE_GRAD_LEAVES)}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs and weights, the reference's results and both launches'."""
    d = tmp_path_factory.mktemp("tensor_parallel")
    rng = np.random.default_rng(0)
    for name, case in CASES.items():
        jc = _cfg(jcfg, case)
        np.savez(d / f"inputs_{name}.npz", **{
            k: rng.integers(0, jc.vocab_size, (case["B"], case["S"]),
                            np.int32) for k in ("tokens", "targets")})
    setup = (f"import json, os\nos.environ.update(json.loads("
             f"{json.dumps(json.dumps(_env(d)))}))\n")
    assert "OK" in jax_run_py(setup + INIT, devices=1, timeout=600)
    # the reference's losses in a child while the 4 ranks run
    ref = subprocess.Popen([sys.executable, "-c", setup + REFERENCE],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=forced_mesh_env(1))
    try:
        for n in (4, 2):
            outs = run_ranks(RANKS, n, timeout=300, env=_env(d))
            assert all(f"OK {r}" in o for r, o in enumerate(outs)), outs
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "OK" in out, err[-4000:]
    res = {"ref": dict(np.load(d / "reference.npz")),
           "kinds": json.loads((d / "reference_kinds.json").read_text()),
           "dir": d}
    for n in (4, 2):
        res[n] = [dict(np.load(d / f"ranks{n}_{r}.npz")) for r in range(n)]
    return res


def _one_rank(run, name):
    """The port's one-rank gradient (remat full), two ZeRO-1 steps on the
    (1, 1) mesh and the serving head's logits of random hidden states, in
    this process: (grads by leaf, [loss 1, loss 2], logits)."""
    case = CASES[name]
    cfg = _cfg(tcfg, case)
    host = dict(np.load(run["dir"] / f"params_{name}.npz",
                        allow_pickle=True))["tree"].item()
    batch = {k: torch.as_tensor(v) for k, v in np.load(
        run["dir"] / f"inputs_{name}.npz").items()}
    params = params_from_numpy(host, "cpu")
    _, _, g = loss_and_grads(cfg, unstack_periods(cfg, params), batch,
                             "full")
    grads = [_stacked_grad(g, p).numpy() for p in _paths(params)]
    hidden = torch.randn((2, 3, cfg.d_model),
                         generator=torch.Generator().manual_seed(1))
    logits = _logits(cfg, params, hidden).numpy()
    m = ProcessMesh(MeshShape((1, 1), ("data", "model")), "cpu")
    ocfg = AdamWConfig(**OPT)
    o = init_zero1_state(ocfg, params, m)
    step = build_train_step(cfg, ocfg, remat_policy="full", device="cpu",
                            mesh=m)
    losses = []
    for _ in range(2):
        params, o, met = step(params, o, batch)
        losses.append(float(met["loss"]))
    return grads, losses, logits


@pytest.fixture(scope="module")
def one_rank(run):
    return {name: _one_rank(run, name) for name in CASES}


def _meshes(name):
    return [(int(n), tuple(s)) for n, ss in
            sorted(CASES[name]["meshes"].items(), key=lambda kv: -int(kv[0]))
            for s in ss]


MESH_CASES = [(name, n, s) for name in CASES for n, s in _meshes(name)]


def _ids(c):
    return f"{c[0]}-{c[2][0]}x{c[2][1]}"


# ------------------------------------------------------------- losses
def test_ranks_run_over_gloo_on_the_cpu(run):
    assert all(str(o["backend"]) == "gloo" for n in (4, 2) for o in run[n])


@pytest.mark.parametrize("case", MESH_CASES, ids=_ids)
def test_first_loss_matches_reference(run, one_rank, case):
    """The first ZeRO-1 step's loss on every rank of each mesh against
    the reference's one-device loss (2e-4) and the port's (1, 1) mesh
    (2e-5)."""
    name, n, shape = case
    want = float(run["ref"][f"{name}_loss_1"])
    assert abs(one_rank[name][1][0] - want) <= 2e-4
    for o in run[n]:
        got = float(o[f"{_key(name, shape)}_loss_1"])
        assert abs(got - want) <= 2e-4, (got, want)
        assert abs(got - one_rank[name][1][0]) <= 2e-5


@pytest.mark.parametrize("case", [c for c in MESH_CASES
                                  if c[0] in STEP_CASES], ids=_ids)
def test_second_step_loss_matches_reference(run, one_rank, case):
    """The loss after one AdamW step (the update over blocks split over
    model and data, gathered back) against the reference's (2e-4) and
    the port's one-rank step's (2e-5)."""
    name, n, shape = case
    want = float(run["ref"][f"{name}_loss_2"])
    for o in run[n]:
        got = float(o[f"{_key(name, shape)}_loss_2"])
        assert abs(got - want) <= 2e-4, (got, want)
        assert abs(got - one_rank[name][1][1]) <= 2e-5


@pytest.mark.parametrize("name", list(CASES))
def test_losses_agree_across_meshes(run, name):
    """Every mesh of a case, every rank: the same first loss within 2e-5
    (the reference test's check across meshes, tightened)."""
    losses = [float(o[f"{_key(name, s)}_loss_1"]) for n, s in _meshes(name)
              for o in run[n]]
    assert max(losses) - min(losses) <= 2e-5, losses


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("case", MESH_CASES, ids=_ids)
def test_gradients_match_one_rank(run, one_rank, case):
    """Every gradient leaf, the ranks' blocks gathered whole (and the
    mean over data taken), against the port's one-rank gradient, within
    1e-4 of the leaf's largest magnitude."""
    name, n, shape = case
    o = run[n][0]
    grads = one_rank[name][0]
    for i, want in enumerate(grads):
        got = o[f"{_key(name, shape)}_grad_{i}"]
        scale = max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= 1e-4 * scale, \
            f"{name} {shape} leaf {i}"


@pytest.mark.parametrize("case", MESH_CASES, ids=_ids)
def test_serving_head_logits_match_one_rank(run, one_rank, case):
    """``_logits`` under the plan: granite's vocab-parallel head (the
    ranks' columns gathered) and gemma3's tied row-parallel one (the
    partial products psummed), against the one-rank logits."""
    name, n, shape = case
    for o in run[n]:
        np.testing.assert_allclose(o[f"{_key(name, shape)}_logits"],
                                   one_rank[name][2], rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- MoE
def _shapes(run, name, n, shape):
    return json.loads(str(run[n][0][f"{_key(name, shape)}_block_shapes"]))


def _leaf(name, suffix):
    cfg = _cfg(tcfg, CASES[name])
    from repro_torch.models import params_spec
    paths = ["/".join(map(str, p)) for p in _paths(params_spec(cfg))]
    return next(i for i, p in enumerate(paths) if p.endswith(suffix))


def test_mixtral_experts_split_by_expert(run):
    """Reduced mixtral (4 experts) at model 4: each rank holds one
    expert of each stack (the rule's expert parallelism) and the router
    whole; the load-balancing loss equals the reference's."""
    for shape in ([1, 4], [2, 2]):
        shapes = _shapes(run, "mixtral", 4, shape)
        m = shape[1]
        for stack in ("ffn/w_up", "ffn/w_down", "ffn/w_gate"):
            assert shapes[_leaf("mixtral", stack)][1] == 4 // m
        assert shapes[_leaf("mixtral", "ffn/router")][-1] == 4
        for o in run[4]:
            np.testing.assert_allclose(
                o[f"{_key('mixtral', shape)}_aux"],
                run["ref"]["mixtral_aux_1"], rtol=1e-5)


def test_moe_with_6_experts_splits_the_hidden_dim(run):
    """6 experts do not split over 4 ranks: the rule's fallback splits
    each expert's hidden dim (``w_up`` and ``w_gate`` by their last dim,
    ``w_down`` by its middle one), and the step is still the
    reference's."""
    shapes = _shapes(run, "moe6", 4, [1, 4])
    f = _cfg(tcfg, CASES["moe6"]).moe.d_ff
    assert shapes[_leaf("moe6", "ffn/w_up")][1:] == [6, 64, f // 4]
    assert shapes[_leaf("moe6", "ffn/w_gate")][1:] == [6, 64, f // 4]
    assert shapes[_leaf("moe6", "ffn/w_down")][1:] == [6, f // 4, 64]
    for o in run[4]:
        np.testing.assert_allclose(o["moe6_1x4_aux"],
                                   run["ref"]["moe6_aux_1"], rtol=1e-5)


def test_moe_whose_hidden_dim_does_not_split_gathers(run):
    """d_ff 66 over 4 ranks: ``w_up`` and ``w_gate`` stay whole and
    ``w_down`` splits on D (the rule's last fallback); each rank gathers
    the stacks and runs every expert whole, and the step is still the
    reference's."""
    shapes = _shapes(run, "moe_odd", 4, [1, 4])
    assert shapes[_leaf("moe_odd", "ffn/w_up")][1:] == [6, 64, 66]
    assert shapes[_leaf("moe_odd", "ffn/w_down")][1:] == [6, 66, 16]
    for o in run[4]:
        np.testing.assert_allclose(o["moe_odd_1x4_aux"],
                                   run["ref"]["moe_odd_aux_1"], rtol=1e-5)


def test_query_heads_reading_uneven_kv_groups(run):
    """6 query and 3 KV heads at model 2: ``wk``'s 48 columns split into
    halves that hold no whole head, and rank 0's heads 0-2 read KV heads
    0, 0, 1 (rank 1's: 1, 2, 2), groups of unequal size: the rank
    gathers ``wk`` and ``wv`` and takes one KV head a query head."""
    shapes = _shapes(run, "gqa63", 2, [1, 2])
    assert shapes[_leaf("gqa63", "mix/wk")][1:] == [64, 24]
    assert shapes[_leaf("gqa63", "mix/wq")][1:] == [64, 48]


def test_tied_head_is_the_table_split_on_d(run):
    """gemma3-1b ties its head to the embedding table: no ``lm_head``;
    the table split on D (the head's product row-parallel, psummed), and
    the q/k norms whole on every rank."""
    cfg = _cfg(tcfg, CASES["gemma3"])
    assert cfg.tie_embeddings
    for n, shape in _meshes("gemma3"):
        shapes = _shapes(run, "gemma3", n, shape)
        assert shapes[_leaf("gemma3", "embed")] == [
            cfg.padded_vocab, cfg.d_model // shape[1]]
        assert shapes[_leaf("gemma3", "mix/q_norm")][-1] == cfg.head_dim


@pytest.mark.parametrize("name", KIND_CASES)
def test_shard_kinds_match_reference_call_sites(run, name):
    """The layout boundaries one step passes through (``layers.shard``'s
    kinds) are the reference's call sites for the family."""
    want = run["kinds"][name]
    assert want
    for n, shape in _meshes(name):
        for o in run[n]:
            assert json.loads(str(o[f"{_key(name, shape)}_kinds"])) == want


# ------------------------------------------------------------ regions
@pytest.mark.parametrize("n", [4, 2])
def test_region_functions_carry_megatrons_gradients(run, n):
    """*f* (``copy_to``): identity forward, the ranks' gradients summed
    backward; *g* (``reduce_from``): the sum forward, the gradient as it
    comes backward; ``gather_from``: the blocks in rank order, backward
    this rank's block of a whole gradient or the sum of partial ones,
    cut to its block."""
    s = n * (n + 1) / 2
    w = np.arange(4.0 * n)
    for r, o in enumerate(run[n]):
        np.testing.assert_array_equal(o["f_grad"], np.full(4, s))
        np.testing.assert_array_equal(o["g_out"], np.arange(4.0) * s)
        np.testing.assert_array_equal(o["g_grad"], np.arange(4.0) * (r + 1))
        want = np.concatenate([np.arange(4.0) + q for q in range(n)])
        np.testing.assert_array_equal(o["gather_False"], want)
        np.testing.assert_array_equal(o["gather_grad_False"],
                                      w[4 * r:4 * r + 4])
        np.testing.assert_array_equal(o["gather_grad_True"],
                                      n * w[4 * r:4 * r + 4])


@pytest.mark.parametrize("n", [4, 2])
def test_region_sums_keep_the_partials_dtype(run, n):
    """*g*'s sum and *f*'s backward sum of bf16 partials are taken in
    bf16, as Megatron's all-reduces are: each moves its 3 elements at 2
    bytes (12 bytes for the two) and gives bf16, the sum of the ranks'
    (r + 1) / 8."""
    want = n * (n + 1) / 16
    for o in run[n]:
        assert int(o["bf16_sum_bytes"]) == 2 * 3 * 2
        assert str(o["g_bf16_dtype"]) == str(o["f_grad_bf16_dtype"]) \
            == "torch.bfloat16"
        np.testing.assert_array_equal(o["g_bf16"], np.full(3, want))
        np.testing.assert_array_equal(o["f_grad_bf16"], np.full(3, want))


def test_model_group_reads_the_same_rows(run):
    """Under ``model_parallel`` 2 the ranks of a model group (0, 1 and
    2, 3) read the same slice, and the two data groups different ones."""
    t = [o["slice_tokens"] for o in run[4]]
    assert t[0].shape == (2, 8)
    np.testing.assert_array_equal(t[0], t[1])
    np.testing.assert_array_equal(t[2], t[3])
    assert not np.array_equal(t[0], t[2])


def test_rwkv_channel_mix_whole_branch_gradients(run, one_rank):
    """The RWKV channel mix reads ``xm`` in ``cm_k`` (split) and ``cm_r``
    (whole): *f* sits right before ``cm_k``, so ``cm_r``'s and
    ``cm_mu``'s gradients are whole on every rank of every mesh (not
    summed ``model`` times): each rank's own, the mean over data taken,
    within 1e-4 of the leaf's largest magnitude of the one-rank
    gradient."""
    grads = one_rank["rwkv6"][0]
    idx = [_leaf("rwkv6", suffix) for suffix in WHOLE_GRAD_LEAVES["rwkv6"]]
    for n, shape in _meshes("rwkv6"):
        for r, o in enumerate(run[n]):
            for i in idx:
                want = grads[i]
                got = o[f"{_key('rwkv6', shape)}_local_grad_{i}"]
                assert got.shape == want.shape
                scale = float(np.abs(want).max())
                assert float(np.abs(got - want).max()) <= 1e-4 * scale, \
                    (shape, r, i)


def test_mamba_w_in_block_is_its_channels_of_both_halves(run):
    """``w_in`` is (D, 2·d_inner), ``xi`` then ``z``: a rank's block (by
    ``shard_params``) is its d_inner/m channels of ``xi`` followed by the
    same channels of ``z``, not a contiguous block of the columns, and
    the blocks gathered (``NamedSharding.gather``, which the update and
    the tests use) give the whole tensor back."""
    cfg = _cfg(tcfg, CASES["jamba"])
    di = cfg.d_model * cfg.mamba.expand
    host = dict(np.load(run["dir"] / "params_jamba.npz",
                        allow_pickle=True))["tree"].item()
    w = np.asarray(host["periods"]["b0"]["mix"]["w_in"])   # (P, D, 2 di)
    for n, shape in _meshes("jamba"):
        m = shape[1]
        dl = di // m
        for r, o in enumerate(run[n]):
            j = r % m                       # the rank's model index
            block = o[f"{_key('jamba', shape)}_w_in_block"]
            want = np.concatenate([w[..., j * dl:(j + 1) * dl],
                                   w[..., di + j * dl:di + (j + 1) * dl]],
                                  -1)
            np.testing.assert_array_equal(block, want)
            np.testing.assert_array_equal(
                o[f"{_key('jamba', shape)}_w_in_gathered"], w)


def test_param_parts_only_where_each_half_splits():
    """``rules.param_parts`` cuts ``w_in``'s columns into two parts where
    ``model`` divides d_inner, under ``params/`` and the optimizer's
    trees too, and nowhere else; ``NamedSharding`` with those parts takes
    each rank's channels of both halves (a tracing mesh per rank: no
    collective)."""
    from repro_torch.distributed import NamedSharding
    from repro_torch.sharding import rules
    mesh = MeshShape((1, 2), ("data", "model"))
    got = rules.param_parts(mesh, ("periods", "b0", "mix", "w_in"),
                            (None, None, "model"), (3, 8, 12))
    assert got == (1, 1, 2)
    assert rules.param_parts(mesh, ("opt", "mu", "periods", "b0", "mix",
                                    "w_in"), (None, "data", "model"),
                             (3, 8, 12)) == (1, 1, 2)
    # model 4 does not divide d_inner 6: contiguous blocks, gathered whole
    # by the layer
    assert rules.param_parts(MeshShape((1, 4), ("data", "model")),
                             ("mix", "w_in"), (None, "model"), (8, 12)) == ()
    assert rules.param_parts(mesh, ("mix", "w_out"), ("model", None),
                             (12, 8)) == ()
    assert rules.param_parts(mesh, ("mix", "w_in"), (None, None),
                             (8, 12)) == ()
    t = torch.arange(2 * 12.0).reshape(2, 12)
    for r in range(2):
        sh = NamedSharding(TracingMesh(mesh, r, "cpu"), (None, "model"),
                           (1, 2))
        assert sh.shard_shape(t.shape) == (2, 6)
        want = torch.cat([t[:, 3 * r:3 * r + 3], t[:, 6 + 3 * r:9 + 3 * r]],
                         1)
        assert torch.equal(sh.shard(t), want)


# ------------------------------------------------------------ refusals
def _step_over_model_2(arch):
    """(cfg, mesh, rank 0's blocks, tokens) after one ZeRO-1 step of
    reduced ``arch`` over (data 1, model 2) on rank 0's blocks (a
    tracing mesh: the collectives computed as if every rank held this
    rank's tensor, so only finiteness is checked), and its loss."""
    from repro_torch.models.transformer import init_params
    from repro_torch.train.step import shard_params
    cfg = tcfg.reduced(tcfg.get_config(arch))
    mesh = TracingMesh(MeshShape((1, 2), ("data", "model")), 0, "cpu")
    ocfg = AdamWConfig(**OPT)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    o = init_zero1_state(ocfg, params, mesh)
    blocks = shard_params(params, mesh)
    step = build_train_step(cfg, ocfg, remat_policy="full", device="cpu",
                            mesh=mesh)
    tokens = torch.randint(0, cfg.vocab_size, (2, 16),
                           generator=torch.Generator().manual_seed(1))
    _, _, met = step(blocks, o, {"tokens": tokens, "targets": tokens})
    return cfg, mesh, blocks, tokens, float(met["loss"])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_mla_rwkv_mamba_step_over_model_axis(arch):
    """MLA, RWKV and Mamba blocks train over a model axis above 1: the
    step over (data 1, model 2) builds and takes a step on rank 0's
    blocks, its loss finite."""
    assert np.isfinite(_step_over_model_2(arch)[-1])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_mla_rwkv_mamba_refuse_model_parallel(arch):
    """MLA, RWKV and Mamba blocks refuse a model axis above 1 with a
    cache (serving over a mesh): a prefill of the blocks that have just
    trained over (data 1, model 2), under the prefill plan, raises
    naming ROADMAP M4.1e."""
    from repro_torch.models import prefill
    from repro_torch.models.layers import activation_sharding
    from repro_torch.sharding import rules
    cfg, mesh, blocks, tokens, _ = _step_over_model_2(arch)
    with activation_sharding(rules.activation_plan(mesh, cfg, kind="prefill"),
                             mesh):
        with pytest.raises(NotImplementedError, match="M4.1e"):
            prefill(cfg, blocks, {"tokens": tokens}, 32)


@pytest.mark.parametrize("arch, block", [
    ("granite-8b", "attention"), ("deepseek-v2-lite-16b", "MLA"),
    ("rwkv6-7b", "RWKV time mix"), ("jamba-v0.1-52b", "Mamba")])
def test_cache_under_model_axis_raises(arch, block):
    """Every layer that takes a cache refuses one under a model axis
    above 1 (serving over a mesh), naming the layer and ROADMAP M4.1e;
    without the mesh the same prefill runs."""
    from repro_torch.models import prefill
    from repro_torch.models.layers import activation_sharding
    from repro_torch.models.transformer import init_params
    from repro_torch.sharding import rules
    cfg = tcfg.reduced(tcfg.get_config(arch))
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.zeros((1, 8), dtype=torch.int64)
    mesh = TracingMesh(MeshShape((1, 2), ("data", "model")), 0, "cpu")
    with activation_sharding(rules.activation_plan(mesh, cfg,
                                                   kind="prefill"), mesh):
        with pytest.raises(NotImplementedError,
                           match=f"{block} with a cache.*M4.1e"):
            prefill(cfg, params, {"tokens": tokens}, 16)
    logits, _ = prefill(cfg, params, {"tokens": tokens}, 16)
    assert torch.isfinite(logits).all()


# ------------------------------------------------------------ launch
def test_launch_train_model_parallel_then_resume(tmp_path):
    """``launch.train --model-parallel 2`` under 4 ranks (data 2, model
    2) trains reduced mixtral and checkpoints; the same 4 ranks resume
    from it as (data 1, model 4) and train a step more."""
    import subprocess
    import sys

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.conformance.subproc import child_env
    ck = str(tmp_path / "ck")
    train = ("-m", "repro_torch.distributed", "--nproc", "4", "-m",
             "repro_torch.launch.train", "--arch", "mixtral-8x7b",
             "--reduced", "--device", "cpu", "--batch", "4", "--seq", "16",
             "--ckpt-dir", ck, "--ckpt-every", "2")

    def launch(*args):
        return subprocess.run([sys.executable, *train, *args], cwd=tmp_path,
                              capture_output=True, text=True, timeout=300,
                              env=child_env())
    res = launch("--steps", "3", "--model-parallel", "2")
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("done at step 3") == 4
    assert "mesh {'data': 2, 'model': 2}" in res.stdout
    assert CheckpointManager(ck).all_steps() == [2, 3]
    res = launch("--steps", "4", "--model-parallel", "4")
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("resumed from step 3") == 4
    assert res.stdout.count("done at step 4") == 4
    assert "mesh {'data': 1, 'model': 4}" in res.stdout


def test_launch_train_jamba_model_parallel_resumes_on_one_rank(tmp_path):
    """``launch.train --model-parallel 2`` under 2 ranks (data 1, model 2)
    trains reduced jamba 2 steps and checkpoints (``w_in`` gathered from
    both ranks' halves); one rank resumes from it and trains to step 4,
    and equals one rank that trains the 4 steps uninterrupted: every
    leaf of the two final checkpoints (parameters and AdamW's state)
    within 1e-4 of its largest magnitude (the first two steps' split
    products round differently)."""
    import subprocess
    import sys

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.conformance.subproc import child_env
    args = ("repro_torch.launch.train", "--arch", "jamba-v0.1-52b",
            "--reduced", "--device", "cpu", "--batch", "2", "--seq", "16",
            "--ckpt-every", "2", "--lr", "1e-3")

    def launch(ck, *extra, nproc=1):
        pre = ("-m", "repro_torch.distributed", "--nproc", str(nproc)) \
            if nproc > 1 else ()
        res = subprocess.run([sys.executable, *pre, "-m", *args,
                              "--ckpt-dir", str(tmp_path / ck), *extra],
                             cwd=tmp_path, capture_output=True, text=True,
                             timeout=300, env=child_env())
        assert res.returncode == 0, res.stderr[-4000:]
        return res.stdout

    out = launch("ck", "--steps", "2", "--model-parallel", "2", nproc=2)
    assert out.count("done at step 2") == 2
    assert "mesh {'data': 1, 'model': 2}" in out
    resumed = launch("ck", "--steps", "4")
    assert "resumed from step 2" in resumed and "done at step 4" in resumed
    launch("ck_whole", "--steps", "4")
    got, want = [CheckpointManager(str(tmp_path / ck)) for ck in
                 ("ck", "ck_whole")]
    assert got.all_steps()[-1] == want.all_steps()[-1] == 4
    d_got, d_want = got._step_dir(4), want._step_dir(4)
    files = sorted(f for f in os.listdir(d_want) if f.endswith(".npy"))
    assert files and files == sorted(f for f in os.listdir(d_got)
                                     if f.endswith(".npy"))
    for f in files:
        x, y = (np.load(os.path.join(d, f)) for d in (d_got, d_want))
        if x.dtype.kind != "f":
            np.testing.assert_array_equal(x, y)
            continue
        scale = max(float(np.abs(y).max()), 1e-30)
        assert float(np.abs(x.astype(np.float64) - y).max()) <= \
            1e-4 * scale, f
