"""Serving over a mesh (``build_prefill_step(..., mesh=)`` and
``build_serve_step(..., mesh=)``) against the reference, over gloo ranks
on the CPU: every block kind (GQA with windowed layers, a tied head and
uneven KV groups; MLA; MoE; RWKV6; Mamba), batched decode with the
caches' sequence cut over ``model`` and the context-parallel
``long_500k`` path (batch 1, the sequence cut over ``data``), MoE
routing groups that span the data-parallel ranks (with drops), the
caches' layout, and the reference's own serve step over a (2, 2) mesh.

The reference runs in one child process with 4 forced host devices: its
one-device ``prefill`` and ``decode_step`` (jit on the default device),
and its ``build_serve_step`` over an Auto (2, 2) mesh for the mesh
invariance case. The port runs in two launches of ranks
(``run_ranks``): 4 ranks on (1, 4), (2, 2) and (4, 1) over ("data",
"model"), then 2 on (1, 2); its one-rank steps (no mesh) run in this
process. Weights are the reference's, carried across as numpy (the MoE
drop case's router scaled so that capacity drops tokens); tokens and the
long-context caches come from numpy seeds.

Prompts are 4 rows of 512 tokens (2 groups of the MoE routing group,
which a rank of data 4 holds half of), then 8 decode steps fed fixed
tokens. A mesh whose ``model`` axis is m > 1 serves caches of m x 516
positions (1,032 or 2,064, at least the 1,024 that ``rules.cache_specs``
needs to cut a sequence), so the prompt ends 4 positions before the
first slice boundary and the decode steps write into the next rank's
slice; the slices past the position are fully masked. The reference's
logits do not depend on the caches' length past the tokens.

Tolerances: every step's logits within 1e-4 of the reference's
one-device logits and within 2e-5 of the port's one-rank steps'
(absolute), and the greedy tokens equal the reference's.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the ranks and the reference's child share the host with this process
torch.set_num_threads(2)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import repro.configs as jcfg  # noqa: E402
from repro.conformance.subproc import forced_mesh_env  # noqa: E402
import repro_torch.configs as tcfg  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.conformance.subproc import (start_ranks,  # noqa: E402
                                             stop_ranks, wait_ranks)
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.models import cache_spec  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train.step import (build_prefill_step,  # noqa: E402
                                    build_serve_step)
from repro_torch.tree import tree_flatten, tree_map  # noqa: E402

ALL = {"4": [[1, 4], [2, 2], [4, 1]], "2": [[1, 2]]}
#: per case: the arch, its reduced depth, overrides of the config, the
#: prompt (B rows of S tokens), the decode steps and the meshes (data,
#: model) by launch size
CASES = {
    "granite": dict(arch="granite-8b", layers=2, over={}, meshes=ALL),
    # 6 query heads over 2 ranks read KV heads 0, 0, 1 and 1, 2, 2
    "gqa63": dict(arch="granite-8b", layers=2,
                  over={"num_heads": 6, "num_kv_heads": 3},
                  meshes={"2": [[1, 2]]}),
    # 2 local prelude layers and a period of 5 local and 1 global, KV 1,
    # the head tied to the table
    "gemma3": dict(arch="gemma3-1b", layers=None,
                   over={"sliding_window": 64}, meshes=ALL),
    "mixtral": dict(arch="mixtral-8x7b", layers=None, over={}, meshes=ALL),
    # the MLA prelude layer and an mla_moe layer, absorbed
    "deepseek": dict(arch="deepseek-v2-lite-16b", layers=None, over={},
                     meshes=ALL),
    "rwkv6": dict(arch="rwkv6-7b", layers=2, over={}, meshes=ALL),
    # one period: 7 mamba and 1 attention mixers, MoE on 4 of them
    "jamba": dict(arch="jamba-v0.1-52b", layers=None, over={}, meshes=ALL),
}
B, S, STEPS = 4, 512, 8
#: the long-context cases: batch 1, caches of LONG_LEN positions filled
#: from a seed up to LONG_POS, LONG_STEPS decode steps from there (over
#: data 2 the slice boundary is at 1,024, over data 4 at 512 and 1,024;
#: gemma3's window of 64 masks whole slices)
LONG = ("gemma3", "rwkv6", "jamba")
LONG_MESHES = [[2, 2], [4, 1]]
LONG_LEN, LONG_POS, LONG_STEPS = 2048, 1020, 4
#: the MoE drop case: reduced mixtral at capacity factor 1 (the reduced
#: config's 2 gives 4 experts top-2 a capacity of every token), its
#: router scaled so that the routing is uneven enough that capacity
#: drops assignments; 16 rows of 64 (one routing group of 1,024 tokens,
#: split over data 2) and 16-token decode groups over data 2
DROP = dict(arch="mixtral-8x7b", B=16, S=64, scale=30.0,
            moe={"capacity_factor": 1.0},
            meshes={"4": [[2, 2]], "2": [[2, 1]]})

#: the case's config, in the reference's package or the port's (``mod``)
CFG = """
import dataclasses
def make_cfg(mod, case):
    cfg = mod.reduced(mod.get_config(case["arch"]), layers=case.get("layers"))
    if case.get("moe"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **case["moe"]))
    return dataclasses.replace(cfg, **case.get("over", {})).validate()
"""
exec(CFG)


def _cfg(mod, case):
    return make_cfg(mod, case)  # noqa: F821 (defined by CFG)


def _len(shape) -> int:
    """The caches' length on a mesh: m x (S + 4) over a model axis m >
    1, so that the first slice boundary falls 4 positions past the
    prompt; else 2 x S."""
    return shape[1] * (S + 4) if shape[1] > 1 else 2 * S


REFERENCE = CFG + """
import json, os, warnings
from functools import partial
warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
import repro.configs as jcfg
import repro.models as jm
from repro.configs.base import ShapeConfig
from repro.train.step import build_serve_step

d = os.environ["TEST_DIR"]
cases = json.loads(os.environ["CASES"])
S, STEPS = int(os.environ["S"]), int(os.environ["STEPS"])
P, LSTEPS = int(os.environ["LONG_POS"]), int(os.environ["LONG_STEPS"])

def load(name):
    return jax.tree_util.tree_map(jnp.asarray, dict(np.load(
        os.path.join(d, name), allow_pickle=True))["tree"].item())

def tree_save(name, tree):
    # renamed into place whole: the ranks read each as it appears
    np.savez(os.path.join(d, "part_" + name), tree=np.array(
        jax.tree_util.tree_map(np.asarray, tree), dtype=object))
    os.replace(os.path.join(d, "part_" + name), os.path.join(d, name))

# the weights first: the ranks read each case's as it appears
for i, (name, case) in enumerate(cases.items()):
    cfg = make_cfg(jcfg, case)
    # eager: one compile a config costs more than the draws
    params = jm.init_params(cfg, jax.random.PRNGKey(3 + i))
    if case.get("scale"):
        ffn = params["periods"]["b0"]["ffn"]
        ffn["router"] = ffn["router"] * case["scale"]
    tree_save(f"params_{name}.npz", params)
out = {}
for name, case in cases.items():
    cfg = make_cfg(jcfg, case)
    params = load(f"params_{name}.npz")
    inp = dict(np.load(os.path.join(d, f"inputs_{name}.npz")))
    s = inp["prompt"].shape[1]
    dec = jax.jit(partial(jm.decode_step, cfg))
    logits, caches = jax.jit(partial(jm.prefill, cfg), static_argnums=2)(
        params, {"tokens": jnp.asarray(inp["prompt"])}, s + STEPS)
    steps = [np.asarray(logits)]
    for t in range(STEPS):
        logits, caches = dec(params, caches, jnp.asarray(inp["next"][:, t:t + 1]),
                             jnp.int32(s + t))
        steps.append(np.asarray(logits))
    out[f"{name}_logits"] = np.stack(steps)
    if name in json.loads(os.environ["LONG"]):
        caches = load(f"long_caches_{name}.npz")
        steps = []
        for t in range(LSTEPS):
            logits, caches = dec(params, caches,
                                 jnp.asarray(inp["long_next"][:, t:t + 1]),
                                 jnp.int32(P + t))
            steps.append(np.asarray(logits))
        out[f"{name}_long_logits"] = np.stack(steps)
    if name == "granite":
        # the reference's own serve step over an Auto (2, 2) mesh of 4
        # host devices, against its one-device decode, from one prefill
        mesh = jax.make_mesh((2, 2), ("data", "model"),
                             axis_types=(AxisType.Auto,) * 2,
                             devices=jax.devices()[:4])
        L = 2 * S
        _, caches = jax.jit(partial(jm.prefill, cfg), static_argnums=2)(
            params, {"tokens": jnp.asarray(inp["prompt"])}, L)
        one = jax.tree_util.tree_map(jnp.copy, caches)
        built = build_serve_step(cfg, mesh, ShapeConfig(
            "d", L, inp["prompt"].shape[0], "decode"), donate=False)
        worst = 0.0
        for t in range(STEPS):
            tok = jnp.asarray(inp["next"][:, t:t + 1])
            _, lm, caches = built.fn(params, caches, tok, jnp.int32(s + t))
            l1, one = dec(params, one, tok, jnp.int32(s + t))
            worst = max(worst, float(jnp.abs(lm - l1).max()))
        out["mesh_invariance"] = np.array(worst)
        out["mesh_devices"] = np.array(len(jax.devices()))
np.savez(os.path.join(d, "reference.npz"), **out)
print("OK")
"""

RANKS = CFG + """
import json, os, time
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.bridge import params_from_numpy
import repro_torch.configs as tcfg
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed import ProcessMesh, process_group, world_size
from repro_torch.launch.mesh import MeshShape
from repro_torch.train.step import (build_prefill_step, build_serve_step,
                                    shard_caches, shard_params)
from repro_torch.tree import tree_flatten

d = os.environ["TEST_DIR"]
cases = json.loads(os.environ["CASES"])
S, STEPS = int(os.environ["S"]), int(os.environ["STEPS"])
P, LSTEPS = int(os.environ["LONG_POS"]), int(os.environ["LONG_STEPS"])
LONG_LEN = int(os.environ["LONG_LEN"])
out = {}

def tree(name):
    t0 = time.time()
    while not os.path.exists(os.path.join(d, name)):
        assert time.time() - t0 < 300, f"no {name} from the reference"
        time.sleep(0.05)
    return params_from_numpy(dict(np.load(os.path.join(d, name),
                                          allow_pickle=True))["tree"].item(),
                             "cpu")

with process_group("cpu") as backend:
    n, r = world_size(), torch.distributed.get_rank()
    out["backend"] = np.array(backend)
    for name, case in cases.items():
        cfg = make_cfg(tcfg, case)
        params = tree(f"params_{name}.npz")
        inp = dict(np.load(os.path.join(d, f"inputs_{name}.npz")))
        rows, s = inp["prompt"].shape
        for shape in case["meshes"].get(str(n), []):
            m = ProcessMesh(MeshShape(tuple(shape), ("data", "model")), "cpu")
            key = f"{name}_{shape[0]}x{shape[1]}"
            L = shape[1] * (s + 4) if shape[1] > 1 else 2 * s
            per = rows // shape[0]
            mine = slice(m.axis_index("data") * per,
                         (m.axis_index("data") + 1) * per)
            blocks = shard_params(params, m)
            logits, caches = build_prefill_step(cfg, L, "cpu", m)(
                blocks, {"tokens": torch.as_tensor(inp["prompt"][mine])})
            step = build_serve_step(cfg, ShapeConfig("d", L, rows, "decode"),
                                    "cpu", m)
            got, toks = [logits], []
            for t in range(STEPS):
                # a 0-d position, and on odd steps the rows' (B,) tensor
                pos = torch.tensor(s + t, dtype=torch.int32)
                if t % 2:
                    pos = pos.expand(per).clone()
                tok, logits, caches = step(
                    blocks, caches, inp["next"][mine, t:t + 1], pos)
                got.append(logits)
                toks.append(tok)
            out[f"{key}_logits"] = torch.stack(got).numpy()
            out[f"{key}_tokens"] = torch.stack(toks).numpy()
            out[f"{key}_cache_shapes"] = np.array(json.dumps(
                [list(t.shape) for t in tree_flatten(caches)[0]]))
        if name in json.loads(os.environ["LONG"]) and n == 4:
            whole = tree(f"long_caches_{name}.npz")
            for shape in json.loads(os.environ["LONG_MESHES"]):
                m = ProcessMesh(MeshShape(tuple(shape), ("data", "model")),
                                "cpu")
                key = f"{name}_long_{shape[0]}x{shape[1]}"
                blocks = shard_params(params, m)
                caches = shard_caches(whole, m, long_context=True)
                out[f"{key}_cache_shapes"] = np.array(json.dumps(
                    [list(t.shape) for t in tree_flatten(caches)[0]]))
                step = build_serve_step(
                    cfg, ShapeConfig("long", LONG_LEN, 1, "decode"), "cpu", m)
                got, toks = [], []
                for t in range(LSTEPS):
                    tok, logits, caches = step(
                        blocks, caches, inp["long_next"][:, t:t + 1],
                        torch.tensor(P + t, dtype=torch.int32))
                    got.append(logits)
                    toks.append(tok)
                out[f"{key}_logits"] = torch.stack(got).numpy()
                out[f"{key}_tokens"] = torch.stack(toks).numpy()
np.savez(os.path.join(d, f"ranks{n}_{r}.npz"), **out)
print("OK", r)
"""


def _all_cases() -> dict:
    """Every case the children run: :data:`CASES` (B x S prompts) and
    the MoE drop case."""
    return dict({k: dict(v, B=B, S=S) for k, v in CASES.items()},
                drop=dict(DROP, layers=None, over={}))


def _env(d) -> dict:
    return {"TEST_DIR": str(d), "CASES": json.dumps(_all_cases()),
            "S": str(S), "STEPS": str(STEPS), "LONG": json.dumps(LONG),
            "LONG_MESHES": json.dumps(LONG_MESHES),
            "LONG_LEN": str(LONG_LEN), "LONG_POS": str(LONG_POS),
            "LONG_STEPS": str(LONG_STEPS)}


def _fill_long_caches(cfg, seed: int) -> dict:
    """Caches of batch 1 and LONG_LEN positions, every leaf drawn from a
    numpy seed (the recurrent states too), as numpy."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda t: rng.standard_normal(tuple(t.shape)).astype(
        np.float32), cache_spec(cfg, 1, LONG_LEN))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Inputs, the reference's results and both launches'."""
    d = tmp_path_factory.mktemp("serve_mesh")
    rng = np.random.default_rng(0)
    for i, (name, case) in enumerate(_all_cases().items()):
        jc = _cfg(jcfg, case)
        arrays = {
            "prompt": rng.integers(0, jc.vocab_size, (case["B"], case["S"]),
                                   np.int32),
            "next": rng.integers(0, jc.vocab_size, (case["B"], STEPS),
                                 np.int32)}
        if name in LONG:
            arrays["long_next"] = rng.integers(0, jc.vocab_size,
                                               (1, LONG_STEPS), np.int32)
            np.savez(d / f"long_caches_{name}.npz", tree=np.array(
                _fill_long_caches(_cfg(tcfg, case), 10 + i), dtype=object))
        np.savez(d / f"inputs_{name}.npz", **arrays)
    setup = (f"import json, os\nos.environ.update(json.loads("
             f"{json.dumps(json.dumps(_env(d)))}))\n")
    # the reference writes the weights first, then computes its results
    # while the ranks run
    ref = subprocess.Popen([sys.executable, "-c", setup + REFERENCE],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True, env=forced_mesh_env(4))
    res = {"dir": d}
    launches = []
    try:
        # both launches while the reference runs, and the one-rank steps
        # here meanwhile; each reads a case's weights as they appear
        for n in (4, 2):
            launches.append(start_ranks(RANKS, n, env=_env(d)))
        res["one"] = {name: _one_rank(d, name, case, ref)
                      for name, case in _all_cases().items()}
        for n, launch in zip((4, 2), launches):
            outs = wait_ranks(launch, timeout=600)
            assert all(f"OK {r}" in o for r, o in enumerate(outs)), outs
        out, err = ref.communicate(timeout=900)
    finally:
        for launch in launches:
            stop_ranks(launch)
        if ref.poll() is None:
            ref.kill()
            ref.communicate()
    assert ref.returncode == 0 and "OK" in out, err[-4000:]
    res["ref"] = dict(np.load(d / "reference.npz"))
    for n in (4, 2):
        res[n] = [dict(np.load(d / f"ranks{n}_{r}.npz")) for r in range(n)]
    return res


def _inputs(d, name):
    return dict(np.load(d / f"inputs_{name}.npz"))


def _params(d, name, ref=None):
    """The case's weights, once the reference (the process ``ref``) has
    written them."""
    while not (d / f"params_{name}.npz").exists():
        if ref is not None and ref.poll() is not None:
            raise AssertionError(ref.communicate()[1][-4000:])
        time.sleep(0.05)
    return params_from_numpy(dict(np.load(
        d / f"params_{name}.npz", allow_pickle=True))["tree"].item(), "cpu")


def _one_rank(d, name, case, ref=None):
    """The port's steps without a mesh on the whole batch: the prefill's
    and every decode step's logits, (STEPS + 1, B, 1, V), and those of
    the long-context steps where the case has them."""
    cfg = _cfg(tcfg, case)
    params = _params(d, name, ref)
    inp = _inputs(d, name)
    rows, s = inp["prompt"].shape
    logits, caches = build_prefill_step(cfg, 2 * s, "cpu")(
        params, {"tokens": inp["prompt"]})
    step = build_serve_step(cfg, ShapeConfig("d", 2 * s, rows, "decode"),
                            "cpu")
    got = [logits]
    for t in range(STEPS):
        _, logits, caches = step(params, caches, inp["next"][:, t:t + 1],
                                 torch.tensor(s + t, dtype=torch.int32))
        got.append(logits)
    res = {"logits": torch.stack(got).numpy()}
    if name in LONG:
        caches = params_from_numpy(dict(np.load(
            d / f"long_caches_{name}.npz", allow_pickle=True))
            ["tree"].item(), "cpu")
        step = build_serve_step(cfg, ShapeConfig("l", LONG_LEN, 1, "decode"),
                                "cpu")
        got = []
        for t in range(LONG_STEPS):
            _, logits, caches = step(params, caches,
                                     inp["long_next"][:, t:t + 1],
                                     torch.tensor(LONG_POS + t,
                                                  dtype=torch.int32))
            got.append(logits)
        res["long_logits"] = torch.stack(got).numpy()
    return res


@pytest.fixture(scope="module")
def one_rank(run):
    return run["one"]


def _meshes(meshes):
    return [(int(n), tuple(s)) for n, ss in
            sorted(meshes.items(), key=lambda kv: -int(kv[0])) for s in ss]


MESH_CASES = [(name, n, s) for name in CASES
              for n, s in _meshes(CASES[name]["meshes"])]
LONG_CASES = [(name, 4, tuple(s)) for name in LONG for s in LONG_MESHES]
DROP_CASES = [("drop", n, s) for n, s in _meshes(DROP["meshes"])]


def _ids(c):
    return f"{c[0]}-{c[2][0]}x{c[2][1]}"


def _hold(got, want, one, tol_ref=1e-4, tol_one=2e-5):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol_ref)
    np.testing.assert_allclose(got, one, rtol=0, atol=tol_one)


def _rows(n_data: int, r: int, rows: int, shape) -> slice:
    per = rows // n_data
    di = r // shape[1]
    return slice(di * per, (di + 1) * per)


# ----------------------------------------------------------- batched
def test_ranks_run_over_gloo_on_the_cpu(run):
    assert all(str(o["backend"]) == "gloo" for n in (4, 2) for o in run[n])


@pytest.mark.parametrize("case", MESH_CASES + DROP_CASES, ids=_ids)
def test_prefill_and_decode_match_reference(run, one_rank, case):
    """The prefill's last logits and 8 decode steps' logits on every rank
    (its rows) against the reference's one-device steps (1e-4) and the
    port's one-rank steps (2e-5), the decode crossing from rank 0's
    slice of the caches into rank 1's where ``model`` cuts them; the
    position a 0-d tensor on even steps and the rank's rows' (B,) tensor
    on odd ones."""
    name, n, shape = case
    want = run["ref"][f"{name}_logits"]
    one = one_rank[name]["logits"]
    _hold(one, want, one)
    rows = want.shape[1]
    for r, o in enumerate(run[n]):
        mine = _rows(shape[0], r, rows, shape)
        _hold(o[f"{name}_{shape[0]}x{shape[1]}_logits"], want[:, mine],
              one[:, mine])


@pytest.mark.parametrize("case", MESH_CASES + DROP_CASES, ids=_ids)
def test_greedy_tokens_match_reference(run, case):
    """Each decode step's greedy token on every rank is the argmax of the
    reference's logits for its rows."""
    name, n, shape = case
    want = run["ref"][f"{name}_logits"][1:].argmax(-1)      # (STEPS, B, 1)
    for r, o in enumerate(run[n]):
        mine = _rows(shape[0], r, want.shape[1], shape)
        np.testing.assert_array_equal(
            o[f"{name}_{shape[0]}x{shape[1]}_tokens"], want[:, mine])


def _whole_cache(name, case, batch, length):
    return cache_spec(_cfg(tcfg, case), batch, length)


@pytest.mark.parametrize("case", [c for c in MESH_CASES
                                  if c[0] in ("granite", "deepseek",
                                              "rwkv6", "jamba")], ids=_ids)
def test_cache_blocks_follow_serve_cache_specs(run, case):
    """Every rank's cache leaves after the decode steps have the shapes
    of its blocks by ``rules.serve_cache_specs``: the rows over data and
    the KV (or latent) sequence over model, m x 516 positions cut into
    slices of 516; RWKV6's ``S`` by heads and Mamba's states by channels
    over model."""
    name, n, shape = case
    mesh = MeshShape(shape, ("data", "model"))
    whole = _whole_cache(name, CASES[name], B, _len(shape))
    specs = rules.spec_leaves(rules.serve_cache_specs(
        mesh, whole, long_context=False), whole)
    from repro_torch.distributed import NamedSharding, TracingMesh
    want = [list(NamedSharding(TracingMesh(mesh, 0, "cpu"), sp)
                 .shard_shape(t.shape))
            for sp, t in zip(specs, tree_flatten(whole)[0])]
    for o in run[n]:
        assert json.loads(str(o[f"{name}_{shape[0]}x{shape[1]}"
                                f"_cache_shapes"])) == want
    if name == "granite" and shape[1] > 1:
        assert want[0][2] == S + 4                 # (P, rows, slice, KV, hd)


# ----------------------------------------------------------- long
@pytest.mark.parametrize("case", LONG_CASES, ids=_ids)
def test_long_context_decode_matches_reference(run, one_rank, case):
    """``long_500k``'s path at batch 1: the caches' sequence cut over
    ``data`` (context parallelism), the rank's heads or channels over
    ``model``; 4 decode steps from caches filled from a seed, crossing
    a slice boundary, against the reference (1e-4) and the port's
    one-rank steps (2e-5), and the greedy tokens equal."""
    name, n, shape = case
    want = run["ref"][f"{name}_long_logits"]
    one = one_rank[name]["long_logits"]
    _hold(one, want, one)
    for o in run[n]:
        key = f"{name}_long_{shape[0]}x{shape[1]}"
        _hold(o[f"{key}_logits"], want, one)
        np.testing.assert_array_equal(o[f"{key}_tokens"],
                                      want.argmax(-1))


def test_long_context_layout(run):
    """At long context (batch 1) the KV sequence is cut over data (2,048
    positions into slices of 1,024 or 512), and jamba's Mamba states hold
    the rank's channels over model, not over data."""
    for name, n, shape in LONG_CASES:
        if name != "jamba":
            continue
        cfg = _cfg(tcfg, CASES[name])
        got = json.loads(str(run[n][0][f"jamba_long_{shape[0]}x{shape[1]}"
                                       f"_cache_shapes"]))
        whole = tree_flatten(cache_spec(cfg, 1, LONG_LEN))[0]
        di = cfg.d_model * cfg.mamba.expand
        for g, t in zip(got, whole):
            if len(t.shape) == 5:                     # k, v
                assert g[2] == LONG_LEN // shape[0]
            elif tuple(t.shape[2:]) == (di, cfg.mamba.d_state):   # h
                assert g[2] == di // shape[1]


# ----------------------------------------------------------- MoE
def test_moe_drop_case_drops_tokens(run):
    """The drop case's routing drops assignments in its prefill group and
    in its decode groups (the port's one-rank steps, whose logits equal
    the reference's): so its meshes, over data 2, hold the reference's
    capacity and drops, not their own."""
    from repro_torch.models import moe as M
    case = _all_cases()["drop"]
    real = M.route
    seen = []

    def spy(*a, **k):
        out = real(*a, **k)
        seen.append(1 - float(out[4].sum()) / float(out[3].sum()))
        return out
    M.route = spy
    try:
        _one_rank(run["dir"], "drop", case)
    finally:
        M.route = real
    assert seen[0] > 0 and max(seen[1:]) > 0, seen


def test_rank_groups_differ_from_the_reference_group():
    """Why the drop case matters: routed alone, a rank's 8 decode rows
    would form a group of 8 with capacity max(ceil(8 x 2 / 4), 4) = 4,
    where the reference's group of 16 has 8."""
    from repro_torch.models.moe import capacity
    cfg = _cfg(tcfg, _all_cases()["drop"])
    assert capacity(cfg, 8) == 4 and capacity(cfg, 16) == 8


# ----------------------------------------------------------- reference
def test_reference_serve_step_is_mesh_invariant(run):
    """The reference's own ``build_serve_step`` over an Auto (2, 2) mesh
    of 4 host devices equals its one-device decode within 1e-5 at every
    step: holding the port's meshes to the one-device reference is
    sound."""
    assert int(run["ref"]["mesh_devices"]) == 4
    assert float(run["ref"]["mesh_invariance"]) <= 1e-5


def test_serve_cache_specs_deviate_only_for_recurrent_states():
    """``rules.serve_cache_specs`` is ``rules.cache_specs`` for every
    leaf but RWKV6's ``S`` (heads over model) and Mamba's ``h`` and
    ``conv`` (channels over model, never over data), on the production
    mesh at full width, batched and at long context."""
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=True)
    for arch, batch, length, long_context in (
            ("rwkv6-7b", 128, 32768, False), ("rwkv6-7b", 1, 524288, True),
            ("jamba-v0.1-52b", 128, 32768, False),
            ("jamba-v0.1-52b", 1, 524288, True)):
        whole = cache_spec(tcfg.get_config(arch), batch, length)
        ref = rules.cache_specs(mesh, whole, long_context=long_context)
        got = rules.serve_cache_specs(mesh, whole, long_context=long_context)
        from repro_torch.sharding.rules import _paths
        for path in _paths(whole):
            a, b = rules._at(ref, path), rules._at(got, path)
            leaf = path[-1]
            if leaf == "S":
                assert b == (None, None if long_context else ("pod", "data"),
                             "model", None, None)
            elif leaf == "h":
                assert b == (None, None if long_context else ("pod", "data"),
                             "model", None)
            elif leaf == "conv":
                assert b == (None, None if long_context else ("pod", "data"),
                             None, "model")
            else:
                assert a == b, path
            if leaf in ("h", "conv") and not long_context:
                assert a == b          # the same layout in batched decode


def test_granite_decode_32k_slices_are_2048_positions():
    """granite-8b ``decode_32k`` on the production mesh: each rank holds
    4 rows x 2,048 positions of every KV head; at ``long_500k`` a rank of
    jamba's attention layer holds 32,768 positions."""
    from repro_torch.distributed import TracingMesh
    from repro_torch.launch.mesh import make_production_mesh
    mesh = TracingMesh(make_production_mesh(multi_pod=True), 0, "cpu")
    from repro_torch.train.step import cache_shardings
    cfg = tcfg.get_config("granite-8b")
    whole = cache_spec(cfg, 128, 32768)
    sh = cache_shardings(whole, mesh, False)
    k = sh["periods"]["b0"]["mix"]["k"].shard_shape(
        whole["periods"]["b0"]["mix"]["k"].shape)
    assert k == (cfg.num_periods, 4, 2048, cfg.num_kv_heads, cfg.head_dim)
    jc = tcfg.get_config("jamba-v0.1-52b")
    whole = cache_spec(jc, 1, 524288)
    sh = cache_shardings(whole, mesh, True)
    k = sh["periods"]["b4"]["mix"]["k"].shard_shape(
        whole["periods"]["b4"]["mix"]["k"].shape)
    assert k[2] == 32768
