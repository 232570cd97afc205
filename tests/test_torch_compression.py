"""The port's int8 error-feedback all-reduce (``train/compression.py``)
against the reference's, over gloo ranks on the CPU.

``quantize_int8``, ``dequantize_int8``, ``init_error_state`` and
``compression_ratio`` run here in one process against the reference's
functions. ``make_compressed_psum`` runs over the ``pod`` axis of two
meshes, (4,) and (2, 2) over ("pod", "data"), for two steps, the second
carrying the first's error: the reference in one child on 4 forced host
devices with Auto mesh axes (``repro.conformance.subproc.run_py(code,
devices=4)``; under JAX 0.9's Explicit default its own test fails,
ROADMAP F8), the port in one launch of 4 ranks (``run_ranks``). Inputs
come from a numpy seed.

Tolerances: the reduced mean and the new errors 1e-6 of the reference's
(the same float32 arithmetic, an int32 sum); the mean within the
reference's bound, 0.03 of its largest magnitude, of the exact mean;
``residual + dequantized`` equal to the input within float32 rounding
(2 ulp of the scale).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402

from repro.conformance.subproc import run_py as jax_run_py  # noqa: E402
from repro.train import compression as jcomp  # noqa: E402
from repro_torch.conformance.subproc import run_ranks  # noqa: E402
from repro_torch.train import compression as tcomp  # noqa: E402

#: each mesh, and the gradient blocks the pod axis splits
MESHES = [((4,), ("pod",)), ((2, 2), ("pod", "data"))]
SHAPES = {"w": (32, 8), "b": (16,)}
BOUND = 0.03


def _key(shape) -> str:
    return "x".join(map(str, shape))


REFERENCE = """
import json, os, warnings
warnings.filterwarnings("ignore")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, PartitionSpec as P
from repro.train.compression import init_error_state, make_compressed_psum

d = os.environ["TEST_DIR"]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
out = {}
for shape, names in json.loads(os.environ["MESHES"]):
    n = int(np.prod(shape))
    mesh = jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:n])
    key = "x".join(map(str, shape))
    grads = {k: jnp.asarray(inp[f"{k}_{key}_1"]) for k in ("w", "b")}
    errors = init_error_state({k: v[0] for k, v in grads.items()})
    red, err = make_compressed_psum(mesh)(grads, errors)
    grads2 = {k: jnp.asarray(inp[f"{k}_{key}_2"]) for k in ("w", "b")}
    red2, err2 = make_compressed_psum(mesh, error_in_spec=P("pod"))(
        grads2, err)
    for k in ("w", "b"):
        out[f"red_{k}_{key}_1"] = np.asarray(red[k])
        out[f"err_{k}_{key}_1"] = np.asarray(err[k])
        out[f"red_{k}_{key}_2"] = np.asarray(red2[k])
        out[f"err_{k}_{key}_2"] = np.asarray(err2[k])
np.savez(os.path.join(d, "reference.npz"), **out)
print("OK")
"""

RANKS = """
import json, os
import numpy as np, torch
torch.set_num_threads(1)
from repro_torch.distributed import ProcessMesh, process_group
from repro_torch.launch.mesh import MeshShape
from repro_torch.train.compression import (init_error_state,
                                           make_compressed_psum)

d = os.environ["TEST_DIR"]
inp = dict(np.load(os.path.join(d, "inputs.npz")))
out = {}
with process_group("cpu"):
    for shape, names in json.loads(os.environ["MESHES"]):
        mesh = ProcessMesh(MeshShape(tuple(shape), tuple(names)), "cpu")
        key = "x".join(map(str, shape))
        pod = mesh.axis_index("pod")
        fn = make_compressed_psum(mesh)
        mesh.reset_moved()
        err = init_error_state({k: torch.zeros(inp[f"{k}_{key}_1"].shape[1:])
                                for k in ("w", "b")})
        for step in (1, 2):
            g = {k: torch.tensor(inp[f"{k}_{key}_{step}"][pod:pod + 1])
                 for k in ("w", "b")}
            red, new = fn(g, err)
            for k in ("w", "b"):
                out[f"red_{k}_{key}_{step}"] = red[k].numpy()
                out[f"err_{k}_{key}_{step}"] = new[k].numpy()
                out[f"in_{k}_{key}_{step}"] = (g[k] + err[k]).numpy()
            err = new
        out[f"moved_{key}"] = np.array(json.dumps(dict(mesh.moved)))
r = int(os.environ["RANK"])
np.savez(os.path.join(d, f"rank{r}.npz"), **out)
print("OK", r)
"""


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("compression")
    rng = np.random.default_rng(7)
    inputs = {}
    for shape, _ in MESHES:
        for step in (1, 2):
            for k, s in SHAPES.items():
                inputs[f"{k}_{_key(shape)}_{step}"] = rng.standard_normal(
                    (shape[0],) + s).astype(np.float32)
    np.savez(d / "inputs.npz", **inputs)
    env = {"TEST_DIR": str(d), "MESHES": json.dumps(MESHES)}
    setup = (f"import json, os\nos.environ.update(json.loads("
             f"{json.dumps(json.dumps(env))}))\n")
    assert "OK" in jax_run_py(setup + REFERENCE, devices=4, timeout=600)
    outs = run_ranks(RANKS, 4, timeout=300, env=env)
    assert all(f"OK {r}" in o for r, o in enumerate(outs)), outs
    return {"inputs": inputs, "ref": dict(np.load(d / "reference.npz")),
            "ranks": [dict(np.load(d / f"rank{r}.npz")) for r in range(4)]}


def _pod(shape, r: int) -> int:
    """The pod index of rank ``r`` on a mesh (row-major, pod first)."""
    return r // (4 // shape[0])


# ------------------------------------------------------- one process
@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_quantize_dequantize_match_reference(scale):
    x = (np.random.default_rng(1).standard_normal((64, 33)) * scale
         ).astype(np.float32)
    q, s = tcomp.quantize_int8(torch.tensor(x))
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
    np.testing.assert_allclose(tcomp.dequantize_int8(q, s).numpy(),
                               np.asarray(jcomp.dequantize_int8(jq, js)),
                               rtol=1e-6)


def test_error_state_and_ratio_match_reference():
    tree = {"a": torch.zeros(3, 4, dtype=torch.bfloat16),
            "b": [torch.zeros(5)]}
    e = tcomp.init_error_state(tree)
    assert e["a"].dtype == e["b"][0].dtype == torch.float32
    assert e["a"].shape == (3, 4) and not e["a"].any()
    for t, j in ((torch.bfloat16, jnp.bfloat16), (torch.float32,
                                                   jnp.float32)):
        assert tcomp.compression_ratio(t) == jcomp.compression_ratio(j)


# ------------------------------------------------------------- ranks
@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=_key)
@pytest.mark.parametrize("step", [1, 2])
def test_compressed_psum_matches_reference(run, mesh, step):
    """Every rank's mean and new error against the reference's, the
    second step carrying the first's error (``error_in_spec=P("pod")``
    there)."""
    key = _key(mesh)
    for r, o in enumerate(run["ranks"]):
        p = _pod(mesh, r)
        for k in SHAPES:
            np.testing.assert_allclose(
                o[f"red_{k}_{key}_{step}"],
                run["ref"][f"red_{k}_{key}_{step}"], rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(
                o[f"err_{k}_{key}_{step}"],
                run["ref"][f"err_{k}_{key}_{step}"][p:p + 1],
                rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=_key)
def test_compressed_psum_within_reference_bound(run, mesh):
    """The first step's mean within 0.03 of the exact mean's largest
    magnitude (the reference's bound), the same on every rank."""
    key = _key(mesh)
    for k in SHAPES:
        exact = run["inputs"][f"{k}_{key}_1"].mean(0)
        got = [o[f"red_{k}_{key}_1"][0] for o in run["ranks"]]
        rel = np.abs(got[0] - exact).max() / np.abs(exact).max()
        assert rel < BOUND, (k, rel)
        for g in got[1:]:
            np.testing.assert_array_equal(g, got[0])


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=_key)
def test_error_feedback_residual_plus_dequantized_is_input(run, mesh):
    """What each rank sent, dequantized, plus its new error is what it
    had (gradient + error carried in), within float32 rounding; the
    error is at most half the shared scale."""
    key = _key(mesh)
    for o in run["ranks"]:
        for step in (1, 2):
            for k in SHAPES:
                x = o[f"in_{k}_{key}_{step}"]
                e = o[f"err_{k}_{key}_{step}"]
                scale = float(np.max([np.abs(r[f"in_{k}_{key}_{step}"]).max()
                                      for r in run["ranks"]])) / 127 + 1e-12
                q = np.round((x - e) / scale)
                assert np.abs(q).max() <= 127
                np.testing.assert_allclose(e + q * np.float32(scale), x,
                                           rtol=0, atol=2 * np.spacing(
                                               np.float32(scale * 127)))
                assert np.abs(e).max() <= scale / 2 * (1 + 1e-5)


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES], ids=_key)
def test_compressed_psum_moves_int32_payload_and_one_scale(run, mesh):
    """Per tensor and step, one float32 pmax and one int32 psum of the
    block; on the (2, 2) mesh over the pod axis only."""
    key = _key(mesh)
    elems = sum(int(np.prod(s)) for s in SHAPES.values())
    for o in run["ranks"]:
        moved = json.loads(str(o[f"moved_{key}"]))
        assert moved == {"pmax": 2 * 4 * len(SHAPES), "psum": 2 * 4 * elems}
