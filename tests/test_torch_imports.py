"""The port stands alone: nothing under src/repro_torch, and not
chip_smoke.py, imports jax or the reference package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_files_import_no_jax_or_reference():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [(str(f.relative_to(ROOT)), mod)
           for f in files for mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, f"port files import the reference or jax: {bad}"


def test_importing_the_port_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    code = ("import sys, repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.bridge, repro_torch.kernels.rwkv6.ops, "
            "repro_torch.models.rwkv, repro_torch.api, "
            "repro_torch.kernels.ssm.ops, repro_torch.models.ssm, "
            "repro_torch.configs.jamba_v0_1_52b, "
            "repro_torch.core.modelgraphs, repro_torch.core.baselines, "
            "repro_torch.core.runtime, repro_torch.analysis, "
            "repro_torch.conformance, repro_torch.conformance.matrix, "
            "repro_torch.train, repro_torch.data, repro_torch.checkpoint, "
            "repro_torch.launch.train, repro_torch.profiling, "
            "repro_torch.launch.dryrun, repro_torch.analysis.mutate, "
            "repro_torch.analysis.synth, repro_torch.analysis.__main__, "
            "repro_torch.conformance.subproc, repro_torch.launch.mesh, "
            "repro_torch.sharding, repro_torch.sharding.rules, "
            "repro_torch.pipeline, repro_torch.pipeline.pardnn_pp, "
            "repro_torch.distributed, repro_torch.train.compression; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "assert not bad, bad")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
