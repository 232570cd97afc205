"""Build the port's CUDA sources into shared libraries at first use.

Each kernel keeps its sources in a ``csrc/`` folder with a plain
``extern "C"`` interface. :func:`load_library` compiles every ``*.cu``
there with ``nvcc`` (one process per source, all started together) and
links the objects into one shared library under
``build/repro_torch_kernels/`` at the repository root, named by a hash
of the sources and the flags, and loads it with ``ctypes``. A library
already built from the same sources is reused; nothing is built when a
module is imported. The ``ptxas`` report (registers, shared memory,
spills) is kept beside the library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# (name, csrc) -> the library loaded for it in this process
_LOADED: dict[tuple[str, Path], ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [str(Path(home) / "bin" / "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def library_path(name: str, csrc: Path) -> tuple[Path, list[Path]]:
    """(target .so path, .cu sources) for the sources in ``csrc``."""
    files = sorted(p for p in csrc.iterdir()
                   if p.suffix in (".cu", ".cuh", ".h"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    sources = [f for f in files if f.suffix == ".cu"]
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so", sources


def build(name: str, csrc: Path) -> Path:
    """Compile ``csrc``'s sources into the library (if not built yet)
    and return its path."""
    so, sources = library_path(name, csrc)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in sources]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [(src, p.communicate()[0], p.returncode)
                for src, p in zip(sources, procs)]
        for src, out, rc in logs:
            if rc != 0:
                raise RuntimeError(f"nvcc failed to compile {src.name} of "
                                   f"{name} (exit {rc}):\n{out}")
        target = str(Path(tmp) / so.name)
        res = subprocess.run([nvcc, "-shared", *NVCC_FLAGS[:2], "-o",
                              target, *objs], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {name} "
                               f"(exit {res.returncode}):\n{res.stderr}")
        so.with_suffix(".log").write_text("".join(out for _, out, _ in logs))
        os.replace(target, so)
    return so


def load_library(name: str, csrc: Path) -> ctypes.CDLL:
    """Build (if needed) and load the library for ``csrc``. Once loaded
    in a process it is returned as it is: the sources are not read and
    hashed again, which cost about a millisecond of host time per call
    (more than the sm90 flash kernel's device time)."""
    key = (name, Path(csrc))
    lib = _LOADED.get(key)
    if lib is None:
        lib = _LOADED[key] = ctypes.CDLL(str(build(name, csrc)))
    return lib


__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build", "library_path",
           "load_library"]
