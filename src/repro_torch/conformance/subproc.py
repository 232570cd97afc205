"""Subprocess helpers: run a snippet or a conformance CLI in a fresh
Python process and parse its structured result (the port's side of
``repro.conformance.subproc``).

The reference's helpers exist to force a device count: a JAX process
locks it at first init, so a mesh of N host devices needs a child with
``XLA_FLAGS`` set before jax imports (``forced_mesh_env``). PyTorch
forces no device count: a child sees the cards the parent sees, and the
PEs of a plan fold onto them (``device_map``). What is left is a fresh
process with the port's ``src`` on ``PYTHONPATH``, so the helper that
builds its environment is :func:`child_env`, and the ``devices`` of
:func:`run_arch_subprocess` is the plan's PE count (K), passed to the
CLI's ``--devices``. Structured results cross the process boundary as a
last ``CONFORMANCE_JSON:`` line (:data:`JSON_MARK`).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

from .matrix import JSON_MARK


class SubprocessError(RuntimeError):
    """A child process failed; the message carries stderr/stdout."""


def repo_src_path() -> str:
    """Directory containing the ``repro_torch`` package (for
    PYTHONPATH)."""
    import repro_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(repro_torch.__file__)))


def child_env(base: dict | None = None) -> dict:
    """Environment for a child process: ``base`` (default: this
    process's) with the running checkout's ``src`` first on
    PYTHONPATH."""
    env = dict(os.environ if base is None else base)
    src = repo_src_path()
    pp = env.get("PYTHONPATH", "")
    if src not in pp.split(os.pathsep):
        env["PYTHONPATH"] = src + (os.pathsep + pp if pp else "")
    return env


def run_py(code: str, timeout: int = 600) -> str:
    """Run a python snippet in a child process; returns stdout, raises
    :class:`SubprocessError` on nonzero exit."""
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=timeout,
                       env=child_env())
    if r.returncode != 0:
        raise SubprocessError(
            f"subprocess exited {r.returncode}:\n{r.stderr[-4000:]}")
    return r.stdout


def start_json(argv: list[str]) -> subprocess.Popen:
    """Start ``python <argv...>`` in a child process, its output piped;
    :func:`wait_json` reads its result. The caller may work meanwhile."""
    return subprocess.Popen([sys.executable] + list(argv),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=child_env())


def wait_json(proc: subprocess.Popen, timeout: int = 900) -> dict:
    """Wait for a child from :func:`start_json` (killing it after
    ``timeout`` seconds, as ``subprocess.run`` does) and parse the last
    ``CONFORMANCE_JSON:`` line of its stdout as the structured result."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    argv = " ".join(proc.args[1:])
    if proc.returncode != 0:
        raise SubprocessError(
            f"{argv} exited {proc.returncode}:\n"
            f"stderr: {err[-4000:]}\nstdout: {out[-1000:]}")
    for line in reversed(out.splitlines()):
        if line.startswith(JSON_MARK):
            return json.loads(line[len(JSON_MARK):])
    raise SubprocessError(
        f"{argv}: no {JSON_MARK} payload in stdout:\n{out[-2000:]}")


def run_json(argv: list[str], timeout: int = 900) -> dict:
    """Run ``python <argv...>`` in a child process and parse the last
    ``CONFORMANCE_JSON:`` line of stdout as the structured result."""
    return wait_json(start_json(argv), timeout)


def run_arch_subprocess(arch: str, devices: int = 4, device=None,
                        fold: bool = False, timeout: int = 900,
                        extra_args: tuple = ()) -> dict:
    """Run one architecture's full conformance loop in a child process.

    Spawns ``python -m repro_torch.conformance.matrix --arch <arch>
    --devices <devices>`` (K PEs), with ``--device`` when given (the
    CLI's default is cuda) and ``--fold`` to fold the PEs onto fewer
    cards, and returns the conformance record (see
    :func:`repro_torch.conformance.run_conformance`). A record whose
    checks failed comes back as the CLI's exit code 1, which raises
    :class:`SubprocessError`.
    """
    argv = ["-m", "repro_torch.conformance.matrix", "--arch", arch,
            "--devices", str(int(devices))]
    if device is not None:
        argv += ["--device", str(device)]
    if fold:
        argv.append("--fold")
    return run_json(argv + list(extra_args), timeout=timeout)
