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

The counterpart of the reference's ``run_py(code, devices=4)`` for the
port's multi-device code is :func:`run_ranks`: N local processes, one
per rank, under a ``torch.distributed`` process group
(:mod:`repro_torch.distributed`). Each launch gets a ``file://`` store in
a temporary directory of its own, so that launches never share a port.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time
from dataclasses import dataclass

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


@dataclass
class RankLaunch:
    """The processes of :func:`start_ranks`, one per rank, their output
    files and the launch's temporary directory."""
    procs: list
    outs: list
    errs: list
    directory: str


def start_ranks(code_or_argv, nprocs: int, *, env: dict | None = None
                ) -> RankLaunch:
    """Start ``nprocs`` local ranks of ``python -c code`` (a string) or
    ``python <argv...>`` (a list), each with ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE`` and a ``file://`` store in a new
    temporary directory (:data:`repro_torch.distributed.STORE_ENV`), and
    the environment of :func:`child_env` over ``env``; unless that sets
    ``OMP_NUM_THREADS``, each rank gets its share of this host's cores,
    as ``torchrun`` does (idle intra-op threads of one rank otherwise
    spin on the cores the others' collectives need). Their output goes
    to files there; :func:`wait_ranks` reads it. The caller may work
    meanwhile."""
    from ..distributed import STORE_ENV
    argv = (["-c", textwrap.dedent(code_or_argv)]
            if isinstance(code_or_argv, str) else list(code_or_argv))
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    launch = RankLaunch([], [], [], tmp)
    try:
        for r in range(nprocs):
            e = child_env(env)
            e.setdefault("OMP_NUM_THREADS",
                         str(max(1, (os.cpu_count() or 1) // nprocs)))
            e.update(RANK=str(r), WORLD_SIZE=str(nprocs), LOCAL_RANK=str(r),
                     LOCAL_WORLD_SIZE=str(nprocs),
                     **{STORE_ENV: "file://" + os.path.join(tmp, "store")})
            launch.outs.append(os.path.join(tmp, f"rank{r}.out"))
            launch.errs.append(os.path.join(tmp, f"rank{r}.err"))
            with open(launch.outs[-1], "w") as out, \
                    open(launch.errs[-1], "w") as err:
                launch.procs.append(subprocess.Popen(
                    [sys.executable] + argv, stdout=out, stderr=err,
                    env=e))
    except BaseException:
        stop_ranks(launch)
        raise
    return launch


def stop_ranks(launch: RankLaunch) -> None:
    """End every rank of ``launch`` still running and remove its
    directory (what :func:`wait_ranks` does however it ends)."""
    for p in launch.procs:
        if p.poll() is None:
            p.kill()
    for p in launch.procs:
        p.wait()
    shutil.rmtree(launch.directory, ignore_errors=True)


def _read(path: str) -> str:
    with open(path, errors="replace") as f:
        return f.read()


def wait_ranks(launch: RankLaunch, timeout: float = 600) -> list[str]:
    """Wait for every rank of :func:`start_ranks` and return their
    stdout, rank by rank. The first rank that exits nonzero, or the
    ``timeout``, ends the others and raises :class:`SubprocessError` with
    that rank's output; every process has ended when this returns."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in launch.procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r = bad[0]
                raise SubprocessError(
                    f"rank {r} of {len(codes)} exited {codes[r]}:\n"
                    f"stderr: {_read(launch.errs[r])[-4000:]}\n"
                    f"stdout: {_read(launch.outs[r])[-2000:]}")
            if all(c == 0 for c in codes):
                return [_read(o) for o in launch.outs]
            if time.monotonic() > deadline:
                raise SubprocessError(
                    f"ranks still running after {timeout} s (exit codes "
                    f"{codes}); rank 0's stderr: "
                    f"{_read(launch.errs[0])[-4000:]}")
            time.sleep(0.05)
    finally:
        stop_ranks(launch)


def run_ranks(code_or_argv, nprocs: int, timeout: float = 600,
              env: dict | None = None) -> list[str]:
    """:func:`start_ranks` then :func:`wait_ranks`: each rank's stdout."""
    return wait_ranks(start_ranks(code_or_argv, nprocs, env=env), timeout)


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
