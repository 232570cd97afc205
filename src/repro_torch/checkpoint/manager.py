"""Atomic, asynchronous checkpoints of tensor trees (port of
``repro.checkpoint.manager``), in the reference's on-disk layout:

    <dir>/step_00001000.tmp/...   — written first
    <dir>/step_00001000/          — atomic os.rename on completion
        index.json                — leaf count, shapes, dtypes, extra
        arr_<n>.npy               — one file per leaf, in JAX's leaf order

so that a directory written by either package restores in the other:
leaves are numbered in the order :func:`repro_torch.tree.tree_flatten`
gives (JAX's: dict keys sorted), and a bfloat16 leaf (numpy has no
such dtype) is stored as its raw bytes, a uint8 array with
one more axis of the item size, marked ``"raw"`` in the index.

* the rename makes a crash mid-save leave the newest complete step as
  it was; a stale ``.tmp`` directory is ignored and removed at the next
  save;
* :meth:`CheckpointManager.save_async` copies the tree to host memory
  on the caller's thread and writes on a background thread (the files
  by several threads at once; a restore reads ahead the same way);
  :meth:`~CheckpointManager.wait` joins it and re-raises its error;
* ``keep_last`` removes old steps, never the newest;
* :meth:`~CheckpointManager.restore` checks the leaf count and every
  shape against a template tree and writes each leaf into the template's
  tensor (its device and dtype) **in place**, so that restoring needs no
  second copy of the model and optimizer state;
* over several ranks (``shardings``: a tree like the saved one of
  :class:`~repro_torch.distributed.NamedSharding`, each rank holding its
  blocks), a save gathers every leaf whole to rank 0's host memory and
  rank 0 alone writes it;
  a restore reads the whole leaf on every rank and keeps its block by
  the placement given, which may be over another number of ranks than
  the save's (the reference's elastic restore).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..tree import tree_flatten

_NATIVE_DTYPES = {"float64", "float32", "float16", "int64", "int32",
                  "int16", "int8", "uint64", "uint32", "uint16", "uint8",
                  "bool", "complex64", "complex128"}
#: dtypes stored as raw bytes, by the name numpy (ml_dtypes) gives them
_RAW_DTYPES = {"bfloat16": torch.bfloat16}
#: files written, and read ahead, at once: one writer left a disk's
#: bandwidth unused (a checkpoint is mostly a few files of GBs)
_IO_THREADS = 8


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor, copy: bool = True) -> np.ndarray:
    """A leaf as the array the file holds: its values, or for a dtype
    numpy lacks its bytes (shape + (itemsize,), uint8). A copy unless
    ``copy`` is false (a new host tensor no one else holds): a CPU tensor
    may be updated in place while a background save writes it."""
    t = t.detach().to("cpu", copy=copy).contiguous()
    name = _dtype_name(t)
    if name in _NATIVE_DTYPES:
        return t.numpy()
    if name not in _RAW_DTYPES:
        raise TypeError(f"cannot checkpoint a leaf of dtype {t.dtype}")
    return t.reshape(-1).view(torch.uint8).numpy().reshape(
        tuple(t.shape) + (t.element_size(),))


@dataclass
class CheckpointManager:
    directory: str
    keep_last: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._save_error: list = []
        # a sharded async save: wait() ends at a barrier of every rank
        self._sharded_pending = False

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: Any, extra: dict | None = None,
             shardings: Any = None) -> str:
        """Blocking save: each leaf is written as soon as it is on the
        host, while the next is copied (or gathered). With ``shardings``
        every rank calls it, rank 0 writes and the others return once it
        has written."""
        from ..distributed import rank
        leaves, structure = tree_flatten(tree)
        host = self._host_leaves(leaves, shardings)
        final = self._step_dir(step)
        if shardings is None or rank() == 0:
            final = self._write(step, host, [_dtype_name(t) for t in leaves],
                                structure, extra or {})
        else:
            for _ in host:          # this rank's part of every gather
                pass
        if shardings is not None:
            _barrier()
            if rank() != 0 and not os.path.isdir(final):
                raise FileNotFoundError(f"rank 0 wrote no {final}")
        return final

    def save_async(self, step: int, tree: Any, extra: dict | None = None,
                   shardings: Any = None) -> None:
        """Copy to host now, write on a background thread (with
        ``shardings``: gather now, on every rank; rank 0 writes)."""
        from ..distributed import rank
        self.wait()
        leaves, structure = tree_flatten(tree)
        host = list(self._host_leaves(leaves, shardings))
        self._sharded_pending = shardings is not None
        if shardings is not None and rank() != 0:
            return
        dtypes = [_dtype_name(t) for t in leaves]

        def work():
            try:
                self._write(step, host, dtypes, structure, extra or {})
            except Exception as e:  # surfaced by wait()
                self._save_error.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the background write and re-raise its error; after a
        sharded save, every rank returns once rank 0 has written."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._save_error:
            raise self._save_error.pop()
        if self._sharded_pending:
            self._sharded_pending = False
            _barrier()

    def _host_leaves(self, leaves: list, shardings: Any = None):
        """The arrays the files hold, leaf by leaf, as each reaches the
        host; with ``shardings`` each leaf is gathered whole to rank 0
        first, and the other ranks get None."""
        if shardings is None:
            yield from (_to_host(t) for t in leaves)
            return
        from ..distributed import rank
        places = tree_flatten(shardings)[0]
        if len(places) != len(leaves):
            raise ValueError(f"{len(places)} shardings for {len(leaves)} "
                             f"leaves")
        for t, sh in zip(leaves, places):
            whole = sh.gather_to_rank0(t)
            yield None if rank() != 0 else _to_host(whole, copy=False)

    def _write(self, step: int, host_leaves, dtypes, structure,
               extra: dict) -> str:
        """Write the arrays of ``host_leaves`` (an iterable: each file is
        written by a pool of threads as soon as its array comes), then
        the index, then rename the step into place."""
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        raw = [dt not in _NATIVE_DTYPES for dt in dtypes]
        shapes, writes = [], []
        with ThreadPoolExecutor(_IO_THREADS) as pool:
            for i, (a, r) in enumerate(zip(host_leaves, raw)):
                shapes.append(list(a.shape[:-1] if r else a.shape))
                writes.append(pool.submit(
                    np.save, os.path.join(tmp, f"arr_{i}.npy"), a))
                del a
            for w in writes:
                w.result()
        index = {
            "step": step,
            "treedef": repr(structure),
            "num_leaves": len(shapes),
            "leaves": [{"file": f"arr_{i}.npy", "shape": shape,
                        "dtype": dt, "raw": r}
                       for i, (shape, dt, r) in enumerate(zip(shapes, dtypes,
                                                              raw))],
            "extra": extra,
            "time": time.time(),
            "num_devices_at_save": _devices(),
        }
        with open(os.path.join(tmp, "index.json"), "w") as f:
            json.dump(index, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()
        return final

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep_last] if self.keep_last else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for name in os.listdir(self.directory):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)

    def restore(self, target_tree: Any, step: int | None = None,
                shardings: Any = None) -> tuple[Any, dict]:
        """Load step ``step`` (default: the newest) into the tensors of
        ``target_tree``, which must have the checkpoint's leaf count and
        shapes; values are cast to each target's dtype. With
        ``shardings`` (a tree like ``target_tree``) each target tensor is
        this rank's block of its leaf, and receives that block. Returns
        (target_tree, extra)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        d = self._step_dir(step)
        with open(os.path.join(d, "index.json")) as f:
            index = json.load(f)
        leaves = tree_flatten(target_tree)[0]
        if len(leaves) != index["num_leaves"]:
            raise ValueError(
                f"checkpoint has {index['num_leaves']} leaves, target tree "
                f"has {len(leaves)} — incompatible model/optimizer config")
        places = (tree_flatten(shardings)[0] if shardings is not None
                  else [None] * len(leaves))
        for i, (ref, meta, sh) in enumerate(zip(leaves, index["leaves"],
                                                places)):
            want = meta["shape"] if sh is None else \
                sh.shard_shape(meta["shape"])
            if list(want) != list(ref.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {meta['shape']} "
                    f"{'' if sh is None else f'(block {list(want)}) '}!= "
                    f"target {list(ref.shape)}")
        for (ref, meta, sh), a in zip(
                zip(leaves, index["leaves"], places),
                _read_ahead([os.path.join(d, m["file"])
                             for m in index["leaves"]])):
            if meta.get("raw"):
                t = torch.from_numpy(np.ascontiguousarray(a).reshape(-1)) \
                    .view(_RAW_DTYPES[meta["dtype"]]).reshape(meta["shape"])
            else:
                t = torch.from_numpy(a)
            with torch.no_grad():
                ref.copy_(t if sh is None else sh.shard(t))
        return target_tree, index["extra"]


def _read_ahead(paths: list[str]):
    """The arrays of ``paths`` in order, read by ``_IO_THREADS`` threads
    at most that many files ahead of the one the caller has."""
    with ThreadPoolExecutor(_IO_THREADS) as pool:
        ahead = [pool.submit(np.load, p) for p in paths[:_IO_THREADS]]
        for i in range(len(paths)):
            a = ahead[i].result()
            ahead[i] = None
            if i + _IO_THREADS < len(paths):
                ahead.append(pool.submit(np.load, paths[i + _IO_THREADS]))
            yield a


def _devices() -> int:
    """The devices the saved state was spread over: the ranks, or this
    process's cards."""
    from ..distributed import world_size
    return world_size() if world_size() > 1 else \
        max(torch.cuda.device_count(), 1)


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


__all__ = ["CheckpointManager"]
