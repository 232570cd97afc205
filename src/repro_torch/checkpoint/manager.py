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
  on the caller's thread and writes on a background thread;
  :meth:`~CheckpointManager.wait` joins it and re-raises its error;
* ``keep_last`` removes old steps, never the newest;
* :meth:`~CheckpointManager.restore` checks the leaf count and every
  shape against a template tree and writes each leaf into the template's
  tensor (its device and dtype) **in place**, so that restoring needs no
  second copy of the model and optimizer state.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
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


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A leaf as the array the file holds: its values, or for a dtype
    numpy lacks its bytes (shape + (itemsize,), uint8). Always a copy:
    a CPU tensor may be updated in place while a background save writes
    it."""
    t = t.detach().to("cpu", copy=True).contiguous()
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

    def save(self, step: int, tree: Any, extra: dict | None = None) -> str:
        """Blocking save."""
        return self._write(step, *self._gather(tree), extra or {})

    def save_async(self, step: int, tree: Any,
                   extra: dict | None = None) -> None:
        """Copy to host now, write on a background thread."""
        self.wait()
        leaves, dtypes, structure = self._gather(tree)

        def work():
            try:
                self._write(step, leaves, dtypes, structure, extra or {})
            except Exception as e:  # surfaced by wait()
                self._save_error.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._save_error:
            raise self._save_error.pop()

    def _gather(self, tree: Any):
        leaves, structure = tree_flatten(tree)
        return ([_to_host(t) for t in leaves],
                [_dtype_name(t) for t in leaves], structure)

    def _write(self, step: int, host_leaves, dtypes, structure,
               extra: dict) -> str:
        final = self._step_dir(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        raw = [dt not in _NATIVE_DTYPES for dt in dtypes]
        index = {
            "step": step,
            "treedef": repr(structure),
            "num_leaves": len(host_leaves),
            "leaves": [{"file": f"arr_{i}.npy",
                        "shape": list(a.shape[:-1] if r else a.shape),
                        "dtype": dt, "raw": r}
                       for i, (a, dt, r) in enumerate(zip(host_leaves,
                                                          dtypes, raw))],
            "extra": extra,
            "time": time.time(),
            "num_devices_at_save": max(torch.cuda.device_count(), 1),
        }
        for i, a in enumerate(host_leaves):
            np.save(os.path.join(tmp, f"arr_{i}.npy"), a)
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

    def restore(self, target_tree: Any,
                step: int | None = None) -> tuple[Any, dict]:
        """Load step ``step`` (default: the newest) into the tensors of
        ``target_tree``, which must have the checkpoint's leaf count and
        shapes; values are cast to each target's dtype. Returns
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
        for i, (ref, meta) in enumerate(zip(leaves, index["leaves"])):
            if list(meta["shape"]) != list(ref.shape):
                raise ValueError(
                    f"leaf {i}: checkpoint shape {meta['shape']} != "
                    f"target {list(ref.shape)}")
        for i, (ref, meta) in enumerate(zip(leaves, index["leaves"])):
            a = np.load(os.path.join(d, meta["file"]))
            if meta.get("raw"):
                t = torch.from_numpy(np.ascontiguousarray(a).reshape(-1)) \
                    .view(_RAW_DTYPES[meta["dtype"]]).reshape(meta["shape"])
            else:
                t = torch.from_numpy(a)
            with torch.no_grad():
                ref.copy_(t)
        return target_tree, index["extra"]


__all__ = ["CheckpointManager"]
