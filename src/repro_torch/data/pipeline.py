"""Deterministic synthetic token pipeline with background prefetch (port
of ``repro.data.pipeline``).

Each step's batch is a pure function of (seed, step, host slice): pure
numpy drawn from ``SeedSequence([seed, step, start])``, the reference's
stream, so the port's batches are bit-equal to the reference's, and
restoring a checkpoint at step N reproduces exactly the stream the
interrupted run would have seen, with no state file. Each process makes
only its slice of the global batch (:func:`_host_slice`): the reference
reads its slice from ``jax.process_index``/``process_count``, the port
from its rank and the world size (one process, one slice, without a
process group). Under tensor parallelism (``model_parallel`` > 1) the
ranks of one ``model`` group, consecutive in rank order as the mesh lays
them, read the same slice. Batches are numpy arrays; the train step
moves them to its device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 32000
    seed: int = 0
    embed_dim: int | None = None      # frontend-stub archs: emit embeddings
    prefetch: int = 2
    model_parallel: int = 1           # ranks that read the same slice


def _host_slice(cfg: DataConfig) -> tuple[int, int]:
    """(first row, rows) of this process's slice of the global batch."""
    from ..distributed import rank, world_size
    m = cfg.model_parallel
    per = cfg.batch_size // (world_size() // m)
    return rank() // m * per, per


def make_batch(cfg: DataConfig, step: int) -> dict:
    """Pure: (cfg, step, host slice) -> batch dict of numpy arrays."""
    start, per = _host_slice(cfg)
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, start]))
    if cfg.embed_dim:
        emb = rng.standard_normal(
            (per, cfg.seq_len, cfg.embed_dim)).astype(np.float32) * 0.1
        tgt = rng.integers(0, cfg.vocab_size,
                           (per, cfg.seq_len)).astype(np.int32)
        return {"embeds": emb, "targets": tgt}
    toks = rng.integers(0, cfg.vocab_size,
                        (per, cfg.seq_len + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


class DataIterator:
    """Prefetching iterator over :func:`make_batch` from ``start_step``;
    a thread keeps up to ``cfg.prefetch`` batches ready. ``state()`` is
    just the step counter; :meth:`close` stops the thread."""

    def __init__(self, cfg: DataConfig, start_step: int = 0):
        self.cfg = cfg
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._next_to_produce = start_step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self):
        while not self._stop.is_set():
            b = make_batch(self.cfg, self._next_to_produce)
            self._next_to_produce += 1
            while not self._stop.is_set():
                try:
                    self._q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        b = self._q.get()
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5)


__all__ = ["DataConfig", "DataIterator", "make_batch"]
