"""Training loop with the reference's fault tolerance (port of
``repro.train.loop``):

  * checkpoint/restart — async checkpoints every ``checkpoint_every``
    steps, atomic; ``resume="auto"`` restarts from the newest one;
  * preemption — SIGTERM/SIGINT finish the step in flight, write a
    synchronous final checkpoint and end the loop (``preempted``);
  * straggler watchdog — a step slower than ``straggler_factor`` x the
    EWMA of step times is counted and logged;
  * non-finite steps — the optimizer skips them; the loop counts them.

Under several ranks (``shardings``, the placement of ``{"params",
"opt"}``: :func:`~repro_torch.train.step.train_state_shardings`) every
rank runs the loop; checkpoints are gathered and written by rank 0 and
restored by the placement. The final checkpoint is written unless the
last step's periodic one already holds that step (the loop waits for it
instead).

A step's time is read once its loss is on the host (``float(loss)``,
which waits for the card), as the reference reads it.
"""
from __future__ import annotations

import math
import signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable

from ..checkpoint.manager import CheckpointManager
from ..data.pipeline import DataIterator, make_batch


@dataclass
class LoopConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 2.5
    ewma_alpha: float = 0.1
    resume: str = "auto"            # "auto" | "none"


@dataclass
class LoopState:
    step: int = 0
    ewma_step_time: float = 0.0
    stragglers: int = 0
    skipped: int = 0
    preempted: bool = False
    history: list = field(default_factory=list)


class TrainLoop:
    def __init__(self, *, step_fn: Callable, params: Any, opt_state: Any,
                 data: DataIterator, ckpt: CheckpointManager | None,
                 cfg: LoopConfig, shardings: Any = None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.ckpt = ckpt
        self.cfg = cfg
        self.shardings = shardings
        self.state = LoopState()
        self._stop_requested = False
        self._orig_handlers: dict = {}

    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._stop_requested = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._orig_handlers[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread

    def _restore_signal_handlers(self):
        for sig, h in self._orig_handlers.items():
            signal.signal(sig, h)
        self._orig_handlers.clear()

    def maybe_resume(self) -> int:
        """Restore the newest checkpoint into the loop's parameters and
        optimizer state (in place) when ``resume == "auto"``; returns the
        step it resumes at (0 for none)."""
        if self.ckpt is None or self.cfg.resume != "auto":
            return 0
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0
        _, extra = self.ckpt.restore(
            {"params": self.params, "opt": self.opt_state}, step=latest,
            shardings=self.shardings)
        self.state.step = int(extra.get("step", latest))
        self.data.step = self.state.step
        return self.state.step

    def _checkpoint_tree(self) -> dict:
        return {"params": self.params, "opt": self.opt_state}

    def run(self) -> LoopState:
        self._install_signal_handlers()
        st = self.state
        saved = None
        try:
            start = st.step
            while st.step < self.cfg.total_steps:
                if self._stop_requested:
                    st.preempted = True
                    break
                batch = make_batch(self.data.cfg, st.step)
                t0 = time.perf_counter()
                self.params, self.opt_state, metrics = self.step_fn(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])  # waits: the true step time
                dt = time.perf_counter() - t0
                st.step += 1

                if st.ewma_step_time == 0.0:
                    st.ewma_step_time = dt
                else:
                    if dt > self.cfg.straggler_factor * st.ewma_step_time \
                            and st.step > start + 3:
                        st.stragglers += 1
                        print(f"[watchdog] step {st.step} took {dt:.3f}s "
                              f"(EWMA {st.ewma_step_time:.3f}s) — straggler")
                    a = self.cfg.ewma_alpha
                    st.ewma_step_time = (1 - a) * st.ewma_step_time + a * dt
                st.skipped += int(metrics.get("skipped", 0))
                gnorm = metrics.get("grad_norm")
                st.history.append(
                    {"step": st.step, "loss": loss, "time": dt,
                     "grad_norm": math.nan if gnorm is None
                     else float(gnorm)})
                if st.step % self.cfg.log_every == 0:
                    print(f"step {st.step}: loss={loss:.4f} "
                          f"({dt * 1e3:.0f} ms/step)")
                if (self.ckpt is not None
                        and st.step % self.cfg.checkpoint_every == 0):
                    self.ckpt.save_async(st.step, self._checkpoint_tree(),
                                         extra={"step": st.step},
                                         shardings=self.shardings)
                    saved = st.step
            # final checkpoint (synchronous: preemption-safe); the wait
            # makes a periodic one of this step durable instead
            if self.ckpt is not None:
                self.ckpt.wait()
                if saved != st.step:
                    self.ckpt.save(st.step, self._checkpoint_tree(),
                                   extra={"step": st.step},
                                   shardings=self.shardings)
        finally:
            self._restore_signal_handlers()
            self.data.close()
        return st


__all__ = ["LoopConfig", "LoopState", "TrainLoop"]
