"""Training: AdamW, the one-device train step and the fault-tolerant
loop."""
from .loop import LoopConfig, LoopState, TrainLoop
from .optimizer import (AdamWConfig, apply_updates, global_norm, init_state,
                        schedule)
from .step import (build_encoder_train_step, build_prefill_step,
                   build_serve_step, build_train_step, rules_total_dp)

__all__ = ["AdamWConfig", "LoopConfig", "LoopState", "TrainLoop",
           "apply_updates", "build_encoder_train_step", "build_prefill_step",
           "build_serve_step", "build_train_step", "global_norm",
           "init_state", "rules_total_dp", "schedule"]
