"""ParDNN-planned pipeline stages (port of ``repro.pipeline``): the
layer-chain planners of :mod:`.pardnn_pp`."""
from .pardnn_pp import (StagePlan, config_stage_plan, layer_flops,
                        plan_stages, plan_stages_emulated,
                        stack_stage_params, uniform_plan)

__all__ = ["StagePlan", "config_stage_plan", "layer_flops", "plan_stages",
           "plan_stages_emulated", "stack_stage_params", "uniform_plan"]
