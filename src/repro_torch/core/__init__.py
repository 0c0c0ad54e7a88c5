# λScale's primary contribution: λPipe — adaptive model multicast
# (binomial pipeline + k-way transmission), dynamically constructed
# execution pipelines, execute-while-load, and mode switching.
from repro_torch.core.blocks import (block_assignment, flatten_params,
                                     pack_block, pack_model,
                                     unflatten_params, unpack_block,
                                     unpack_model)
from repro_torch.core.ewl import ScalePlan, plan_scale
from repro_torch.core.mode_switch import recompute_cache, redistribute
from repro_torch.core.multicast import (LinkModel, Schedule,
                                        binomial_schedule,
                                        kway_block_orders, kway_schedule,
                                        optimal_steps)
from repro_torch.core.pipeline import (ExecutionPipeline, Stage,
                                       generate_pipelines,
                                       pipeline_ready_step)

__all__ = [
    "Schedule", "binomial_schedule", "kway_schedule", "kway_block_orders",
    "optimal_steps", "LinkModel", "ExecutionPipeline", "Stage",
    "generate_pipelines", "pipeline_ready_step", "ScalePlan", "plan_scale",
    "pack_block", "unpack_block", "pack_model", "unpack_model",
    "flatten_params", "unflatten_params", "block_assignment",
    "recompute_cache", "redistribute",
]
