from repro_torch.distributed.collectives import (multicast, multicast_group,
                                                 multicast_reference)
from repro_torch.distributed.pipeline import (PipelinedEngine, PipelineStage,
                                              pipelined_forward, stage_params,
                                              stages_from_flat)

__all__ = ["multicast", "multicast_group", "multicast_reference",
           "pipelined_forward", "stage_params", "stages_from_flat",
           "PipelineStage", "PipelinedEngine"]
