from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        InferenceEngine)
from repro_torch.serving.scheduler import (ADMISSION_POLICIES, DEFAULT_SLOTS,
                                           AdmissionPolicy, EDFPolicy,
                                           Scheduler, SeqState,
                                           StrictPriorityPolicy)
from repro_torch.serving.workload import (SLOClass,
                                          make_shared_prefix_prompts)

__all__ = ["ContinuousBatchingEngine", "InferenceEngine", "ADMISSION_POLICIES", "DEFAULT_SLOTS",
           "AdmissionPolicy", "EDFPolicy", "Scheduler", "SeqState",
           "StrictPriorityPolicy", "SLOClass", "make_shared_prefix_prompts"]
