from repro_torch.serving.autoscaler import (Autoscaler, AutoscalerConfig,
                                            LoadSignals, ScaleDown, ScaleUp)
from repro_torch.serving.baselines import (POLICIES, FaaSNetPolicy,
                                           IdealPolicy, LambdaScalePolicy,
                                           NCCLPolicy, ServerlessLLMPolicy)
from repro_torch.serving.cluster import (LiveCluster, ModelDeployment,
                                         ScaleReport)
from repro_torch.serving.engine import (ContinuousBatchingEngine,
                                        InferenceEngine)
from repro_torch.serving.metrics import (MetricsLog, RequestMetric,
                                         ScaleEvent, percentile)
from repro_torch.serving.placement import PlacementArbiter, slo_pressure_of
from repro_torch.serving.scheduler import (ADMISSION_POLICIES, DEFAULT_SLOTS,
                                           AdmissionPolicy, EDFPolicy,
                                           Pending, Scheduler, SeqState,
                                           SlotState, StrictPriorityPolicy,
                                           instance_slot_count)
from repro_torch.serving.simulator import SimModel, SimResult, Simulator
from repro_torch.serving.tiers import (H800, ClusterState, HardwareProfile,
                                       LRUCache, ModelManager, ModelShard)
from repro_torch.serving.workload import (BATCH, INTERACTIVE, SLO_CLASSES,
                                          STANDARD, Request, SLOClass,
                                          assign_slo, burstgpt_like,
                                          constant_stress,
                                          make_shared_prefix_prompts,
                                          multi_model_trace)

__all__ = [
    "Autoscaler", "AutoscalerConfig", "LoadSignals", "ScaleUp", "ScaleDown",
    "MetricsLog", "RequestMetric", "ScaleEvent", "percentile",
    "InferenceEngine", "ContinuousBatchingEngine", "Scheduler", "SeqState",
    "SlotState", "DEFAULT_SLOTS", "instance_slot_count",
    "AdmissionPolicy", "EDFPolicy", "StrictPriorityPolicy", "Pending",
    "ADMISSION_POLICIES", "PlacementArbiter", "slo_pressure_of",
    "Simulator", "SimResult", "SimModel",
    "LiveCluster", "ModelDeployment", "ScaleReport",
    "HardwareProfile", "H800", "ClusterState", "ModelManager", "ModelShard",
    "LRUCache", "POLICIES",
    "LambdaScalePolicy", "ServerlessLLMPolicy", "FaaSNetPolicy",
    "NCCLPolicy", "IdealPolicy", "Request", "burstgpt_like",
    "constant_stress", "multi_model_trace",
    "SLOClass", "SLO_CLASSES", "INTERACTIVE", "STANDARD", "BATCH",
    "assign_slo", "make_shared_prefix_prompts",
]
