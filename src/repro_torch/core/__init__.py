"""Marrow core on PyTorch — the paper's runtime for a CPU + CUDA host.

Layers (paper Fig. 2):
  Library  — :mod:`repro_torch.core.skeletons` (SCTs), :mod:`repro_torch.core.spec`
             (kernel interfaces, Vector/Scalar types, traits, merges).
  Runtime  — :mod:`repro_torch.core.scheduler` (Fig. 4 workflow),
             :mod:`repro_torch.core.faults` (fault taxonomy, deterministic
             injection, retry policy, device-health quarantine),
             :mod:`repro_torch.core.decomposition` (locality-aware domain
             decomposition), :mod:`repro_torch.core.distribution` (binary-search
             workload distribution), :mod:`repro_torch.core.autotuner`
             (Algorithm 1), :mod:`repro_torch.core.knowledge_base` (profiles +
             RBF/NN derivation), :mod:`repro_torch.core.load_balancer` (lbt),
             :mod:`repro_torch.core.platforms` (fission / CUDA-stream overlap),
             :mod:`repro_torch.core.occupancy` (GPU occupancy model),
             :mod:`repro_torch.core.executor` / :mod:`repro_torch.core.simulator`,
             :mod:`repro_torch.core.telemetry` (tracing, metrics, event log).
"""
from repro_torch.core.decomposition import (ConcretePartitioning, DecompositionError,
                                            DecompositionPlan, ExecutionSlot,
                                            build_plan, validate)
from repro_torch.core.distribution import (AdaptiveBinarySearch, Distribution,
                                           WorkloadDistributionGenerator,
                                           balance_until_stable, run_binary_search)
from repro_torch.core.executor import (ExecResult, Future, ResidentPartition,
                                       Session, ThreadedExecutor, from_numpy)
from repro_torch.core.graph import (GraphDriver, GraphError, GraphHandle,
                                    GraphResult, JobGraph, JobNode)
from repro_torch.core.faults import (DeviceFault, DeviceHealth, ExecutionError,
                                     FaultInjector,
                                     FaultPolicy, FaultRecord, PartitionLost,
                                     SlotFailure, SlotTimeout)
from repro_torch.core.knowledge_base import (KnowledgeBase, Origin, PlatformConfig,
                                             Profile, RBFNetwork)
from repro_torch.core.load_balancer import ExecutionStats, LoadBalancer
from repro_torch.core.platforms import (AcceleratorPlatform, DeviceInfo,
                                        FISSION_LEVELS, HostPlatform)
from repro_torch.core.scheduler import (GraphPlan, GraphPlanCache, NodePlan,
                                        PlanCache, ScheduledRun, Scheduler,
                                        infer_workload)
from repro_torch.core.simulator import CostModel, SimDevice, SimulatedExecutor
from repro_torch.core.skeletons import (SCT, KernelNode, Loop, LoopState, Map,
                                        MapReduce, Pipeline, kernel)
from repro_torch.core.spec import (ArgSpec, KernelSpec, MERGE_ADD, MERGE_DIV,
                                   MERGE_MUL, MERGE_SUB, Trait, Transfer, Workload,
                                   scalar, vector)
from repro_torch.core.telemetry import (Event, EventLog, MetricsRegistry,
                                        NULL_TELEMETRY, Telemetry, Tracer,
                                        metrics_block, validate_chrome_trace)
from repro_torch.core.autotuner import TunerParams, TuneResult, build_profile

__all__ = [n for n in dir() if not n.startswith("_")]
