"""Fault tolerance: checkpoints, replica chains, recovery, elasticity,
straggler speculation, retries, seeded chaos schedules, and the worker
leases and heartbeats of the multi-process launch (``health.py``).
"""
from repro_torch.runtime.checkpoint import (CheckpointCorruption,
                                            CheckpointManager,
                                            atomic_write_json)
from repro_torch.runtime.chaos import ChaosConfig, generate_schedule
from repro_torch.runtime.elastic import (apply_route_buffer, grow,
                                         migrate_route_buffers, remap_state,
                                         reshard_tree)
from repro_torch.runtime.health import (HealthConfig, HealthMonitor,
                                        HealthReport, WorkerStatus,
                                        write_heartbeat)
from repro_torch.runtime.recovery import (FaultEvent, FaultPlan,
                                          FaultSchedule, ReplicaChain,
                                          ResilientDriver, ResilientResult,
                                          StratumRunner, as_schedule,
                                          pack_state, run_with_failure,
                                          unpack_state)
from repro_torch.runtime.retry import (IO_RETRYABLE, OperationTimeout,
                                       RecoveryExhausted, Retrier,
                                       RetryBudget, RetryPolicy)
from repro_torch.runtime.straggler import (SpeculationPolicy,
                                           StragglerMitigator)

__all__ = ["CheckpointManager", "CheckpointCorruption", "atomic_write_json",
           "ChaosConfig", "generate_schedule",
           "HealthConfig", "HealthMonitor", "HealthReport",
           "WorkerStatus", "write_heartbeat",
           "grow", "remap_state", "reshard_tree",
           "migrate_route_buffers", "apply_route_buffer",
           "StratumRunner", "run_with_failure", "FaultPlan", "FaultEvent",
           "FaultSchedule", "as_schedule",
           "ReplicaChain", "ResilientDriver", "ResilientResult",
           "pack_state", "unpack_state",
           "RetryPolicy", "RetryBudget", "Retrier", "RecoveryExhausted",
           "OperationTimeout", "IO_RETRYABLE",
           "SpeculationPolicy", "StragglerMitigator"]
