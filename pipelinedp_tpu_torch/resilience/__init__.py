"""The resilience plane: checkpoint and resume of a stream, the fault
injection that tests it (in process or through ``PIPELINEDP_TPU_FAULTS``),
the injectable clock and the retry policy, the device-health probe with
its flagged degrade, and the mesh supervisor with the resilient mesh and
rendezvous (``health``). ``resilience.chaos`` is the seeded chaos
campaign over every fault seam (``python -m
pipelinedp_tpu_torch.resilience.chaos``); it loads only when named."""

from pipelinedp_tpu_torch.resilience.clock import (Clock, FakeClock,
                                                   SystemClock)
from pipelinedp_tpu_torch.resilience.retry import (RetriesExhausted,
                                                   RetryPolicy,
                                                   call_with_retry)
from pipelinedp_tpu_torch.resilience.checkpoint import (CheckpointMismatch,
                                                        CheckpointStore,
                                                        StreamCheckpoint,
                                                        as_store)
from pipelinedp_tpu_torch.resilience.faults import (ChunkFailure,
                                                    CoordinatorTimeout,
                                                    DeviceLost,
                                                    FaultInjected, FaultPlan,
                                                    ServeKill,
                                                    injected_faults)
from pipelinedp_tpu_torch.resilience.health import (
    HealthReport, MeshParticipantLost, MeshSupervisor,
    collective_failure_to_loss, ensure_device_or_degrade, probe_devices,
    resilient_init_process_group, resilient_make_mesh, supervisor_from_env)

__all__ = ["CheckpointMismatch", "CheckpointStore", "ChunkFailure", "Clock",
           "CoordinatorTimeout", "DeviceLost", "FakeClock", "FaultInjected",
           "FaultPlan", "HealthReport", "MeshParticipantLost",
           "MeshSupervisor", "RetriesExhausted", "RetryPolicy", "ServeKill",
           "StreamCheckpoint", "SystemClock", "as_store", "call_with_retry",
           "collective_failure_to_loss", "ensure_device_or_degrade",
           "injected_faults", "probe_devices",
           "resilient_init_process_group", "resilient_make_mesh",
           "supervisor_from_env"]
