"""Checkpoint and resume of a stream, the fault injection that tests them,
and the clock and retry policy the live monitor and the health probes use.
``health.DEGRADED_ENV`` arms the resident service's degraded mode. The
chaos harness and the fault transport are ROADMAP step 7b; the health
probe and the mesh supervisor step 5b."""

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
                                                    FaultInjected, FaultPlan,
                                                    ServeKill,
                                                    injected_faults)

__all__ = ["CheckpointMismatch", "CheckpointStore", "ChunkFailure", "Clock",
           "FakeClock", "FaultInjected", "FaultPlan", "RetriesExhausted",
           "RetryPolicy", "ServeKill", "StreamCheckpoint", "SystemClock",
           "as_store", "call_with_retry", "injected_faults"]
