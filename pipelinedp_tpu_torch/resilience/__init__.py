"""Checkpoint and resume of a stream, the fault injection that tests them,
and the clock and retry policy the live monitor and the health probes use.
The chaos harness and the fault transport are ROADMAP step 7b."""

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
                                                    injected_faults)

__all__ = ["CheckpointMismatch", "CheckpointStore", "ChunkFailure", "Clock",
           "FakeClock", "FaultInjected", "FaultPlan", "RetriesExhausted",
           "RetryPolicy", "StreamCheckpoint", "SystemClock", "as_store",
           "call_with_retry", "injected_faults"]
