"""Checkpoint and resume of a stream, and the fault injection that tests
them (ROADMAP step 7)."""

from pipelinedp_tpu_torch.resilience.checkpoint import (CheckpointMismatch,
                                                        CheckpointStore,
                                                        StreamCheckpoint,
                                                        as_store)
from pipelinedp_tpu_torch.resilience.faults import (ChunkFailure,
                                                    FaultInjected, FaultPlan,
                                                    injected_faults)

__all__ = ["CheckpointMismatch", "CheckpointStore", "ChunkFailure",
           "FaultInjected", "FaultPlan", "StreamCheckpoint", "as_store",
           "injected_faults"]
