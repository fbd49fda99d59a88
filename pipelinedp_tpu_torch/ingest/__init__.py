"""The overlapped streaming ingest: a background stager
prepares batch b+1 while the device computes batch b, and an ordered fold
worker fetches and folds finished batches in batch order, so the float64
left fold and the checkpoints stay those of the serial stream. On by
default; ``PIPELINEDP_TPU_INGEST_EXECUTOR=0`` selects the serial stream.
A port of ``pipelinedp_tpu/ingest/executor.py``."""

from pipelinedp_tpu_torch.ingest.executor import (THREAD_PREFIX,
                                                  BackgroundStager,
                                                  IngestCancelled,
                                                  OrderedFoldWorker,
                                                  StagingRing,
                                                  executor_enabled)

__all__ = ["BackgroundStager", "IngestCancelled", "OrderedFoldWorker",
           "StagingRing", "THREAD_PREFIX", "executor_enabled"]
