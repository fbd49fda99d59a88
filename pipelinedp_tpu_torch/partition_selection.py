"""Partition-selection strategy factory: the import path and factory
signature of ``pipelinedp_tpu/partition_selection.py`` (parity with the
reference module ``pipeline_dp/partition_selection.py:19-33``). The
strategies live in ``pipelinedp_tpu_torch.ops.partition_selection``."""

from pipelinedp_tpu_torch.ops.partition_selection import (
    GaussianThresholdingPartitionStrategy,
    LaplaceThresholdingPartitionStrategy,
    PartitionSelectionStrategyBase,
    TruncatedGeometricPartitionStrategy,
    create_partition_selection_strategy,
)

__all__ = [
    "GaussianThresholdingPartitionStrategy",
    "LaplaceThresholdingPartitionStrategy",
    "PartitionSelectionStrategyBase",
    "TruncatedGeometricPartitionStrategy",
    "create_partition_selection_strategy",
]
