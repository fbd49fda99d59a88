"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper launches its kernel for CUDA tensors and takes the
plain version for CPU tensors; sources live in ``csrc/`` and build at
first use (``_build.py``)."""

from pipelinedp_tpu_torch.ops.kernels.hist import (subtree_counts_multi,
                                                   subtree_counts_multi_plain)
from pipelinedp_tpu_torch.ops.kernels.segkeyed import (key_layout,
                                                       segmented_sums,
                                                       segmented_sums_plain)
from pipelinedp_tpu_torch.ops.kernels.segsum import (segment_sum_lanes,
                                                     segment_sum_lanes_plain,
                                                     segment_sum_wide,
                                                     segment_sum_wide_plain)
from pipelinedp_tpu_torch.ops.kernels.segtotal import (segment_totals,
                                                       segment_totals_plain)

__all__ = ["key_layout", "segmented_sums", "segmented_sums_plain",
           "segment_sum_lanes", "segment_sum_lanes_plain",
           "segment_sum_wide", "segment_sum_wide_plain",
           "segment_totals", "segment_totals_plain",
           "subtree_counts_multi", "subtree_counts_multi_plain"]
