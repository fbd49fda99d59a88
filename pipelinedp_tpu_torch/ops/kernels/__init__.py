"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version. A wrapper launches its kernel for CUDA tensors and takes the
plain version for CPU tensors; sources live in ``csrc/`` and build at
first use (``_build.py``), or all at once through :func:`build`."""

from pipelinedp_tpu_torch.ops.kernels.assign import (group_by_cell,
                                                     group_by_cell_plain)
from pipelinedp_tpu_torch.ops.kernels.hist import (subtree_counts_multi,
                                                   subtree_counts_multi_plain)
from pipelinedp_tpu_torch.ops.kernels.segkeyed import (key_layout,
                                                       segmented_sums,
                                                       segmented_sums_plain)
from pipelinedp_tpu_torch.ops.kernels.segscan import (bound_linf_l0,
                                                      bound_linf_l0_plain,
                                                      run_scan,
                                                      run_scan_plain)
from pipelinedp_tpu_torch.ops.kernels.segsum import (segment_sum_lanes,
                                                     segment_sum_lanes_plain,
                                                     segment_sum_wide,
                                                     segment_sum_wide_plain)
from pipelinedp_tpu_torch.ops.kernels.segtotal import (segment_totals,
                                                       segment_totals_plain)

__all__ = ["bound_linf_l0", "bound_linf_l0_plain", "build",
           "group_by_cell", "group_by_cell_plain", "key_layout",
           "run_scan", "run_scan_plain", "segmented_sums",
           "segmented_sums_plain",
           "segment_sum_lanes", "segment_sum_lanes_plain",
           "segment_sum_wide", "segment_sum_wide_plain",
           "segment_totals", "segment_totals_plain",
           "subtree_counts_multi", "subtree_counts_multi_plain"]


def build(sources) -> None:
    """Builds (or loads) the libraries of ``csrc/<source>.cu`` for each of
    ``sources`` now, one ``nvcc`` per source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    from pipelinedp_tpu_torch.ops.kernels import _build
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.load, sources))
