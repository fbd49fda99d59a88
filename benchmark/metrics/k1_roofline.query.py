"""K1's share of its roofline: the frozen least time of the window's
``segment_sum_lanes`` launches over its kernels' device time."""
from benchmark.core.readers import roofline_pct
from benchmark.core.trace import KernelTarget
from benchmark.roofline import k1_work

KERNEL = KernelTarget(
    key="K1", owner="pipelinedp_tpu_torch.ops.kernels.segsum",
    attr="segment_sum_lanes", work=k1_work,
    kernel_names=("segsum_lanes_kernel", "prep_kernel"))


def read(run):
    return roofline_pct(run, KERNEL.key, KERNEL.kernel_names)
