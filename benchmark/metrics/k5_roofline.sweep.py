"""K5's share of its roofline: the frozen least time of the window's
``segmented_sums`` launches (bytes, or the longest add chain at the top
SM clock) over its kernels' device time."""
from benchmark.core.readers import roofline_pct
from benchmark.core.trace import KernelTarget
from benchmark.roofline import k5_work

KERNEL = KernelTarget(
    key="K5", owner="pipelinedp_tpu_torch.ops.kernels.segkeyed",
    attr="segmented_sums",
    work=lambda values, layout: k5_work(values, layout.offsets),
    kernel_names=("fold_ring", "fold_tiled"))


def read(run):
    return roofline_pct(run, KERNEL.key, KERNEL.kernel_names)
