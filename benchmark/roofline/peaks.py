"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, the
700 W part): 3.35 TB/s of HBM3, 67 TFLOP/s of float32 outside the tensor
cores (the rate taken for the kernels' int32 and float32 adds), and the
top SM clock of 1,980 MHz, at which one dependent float32 add takes four
cycles. A copy of the H100 row of ``pipelinedp_tpu_torch/obs/costs.py``'s
``DEVICE_PEAKS`` and of its ``kernel_bound``."""

from __future__ import annotations

H100_SXM = {
    "hbm_bytes_per_s": 3.35e12,
    "flops_per_s": 67e12,
    "sm_clock_hz": 1.98e9,
    "add_chain_cycles": 4,
}


def bound_s(work, peaks=H100_SXM) -> float:
    """The least seconds the card could take for ``work``: the larger of
    its bytes at the memory rate, its adds at the peak rate, and its
    longest chain of dependent adds at the top SM clock."""
    return max(work.bytes / peaks["hbm_bytes_per_s"],
               work.ops / peaks["flops_per_s"],
               work.chain * peaks["add_chain_cycles"] / peaks["sm_clock_hz"])
