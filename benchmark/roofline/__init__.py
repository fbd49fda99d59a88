"""The benchmark's frozen yardstick: the H100's published peaks and the
least work of kernels K1, K3 and K5, copied from the port so that a later
change to the port cannot move them."""

from benchmark.roofline.peaks import H100_SXM, bound_s
from benchmark.roofline.work import Work, k1_work, k3_work, k5_work

__all__ = ["H100_SXM", "Work", "bound_s", "k1_work", "k3_work", "k5_work"]
