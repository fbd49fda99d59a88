"""Counter-based random bits keyed by content, in PyTorch.

Port of the part of ``pipelinedp_tpu/ops/counter_rng.py`` that the fused
scalar path runs: ``row_bits``, the length-invariant tie-break stream of
contribution bounding. Element ``i`` is the first output lane of one
Threefry-2x32 block over the counter ``(i, 0)``, so the same row draws the
same bits however far the row axis is padded. The counter-keyed Laplace
and Gaussian node draws of the quantile walk come with the percentile
slice (ROADMAP step 5).
"""

from __future__ import annotations

import torch

from pipelinedp_tpu_torch.ops.prng import key_words, threefry2x32

__all__ = ["threefry2x32", "row_bits"]


def row_bits(key: torch.Tensor, n: int, device="cpu") -> torch.Tensor:
    """uint32 tie-break per row (int64 tensor [n]), a pure function of
    ``(key, row index)``."""
    k0, k1 = key_words(key)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    out, _ = threefry2x32(k0, k1, idx, torch.zeros_like(idx))
    return out
