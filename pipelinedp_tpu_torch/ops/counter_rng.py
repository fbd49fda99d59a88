"""Counter-based random bits keyed by content, in PyTorch.

Port of ``pipelinedp_tpu/ops/counter_rng.py``. ``row_bits`` is the
length-invariant tie-break stream of contribution bounding: element ``i``
is the first output lane of one Threefry-2x32 block over the counter
``(i, 0)``, so the same row draws the same bits however far the row axis
is padded. ``laplace`` and ``normal`` are the counter-keyed noise draws:
element ``i`` is a pure function of ``(key, x0[i], x1[i])``, which is how
VECTOR_SUM keys each coordinate's noise by (partition, coordinate). Their
``log1p`` and ``erf_inv`` are XLA's float32 algorithms (``ops/prng.py``),
so the draws are bit-equal to the JAX package's on the CPU and the card.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pipelinedp_tpu_torch.ops.prng import (key_words, threefry2x32,
                                           xla_erfinv, xla_log1p)

__all__ = ["threefry2x32", "row_bits", "laplace", "normal"]


def row_bits(key: torch.Tensor, n: int, device="cpu") -> torch.Tensor:
    """uint32 tie-break per row (int64 tensor [n]), a pure function of
    ``(key, row index)``."""
    k0, k1 = key_words(key)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    out, _ = threefry2x32(k0, k1, idx, torch.zeros_like(idx))
    return out


def _uniform_open01(bits: torch.Tensor) -> torch.Tensor:
    """float32 uniform on the open interval (0, 1) from uint32 bits (held
    in int64): the top 24 bits on a half-step-offset grid. ``m * 2^-24``
    is exact, so the one rounding is that of the add, as in XLA with or
    without a contracted FMA."""
    return ((bits >> 8).to(torch.float32) * 2.0**-24) + 2.0**-25


def laplace_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The inverse-CDF Laplace transform of uint32 bits (in int64)."""
    # ``_uniform_open01(bits) - 0.5``, as XLA computes it: it folds the
    # two constants into one (2^-25 - 0.5), so c is the exact
    # (2m + 1 - 2^24) * 2^-25, an integer below 2^24 times a power of
    # two, with no rounding of the uniform in between.
    c = (2 * (bits >> 8) + 1 - (1 << 24)).to(torch.float32) * 2.0**-25
    # The offset grid never lands on exactly 0.5, so sign(c) != 0.
    return -torch.sign(c) * xla_log1p(-2.0 * torch.abs(c))


#: ``sqrt(2)`` in float32, the factor of every Gaussian draw.
SQRT2_F32 = float(np.float32(math.sqrt(2.0)))


def erfinv_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``erf_inv`` of the open-interval uniform of uint32 bits (in int64),
    mapped to (-1, 1]: the top grid point rounds to 1.0, where XLA's
    ``erf_inv`` is +inf. A Gaussian draw is ``SQRT2_F32`` times it."""
    return xla_erfinv(_uniform_open01(bits) * 2.0 - 1.0)


def normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """``sqrt(2) * erf_inv`` of the open-interval uniform of uint32 bits
    (in int64)."""
    return SQRT2_F32 * erfinv_from_bits(bits)


def laplace(key: torch.Tensor, x0: torch.Tensor,
            x1: torch.Tensor) -> torch.Tensor:
    """Unit-scale Laplace noise keyed by counter content: float32, the
    shape of ``x0`` and ``x1`` (uint32 values in int64 tensors)."""
    k0, k1 = key_words(key)
    bits, _ = threefry2x32(k0, k1, x0, x1)
    return laplace_from_bits(bits)


def normal(key: torch.Tensor, x0: torch.Tensor,
           x1: torch.Tensor) -> torch.Tensor:
    """Unit-variance Gaussian noise keyed by counter content."""
    k0, k1 = key_words(key)
    bits, _ = threefry2x32(k0, k1, x0, x1)
    return normal_from_bits(bits)
