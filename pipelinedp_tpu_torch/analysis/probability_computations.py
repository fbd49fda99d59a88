"""Quantiles of the Laplace + Gaussian convolution, by Monte Carlo. A
copy of ``pipelinedp_tpu/analysis/probability_computations.py``: the
reference's sampler (``analysis/probability_computations.py:20-35``),
which draws from the module-global host RNG, and a batched variant that
draws one [num_calls, num_samples] matrix."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from pipelinedp_tpu_torch.ops import noise as noise_ops


def compute_sum_laplace_gaussian_quantiles(
        laplace_b: float,
        gaussian_sigma: float,
        quantiles: Sequence[float],
        num_samples: int,
        rng: Optional[np.random.Generator] = None) -> List[float]:
    """Monte-Carlo quantiles of Lap(b) + N(0, sigma) (reference :20-35)."""
    # lint: disable=rng-purity(host Monte-Carlo draws from the seed_host_rng generator unless the caller passes one)
    rng = rng or noise_ops._host_rng
    samples = rng.laplace(scale=laplace_b, size=num_samples) + rng.normal(
        loc=0, scale=gaussian_sigma, size=num_samples)
    return list(np.quantile(samples, quantiles))


def compute_sum_laplace_gaussian_quantiles_batch(
        laplace_bs: np.ndarray,
        gaussian_sigmas: np.ndarray,
        quantiles: Sequence[float],
        num_samples: int,
        rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Batched variant: row i gives quantiles of Lap(b_i) + N(0, s_i);
    returns [len(laplace_bs), len(quantiles)]. One vectorized draw replaces
    len(laplace_bs) Python-level sampler calls."""
    # lint: disable=rng-purity(host Monte-Carlo draws from the seed_host_rng generator unless the caller passes one)
    rng = rng or noise_ops._host_rng
    laplace_bs = np.asarray(laplace_bs, dtype=np.float64)[:, None]
    gaussian_sigmas = np.asarray(gaussian_sigmas, dtype=np.float64)[:, None]
    n = laplace_bs.shape[0]
    samples = rng.laplace(size=(n, num_samples)) * laplace_bs + rng.normal(
        size=(n, num_samples)) * gaussian_sigmas
    return np.quantile(samples, quantiles, axis=1).T
