"""Poisson-binomial PMF: exact (PGF convolution) and refined-normal
approximation. A copy of ``pipelinedp_tpu/analysis/poisson_binomial.py``
(capability parity with the reference's ``analysis/poisson_binomial.py``;
approximation per Hong 2013 §3.3)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
from scipy.stats import norm


@dataclass
class PMF:
    """PMF over integers: probability of value ``start + i`` is
    ``probabilities[i]``."""
    start: int
    probabilities: np.ndarray


def compute_pmf(probabilities: Sequence[float]) -> PMF:
    """Exact PMF via probability-generating-function convolution
    (reference :39-50)."""
    pmf = np.array([1.0])
    for p in probabilities:
        nxt = np.zeros(len(pmf) + 1)
        nxt[:-1] = pmf * (1 - p)
        nxt[1:] += pmf * p
        pmf = nxt
    return PMF(0, pmf)


def compute_exp_std_skewness(
        probabilities: Sequence[float]) -> Tuple[float, float, float]:
    p = np.asarray(probabilities, dtype=np.float64)
    exp = float(p.sum())
    var = float((p * (1 - p)).sum())
    std = float(np.sqrt(var))
    skewness = 0.0 if std == 0 else float(
        (p * (1 - p) * (1 - 2 * p)).sum() / std**3)
    return exp, std, skewness


def compute_pmf_approximation(mean: float, sigma: float, skewness: float,
                              n: int) -> PMF:
    """Refined-normal approximation with skewness correction over a
    +-8 sigma window; tails < 1e-15 dropped (reference :62-83)."""
    if sigma == 0:
        return PMF(int(round(mean)), np.array([1.0]))

    def G(x):
        return norm.cdf(x) + skewness * (1 - x * x) * norm.pdf(x) / 6

    start = max(0, int(np.floor(mean - 8 * sigma)))
    end = min(n, int(np.round(mean + 8 * sigma)))
    xs = np.arange(start - 1, end + 1)
    cdf_values = np.clip(G((xs + 0.5 - mean) / sigma), 0, 1)
    return PMF(start, np.diff(cdf_values))
