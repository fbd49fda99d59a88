"""Private partition-selection strategies — replaces the PyDP/C++ strategies
used by the reference (``pipeline_dp/partition_selection.py:19-33``; consumed
at ``dp_engine.py:350-352`` via ``should_keep`` and at
``analysis/combiners.py:135-141`` via ``probability_of_keep``).

Each strategy exposes the PyDP-parity instance API

* ``should_keep(num_users) -> bool`` — one random keep decision, and
* ``probability_of_keep(num_users) -> float`` — the exact keep probability,

plus the vectorized forms the TPU path is built on:

* ``probabilities(counts: np.ndarray) -> np.ndarray`` — keep probability for
  every candidate partition in one shot, and
* for the fused XLA program: the truncated-geometric strategy materializes
  its keep-probability *table* (a 1-D array indexed by user count) and the
  thresholding strategies expose ``(threshold, noise_scale)`` scalars, so
  batched on-device selection is a gather/compare over the whole count
  vector — no per-partition Python.

Math notes
----------
Truncated geometric ("magic") selection follows Desfontaines-Voss-Gipson-
Mandayam, 'Differentially private partition selection' (PoPETs 2022): the
optimal keep-probability sequence obeys

    pi_0 = 0
    pi_n = min(e^eps' pi_{n-1} + delta',
               1 - e^{-eps'}(1 - pi_{n-1} - delta'),
               1)

with per-partition budget eps' = eps/m0 and delta' = 1-(1-delta)^(1/m0)
for a user contributing to at most m0 partitions (the C++ library's
adjustment). The sequence saturates at 1 after O((1/eps') log(1/delta'))
steps; we precompute it once into a dense table.

Laplace thresholding keeps a partition when ``n + Lap(b) >= T`` with
``b = m0/eps`` and T calibrated so a lone user's partition survives with
probability at most delta'. Gaussian thresholding splits delta evenly
between noise and threshold: sigma is the analytic-Gaussian sigma for
(eps, delta/2) at L2 sensitivity sqrt(m0), and T makes the lone-user
survival probability delta_threshold'.
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Union

import numpy as np

from pipelinedp_tpu_torch.aggregate_params import PartitionSelectionStrategy
from pipelinedp_tpu_torch.ops import noise as noise_ops

# Keep-probability tables longer than this are clamped (the tail is within
# float rounding of 1 anyway); guards pathological (tiny-eps) configs.
_MAX_TABLE_SIZE = 4_000_000


def _adjusted_delta(delta: float, max_partitions_contributed: int) -> float:
    """Per-partition delta: 1-(1-delta)^(1/m0) (~delta/m0 for small delta)."""
    if delta == 0:
        return 0.0
    return -math.expm1(math.log1p(-delta) / max_partitions_contributed)


class PartitionSelectionStrategyBase:
    """Common surface of all strategies (PyDP-parity + vectorized)."""

    def __init__(self, epsilon: float, delta: float,
                 max_partitions_contributed: int,
                 pre_threshold: Optional[int] = None):
        if epsilon <= 0:
            raise ValueError("epsilon must be positive")
        if not 0 < delta < 1:
            raise ValueError("delta must be in (0, 1) for partition "
                             "selection")
        if max_partitions_contributed <= 0:
            raise ValueError("max_partitions_contributed must be positive")
        if pre_threshold is not None and pre_threshold <= 0:
            raise ValueError("pre_threshold must be positive")
        self._epsilon = epsilon
        self._delta = delta
        self._max_partitions_contributed = max_partitions_contributed
        self._pre_threshold = pre_threshold

    # -- PyDP-parity scalar API --

    def probability_of_keep(self, num_users: int) -> float:
        return float(self.probabilities(np.asarray([num_users]))[0])

    def should_keep(self,
                    num_users: int,
                    rng: Optional[np.random.Generator] = None) -> bool:
        # lint: disable=rng-purity(keep decision from the seed_host_rng generator unless the caller passes one)
        rng = rng or noise_ops._host_rng
        return bool(rng.random() < self.probability_of_keep(num_users))

    # -- vectorized API --

    def probabilities(self, counts: np.ndarray) -> np.ndarray:
        """Keep probability for each count; applies pre-thresholding then
        delegates to the strategy-specific ``_probabilities_impl``."""
        counts = np.asarray(counts)
        if self._pre_threshold is None:
            return self._probabilities_impl(counts)
        # Pre-thresholding (C++ semantics): counts below the pre-threshold
        # are never kept; otherwise the strategy sees n - pre_threshold + 1.
        shifted = counts - self._pre_threshold + 1
        probs = self._probabilities_impl(np.maximum(shifted, 0))
        return np.where(counts >= self._pre_threshold, probs, 0.0)

    def _probabilities_impl(self, counts: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class TruncatedGeometricPartitionStrategy(PartitionSelectionStrategyBase):
    """The optimal 'magic' selection; see module docstring for the math."""

    def __init__(self, epsilon: float, delta: float,
                 max_partitions_contributed: int,
                 pre_threshold: Optional[int] = None):
        super().__init__(epsilon, delta, max_partitions_contributed,
                         pre_threshold)
        eps_p = epsilon / max_partitions_contributed
        delta_p = _adjusted_delta(delta, max_partitions_contributed)
        self._keep_table = _truncated_geometric_table(eps_p, delta_p)

    @property
    def keep_table(self) -> np.ndarray:
        """pi_n indexed by user count n; input to the fused XLA gather."""
        return self._keep_table

    def _probabilities_impl(self, counts: np.ndarray) -> np.ndarray:
        idx = np.clip(counts, 0, self._keep_table.size - 1).astype(np.int64)
        return self._keep_table[idx]


@functools.lru_cache(maxsize=64)
def _truncated_geometric_table(eps: float, delta: float) -> np.ndarray:
    """Precomputes pi_n until saturation (pi_n == 1), in closed form.

    The recurrence pi_n = min(e^eps pi_{n-1} + delta,
    1 - e^-eps (1 - pi_{n-1} - delta), 1) switches branches exactly once:
    the first branch wins while pi <= p* = (1-delta)(1-e^-eps)/(e^eps-e^-eps),
    giving the geometric series pi_n = delta (e^{n eps} - 1)/(e^eps - 1);
    after the crossover q_n = 1 - pi_n decays as q -> e^-eps (q - delta)
    toward a negative fixed point q^ = -delta/(e^eps - 1), so
    q_{c+k} = e^{-k eps} (q_c - q^) + q^. Both phases vectorize — the
    per-step Python loop this replaces dominated multi-config utility
    sweeps. Cached: utility analysis builds one table per swept l0.
    """
    if delta <= 0:
        raise ValueError("truncated geometric selection requires delta > 0")
    eps = min(eps, 700.0)  # avoids overflow; saturated result unchanged
    em1 = math.expm1(eps)  # e^eps - 1
    p_star = ((1.0 - delta) * -math.expm1(-eps) /
              (math.exp(eps) - math.exp(-eps)))

    # Phase A: indices 0..n_c, where n_c is the first n with pi_n > p*.
    with np.errstate(over="ignore"):
        n_c = int(math.log1p(min(p_star * em1 / delta, 1e300)) // eps) + 1
    n_c = min(n_c, _MAX_TABLE_SIZE - 1)
    nA = np.arange(n_c + 1, dtype=np.float64)
    piA = np.minimum(delta * np.expm1(np.minimum(nA * eps, 700.0)) / em1,
                     1.0)

    # Phase B: q_{c+k} = e^{-k eps} (q_c - q^) + q^ until q <= ~0. When
    # the table hits _MAX_TABLE_SIZE before true saturation, keep the last
    # (conservative, unsaturated) value — counts beyond the table clamp to
    # it, and forcing 1.0 early would overstate the keep probability.
    q_c = 1.0 - piA[-1]
    q_bar = -delta / em1
    if q_c <= 1e-15:
        piA[-1] = 1.0
        table = piA
    else:
        k_needed = max(1, int(math.ceil(
            math.log((q_c - q_bar) / (1e-15 - q_bar)) / eps)))
        k_fit = min(k_needed, _MAX_TABLE_SIZE - len(piA))
        if k_fit <= 0:
            table = piA
        else:
            kB = np.arange(1.0, k_fit + 1.0)
            piB = 1.0 - (np.exp(-kB * eps) * (q_c - q_bar) + q_bar)
            piB = np.minimum(piB, 1.0)
            if k_fit >= k_needed:
                piB[-1] = 1.0
            table = np.concatenate([piA, piB])
    table.setflags(write=False)
    return table


class LaplaceThresholdingPartitionStrategy(PartitionSelectionStrategyBase):
    """Keep iff ``num_users + Lap(b) >= threshold``."""

    def __init__(self, epsilon: float, delta: float,
                 max_partitions_contributed: int,
                 pre_threshold: Optional[int] = None):
        super().__init__(epsilon, delta, max_partitions_contributed,
                         pre_threshold)
        self._scale = max_partitions_contributed / epsilon  # b = L1/eps
        delta_p = _adjusted_delta(delta, max_partitions_contributed)
        # T solves P(1 + Lap(b) >= T) = delta'.
        if delta_p <= 0.5:
            self._threshold = 1.0 - self._scale * math.log(2.0 * delta_p)
        else:
            self._threshold = 1.0 + self._scale * math.log(
                2.0 * (1.0 - delta_p))

    @property
    def threshold(self) -> float:
        return self._threshold

    @property
    def noise_scale(self) -> float:
        return self._scale

    def _probabilities_impl(self, counts: np.ndarray) -> np.ndarray:
        # P(n + Lap(b) >= T) = 1 - LaplaceCDF(T - n; b)
        z = (self._threshold - counts.astype(np.float64)) / self._scale
        return np.where(z < 0, 1.0 - 0.5 * np.exp(z), 0.5 * np.exp(-z))

    def should_keep(self,
                    num_users: int,
                    rng: Optional[np.random.Generator] = None) -> bool:
        # lint: disable=rng-purity(keep decision from the seed_host_rng generator unless the caller passes one)
        rng = rng or noise_ops._host_rng
        n = num_users
        if self._pre_threshold is not None:
            if n < self._pre_threshold:
                return False
            n = n - self._pre_threshold + 1
        return bool(n + rng.laplace(0.0, self._scale) >= self._threshold)


class GaussianThresholdingPartitionStrategy(PartitionSelectionStrategyBase):
    """Keep iff ``num_users + N(0, sigma^2) >= threshold``; delta is split
    half for the noise calibration, half for the threshold tail."""

    def __init__(self, epsilon: float, delta: float,
                 max_partitions_contributed: int,
                 pre_threshold: Optional[int] = None):
        super().__init__(epsilon, delta, max_partitions_contributed,
                         pre_threshold)
        from scipy.special import ndtri
        delta_noise = delta / 2.0
        delta_thresh = delta / 2.0
        l2 = math.sqrt(max_partitions_contributed)
        self._sigma = noise_ops.gaussian_sigma(epsilon, delta_noise, l2)
        delta_thresh_p = _adjusted_delta(delta_thresh,
                                         max_partitions_contributed)
        # T solves P(1 + N(0, sigma) >= T) = delta_thresh'.
        self._threshold = 1.0 + self._sigma * float(
            ndtri(1.0 - delta_thresh_p))

    @property
    def threshold(self) -> float:
        return self._threshold

    @property
    def noise_stddev(self) -> float:
        return self._sigma

    def _probabilities_impl(self, counts: np.ndarray) -> np.ndarray:
        from scipy.special import ndtr
        z = (counts.astype(np.float64) - self._threshold) / self._sigma
        return np.asarray(ndtr(z))

    def should_keep(self,
                    num_users: int,
                    rng: Optional[np.random.Generator] = None) -> bool:
        # lint: disable=rng-purity(keep decision from the seed_host_rng generator unless the caller passes one)
        rng = rng or noise_ops._host_rng
        n = num_users
        if self._pre_threshold is not None:
            if n < self._pre_threshold:
                return False
            n = n - self._pre_threshold + 1
        return bool(n + rng.normal(0.0, self._sigma) >= self._threshold)


def create_partition_selection_strategy(
        strategy: PartitionSelectionStrategy,
        epsilon: float,
        delta: float,
        max_partitions_contributed: int,
        pre_threshold: Optional[int] = None
) -> PartitionSelectionStrategyBase:
    """Factory mirroring the reference module
    (``pipeline_dp/partition_selection.py:19-33``), extended with
    ``pre_threshold``."""
    classes = {
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC:
            TruncatedGeometricPartitionStrategy,
        PartitionSelectionStrategy.LAPLACE_THRESHOLDING:
            LaplaceThresholdingPartitionStrategy,
        PartitionSelectionStrategy.GAUSSIAN_THRESHOLDING:
            GaussianThresholdingPartitionStrategy,
    }
    if strategy not in classes:
        raise ValueError(f"Unknown partition selection strategy {strategy}")
    return classes[strategy](epsilon, delta, max_partitions_contributed,
                             pre_threshold)
