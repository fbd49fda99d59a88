"""DP noise math — count/sum/mean/variance/vector-sum computations.

Capability parity with the reference's ``pipeline_dp/dp_computations.py``
(sensitivity calculus :72-91, count :255, sum :278, the normalized-sum mean
trick :310-397, variance :400-459, vector noise :178-222, budget splitting
:224-252, noise-std predictors :462-489) with one deliberate re-design for
TPU: **every compute function is vectorized** — inputs may be Python scalars
or NumPy arrays of per-partition aggregates, and one call draws one batched
noise sample for *all* partitions. The scalar path (used by the host
combiners) is just the 0-d case. The fused XLA program reuses the same
calibration helpers (which are pure host arithmetic).

Port copy: the same host float64 mechanisms as the JAX package, so the
port's release draws the same noise from the same ``rng``. With
``ops.noise.set_secure_host_noise(True)`` and no explicit ``rng``, every
release goes through the port's native samplers instead
(``_secure_release``), in the JAX package's order, so the same
``seed_host_rng`` seed gives the same hardened bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np

from pipelinedp_tpu_torch import native
from pipelinedp_tpu_torch.aggregate_params import NoiseKind, NormKind
from pipelinedp_tpu_torch.ops import noise as noise_ops

ArrayLike = Union[float, int, np.ndarray]

# Re-exported calibration helpers (reference :72-108).
compute_l1_sensitivity = noise_ops.compute_l1_sensitivity
compute_l2_sensitivity = noise_ops.compute_l2_sensitivity
compute_sigma = noise_ops.compute_sigma


def count_sensitivity_pair(max_partitions_contributed,
                           max_contributions_per_partition,
                           max_contributions):
    """(l0, linf) for count-like releases, shared by the host mechanisms
    and the fused plane's noise calibration. Total-cap mode: a unit's M
    rows can all land in ONE partition, so the L2-worst case is
    concentration — (1, M) yields Delta1 = Delta2 = M, valid for both
    mechanisms."""
    if max_contributions is not None:
        return 1.0, float(max_contributions)
    return float(max_partitions_contributed), float(
        max_contributions_per_partition)


def pid_count_sensitivity_pair(max_partitions_contributed,
                               max_contributions_per_partition,
                               max_contributions):
    """(l0, linf) for the privacy-id count: a unit adds at most 1 per
    touched partition, so concentration cannot occur — total-cap mode
    gets the tight (M, 1) with Delta2 = sqrt(M). Pair mode keeps the
    reference's (l0, linf) exactly (conservative when linf > 1,
    reference ``combiners.py:211-239``)."""
    if max_contributions is not None:
        return float(max_contributions), 1.0
    return float(max_partitions_contributed), float(
        max_contributions_per_partition)


def compute_middle(min_value: float, max_value: float) -> float:
    """Midpoint, written to avoid overflow on large bounds (reference :65)."""
    return min_value + (max_value - min_value) / 2


def compute_squares_interval(min_value: float,
                             max_value: float) -> Tuple[float, float]:
    """Bounds of {x^2 : x in [min, max]} (reference :58)."""
    if min_value < 0 < max_value:
        return 0, max(min_value**2, max_value**2)
    return min_value**2, max_value**2


@dataclasses.dataclass
class ScalarNoiseParams:
    """Parameters of scalar DP aggregations (reference :23-55).

    Contribution bounding comes in two modes: the (l0, linf) pair
    (``max_partitions_contributed`` x ``max_contributions_per_partition``)
    or a single total cap ``max_contributions`` across all partitions —
    a parameter the reference declares end-to-end but never implements
    (its engine raises, reference ``dp_engine.py:395-396``). Here the
    total-cap mode is fully supported; see ``count_sensitivities`` /
    ``pid_count_sensitivities`` / ``sum_sensitivities`` for the
    calculus."""
    eps: float
    delta: float
    min_value: Optional[float]
    max_value: Optional[float]
    min_sum_per_partition: Optional[float]
    max_sum_per_partition: Optional[float]
    max_partitions_contributed: Optional[int]
    max_contributions_per_partition: Optional[int]
    noise_kind: NoiseKind
    max_contributions: Optional[int] = None

    def __post_init__(self):
        assert (self.min_value is None) == (self.max_value is None), (
            "min_value and max_value should both be set or both be None.")
        assert (self.min_sum_per_partition is None) == (
            self.max_sum_per_partition is None), (
                "min_sum_per_partition and max_sum_per_partition should both "
                "be set or both be None.")
        assert (self.max_contributions is not None or
                self.max_partitions_contributed is not None), (
            "either max_contributions or max_partitions_contributed "
            "must be set")

    def l0_sensitivity(self) -> int:
        if self.max_contributions is not None:
            # A privacy unit touches at most max_contributions partitions.
            return self.max_contributions
        return self.max_partitions_contributed

    def count_sensitivities(self):
        """(l0, linf) for count-like releases — see
        :func:`count_sensitivity_pair`."""
        return count_sensitivity_pair(self.max_partitions_contributed,
                                      self.max_contributions_per_partition,
                                      self.max_contributions)

    def pid_count_sensitivities(self):
        """(l0, linf) for the privacy-id count — see
        :func:`pid_count_sensitivity_pair`."""
        return pid_count_sensitivity_pair(
            self.max_partitions_contributed,
            self.max_contributions_per_partition, self.max_contributions)

    def sum_sensitivities(self):
        """(l0, linf) for the SUM release in either clipping mode: with
        per-contribution value bounds, linf scales the count-like pair by
        max|bound|; with per-partition sum bounds, each touched
        partition's sum is capped directly."""
        if self.bounds_per_contribution_are_set:
            max_abs = max(abs(self.min_value), abs(self.max_value))
            l0, linf = self.count_sensitivities()
            return l0, linf * max_abs
        return float(self.l0_sensitivity()), max(
            abs(self.min_sum_per_partition),
            abs(self.max_sum_per_partition))

    @property
    def bounds_per_contribution_are_set(self) -> bool:
        return self.min_value is not None and self.max_value is not None

    @property
    def bounds_per_partition_are_set(self) -> bool:
        return (self.min_sum_per_partition is not None and
                self.max_sum_per_partition is not None)


def _noise_std(eps: float, delta: float, l0_sensitivity: float,
               linf_sensitivity: float, noise_kind: NoiseKind) -> float:
    """Standard deviation of the calibrated additive noise."""
    if noise_kind == NoiseKind.LAPLACE:
        return noise_ops.laplace_std(
            eps, compute_l1_sensitivity(l0_sensitivity, linf_sensitivity))
    if noise_kind == NoiseKind.GAUSSIAN:
        return noise_ops.gaussian_sigma(
            eps, delta, compute_l2_sensitivity(l0_sensitivity,
                                               linf_sensitivity))
    raise ValueError("Noise kind must be either Laplace or Gaussian.")


def _secure_release(value: ArrayLike, scale: float, int_fn, float_fn,
                    shape) -> ArrayLike:
    """Hardened release through the native samplers: exact integer noise
    for integer queries (counts, with no float noise bits at all), the
    grid-snapped mechanism for real-valued ones. Which sampler runs is
    decided by ``value``'s dtype, as in the JAX package, so callers keep
    count columns integral. Shared by both noise kinds (the native twin
    of the reference's PyDP secure mechanisms, reference
    ``dp_computations.py:111-143``)."""
    varr = np.asarray(value)
    if varr.dtype.kind in "iu":
        result = int_fn(varr, scale).astype(np.float64)
    else:
        result = float_fn(varr.astype(np.float64), scale)
    return result if shape else float(result)


def _add_random_noise(value: ArrayLike, eps: float, delta: float,
                      l0_sensitivity: float, linf_sensitivity: float,
                      noise_kind: NoiseKind,
                      rng: Optional[np.random.Generator] = None) -> ArrayLike:
    """Adds calibrated noise; batched when ``value`` is an array
    (reference :146-176, but vectorized). With secure host noise on and no
    explicit ``rng``, the native samplers release instead."""
    shape = np.shape(value) or None
    secure = noise_ops.secure_host_noise_enabled() and rng is None
    if noise_kind == NoiseKind.LAPLACE:
        scale = noise_ops.laplace_scale(
            eps, compute_l1_sensitivity(l0_sensitivity, linf_sensitivity))
        if secure:
            # Discrete Laplace for counts, Mironov snapping otherwise.
            return _secure_release(value, scale, native.discrete_laplace,
                                   native.snapping_laplace, shape)
        noise = noise_ops.np_laplace(scale, shape=shape, rng=rng)
    elif noise_kind == NoiseKind.GAUSSIAN:
        sigma = noise_ops.gaussian_sigma(
            eps, delta, compute_l2_sensitivity(l0_sensitivity,
                                               linf_sensitivity))
        if secure:
            # Exact discrete Gaussian (CKS) for counts, the
            # granularity-snapped discrete Gaussian otherwise.
            return _secure_release(value, sigma, native.discrete_gaussian,
                                   native.secure_gaussian, shape)
        noise = noise_ops.np_gaussian(sigma, shape=shape, rng=rng)
    else:
        raise ValueError("Noise kind must be either Laplace or Gaussian.")
    result = value + noise
    return result if shape else float(result)


def apply_laplace_mechanism(value: ArrayLike, eps: float,
                            l1_sensitivity: float) -> ArrayLike:
    """Releases ``value`` with Laplace noise of scale l1/eps
    (reference ``dp_computations.py:111-124``); batched over arrays."""
    return _add_random_noise(value, eps, 0.0, 1.0, l1_sensitivity,
                             NoiseKind.LAPLACE)


def apply_gaussian_mechanism(value: ArrayLike, eps: float, delta: float,
                             l2_sensitivity: float) -> ArrayLike:
    """Releases ``value`` with Gaussian noise at the optimal sigma for
    (eps, delta) (reference ``dp_computations.py:127-143``)."""
    return _add_random_noise(value, eps, delta, 1.0, l2_sensitivity,
                             NoiseKind.GAUSSIAN)


def equally_split_budget(eps: float, delta: float, no_mechanisms: int):
    """Splits (eps, delta) into ``no_mechanisms`` equal parts; the last part
    absorbs the floating-point residue so the shares sum exactly to the
    total (reference :224-252)."""
    if no_mechanisms <= 0:
        raise ValueError(
            "The number of mechanisms must be a positive integer.")
    eps_used = delta_used = 0
    budgets = []
    for _ in range(no_mechanisms - 1):
        budget = (eps / no_mechanisms, delta / no_mechanisms)
        eps_used += budget[0]
        delta_used += budget[1]
        budgets.append(budget)
    budgets.append((eps - eps_used, delta - delta_used))
    return budgets


def compute_dp_count(count: ArrayLike, dp_params: ScalarNoiseParams,
                     rng: Optional[np.random.Generator] = None) -> ArrayLike:
    """DP count; linf = max_contributions_per_partition (reference :255),
    or the concentration-safe (1, max_contributions) in total-cap mode."""
    l0, linf = dp_params.count_sensitivities()
    return _add_random_noise(count, dp_params.eps, dp_params.delta, l0,
                             linf, dp_params.noise_kind, rng)


def compute_dp_privacy_id_count(
        count: ArrayLike, dp_params: ScalarNoiseParams,
        rng: Optional[np.random.Generator] = None) -> ArrayLike:
    """DP privacy-id count: like compute_dp_count but with the tight
    1-per-partition sensitivities (matters only in total-cap mode)."""
    l0, linf = dp_params.pid_count_sensitivities()
    return _add_random_noise(count, dp_params.eps, dp_params.delta, l0,
                             linf, dp_params.noise_kind, rng)


def compute_dp_sum(sum_: ArrayLike, dp_params: ScalarNoiseParams,
                   rng: Optional[np.random.Generator] = None) -> ArrayLike:
    """DP sum; linf from value bounds x contributions, or per-partition sum
    bounds; zero sensitivity short-circuits to 0 (reference :278-307)."""
    l0, linf = dp_params.sum_sensitivities()
    if linf == 0:
        return np.zeros_like(sum_) if np.shape(sum_) else 0
    return _add_random_noise(sum_, dp_params.eps, dp_params.delta, l0,
                             linf, dp_params.noise_kind, rng)


def _compute_mean_for_normalized_sum(
        dp_count: ArrayLike, sum_: ArrayLike, min_value: float,
        max_value: float, eps: float, delta: float, l0_sensitivity: float,
        max_contributions_per_partition: float, noise_kind: NoiseKind,
        rng: Optional[np.random.Generator] = None) -> ArrayLike:
    """DP mean of normalized values (values shifted by the interval middle):
    noisy normalized sum divided by the DP count clamped to >= 1
    (reference :310-350)."""
    if min_value == max_value:
        return (np.full(np.shape(sum_), min_value)
                if np.shape(sum_) else min_value)
    middle = compute_middle(min_value, max_value)
    linf = max_contributions_per_partition * abs(middle - min_value)
    dp_normalized_sum = _add_random_noise(sum_, eps, delta, l0_sensitivity,
                                          linf, noise_kind, rng)
    dp_count_clamped = np.maximum(1.0, dp_count)
    result = dp_normalized_sum / dp_count_clamped
    return result if np.shape(sum_) else float(result)


def compute_dp_mean(count: ArrayLike, normalized_sum: ArrayLike,
                    dp_params: ScalarNoiseParams,
                    rng: Optional[np.random.Generator] = None):
    """DP (count, sum, mean) via the normalized-sum trick with an equal
    two-way budget split (reference :353-397)."""
    (count_eps, count_delta), (sum_eps, sum_delta) = equally_split_budget(
        dp_params.eps, dp_params.delta, 2)
    l0, linf = dp_params.count_sensitivities()
    dp_count = _add_random_noise(count, count_eps, count_delta, l0, linf,
                                 dp_params.noise_kind, rng)
    dp_mean = _compute_mean_for_normalized_sum(
        dp_count, normalized_sum, dp_params.min_value, dp_params.max_value,
        sum_eps, sum_delta, l0, linf, dp_params.noise_kind, rng)
    if dp_params.min_value != dp_params.max_value:
        dp_mean = dp_mean + compute_middle(dp_params.min_value,
                                           dp_params.max_value)
    return dp_count, dp_mean * dp_count, dp_mean


def compute_dp_var(count: ArrayLike, normalized_sum: ArrayLike,
                   normalized_sum_squares: ArrayLike,
                   dp_params: ScalarNoiseParams,
                   rng: Optional[np.random.Generator] = None):
    """DP (count, sum, mean, variance) with an equal three-way budget split;
    variance = E[(x-mid)^2] - E[x-mid]^2 (reference :400-459)."""
    ((count_eps, count_delta), (sum_eps, sum_delta),
     (sq_eps, sq_delta)) = equally_split_budget(dp_params.eps,
                                                dp_params.delta, 3)
    l0, linf = dp_params.count_sensitivities()
    dp_count = _add_random_noise(count, count_eps, count_delta, l0, linf,
                                 dp_params.noise_kind, rng)
    dp_mean = _compute_mean_for_normalized_sum(
        dp_count, normalized_sum, dp_params.min_value, dp_params.max_value,
        sum_eps, sum_delta, l0, linf, dp_params.noise_kind, rng)
    squares_min, squares_max = compute_squares_interval(
        dp_params.min_value, dp_params.max_value)
    dp_mean_squares = _compute_mean_for_normalized_sum(
        dp_count, normalized_sum_squares, squares_min, squares_max, sq_eps,
        sq_delta, l0, linf, dp_params.noise_kind, rng)
    dp_var = dp_mean_squares - dp_mean**2
    if dp_params.min_value != dp_params.max_value:
        dp_mean = dp_mean + compute_middle(dp_params.min_value,
                                           dp_params.max_value)
    return dp_count, dp_mean * dp_count, dp_mean, dp_var


# ---------------------------------------------------------------------------
# Vector sum (reference :178-222)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdditiveVectorNoiseParams:
    eps_per_coordinate: float
    delta_per_coordinate: float
    max_norm: float
    l0_sensitivity: float
    linf_sensitivity: float
    norm_kind: NormKind
    noise_kind: NoiseKind


def _clip_vector(vec: np.ndarray, max_norm: float,
                 norm_kind: NormKind) -> np.ndarray:
    """Norm-clips ``vec``; batched over leading axes (the norm is taken
    over the last axis), so one [D] vector and a [P, D] stack of
    per-partition vectors share the implementation."""
    kind = norm_kind.value
    if kind == "linf":
        return np.clip(vec, -max_norm, max_norm)
    if kind in ("l1", "l2"):
        norms = np.linalg.norm(vec, ord=int(kind[-1]), axis=-1,
                               keepdims=True)
        # Zero-norm rows pass through unscaled (factor 1), computed
        # without dividing by ~0 (overflow warnings for huge max_norm).
        factor = np.where(norms > max_norm, max_norm / np.where(
            norms > 0, norms, 1.0), 1.0)
        return vec * factor
    raise NotImplementedError(
        f"Vector norm of kind '{kind}' is not supported.")


def add_noise_vector(vec: np.ndarray,
                     noise_params: AdditiveVectorNoiseParams,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Clips by the configured norm, then adds per-coordinate noise with the
    per-coordinate budget — one batched draw over all coordinates."""
    vec = _clip_vector(np.asarray(vec, dtype=np.float64),
                       noise_params.max_norm, noise_params.norm_kind)
    return np.asarray(
        _add_random_noise(vec, noise_params.eps_per_coordinate,
                          noise_params.delta_per_coordinate,
                          noise_params.l0_sensitivity,
                          noise_params.linf_sensitivity,
                          noise_params.noise_kind, rng))


# ---------------------------------------------------------------------------
# Noise-std predictors for utility analysis (reference :462-489)
# ---------------------------------------------------------------------------


def compute_dp_count_noise_std(dp_params: ScalarNoiseParams) -> float:
    l0, linf = dp_params.count_sensitivities()
    return _noise_std(dp_params.eps, dp_params.delta, l0, linf,
                      dp_params.noise_kind)


def compute_dp_sum_noise_std(dp_params: ScalarNoiseParams) -> float:
    l0, linf = dp_params.sum_sensitivities()
    return _noise_std(dp_params.eps, dp_params.delta, l0, linf,
                      dp_params.noise_kind)
