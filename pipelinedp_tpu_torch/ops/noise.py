"""Noise calibration and batched sampling — replaces PyDP's Laplace/Gaussian
mechanisms (reference ``pipeline_dp/dp_computations.py:93-143`` delegating to
``pydp.algorithms.numerical_mechanisms``).

Port copy of the JAX package's host half (``pipelinedp_tpu/ops/noise.py``
lines 1-216): calibration (Laplace scale ``b = L1/eps``; Gaussian sigma via
the analytic Gaussian mechanism of Balle & Wang 2018) is closed-form host
NumPy, and the NumPy samplers serve the float64 host release. The device
draws of the port live in ``ops/prng.py``, which reproduces JAX's threefry
streams bit for bit.

Noise-generation caveat, as in the JAX package: a float Laplace or Gaussian
sample leaks through its least significant bits (Mironov, CCS 2012). For
releases where that hardening matters, ``set_secure_host_noise(True)``
routes every host release with no explicit ``rng`` through the native
library (``pipelinedp_tpu_torch/native``: a ChaCha20 CSPRNG, Mironov's
snapping mechanism and its Gaussian twin for real values, exact discrete
Laplace and discrete Gaussian samplers for integer counts), compiled at
first use with the host's ``g++``. ``seed_host_rng`` seeds the NumPy RNG and
that CSPRNG together, so a hardened run is reproducible.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np

from scipy.special import log_ndtr as _log_ndtr
from scipy.special import ndtr as _ndtr

from pipelinedp_tpu_torch import native


# ---------------------------------------------------------------------------
# Calibration (host-side, closed form)
# ---------------------------------------------------------------------------


def laplace_scale(eps: float, l1_sensitivity: float) -> float:
    """Laplace parameter b such that Lap(b) noise gives eps-DP for the given
    L1 sensitivity (reference ``dp_computations.py:111-125``)."""
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")
    if l1_sensitivity <= 0:
        raise ValueError(f"l1_sensitivity must be positive")
    return l1_sensitivity / eps


def laplace_std(eps: float, l1_sensitivity: float) -> float:
    """Standard deviation of the calibrated Laplace noise: b*sqrt(2)
    (reference ``dp_computations.py:462-483``)."""
    return laplace_scale(eps, l1_sensitivity) * math.sqrt(2.0)


def gaussian_delta(eps: float, sigma: float, l2_sensitivity: float) -> float:
    """Exact delta(eps) of the Gaussian mechanism with std ``sigma``
    (Balle & Wang 2018, 'Improving the Gaussian mechanism', Thm. 8)."""
    if sigma <= 0:
        return 1.0
    s = l2_sensitivity
    a = s / (2.0 * sigma) - eps * sigma / s
    b = -s / (2.0 * sigma) - eps * sigma / s
    # The second term is e^eps * Phi(b) with Phi(b) potentially denormal for
    # large eps; evaluate in log space to avoid overflow.
    log_term = eps + float(_log_ndtr(b))
    term = math.exp(log_term) if log_term < 700.0 else math.inf
    return float(_ndtr(a) - term)


def gaussian_sigma(eps: float, delta: float, l2_sensitivity: float) -> float:
    """Minimal sigma of the Gaussian mechanism for (eps, delta)-DP.

    The analytic Gaussian mechanism: bisection on the exact delta(sigma)
    curve (monotone decreasing in sigma). Replaces PyDP's
    ``GaussianMechanism`` calibration (reference
    ``dp_computations.py:93-108``)."""
    if eps <= 0:
        raise ValueError(f"eps must be positive, got {eps}")
    if not 0 < delta < 1:
        raise ValueError(f"delta must be in (0, 1), got {delta}")
    if l2_sensitivity <= 0:
        raise ValueError("l2_sensitivity must be positive")
    lo = hi = l2_sensitivity
    # Expand brackets.
    for _ in range(200):
        if gaussian_delta(eps, hi, l2_sensitivity) <= delta:
            break
        hi *= 2.0
    else:  # pragma: no cover
        raise ValueError("could not bracket gaussian sigma (upper)")
    for _ in range(200):
        if gaussian_delta(eps, lo, l2_sensitivity) > delta:
            break
        lo /= 2.0
        if lo < 1e-12:
            return lo
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        if gaussian_delta(eps, mid, l2_sensitivity) <= delta:
            hi = mid
        else:
            lo = mid
    return hi


def gaussian_std(eps: float, delta: float, l2_sensitivity: float) -> float:
    """Alias for ``gaussian_sigma`` mirroring the reference's naming
    (``compute_sigma``/``.std``, ``dp_computations.py:93-108``)."""
    return gaussian_sigma(eps, delta, l2_sensitivity)


# ---------------------------------------------------------------------------
# Sensitivity calculus (reference ``dp_computations.py:62-108``)
# ---------------------------------------------------------------------------


def compute_l1_sensitivity(l0_sensitivity: float,
                           linf_sensitivity: float) -> float:
    """L1 = L0 * Linf (reference :72-82)."""
    return l0_sensitivity * linf_sensitivity


def compute_l2_sensitivity(l0_sensitivity: float,
                           linf_sensitivity: float) -> float:
    """L2 = sqrt(L0) * Linf (reference :85-91)."""
    return math.sqrt(l0_sensitivity) * linf_sensitivity


def compute_sigma(eps: float, delta: float, l2_sensitivity: float) -> float:
    """Reference-parity name (``dp_computations.py:93-108``)."""
    return gaussian_sigma(eps, delta, l2_sensitivity)


# ---------------------------------------------------------------------------
# Host (NumPy) sampling — for LocalBackend combiners
# ---------------------------------------------------------------------------

_host_rng = np.random.default_rng()


def np_laplace(scale: Union[float, np.ndarray],
               shape=None,
               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or _host_rng
    return rng.laplace(0.0, scale, size=shape)


def np_gaussian(stddev: Union[float, np.ndarray],
                shape=None,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or _host_rng
    return rng.normal(0.0, stddev, size=shape)


def seed_host_rng(seed: int) -> None:
    """Reseeds the process-global host RNG (tests, reproducible runs).
    Also re-keys the native CSPRNG if it is loaded, so hardened runs are
    reproducible under the same call."""
    global _host_rng
    _host_rng = np.random.default_rng(seed)
    if native.is_loaded():
        native.seed(seed)


def reseed_host_rng_from_entropy() -> None:
    """Reseeds the process-global host RNG, and the native CSPRNG if it is
    loaded, from fresh OS entropy.

    Worker processes that drew noise from one RNG state would produce
    identical noise streams, and identical noise across partitions cancels
    in pairwise differences, voiding the DP guarantee. Every process-pool
    worker must call this before touching the DP path. Only a loaded
    library is re-keyed: ``native.available()`` would build it in every
    worker even with secure noise off.
    """
    global _host_rng
    _host_rng = np.random.default_rng(np.random.SeedSequence())
    if native.is_loaded():
        native.seed_from_os()


_secure_host_noise = False


def set_secure_host_noise(enabled: bool) -> None:
    """Opts into the hardened host release: the native samplers replace
    value + raw float noise in every host release drawn without an
    explicit ``rng`` (the combiners, the fused path's release and
    VECTOR_SUM's). Raises ``native.NativeUnavailableError`` if the native
    library cannot be built on this host."""
    global _secure_host_noise
    if enabled and not native.available():
        raise native.NativeUnavailableError(
            "secure host noise requires the native library (g++ toolchain)")
    _secure_host_noise = enabled


def secure_host_noise_enabled() -> bool:
    return _secure_host_noise
