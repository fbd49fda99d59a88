"""Self-contained privacy-loss-distribution (PLD) accounting engine.

The reference's ``PLDBudgetAccountant`` (``pipeline_dp/budget_accounting.py:
399-600``) delegates PLD arithmetic to the external ``dp_accounting`` library:
it builds one PLD per registered mechanism (Laplace / Gaussian / a modeled
"generic" mechanism, :560-600), composes them, and binary-searches the minimal
noise standard deviation whose composed PLD still satisfies the pipeline's
total (epsilon, delta) (:526-558).

The JAX package re-implements that capability from first principles, so it
has no external accounting dependency; this module is the port's copy of
``pipelinedp_tpu/pld.py``, the same operations in the same order on the same
dtypes, so both packages grant bit-identical noise levels:

* A PLD is a discretized probability mass function over privacy-loss values
  ``L = ln(p0(x)/p1(x))`` on the grid ``k * h`` (``h`` = ``discretization``),
  with an explicit ``infinity_mass`` catching the pessimistically-truncated
  tail, and losses rounded **up** to the next grid point (pessimistic — never
  under-reports delta).
* Composition of independent mechanisms = convolution of loss pmfs
  (``scipy.signal.fftconvolve``; identical mechanisms are composed by
  exponentiation-by-squaring of self-convolutions).
* ``delta(eps)`` is the hockey-stick divergence
  ``sum_{l > eps} p(l) * (1 - e^(eps - l)) + infinity_mass``.

Everything here is host-side NumPy: accounting runs once per pipeline at
graph-finalization time and is far off the hot path.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Sequence, Tuple

import numpy as np

from pipelinedp_tpu_torch.aggregate_params import MechanismType

# Loss values beyond this many standard deviations of the Gaussian loss
# distribution are truncated into infinity_mass (pessimistic).
_GAUSSIAN_TAIL_SIGMAS = 12.0


@dataclasses.dataclass
class DiscretePLD:
    """A discretized privacy-loss distribution.

    ``probs[i]`` is the probability (under the mechanism's 'left' output
    distribution) that the privacy loss lies in the bucket whose *upper* edge
    is ``(lowest_index + i) * discretization``. ``infinity_mass`` is the
    probability of an unbounded loss (events impossible under the 'right'
    distribution, or truncated tails).
    """
    discretization: float
    lowest_index: int
    probs: np.ndarray
    infinity_mass: float

    def delta_for_epsilon(self, epsilon: float) -> float:
        """Hockey-stick divergence at ``epsilon``."""
        losses = (self.lowest_index +
                  np.arange(self.probs.size)) * self.discretization
        mask = losses > epsilon
        if not mask.any():
            return self.infinity_mass
        tail_probs = self.probs[mask]
        tail_losses = losses[mask]
        delta = float(
            np.sum(tail_probs * -np.expm1(epsilon - tail_losses)))
        return min(1.0, delta + self.infinity_mass)

    def compose(self, other: "DiscretePLD") -> "DiscretePLD":
        """PLD of running both mechanisms (independent composition)."""
        if self.discretization != other.discretization:
            raise ValueError("PLDs must share a discretization grid")
        import scipy.signal
        probs = scipy.signal.fftconvolve(self.probs, other.probs)
        probs = np.maximum(probs, 0.0)  # FFT round-off can go slightly <0
        inf_mass = 1.0 - (1.0 - self.infinity_mass) * (1.0 -
                                                       other.infinity_mass)
        return _trim(
            DiscretePLD(discretization=self.discretization,
                        lowest_index=self.lowest_index + other.lowest_index,
                        probs=probs,
                        infinity_mass=inf_mass))

    def self_compose(self, times: int) -> "DiscretePLD":
        """Composes this PLD with itself ``times`` times
        (exponentiation-by-squaring, O(log times) convolutions)."""
        if times < 1:
            raise ValueError("times must be >= 1")
        result = None
        power = self
        t = times
        while t:
            if t & 1:
                result = power if result is None else result.compose(power)
            t >>= 1
            if t:
                power = power.compose(power)
        return result


def _trim(pld: DiscretePLD, tail_eps: float = 1e-15) -> DiscretePLD:
    """Drops negligible leading/trailing mass to keep convolutions small.

    Trailing (large-loss) mass is folded into ``infinity_mass`` (pessimistic);
    leading (very negative loss) mass is simply dropped after being kept as
    lower-bound mass at the lowest retained bucket (it only ever *reduces*
    delta, so dropping is pessimistic too — we reassign it to the lowest
    bucket to keep total mass ~1 for numerical sanity)."""
    probs = pld.probs
    total = probs.sum()
    if total <= 0:
        return pld
    # Trailing trim → infinity mass.
    csum_rev = np.cumsum(probs[::-1])
    keep_rev = csum_rev > tail_eps
    hi = probs.size - int(np.argmax(keep_rev)) if keep_rev.any() else 0
    inf_extra = float(probs[hi:].sum())
    # Leading trim → collapse into the first kept bucket.
    csum = np.cumsum(probs)
    keep = csum > tail_eps
    lo = int(np.argmax(keep)) if keep.any() else 0
    lead_mass = float(probs[:lo].sum())
    new_probs = probs[lo:hi].copy()
    if new_probs.size == 0:
        new_probs = np.array([total])
        lo = 0
    new_probs[0] += lead_mass
    return DiscretePLD(discretization=pld.discretization,
                       lowest_index=pld.lowest_index + lo,
                       probs=new_probs,
                       infinity_mass=pld.infinity_mass + inf_extra)


def laplace_pld(parameter: float,
                sensitivity: float = 1.0,
                discretization: float = 1e-4) -> DiscretePLD:
    """PLD of the Laplace mechanism with scale ``parameter``.

    For ``x ~ Laplace(0, b)`` the loss vs the distribution shifted by the
    sensitivity ``s`` is ``L(x) = ln(p0(x)/p1(x)) = (|x - s| - |x|) / b`` —
    bounded in ``[-s/b, s/b]`` and non-increasing in ``x`` (atom of mass 1/2
    at the max loss ``s/b`` for ``x <= 0``; atom ``e^(-s/b)/2`` at the min
    loss for ``x >= s``). The pmf over loss buckets comes from the preimage
    ``{L <= l} = {x >= (s - l*b)/2}``."""
    b = float(parameter)
    s = float(sensitivity)
    if b <= 0 or s <= 0:
        raise ValueError("parameter and sensitivity must be positive")
    h = discretization
    max_loss = s / b

    def laplace_cdf(x):
        x = np.asarray(x, dtype=np.float64)
        return np.where(x < 0, 0.5 * np.exp(x / b),
                        1.0 - 0.5 * np.exp(-x / b))

    # Loss buckets: upper edges k*h for k in [lo_idx, hi_idx]. The lowest
    # edge is -floor(max_loss/h)*h >= -max_loss so the bottom atom (all mass
    # at exactly -s/b) is rounded UP onto the grid — pessimistic, like every
    # other bucket.
    hi_idx = math.ceil(max_loss / h)
    lo_idx = -math.floor(max_loss / h)
    edges_upper = np.arange(lo_idx, hi_idx + 1) * h
    # Preimage: {L <= l} = {x >= (s - l*b)/2} for -s/b < l < s/b (L is
    # non-increasing in x), so P(L <= l) = 1 - CDF((s - l*b)/2). The atom at
    # the max loss (x <= 0, mass 1/2) enters only once l >= s/b.
    clamped = np.clip(edges_upper, -max_loss, max_loss)
    x_of = (s - clamped * b) / 2.0
    cdf_vals = 1.0 - laplace_cdf(x_of)
    cdf_vals[edges_upper >= max_loss] = 1.0
    probs = np.diff(np.concatenate([[0.0], cdf_vals]))
    probs = np.maximum(probs, 0.0)
    return _trim(
        DiscretePLD(discretization=h,
                    lowest_index=lo_idx,
                    probs=probs,
                    infinity_mass=0.0))


def gaussian_pld(standard_deviation: float,
                 sensitivity: float = 1.0,
                 discretization: float = 1e-4) -> DiscretePLD:
    """PLD of the Gaussian mechanism with std ``standard_deviation``.

    For ``x ~ N(0, sigma^2)`` vs the alternative shifted by the sensitivity
    ``s``, ``L(x) = (s^2 - 2*s*x) / (2*sigma^2)``, so ``L`` is exactly normal
    with mean ``mu = s^2 / (2 sigma^2)`` and std ``s / sigma``. Tails
    beyond ``_GAUSSIAN_TAIL_SIGMAS`` are truncated into ``infinity_mass``
    (upper tail) or the lowest bucket (lower tail)."""
    sigma = float(standard_deviation)
    s = float(sensitivity)
    if sigma <= 0 or s <= 0:
        raise ValueError("standard_deviation and sensitivity must be > 0")
    h = discretization
    mu = s * s / (2.0 * sigma * sigma)
    loss_std = s / sigma

    def loss_cdf(l):
        # P(L <= l) with L ~ N(mu, loss_std^2)
        z = (np.asarray(l, dtype=np.float64) - mu) / loss_std
        return _norm_cdf(z)

    lo = mu - _GAUSSIAN_TAIL_SIGMAS * loss_std
    hi = mu + _GAUSSIAN_TAIL_SIGMAS * loss_std
    lo_idx = math.floor(lo / h)
    hi_idx = math.ceil(hi / h)
    edges_upper = np.arange(lo_idx, hi_idx + 1) * h
    cdf_vals = loss_cdf(edges_upper)
    probs = np.diff(np.concatenate([[0.0], cdf_vals]))
    probs = np.maximum(probs, 0.0)
    infinity_mass = float(1.0 - cdf_vals[-1])  # pessimistic upper tail
    return _trim(
        DiscretePLD(discretization=h,
                    lowest_index=lo_idx,
                    probs=probs,
                    infinity_mass=infinity_mass))


def pure_dp_pld(epsilon: float,
                delta: float = 0.0,
                discretization: float = 1e-4) -> DiscretePLD:
    """Tight PLD of an arbitrary (epsilon, delta)-DP mechanism.

    The dominating pair for (eps, delta)-DP: with probability ``delta`` the
    loss is infinite; the remaining mass sits at ``+eps`` w.p.
    ``e^eps/(1+e^eps)`` and ``-eps`` w.p. ``1/(1+e^eps)``. This models the
    reference's GENERIC mechanism (partition selection), which consumes raw
    (eps, delta) (``budget_accounting.py:586-596``)."""
    if epsilon < 0 or not 0 <= delta < 1:
        raise ValueError("invalid (epsilon, delta)")
    h = discretization
    # Round the +eps atom up and the -eps atom up (towards zero) so neither
    # under-reports delta after composition.
    hi_idx = math.ceil(epsilon / h) if epsilon > 0 else 0
    lo_idx = -(math.floor(epsilon / h) if epsilon > 0 else 0)
    probs = np.zeros(hi_idx - lo_idx + 1)
    # Stable sigmoid: exp(eps) overflows float64 past ~709.
    p_up = 1.0 / (1.0 + math.exp(-epsilon))
    probs[-1] = (1.0 - delta) * p_up
    probs[0] += (1.0 - delta) * (1.0 - p_up)
    return DiscretePLD(discretization=h,
                       lowest_index=lo_idx,
                       probs=probs,
                       infinity_mass=delta)


def _norm_cdf(z):
    import scipy.special
    return scipy.special.ndtr(np.asarray(z, dtype=np.float64))


def compose_all(plds: Sequence[DiscretePLD]) -> DiscretePLD:
    if not plds:
        raise ValueError("no PLDs to compose")
    out = plds[0]
    for p in plds[1:]:
        out = out.compose(p)
    return out


# ---------------------------------------------------------------------------
# Minimal-noise search (reference ``budget_accounting.py:526-600``).
# ---------------------------------------------------------------------------

Mechanism = Tuple[MechanismType, float, float]  # (type, sensitivity, weight)


def generic_mechanism_eps_delta(noise_std: float, total_epsilon: float,
                                total_delta: float) -> Tuple[float, float]:
    """(eps0, delta0) modeling a GENERIC mechanism at a given noise level.

    The single implementation of the conversion formula, assuming (eps,
    delta) specifies a Laplace-like mechanism: ``eps0 = sqrt(2)/noise_std``
    and ``delta0 = eps0/total_eps * total_delta``
    (``budget_accounting.py:521-524,586-596``).

    NOTE an asymmetry inherited deliberately for reference parity: during the
    noise *search* the reference feeds the raw common noise multiplier into
    this formula, while the final budget written into the spec uses the
    weight/sensitivity-scaled stddev (reference :518-523 vs :586-596) — for
    GENERIC mechanisms with weight != 1 or sensitivity != 1 the composed
    accounting and the granted budget therefore differ exactly as they do in
    the reference."""
    eps0 = math.sqrt(2.0) / noise_std
    delta0 = eps0 / total_epsilon * total_delta if total_epsilon else 0.0
    return eps0, delta0


# Cap on per-mechanism loss-grid buckets: past this the grid coarsens
# (losses still round UP — pessimistic), keeping huge-epsilon pipelines
# (tiny noise => losses of 1e4+) at bounded memory instead of allocating
# multi-GB pmf arrays.
_MAX_GRID_BUCKETS = 1 << 20


def _effective_discretization(mechanisms: Sequence[Mechanism],
                              noise_std: float, total_epsilon: float,
                              total_delta: float, h: float) -> float:
    """Discretization to use at this noise level: the requested ``h``
    unless some mechanism's loss range would need more than
    ``_MAX_GRID_BUCKETS`` buckets (all PLDs in one composition must share
    a grid, so the widest mechanism sets it)."""
    max_loss = 0.0
    for mech_type, sensitivity, weight in mechanisms:
        stddev = sensitivity * noise_std / weight
        if mech_type == MechanismType.LAPLACE:
            loss = sensitivity / (stddev / math.sqrt(2.0))  # s/b
        elif mech_type == MechanismType.GAUSSIAN:
            mu = sensitivity**2 / (2.0 * stddev**2)
            loss = mu + _GAUSSIAN_TAIL_SIGMAS * sensitivity / stddev
        else:
            loss = generic_mechanism_eps_delta(noise_std, total_epsilon,
                                               total_delta)[0]
        max_loss = max(max_loss, loss)
    if max_loss / h > _MAX_GRID_BUCKETS:
        return max_loss / _MAX_GRID_BUCKETS
    return h


def _compose_for_noise_std(mechanisms: Iterable[Mechanism],
                           noise_std: float,
                           total_epsilon: float,
                           total_delta: float,
                           discretization: float) -> DiscretePLD:
    """Builds the composed PLD when every mechanism uses the common noise
    multiplier ``noise_std`` (per-mechanism std = sensitivity*noise_std/weight
    — larger weight => less noise, reference :506-524)."""
    mechanisms = list(mechanisms)
    discretization = _effective_discretization(
        mechanisms, noise_std, total_epsilon, total_delta, discretization)
    plds: List[DiscretePLD] = []
    for mech_type, sensitivity, weight in mechanisms:
        stddev = sensitivity * noise_std / weight
        if mech_type == MechanismType.LAPLACE:
            # std = b*sqrt(2)  =>  b = std/sqrt(2)
            plds.append(
                laplace_pld(parameter=stddev / math.sqrt(2.0),
                            sensitivity=sensitivity,
                            discretization=discretization))
        elif mech_type == MechanismType.GAUSSIAN:
            plds.append(
                gaussian_pld(standard_deviation=stddev,
                             sensitivity=sensitivity,
                             discretization=discretization))
        elif mech_type == MechanismType.GENERIC:
            # The reference's composition step models GENERIC from the *raw*
            # noise multiplier, not the weight/sensitivity-scaled one
            # (budget_accounting.py:586-596); mirrored exactly.
            eps0, delta0 = generic_mechanism_eps_delta(
                noise_std, total_epsilon, total_delta)
            plds.append(
                pure_dp_pld(epsilon=eps0,
                            delta=min(delta0, 0.999),
                            discretization=discretization))
        else:
            raise ValueError(f"unsupported mechanism type {mech_type}")
    return _compose_grouped(mechanisms, plds)


def _compose_grouped(mechanisms: Sequence[Mechanism],
                     plds: Sequence[DiscretePLD]) -> DiscretePLD:
    """Composes per-mechanism PLDs, self-composing groups of identical
    (type, sensitivity, weight) mechanisms by squaring — O(log k)
    convolutions for k identical mechanisms instead of O(k)."""
    groups = {}
    for mech, p in zip(mechanisms, plds):
        key = (mech[0], mech[1], mech[2])
        if key in groups:
            groups[key] = (groups[key][0], groups[key][1] + 1)
        else:
            groups[key] = (p, 1)
    out = None
    for p, count in groups.values():
        composed = p.self_compose(count) if count > 1 else p
        out = composed if out is None else out.compose(composed)
    return out


def find_minimum_noise_std(mechanisms: Sequence[Mechanism],
                           total_epsilon: float,
                           total_delta: float,
                           discretization: float = 1e-4,
                           tolerance: float = 1e-3) -> float:
    """Smallest common noise multiplier whose composed PLD satisfies
    (total_epsilon, total_delta). Mirrors the reference's binary search with
    a doubling upper-bound probe (``budget_accounting.py:526-558``)."""
    if not mechanisms:
        raise ValueError("no mechanisms registered")

    def satisfied(noise_std: float) -> bool:
        pld = _compose_for_noise_std(mechanisms, noise_std, total_epsilon,
                                     total_delta, discretization)
        return pld.delta_for_epsilon(total_epsilon) <= total_delta

    # Doubling probe for an upper bound (reference _calculate_max_noise_std).
    hi = 1.0
    for _ in range(60):
        if satisfied(hi):
            break
        hi *= 2.0
    else:
        raise ValueError("could not find a feasible noise std")
    lo = 0.0
    while hi - lo > tolerance * max(1.0, hi):
        mid = (lo + hi) / 2.0
        if mid <= 0:
            break
        if satisfied(mid):
            hi = mid
        else:
            lo = mid
    return hi
