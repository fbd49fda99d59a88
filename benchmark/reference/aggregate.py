"""The plain reference of a DP aggregation of COUNT, SUM and MEAN, in
NumPy and float64, from the table and the query alone.

A release is noisy, so it is judged by what it says against its
distribution, which the query fixes: contribution bounding keeps a
uniform sample of ``min(n_u, l0)`` of user ``u``'s ``n_u`` partitions
(each with probability ``p_u = min(1, l0 / n_u)``) and ``min(c, linf)``
of a pair's ``c`` rows; values are clipped to ``[min_value, max_value]``;
PipelineDP's naive accountant splits ``epsilon`` evenly over the metric
request (MEAN's split in two between the count and the normalized sum)
and the partition selection, which takes all of ``delta``; Laplace
noise of scale ``l0 * linf * width / eps``. Per partition the reference
works out the mean and variance of the bounded count and normalized sum
and of the bounded privacy-unit count.

Partition selection keeps a partition with probability ``pi(N)``, for
``N`` its count of kept privacy units, a Poisson-binomial variable (each
of its users kept with ``p_u``, independently of the others). The
reference works out the exact law of ``N`` for every partition whose
keep probability is not 1 to rounding: the users grouped by ``p_u``,
the characteristic function is a product of binomial ones, and its
inverse discrete Fourier transform is the law. From it, each such
partition's keep probability ``E[pi(N)]``, and, for a partition whose
pairs each hold one row, the mean and variance of its count given that
it is released.

``judge`` standardises each released count: on the partitions whose
keep probability is 1 to within 1e-12 at seven standard deviations
below their expected unit count (the judged partitions) against its
mean and variance, on every other released partition against them given
the release. It standardises the normalized sum (recovered from the
released mean and count) on the judged partitions. It reads: the
standardised bias of the counts and of the sums, the gap of each one's
root mean square from 1, and the largest standardised deviation, which
is infinite where a judged partition is missing, a released key is not
in the table, or a value is not finite. For selection it bins the
partitions that are not judged by their expected unit count, each bin
holding a variance of at least ``BIN_VARIANCE`` partitions, and reads
the number released against the sum of the keep probabilities:
``selection_bias`` over all of them together and ``selection_max_z``,
the largest of the bins, each standardised by ``sqrt(sum pi (1 - pi))``.

``simulate`` is the reference put in the program's place: a release
drawn from the same model, with the L0 bound or partition selection
left out for the controls.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import selection

# Standard deviations of the unit count below its mean at which a judged
# partition's keep probability must still be 1 to within SAFE_KEEP.
SAFE_SIGMAS = 7.0
SAFE_KEEP = 1e-12
# The least variance of the number of partitions released in one bin.
BIN_VARIANCE = 16.0
# Standard deviations of the unit count above its mean that the law's
# transform holds without wrapping round.
LAW_SIGMAS = 30.0
# Partitions per block of the law's transform.
LAW_BLOCK = 4096


@dataclasses.dataclass
class Budget:
    eps_count: float
    eps_sum: float
    eps_selection: float
    delta_selection: float


def budget(query: Dict) -> Budget:
    """The naive accountant's split for the query's metrics."""
    metrics = set(query["metrics"])
    if not metrics <= {"COUNT", "SUM", "MEAN"}:
        raise ValueError(f"the reference has no model of {metrics}")
    eps = query["epsilon"]
    if "MEAN" in metrics:
        share = eps / 2  # the MEAN request and the selection
        return Budget(share / 2, share - share / 2, eps - share,
                      query["delta"])
    requests = len(metrics) + 1
    share = eps / requests
    return Budget(share, share, eps - share * (requests - 1), query["delta"])


@dataclasses.dataclass
class Expected:
    keys: np.ndarray  # int64 [P] sorted partition keys of the table
    e_count: np.ndarray
    v_count: np.ndarray
    e_nsum: np.ndarray
    v_nsum: np.ndarray
    judged: np.ndarray  # bool [P]
    e_keep: np.ndarray  # [P] E[pi(N)]; 1 on the judged partitions
    # The count's mean and variance given the release; NaN where the
    # partition is judged or a pair of it holds more than one row.
    e_count_kept: np.ndarray
    v_count_kept: np.ndarray
    bins: np.ndarray  # int64 [P] selection bin; -1 on the judged
    b_count: float
    b_nsum: float
    middle: float


def factorize(a: np.ndarray):
    """(sorted distinct values, each row's index among them): by a
    presence table for integers of a narrow range, else by a sort."""
    if a.dtype.kind in "iu" and a.size:
        lo = int(a.min())
        span = int(a.max()) - lo + 1
        if span <= 4 * a.size:
            present = np.bincount(a - lo, minlength=span) > 0
            index = np.cumsum(present) - 1
            return (np.flatnonzero(present) + lo).astype(a.dtype), \
                index[a - lo]
    return np.unique(a, return_inverse=True)


def _pairs(pid: np.ndarray, pk: np.ndarray, value: np.ndarray, query: Dict):
    """Per (user, partition) pair: user, partition index, row count and
    the sums of the clipped, centred values and of their squares."""
    keys, pk_idx = factorize(pk)
    lo, hi = float(query["min_value"]), float(query["max_value"])
    mid = (lo + hi) / 2
    w = np.clip(value.astype(np.float64), lo, hi) - mid
    pair = pid.astype(np.int64) * len(keys) + pk_idx
    if len(pair) > 1 and not np.all(pair[1:] > pair[:-1]):
        order = np.argsort(pair, kind="stable")
        pair, w = pair[order], w[order]
    start = np.flatnonzero(np.r_[True, pair[1:] != pair[:-1]])
    c = np.diff(np.r_[start, len(pair)]).astype(np.float64)
    s1 = np.add.reduceat(w, start)
    s2 = np.add.reduceat(w * w, start)
    return keys, pair[start] // len(keys), pair[start] % len(keys), c, s1, \
        s2, mid


def _bins(e_units: np.ndarray, e_keep: np.ndarray,
          judged: np.ndarray) -> np.ndarray:
    """Bins of the partitions that are not judged, in the order of their
    expected unit count, each closed once its variance of the number
    released reaches ``BIN_VARIANCE``; a last bin short of it joins the
    one before."""
    out = np.full(len(e_units), -1, np.int64)
    rest = np.flatnonzero(~judged)
    if not len(rest):
        return out
    rest = rest[np.argsort(e_units[rest], kind="stable")]
    v = e_keep[rest] * (1.0 - e_keep[rest])
    b = np.floor(np.cumsum(v) / BIN_VARIANCE).astype(np.int64)
    # A bin closes at the partition that takes it past the variance.
    b = np.r_[0, b[:-1]]
    last = b[-1]
    if last > 0 and v[b == last].sum() < BIN_VARIANCE:
        b[b == last] = last - 1
    out[rest] = b
    return out


def _unit_law(part: np.ndarray, p: np.ndarray, rows: np.ndarray,
              table: np.ndarray, e_units: np.ndarray, v_units: np.ndarray,
              device: torch.device):
    """For the partitions ``rows``: E[pi(N)], E[N | kept] and
    Var[N | kept], for ``N`` the count of kept units, from its exact
    law: ``prod_g (1 - p_g + p_g w)^m_g`` over the groups of users with
    one keep probability ``p_g``, evaluated at the ``L``-th roots of
    unity and transformed back, in float64 and complex128."""
    R = len(rows)
    if not R:
        z = np.zeros(0)
        return z, z, z
    at = np.full(len(e_units), -1, np.int64)
    at[rows] = np.arange(R)
    sel = at[part] >= 0
    levels, g = np.unique(p[sel], return_inverse=True)
    G = len(levels)
    m = np.bincount(at[part[sel]] * G + g, minlength=R * G).reshape(R, G)
    top = float(np.max(e_units[rows] + LAW_SIGMAS * np.sqrt(v_units[rows])))
    L = 1 << max(int(np.ceil(np.log2(max(top, len(table)) + 2))), 4)
    k = torch.arange(L, dtype=torch.float64, device=device)
    w = torch.polar(torch.ones_like(k), -2 * np.pi * k / L)
    pg = torch.as_tensor(levels, dtype=torch.float64, device=device)[:, None]
    log_factor = torch.log((1 - pg) + pg * w[None, :])  # [G, L]
    keep = torch.ones(L, dtype=torch.float64, device=device)
    keep[:len(table)] = torch.as_tensor(table[:L], device=device)
    e_keep, mean, var = (np.empty(R) for _ in range(3))
    for lo in range(0, R, LAW_BLOCK):
        hi = min(R, lo + LAW_BLOCK)
        mb = torch.as_tensor(m[lo:hi], dtype=torch.float64, device=device)
        log_cf = torch.complex(mb @ log_factor.real, mb @ log_factor.imag)
        law = torch.fft.ifft(torch.exp(log_cf), dim=1).real
        kept = law * keep
        e = kept.sum(1)
        m1 = (kept * k).sum(1) / e
        m2 = (kept * k * k).sum(1) / e
        e_keep[lo:hi] = e.cpu().numpy()
        mean[lo:hi] = m1.cpu().numpy()
        var[lo:hi] = (m2 - m1 * m1).cpu().numpy()
    return e_keep, mean, var


def expected(pid: np.ndarray, pk: np.ndarray, value: np.ndarray,
             query: Dict, device: torch.device) -> Expected:
    keys, user, part, c, s1, s2, mid = _pairs(pid, pk, value, query)
    P = len(keys)
    l0 = query["max_partitions_contributed"]
    linf = query["max_contributions_per_partition"]
    n_u = np.bincount(user)
    p = np.minimum(1.0, l0 / n_u[user])
    k = np.minimum(c, linf)
    # A kept pair's normalized sum: k of its c rows without replacement.
    mu = k * s1 / c
    var_in = np.where(c > 1, k * (s2 / c - (s1 / c) ** 2) * (c - k) /
                      np.maximum(c - 1, 1), 0.0)
    q = 1.0 - p

    def per_part(x):
        return np.bincount(part, weights=x, minlength=P)

    b = budget(query)
    width = max(abs(query["min_value"] - mid), abs(query["max_value"] - mid))
    e_units, v_units = per_part(p), per_part(p * q)
    table = selection.keep_table(b.eps_selection, b.delta_selection, l0)
    safe = table >= 1.0 - SAFE_KEEP
    safe_n = int(np.argmax(safe)) if safe.any() else np.inf
    judged = e_units - SAFE_SIGMAS * np.sqrt(v_units) >= safe_n
    rest = np.flatnonzero(~judged)
    law = _unit_law(part, p, rest, table, e_units, v_units, device)
    e_keep = np.ones(P)
    e_keep[rest] = law[0]
    # Where every pair of a partition holds one row its count is N.
    one_row = np.bincount(part, weights=(c != 1), minlength=P) == 0
    e_kept, v_kept = np.full(P, np.nan), np.full(P, np.nan)
    e_kept[rest], v_kept[rest] = law[1], law[2]
    e_kept[~one_row] = v_kept[~one_row] = np.nan
    return Expected(
        keys=keys, e_count=per_part(p * k), v_count=per_part(p * q * k * k),
        e_nsum=per_part(p * mu), v_nsum=per_part(p * var_in + p * q * mu * mu),
        judged=judged, e_keep=e_keep, e_count_kept=e_kept,
        v_count_kept=v_kept, bins=_bins(e_units, e_keep, judged),
        b_count=l0 * linf / b.eps_count,
        b_nsum=l0 * linf * width / b.eps_sum, middle=mid)


def released(rows: List) -> Dict[str, np.ndarray]:
    """The program's ``[(key, MetricsTuple)]`` as columns."""
    n = len(rows)
    out = {"keys": np.fromiter((k for k, _ in rows), np.int64, n)}
    for field in ("count", "mean"):
        out[field] = np.fromiter((getattr(m, field) for _, m in rows),
                                 np.float64, n)
    return out


def judge(exp: Expected, rel: Dict[str, np.ndarray]) -> Dict[str, float]:
    names = ("count_bias", "sum_bias", "count_spread", "sum_spread",
             "max_abs_z", "selection_bias", "selection_max_z")
    bad = {n: float("inf") for n in names}
    keys = rel["keys"]
    pos = np.searchsorted(exp.keys, keys)
    pos = np.minimum(pos, len(exp.keys) - 1)
    if (len(np.unique(keys)) != len(keys) or
            not np.all(exp.keys[pos] == keys) or
            not np.all(np.isfinite(rel["count"])) or
            not np.all(np.isfinite(rel["mean"]))):
        return bad
    present = np.zeros(len(exp.keys), bool)
    present[pos] = True
    if not np.all(present[exp.judged]) or not exp.judged.any():
        return bad
    at = np.full(len(exp.keys), -1)
    at[pos] = np.arange(len(keys))
    j = at[exp.judged]
    count = rel["count"][j]
    nsum = (rel["mean"][j] - exp.middle) * np.maximum(1.0, count)
    noise_c = 2 * exp.b_count ** 2
    z_c = (count - exp.e_count[exp.judged]) / np.sqrt(
        exp.v_count[exp.judged] + noise_c)
    z_s = (nsum - exp.e_nsum[exp.judged]) / np.sqrt(
        exp.v_nsum[exp.judged] + 2 * exp.b_nsum ** 2)
    # The other released partitions' counts, given their release.
    tail = present & ~exp.judged & np.isfinite(exp.e_count_kept)
    z_c = np.r_[z_c, (rel["count"][at[tail]] - exp.e_count_kept[tail]) /
                np.sqrt(exp.v_count_kept[tail] + noise_c)]
    # Selection: the number released in each bin against its law.
    binned = exp.bins >= 0
    nb = int(exp.bins.max()) + 1 if binned.any() else 0
    got = np.bincount(exp.bins[binned], weights=present[binned],
                      minlength=nb)
    e_b = np.bincount(exp.bins[binned], weights=exp.e_keep[binned],
                      minlength=nb)
    v_b = np.bincount(exp.bins[binned], weights=exp.e_keep[binned] *
                      (1 - exp.e_keep[binned]), minlength=nb)
    return {
        "count_bias": float(abs(z_c.sum()) / np.sqrt(len(z_c))),
        "sum_bias": float(abs(z_s.sum()) / np.sqrt(len(z_s))),
        "count_spread": float(abs(np.sqrt(np.mean(z_c ** 2)) - 1.0)),
        "sum_spread": float(abs(np.sqrt(np.mean(z_s ** 2)) - 1.0)),
        "max_abs_z": float(max(np.abs(z_c).max(), np.abs(z_s).max())),
        "selection_bias": _standardised(got.sum() - e_b.sum(), v_b.sum()),
        "selection_max_z": max((_standardised(d, v)
                                for d, v in zip(got - e_b, v_b)),
                               default=0.0),
    }


def _standardised(gap: float, variance: float) -> float:
    """|gap| / sqrt(variance); where the variance is nought to rounding,
    0 for no gap and infinite for one."""
    if variance > 1e-12:
        return float(abs(gap) / np.sqrt(variance))
    return 0.0 if abs(gap) < 0.5 else float("inf")


def simulate(pid: np.ndarray, pk: np.ndarray, value: np.ndarray,
             query: Dict, rng: np.random.Generator,
             bound_l0: bool = True, select: bool = True
             ) -> Dict[str, np.ndarray]:
    """A release drawn from the model ``expected`` describes, in the
    program's place; ``bound_l0=False`` leaves the L0 bound out,
    ``select=False`` partition selection (every partition with a kept
    unit is released). A kept
    pair contributes its expected normalized sum (exact at ``c <=
    linf``, every pair of the rating configurations)."""
    keys, user, part, c, s1, _, mid = _pairs(pid, pk, value, query)
    P = len(keys)
    l0 = query["max_partitions_contributed"]
    linf = query["max_contributions_per_partition"]
    if bound_l0:
        # ``user`` is sorted: a random order within each user's pairs.
        order = np.argsort(user + rng.random(len(user)), kind="stable")
        starts = np.r_[0, np.cumsum(np.bincount(user))]
        rank = np.empty(len(user), np.int64)
        rank[order] = np.arange(len(user)) - starts[user[order]]
        keep = rank < l0
    else:
        keep = np.ones(len(user), bool)
    k = np.minimum(c, linf) * keep
    units = np.bincount(part, weights=keep, minlength=P)
    count = np.bincount(part, weights=k, minlength=P)
    nsum = np.bincount(part, weights=k * s1 / c, minlength=P)
    b = budget(query)
    width = max(abs(query["min_value"] - mid), abs(query["max_value"] - mid))
    count = count + rng.laplace(scale=l0 * linf / b.eps_count, size=P)
    nsum = nsum + rng.laplace(scale=l0 * linf * width / b.eps_sum, size=P)
    table = selection.keep_table(b.eps_selection, b.delta_selection, l0)
    kept = rng.random(P) < selection.keep_probability(table, units)
    if not select:
        kept = units > 0
    mean = nsum / np.maximum(1.0, count) + mid
    return {"keys": keys[kept], "count": count[kept], "mean": mean[kept]}
