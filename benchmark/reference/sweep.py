"""The plain reference of a COUNT utility-analysis sweep (PipelineDP's
``perform_utility_analysis`` over a grid of contribution bounds), from
the table and the query alone, in plain PyTorch at a given precision:
float64 for the reference, bfloat16 for the control.

Per (user, partition) pair of ``c`` rows and per configuration
``(l0, linf)``: the pair is kept by the L0 bound with probability
``p = min(1, l0 / n_u)``; its contribution ``min(c, linf)``; its expected
L0 error ``-min(c, linf) (1 - p)`` and variance
``min(c, linf)^2 p (1 - p)``; the Linf error ``min(c, linf) - c``. Per
partition these add up, and the keep probability of private selection
is ``E[pi(N)]`` for ``N`` the Poisson-binomial count of kept units,
taken as PipelineDP takes it: a normal approximation refined by the
skewness over the integers within 64 of the mean while ``8 sigma <= 64``,
32-point Gauss-Hermite quadrature past that. The noise is Laplace with
the analysis's share of epsilon (the sweep requests the selection and
the metric evenly). The cross-partition averages are those of
``AggregateErrorMetrics``.

``judge`` reads, over every configuration, the widest gap between the
program's field and the reference's, relative to the larger of the
reference's value and the median over configurations of its magnitude:
``moment_gap`` over the error moments and the noise, ``selection_gap``
over what the keep probabilities decide.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark.reference import selection
from benchmark.reference.aggregate import factorize

WINDOW = 64
GH_ORDER = 32
MOMENT_FIELDS = ("error_l0_expected", "error_l0_variance", "error_variance",
                 "error_linf_expected", "ratio_data_dropped_l0", "noise_std")
SELECTION_FIELDS = ("dropped_partitions_expected",
                    "dropped_partitions_variance",
                    "ratio_data_dropped_partition_selection",
                    "error_expected_w_dropped_partitions")
# Configurations per block of the keep-probability window.
_BLOCK = 8


def grid(query: Dict) -> List[tuple]:
    """The (l0, linf) configurations, l0 outer."""
    lo, hi = query["l0_range"]
    return [(a, b) for a in range(lo, hi + 1) for b in query["linf_values"]]


def _ndtr(x: torch.Tensor) -> torch.Tensor:
    """The normal cdf; bfloat16 through float32 and back."""
    if x.dtype == torch.bfloat16:
        return torch.special.ndtr(x.float()).to(x.dtype)
    return torch.special.ndtr(x)


def _keep(table: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """pi(n) of each config's table [C, T] at float counts n [P, C, K]."""
    T = table.shape[1]
    i = torch.clamp(torch.round(n.double()), 0, T - 1).long()
    cfg = torch.arange(table.shape[0], device=n.device).view(1, -1, 1)
    return table[cfg.expand_as(i), i].to(n.dtype)


def _keep_probability(mu, var, m3, table):
    """E[pi(N)] over [P, C] from the Poisson-binomial moments."""
    dt = mu.dtype
    sigma = torch.sqrt(torch.clamp_min(var, 0.0))
    s = torch.clamp_min(sigma, 1e-30)
    skew = torch.where(sigma > 0, m3 / (s * s * s), torch.zeros_like(m3))
    rmu = torch.round(mu)[..., None]
    offs = torch.arange(-WINDOW, WINDOW + 1, device=mu.device, dtype=dt)
    centers = rmu + offs
    edges = torch.arange(-WINDOW - 1, WINDOW + 1, device=mu.device, dtype=dt)
    z = (rmu + edges + 0.5 - mu[..., None]) / s[..., None]
    pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi)
    cdf = torch.clamp(_ndtr(z) + skew[..., None] * (1 - z * z) * pdf / 6,
                      0.0, 1.0)
    pmf = cdf[..., 1:] - cdf[..., :-1]
    pmf[..., 0] = cdf[..., 1]
    pmf[..., -1] = 1.0 - cdf[..., -2]
    pmf = torch.where(centers >= 0, pmf, torch.zeros_like(pmf))
    win = (pmf * _keep(table, torch.clamp_min(centers, 0.0))).sum(-1)
    nodes, weights = np.polynomial.hermite.hermgauss(GH_ORDER)
    nodes = torch.tensor(nodes, device=mu.device, dtype=dt)
    weights = torch.tensor(weights / math.sqrt(math.pi), device=mu.device,
                           dtype=dt)
    xs = mu[..., None] + math.sqrt(2.0) * sigma[..., None] * nodes
    gh = (weights * _keep(table, torch.clamp_min(xs, 0.0))).sum(-1)
    point = _keep(table, torch.clamp_min(rmu, 0.0))[..., 0]
    small = sigma * 8.0 <= WINDOW
    return torch.clamp(torch.where(sigma < 1e-9, point,
                                   torch.where(small, win, gh)), 0.0, 1.0)


def reference(pid: np.ndarray, pk: np.ndarray, query: Dict,
              dtype: torch.dtype, device: torch.device
              ) -> Dict[str, np.ndarray]:
    """Each field of ``MOMENT_FIELDS + SELECTION_FIELDS`` per
    configuration, float64 [C]."""
    keys, pk_idx = factorize(pk)
    P = len(keys)
    pair, c = np.unique(pid.astype(np.int64) * P + pk_idx,
                        return_counts=True)
    user, part = pair // P, pair % P
    n_u = np.bincount(user)
    t = lambda a: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
    part_t = torch.as_tensor(part, device=device)
    n_pair = t(n_u[user])
    c_t = t(c)
    configs = grid(query)
    eps_sel = query["epsilon"] / 2
    eps_metric = query["epsilon"] - eps_sel
    out = {f: np.zeros(len(configs)) for f in MOMENT_FIELDS +
           SELECTION_FIELDS}

    def per_part(x):
        z = torch.zeros(P, device=device, dtype=dtype)
        return z.index_add_(0, part_t, x)

    psum = per_part(c_t)
    total = torch.clamp_min(psum.sum(), 1.0)
    tables = {}
    for start in range(0, len(configs), _BLOCK):
        block = configs[start:start + _BLOCK]
        mom, err = [], []
        for l0, linf in block:
            p = torch.clamp_max(l0 / n_pair, 1.0)
            q = 1 - p
            k = torch.clamp_max(c_t, float(linf))
            mom.append(torch.stack([per_part(p), per_part(p * q),
                                    per_part(p * q * (1 - 2 * p))]))
            err.append(torch.stack([per_part(-k * q), per_part(k * k * p * q),
                                    per_part(k - c_t)]))
            if l0 not in tables:
                tables[l0] = selection.keep_table(eps_sel, query["delta"],
                                                  l0)
        T = max(len(tables[l0]) for l0, _ in block)
        tab = np.ones((len(block), T))
        for i, (l0, _) in enumerate(block):
            tab[i, :len(tables[l0])] = tables[l0]
            tab[i, len(tables[l0]):] = tables[l0][-1]
        mom = torch.stack(mom, -1)  # [3, P, B]
        err = torch.stack(err, -1)
        p_keep = _keep_probability(mom[0], mom[1], mom[2], t(tab))
        for i, (l0, linf) in enumerate(block):
            pk_ = p_keep[:, i]
            exp_l0, var_l0, e_max = err[0][:, i], err[1][:, i], err[2][:, i]
            noise = math.sqrt(2.0) * l0 * linf / eps_metric
            kept = torch.clamp_min(pk_.sum(), 1e-30)
            row = {
                "error_l0_expected": (pk_ * exp_l0).sum() / kept,
                "error_l0_variance": (pk_ * var_l0).sum() / kept,
                "error_variance": (pk_ * (var_l0 + noise * noise)).sum()
                / kept,
                "error_linf_expected": (pk_ * e_max).sum() / kept,
                "ratio_data_dropped_l0": (-exp_l0).sum() / total,
                "noise_std": torch.tensor(noise),
                "dropped_partitions_expected": P - pk_.sum(),
                "dropped_partitions_variance": (pk_ * (1 - pk_)).sum(),
                "ratio_data_dropped_partition_selection":
                    ((1 - pk_) * (psum + exp_l0 + e_max)).sum() / total,
                "error_expected_w_dropped_partitions":
                    (pk_ * (exp_l0 + e_max) - (1 - pk_) * psum).sum() / P,
            }
            for f, v in row.items():
                out[f][start + i] = float(v)
    return out


def program_fields(result) -> Dict[str, np.ndarray]:
    """The same fields from the program's ``List[AggregateMetrics]``."""
    get = {
        "dropped_partitions_expected":
            lambda m: m.partition_selection_metrics.dropped_partitions_expected,
        "dropped_partitions_variance":
            lambda m: m.partition_selection_metrics.dropped_partitions_variance,
    }
    out = {}
    for f in MOMENT_FIELDS + SELECTION_FIELDS:
        fn = get.get(f, lambda m, _f=f: getattr(m.count_metrics, _f))
        out[f] = np.asarray([fn(m) for m in result], np.float64)
    return out


def judge(ref: Dict[str, np.ndarray], got: Dict[str, np.ndarray]
          ) -> Dict[str, float]:
    def widest(fields):
        gap = 0.0
        for f in fields:
            r, g = ref[f], got[f]
            if r.shape != g.shape or not np.all(np.isfinite(g)):
                return float("inf")
            floor = np.median(np.abs(r))
            gap = max(gap, float(np.max(np.abs(g - r) / np.maximum(
                np.abs(r), floor if floor > 0 else 1.0))))
        return gap
    return {"moment_gap": widest(MOMENT_FIELDS),
            "selection_gap": widest(SELECTION_FIELDS)}
