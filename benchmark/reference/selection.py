"""Truncated-geometric partition selection (the optimal "magic"
selection of Desfontaines et al., PipelineDP's default): the keep
probability of a partition with ``n`` privacy units, for a per-unit
budget ``(eps / l0, 1 - (1 - delta) ** (1 / l0))``. The recurrence
``pi_n = min(e^eps pi_{n-1} + delta, 1 - e^-eps (1 - pi_{n-1} - delta),
1)`` evaluated step by step in float64, as the paper states it."""

from __future__ import annotations

import math

import numpy as np

# Tables stop here: far past saturation for any budget a cell uses.
MAX_TABLE = 1 << 16


def keep_table(eps: float, delta: float, l0: int) -> np.ndarray:
    """pi_n for n = 0, 1, ... up to the first n with pi_n == 1 (or
    ``MAX_TABLE`` entries)."""
    e = eps / l0
    d = -math.expm1(math.log1p(-delta) / l0)
    out = [0.0]
    while out[-1] < 1.0 and len(out) < MAX_TABLE:
        p = out[-1]
        out.append(min(math.exp(e) * p + d,
                       1.0 - math.exp(-e) * (1.0 - p - d), 1.0))
    return np.asarray(out)


def keep_probability(table: np.ndarray, n: np.ndarray) -> np.ndarray:
    return table[np.clip(np.asarray(n, np.int64), 0, len(table) - 1)]
