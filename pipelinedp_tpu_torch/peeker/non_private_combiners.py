"""Raw (non-DP) combiners with the standard Combiner API — used by the
peeker for true-value baselines. A port of
``pipelinedp_tpu/peeker/non_private_combiners.py`` on the port's
``combiners.Combiner`` and ``CompoundCombiner``."""

from __future__ import annotations

from typing import Iterable, List, Sized, Tuple

import numpy as np

from pipelinedp_tpu_torch import combiners as dp_combiners


class RawCountCombiner(dp_combiners.Combiner):
    AccumulatorType = int

    def create_accumulator(self, values: Sized) -> int:
        return len(values)

    def merge_accumulators(self, c1, c2):
        return c1 + c2

    def compute_metrics(self, count):
        return count

    def metrics_names(self) -> List[str]:
        return ["count"]

    def explain_computation(self):
        return "Raw count"


class RawPrivacyIdCountCombiner(dp_combiners.Combiner):
    AccumulatorType = int

    def create_accumulator(self, values: Sized) -> int:
        return 1 if values else 0

    def merge_accumulators(self, c1, c2):
        return c1 + c2

    def compute_metrics(self, count):
        return count

    def metrics_names(self) -> List[str]:
        return ["privacy_id_count"]

    def explain_computation(self):
        return "Raw privacy id count"


class RawSumCombiner(dp_combiners.Combiner):
    AccumulatorType = float

    def create_accumulator(self, values: Iterable[float]) -> float:
        return float(sum(values))

    def merge_accumulators(self, s1, s2):
        return s1 + s2

    def compute_metrics(self, total):
        return total

    def metrics_names(self) -> List[str]:
        return ["sum"]

    def explain_computation(self):
        return "Raw sum"


class RawMeanCombiner(dp_combiners.Combiner):
    AccumulatorType = Tuple[int, float]

    def create_accumulator(self, values):
        values = list(values)
        return len(values), float(sum(values))

    def merge_accumulators(self, a1, a2):
        return a1[0] + a2[0], a1[1] + a2[1]

    def compute_metrics(self, acc):
        count, total = acc
        return total / count if count else 0.0

    def metrics_names(self) -> List[str]:
        return ["mean"]

    def explain_computation(self):
        return "Raw mean"


class RawVarianceCombiner(dp_combiners.Combiner):
    AccumulatorType = Tuple[int, float, float]

    def create_accumulator(self, values):
        arr = np.asarray(list(values), dtype=np.float64)
        return len(arr), float(arr.sum()), float((arr**2).sum())

    def merge_accumulators(self, a1, a2):
        return a1[0] + a2[0], a1[1] + a2[1], a1[2] + a2[2]

    def compute_metrics(self, acc):
        count, total, total_sq = acc
        if not count:
            return 0.0
        mean = total / count
        return total_sq / count - mean * mean

    def metrics_names(self) -> List[str]:
        return ["variance"]

    def explain_computation(self):
        return "Raw variance"


_METRIC_TO_COMBINER = {
    "COUNT": RawCountCombiner,
    "PRIVACY_ID_COUNT": RawPrivacyIdCountCombiner,
    "SUM": RawSumCombiner,
    "MEAN": RawMeanCombiner,
    "VARIANCE": RawVarianceCombiner,
}


def create_compound_combiner(metrics) -> dp_combiners.CompoundCombiner:
    """Compound of raw combiners for the requested metrics."""
    internal = []
    for metric in metrics:
        cls = _METRIC_TO_COMBINER.get(metric.name)
        if cls is None:
            raise ValueError(f"unsupported raw metric {metric}")
        internal.append(cls())
    return dp_combiners.CompoundCombiner(internal,
                                         return_named_tuple=False)
