"""Utility-analysis combiners of the host graph: per-partition error
models and the cross-partition aggregation. A copy of
``pipelinedp_tpu/analysis/combiners.py`` (capability parity with the
reference's ``analysis/combiners.py``), with the JAX package's fixes of
the reference kept.

Per-partition accumulators are NumPy-vectorized over the per-user arrays
(count, sum, n_partitions); partition-selection probability is tracked
exactly (explicit probability list) while small and by moments of the
Poisson-binomial distribution once it grows past
``MAX_PROBABILITIES_IN_ACCUMULATOR`` (reference :32,70-175)."""

from __future__ import annotations

import abc
import copy
import math
import dataclasses
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

import numpy as np
import scipy.stats

from pipelinedp_tpu_torch import combiners as dp_combiners
from pipelinedp_tpu_torch import dp_computations, partition_selection
from pipelinedp_tpu_torch.aggregate_params import (
    NoiseKind, PartitionSelectionStrategy)
from pipelinedp_tpu_torch.analysis import metrics, poisson_binomial
from pipelinedp_tpu_torch.analysis import probability_computations

MAX_PROBABILITIES_IN_ACCUMULATOR = 100

# Aggregated per (privacy_id, partition_key): (count, sum, n_partitions).
PreaggregatedData = Tuple[int, float, int]


class UtilityAnalysisCombiner(dp_combiners.Combiner):

    @abc.abstractmethod
    def create_accumulator(self, data: Tuple[int, float, int]):
        """data = (count, sum, n_partitions) arrays per privacy unit."""

    def merge_accumulators(self, acc1: Tuple, acc2: Tuple):
        return tuple(a + b for a, b in zip(acc1, acc2))

    def explain_computation(self):
        """No-op."""

    def metrics_names(self) -> List[str]:
        return []


@dataclass
class SumOfRandomVariablesMoments:
    """Moments of a sum of independent random variables (reference :70)."""
    count: int
    expectation: float
    variance: float
    third_central_moment: float

    def __add__(self, other):
        return SumOfRandomVariablesMoments(
            self.count + other.count,
            self.expectation + other.expectation,
            self.variance + other.variance,
            self.third_central_moment + other.third_central_moment)


def _probabilities_to_moments(
        probabilities: List[float]) -> SumOfRandomVariablesMoments:
    p = np.asarray(probabilities, dtype=np.float64)
    return SumOfRandomVariablesMoments(
        len(probabilities), float(p.sum()), float((p * (1 - p)).sum()),
        float((p * (1 - p) * (1 - 2 * p)).sum()))


@dataclass
class PartitionSelectionCalculator:
    """P(partition kept) from either the exact per-user keep probabilities
    or the moment approximation (reference :87-141)."""
    probabilities: Optional[List[float]] = None
    moments: Optional[SumOfRandomVariablesMoments] = None

    def __post_init__(self):
        assert (self.probabilities is None) != (self.moments is None), (
            "Exactly one of probabilities and moments must be set.")

    def compute_probability_to_keep(
            self, strategy: PartitionSelectionStrategy, eps: float,
            delta: float, max_partitions_contributed: int) -> float:
        pmf = self._compute_pmf()
        ps_strategy = partition_selection.create_partition_selection_strategy(
            strategy, eps, delta, max_partitions_contributed)
        counts = np.arange(pmf.start, pmf.start + len(pmf.probabilities))
        keep_probs = ps_strategy.probabilities(counts)
        return float(np.dot(pmf.probabilities, keep_probs))

    def _compute_pmf(self) -> poisson_binomial.PMF:
        if self.probabilities:
            return poisson_binomial.compute_pmf(self.probabilities)
        moments = self.moments
        std = math.sqrt(moments.variance)
        skewness = (0 if std == 0 else
                    moments.third_central_moment / std**3)
        return poisson_binomial.compute_pmf_approximation(
            moments.expectation, std, skewness, moments.count)


# (probabilities, moments) — mutually exclusive, see calculator docstring.
PartitionSelectionAccumulator = Tuple[Optional[List[float]],
                                      Optional[SumOfRandomVariablesMoments]]


def _merge_list(a: List, b: List) -> List:
    """In-place merge that always extends the longer list (O(min))."""
    shorter, longer = (a, b) if len(a) < len(b) else (b, a)
    longer.extend(shorter)
    return longer


def _merge_partition_selection_accumulators(
        acc1: PartitionSelectionAccumulator,
        acc2: PartitionSelectionAccumulator
) -> PartitionSelectionAccumulator:
    """Stays exact (explicit probability lists) while small; degrades to
    summed moments once the merged list would exceed the cap."""
    both_exact = acc1[1] is None and acc2[1] is None
    if both_exact and (len(acc1[0]) + len(acc2[0]) <=
                       MAX_PROBABILITIES_IN_ACCUMULATOR):
        return (_merge_list(acc1[0], acc2[0]), None)

    def as_moments(acc):
        return (acc[1] if acc[1] is not None else
                _probabilities_to_moments(acc[0]))

    return (None, as_moments(acc1) + as_moments(acc2))


class PartitionSelectionCombiner(UtilityAnalysisCombiner):
    """Tracks P(partition kept) per partition (reference :192-226)."""

    def __init__(self, params: dp_combiners.CombinerParams):
        self._params = params

    def create_accumulator(self, sparse_acc):
        count, sum_, n_partitions = sparse_acc
        max_partitions = (
            self._params.aggregate_params.max_partitions_contributed)
        prob_keep = np.where(
            n_partitions > 0,
            np.minimum(1, max_partitions / np.maximum(n_partitions, 1)), 0)
        acc = (list(prob_keep), None)
        return _merge_partition_selection_accumulators(acc, ([], None))

    def merge_accumulators(self, acc1, acc2):
        return _merge_partition_selection_accumulators(acc1, acc2)

    def compute_metrics(self, acc: PartitionSelectionAccumulator) -> float:
        probs, moments = acc
        params = self._params
        calculator = PartitionSelectionCalculator(probs, moments)
        return calculator.compute_probability_to_keep(
            params.aggregate_params.partition_selection_strategy,
            params.eps, params.delta,
            params.aggregate_params.max_partitions_contributed)


class SumCombiner(UtilityAnalysisCombiner):
    """Per-partition SUM error model, vectorized over the per-user arrays
    (reference :228-277). Accumulator = (partition_sum, error_min,
    error_max, expected_l0_error, var_l0_error)."""
    AccumulatorType = Tuple[float, float, float, float, float]

    def __init__(self, params: dp_combiners.CombinerParams):
        self._params = copy.copy(params)

    def create_accumulator(self, data) -> AccumulatorType:
        count, partition_sum, n_partitions = data
        del count
        p = self._params.aggregate_params
        min_bound = p.min_sum_per_partition
        max_bound = p.max_sum_per_partition
        max_partitions = p.max_partitions_contributed
        partition_sum = np.asarray(partition_sum, dtype=np.float64)
        n_partitions = np.asarray(n_partitions)
        l0_prob_keep = np.where(
            n_partitions > 0,
            np.minimum(1, max_partitions / np.maximum(n_partitions, 1)), 0)
        contribution = np.clip(partition_sum, min_bound, max_bound)
        error = contribution - partition_sum
        error_min = np.where(partition_sum < min_bound, error, 0)
        error_max = np.where(partition_sum > max_bound, error, 0)
        expected_l0 = -contribution * (1 - l0_prob_keep)
        var_l0 = contribution**2 * l0_prob_keep * (1 - l0_prob_keep)
        return (float(partition_sum.sum()), float(error_min.sum()),
                float(error_max.sum()), float(expected_l0.sum()),
                float(var_l0.sum()))

    def compute_metrics(self, acc: AccumulatorType) -> metrics.SumMetrics:
        (partition_sum, error_min, error_max, expected_l0, var_l0) = acc
        std_noise = dp_computations.compute_dp_count_noise_std(
            self._params.scalar_noise_params)
        return metrics.SumMetrics(
            sum=partition_sum,
            per_partition_error_min=error_min,
            per_partition_error_max=error_max,
            expected_cross_partition_error=expected_l0,
            std_cross_partition_error=math.sqrt(var_l0),
            std_noise=std_noise,
            noise_kind=self._params.aggregate_params.noise_kind)


class CountCombiner(SumCombiner):
    """COUNT reduces to SUM over per-user counts with synthetic bounds
    [0, max_contributions_per_partition] (reference :280-294). The bounds
    are set once on a private params copy in __init__ — the reference
    mutates the (possibly shared) params inside create_accumulator, which
    corrupts a sibling SUM analysis (reference bug :291-292, not
    replicated)."""

    def __init__(self, params):
        super().__init__(params)
        p = copy.copy(self._params.aggregate_params)
        p.min_sum_per_partition = 0.0
        p.max_sum_per_partition = p.max_contributions_per_partition
        self._params.aggregate_params = p

    def create_accumulator(self, sparse_acc):
        count, _sum, n_partitions = sparse_acc
        data = None, np.asarray(count, dtype=np.float64), n_partitions
        return super().create_accumulator(data)


class PrivacyIdCountCombiner(SumCombiner):
    """PRIVACY_ID_COUNT reduces to SUM over 0/1 indicators with bounds
    [0, 1] (reference :296-310; same mutation fix as CountCombiner)."""

    def __init__(self, params):
        super().__init__(params)
        p = copy.copy(self._params.aggregate_params)
        p.min_sum_per_partition = 0.0
        p.max_sum_per_partition = 1.0
        self._params.aggregate_params = p

    def create_accumulator(self, sparse_acc):
        counts, _sum, n_partitions = sparse_acc
        counts = np.where(np.asarray(counts) > 0, 1.0, 0.0)
        data = None, counts, n_partitions
        return super().create_accumulator(data)


class CompoundCombiner(dp_combiners.CompoundCombiner):
    """Sparse/dense compound accumulator (reference :313-381): raw
    (counts, sums, n_partitions) lists while small; per-combiner dense
    accumulators (vectorized create) once the sparse form would outgrow
    2x the number of internal combiners."""

    SparseAccumulatorType = Tuple[List[int], List[float], List[int]]
    DenseAccumulatorType = List[Any]
    AccumulatorType = Tuple[Optional[SparseAccumulatorType],
                            Optional[DenseAccumulatorType]]

    def create_accumulator(self, data) -> AccumulatorType:
        if not data:
            # Empty public partitions.
            return (([0], [0], [0]), None)
        return (([data[0]], [data[1]], [data[2]]), None)

    def _to_dense(self, sparse_acc) -> DenseAccumulatorType:
        sparse_acc = [np.array(a) for a in sparse_acc]
        return (len(sparse_acc[0]),
                tuple(c.create_accumulator(sparse_acc)
                      for c in self._combiners))

    def merge_accumulators(self, acc1, acc2):
        if acc1[0] and acc2[0]:  # both still sparse
            columns = tuple(_merge_list(s, t)
                            for s, t in zip(acc1[0], acc2[0]))
            if len(columns[0]) <= 2 * len(self._combiners):
                return (columns, None)
            return (None, self._to_dense(columns))
        return (None, super().merge_accumulators(
            self._as_dense(acc1), self._as_dense(acc2)))

    def _as_dense(self, acc):
        return self._to_dense(acc[0]) if acc[0] else acc[1]

    def compute_metrics(self, acc):
        return super().compute_metrics(self._as_dense(acc))


@dataclass
class AggregateErrorMetricsAccumulator:
    """Sums across partitions (noise_std excepted) — reference :384-465."""
    num_partitions: int
    kept_partitions_expected: float
    total_aggregate: float

    data_dropped_l0: float
    data_dropped_linf: float
    data_dropped_partition_selection: float

    error_l0_expected: float
    error_linf_expected: float
    error_linf_min_expected: float
    error_linf_max_expected: float
    error_l0_variance: float
    error_variance: float
    error_quantiles: List[float]
    rel_error_l0_expected: float
    rel_error_linf_expected: float
    rel_error_linf_min_expected: float
    rel_error_linf_max_expected: float
    rel_error_l0_variance: float
    rel_error_variance: float
    rel_error_quantiles: List[float]

    error_expected_w_dropped_partitions: float
    rel_error_expected_w_dropped_partitions: float

    noise_std: float

    def __add__(self, other):
        """Every field is additive across partitions (quantile lists
        elementwise) except noise_std, which is a per-mechanism constant
        carried through."""
        assert self.noise_std == other.noise_std, (
            "Accumulators must share noise_std to merge")
        merged = {}
        for field in dataclasses.fields(self):
            mine = getattr(self, field.name)
            theirs = getattr(other, field.name)
            if field.name == "noise_std":
                merged[field.name] = mine
            elif isinstance(mine, list):
                merged[field.name] = [a + b for a, b in zip(mine, theirs)]
            else:
                merged[field.name] = mine + theirs
        return AggregateErrorMetricsAccumulator(**merged)


class AggregateErrorMetricsCompoundCombiner(dp_combiners.CompoundCombiner):
    """Threads each partition's P(keep) into every metric's error
    accumulator (reference :468-485).

    Deliberate fix vs the reference (:470-483): the reference reads
    ``values[0]`` — the FIRST configuration's keep probability — into
    every configuration's error metrics, so a multi-parameter sweep
    scores all configurations with config 0's partition-selection
    behavior. Here each configuration's own selection combiner value
    (which precedes its metric combiners in the compound order) sets the
    probability for that configuration's metrics."""
    AccumulatorType = Tuple[int, Tuple]

    def create_accumulator(self, values) -> AccumulatorType:
        probability_to_keep = 1
        accumulators = []
        for combiner, value in zip(self._combiners, values):
            if isinstance(
                    combiner,
                    PrivatePartitionSelectionAggregateErrorMetricsCombiner):
                probability_to_keep = value
                accumulators.append(combiner.create_accumulator(value))
            else:
                accumulators.append(
                    combiner.create_accumulator(value, probability_to_keep))
        return 1, tuple(accumulators)


class SumAggregateErrorMetricsCombiner(dp_combiners.Combiner):
    """Aggregates per-partition SumMetrics across partitions
    (reference :488-679)."""
    AccumulatorType = AggregateErrorMetricsAccumulator

    def __init__(self, metric_type: metrics.AggregateMetricType,
                 error_quantiles: List[float]):
        self._metric_type = metric_type
        self._error_quantiles = self._invert_error_quantiles(
            error_quantiles)

    def create_accumulator(self,
                           partition_metrics: metrics.SumMetrics,
                           prob_to_keep: float = 1) -> AccumulatorType:
        """One partition's error contribution, weighted by its keep
        probability. The relative fields are the absolute fields scaled
        by 1/|true sum| (variances by 1/sum²), all zero on an empty
        partition."""
        m = partition_metrics
        keep = prob_to_keep
        bounding_error = (m.expected_cross_partition_error +
                          m.per_partition_error_min +
                          m.per_partition_error_max)

        absolute = {
            "error_l0_expected": keep * m.expected_cross_partition_error,
            "error_linf_min_expected": keep * m.per_partition_error_min,
            "error_linf_max_expected": keep * m.per_partition_error_max,
            "error_l0_variance": keep * m.std_cross_partition_error**2,
            "error_variance": keep * (m.std_cross_partition_error**2 +
                                      m.std_noise**2),
            "error_expected_w_dropped_partitions": (
                keep * bounding_error + (1 - keep) * -m.sum),
        }
        absolute["error_linf_expected"] = (
            absolute["error_linf_min_expected"] +
            absolute["error_linf_max_expected"])
        quantiles = self._compute_error_quantiles(keep, m)

        inv = 0.0 if m.sum == 0 else 1.0 / abs(m.sum)
        inv_sq = inv * inv
        relative = {
            "rel_" + name: value * (inv_sq if "variance" in name else inv)
            for name, value in absolute.items()
        }

        # COUNT-style metrics report what bounding/selection discards as
        # data-drop ratios; for SUM the clipped "excess" is not data.
        dropped = dict(data_dropped_l0=0.0, data_dropped_linf=0.0,
                       data_dropped_partition_selection=0.0)
        if self._metric_type != metrics.AggregateMetricType.SUM:
            dropped = dict(
                data_dropped_l0=-m.expected_cross_partition_error,
                data_dropped_linf=-m.per_partition_error_max,
                data_dropped_partition_selection=(
                    (1 - keep) * (m.sum + m.expected_cross_partition_error
                                  + m.per_partition_error_max)))

        return AggregateErrorMetricsAccumulator(
            num_partitions=1,
            kept_partitions_expected=keep,
            total_aggregate=m.sum,
            error_quantiles=quantiles,
            rel_error_quantiles=[q * inv for q in quantiles],
            noise_std=m.std_noise,
            **absolute, **relative, **dropped)

    def merge_accumulators(self, acc1, acc2):
        return acc1 + acc2

    # Fields averaged over EXPECTED KEPT partitions vs over ALL
    # partitions; data-drop sums become ratios of the total aggregate.
    _PER_KEPT = ("error_l0_expected", "error_linf_min_expected",
                 "error_linf_max_expected", "error_linf_expected",
                 "error_l0_variance", "error_variance", "error_quantiles",
                 "rel_error_l0_expected", "rel_error_linf_min_expected",
                 "rel_error_linf_max_expected", "rel_error_linf_expected",
                 "rel_error_l0_variance", "rel_error_variance",
                 "rel_error_quantiles")
    _PER_PARTITION = ("error_expected_w_dropped_partitions",
                      "rel_error_expected_w_dropped_partitions")

    def compute_metrics(self, acc) -> metrics.AggregateErrorMetrics:
        out = {}
        for name in self._PER_KEPT:
            value = getattr(acc, name)
            denom = acc.kept_partitions_expected
            out[name] = ([v / denom for v in value]
                         if isinstance(value, list) else value / denom)
        for name in self._PER_PARTITION:
            out[name] = getattr(acc, name) / acc.num_partitions
        out["error_expected"] = (out["error_l0_expected"] +
                                 out["error_linf_expected"])
        out["rel_error_expected"] = (out["rel_error_l0_expected"] +
                                     out["rel_error_linf_expected"])
        denom = max(1.0, acc.total_aggregate)
        for src, dst in (("data_dropped_l0", "ratio_data_dropped_l0"),
                         ("data_dropped_linf", "ratio_data_dropped_linf"),
                         ("data_dropped_partition_selection",
                          "ratio_data_dropped_partition_selection")):
            out[dst] = getattr(acc, src) / denom
        return metrics.AggregateErrorMetrics(
            metric_type=self._metric_type, noise_std=acc.noise_std, **out)

    def metrics_names(self) -> List[str]:
        return []

    def explain_computation(self):
        pass

    def _invert_error_quantiles(self,
                                quantiles: List[float]) -> List[float]:
        # Bounding error is negative, so the worst error quantiles come
        # from the (1-q) side of the noise+bounding distribution.
        return [(1 - q) for q in quantiles]

    def _compute_error_quantiles(self, prob_to_keep: float,
                                 metric: metrics.SumMetrics) -> List[float]:
        error_expectation = metric.expected_cross_partition_error
        error_std = math.sqrt(metric.std_cross_partition_error**2 +
                              metric.std_noise**2)
        if metric.noise_kind == NoiseKind.GAUSSIAN:
            qs = scipy.stats.norm.ppf(q=self._error_quantiles,
                                      loc=error_expectation,
                                      scale=error_std)
        else:
            qs = probability_computations.compute_sum_laplace_gaussian_quantiles(
                laplace_b=metric.std_noise / math.sqrt(2),
                gaussian_sigma=metric.std_cross_partition_error,
                quantiles=self._error_quantiles,
                num_samples=10**3)
            # Deliberate fix vs the reference (:669-675): its Laplace branch
            # samples a zero-centered distribution and never shifts by the
            # expected L0 error, while its Gaussian branch passes
            # loc=error_expectation — we center both consistently.
            qs = [q + error_expectation for q in qs]
        per_partition_error = (metric.per_partition_error_min +
                               metric.per_partition_error_max)
        return [
            prob_to_keep * (float(q) + per_partition_error) for q in qs
        ]


class PrivatePartitionSelectionAggregateErrorMetricsCombiner(
        dp_combiners.Combiner):
    """Aggregates keep probabilities into partition-selection metrics
    (reference :682-723)."""
    AccumulatorType = PartitionSelectionAccumulator

    def __init__(self, error_quantiles: List[float]):
        self._error_quantiles = error_quantiles

    def create_accumulator(self, prob_to_keep: float):
        return ([prob_to_keep], None)

    def merge_accumulators(self, acc1, acc2):
        return _merge_partition_selection_accumulators(acc1, acc2)

    def compute_metrics(self, acc) -> metrics.PartitionSelectionMetrics:
        probs, moments = acc
        if moments is None:
            moments = _probabilities_to_moments(probs)
        return metrics.PartitionSelectionMetrics(
            num_partitions=moments.count,
            dropped_partitions_expected=(moments.count -
                                         moments.expectation),
            dropped_partitions_variance=moments.variance)

    def metrics_names(self) -> List[str]:
        return []

    def explain_computation(self):
        pass
