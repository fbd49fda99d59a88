"""Aggregation combiners of the host path: create/merge/compute state
machines. A copy of ``pipelinedp_tpu/combiners.py`` on the port's own
modules (capability parity with the reference's
``pipeline_dp/combiners.py``: contract at :40-53; Count :178,
PrivacyIdCount :211, Sum :242, Mean :280, Variance :337, Quantile :402,
VectorSum :606, Compound :507, factory :652).

Accumulators are flat numeric tuples, small arrays, or a serialized
quantile tree. ``compute_metrics`` reads eps and delta lazily through
``MechanismSpec`` (the two-phase budget protocol) and draws its noise from
the module-global host RNG (``ops.noise._host_rng``), in the JAX
package's order, so the same ``seed_host_rng`` seed releases the same
values. A user's own combiner subclasses ``CustomCombiner`` of this
module.
"""

from __future__ import annotations

import abc
import collections
import copy
from typing import Iterable, List, Sequence, Sized, Tuple

import numpy as np

from pipelinedp_tpu_torch import budget_accounting, dp_computations
from pipelinedp_tpu_torch.aggregate_params import AggregateParams, Metrics
from pipelinedp_tpu_torch.ops import quantile_tree as quantile_tree_ops


class Combiner(abc.ABC):
    """Base combiner contract (reference :32-75): ``create_accumulator`` on
    a chunk of values, associative ``merge_accumulators``, DP
    ``compute_metrics`` at the end."""

    @abc.abstractmethod
    def create_accumulator(self, values):
        """Creates an accumulator from raw values."""

    @abc.abstractmethod
    def merge_accumulators(self, accumulator1, accumulator2):
        """Merges two accumulators (must be associative)."""

    @abc.abstractmethod
    def compute_metrics(self, accumulator):
        """Computes the DP result from a final accumulator."""

    @abc.abstractmethod
    def metrics_names(self) -> List[str]:
        """Names of metrics this combiner produces."""

    @abc.abstractmethod
    def explain_computation(self):
        """String or zero-arg callable describing the computation."""


class CustomCombiner(Combiner, abc.ABC):
    """User extension point (reference :77-129): implements its own DP
    mechanism; requests budget during graph construction."""

    @abc.abstractmethod
    def request_budget(self,
                       budget_accountant: budget_accounting.BudgetAccountant):
        """Called during construction; store the returned spec on self —
        do NOT store the accountant itself (it stays in the main process)."""

    def set_aggregate_params(self, aggregate_params: AggregateParams):
        self._aggregate_params = aggregate_params

    def metrics_names(self) -> List[str]:
        return [self.__class__.__name__]


class CombinerParams:
    """Marries a lazy ``MechanismSpec`` with a copy of the aggregate params
    (reference :131-175). eps/delta resolve at execution time."""

    def __init__(self, spec: budget_accounting.MechanismSpec,
                 aggregate_params: AggregateParams):
        self._mechanism_spec = spec
        self.aggregate_params = copy.copy(aggregate_params)

    @property
    def mechanism_spec(self) -> budget_accounting.MechanismSpec:
        return self._mechanism_spec

    @property
    def eps(self):
        return self._mechanism_spec.eps

    @property
    def delta(self):
        return self._mechanism_spec.delta

    @property
    def scalar_noise_params(self) -> dp_computations.ScalarNoiseParams:
        p = self.aggregate_params
        return dp_computations.ScalarNoiseParams(
            self.eps, self.delta, p.min_value, p.max_value,
            p.min_sum_per_partition, p.max_sum_per_partition,
            p.max_partitions_contributed, p.max_contributions_per_partition,
            p.noise_kind, max_contributions=p.max_contributions)

    @property
    def additive_vector_noise_params(
            self) -> dp_computations.AdditiveVectorNoiseParams:
        p = self.aggregate_params
        return dp_computations.AdditiveVectorNoiseParams(
            eps_per_coordinate=self.eps / p.vector_size,
            delta_per_coordinate=self.delta / p.vector_size,
            max_norm=p.vector_max_norm,
            l0_sensitivity=p.max_partitions_contributed,
            linf_sensitivity=p.max_contributions_per_partition,
            norm_kind=p.vector_norm_kind,
            noise_kind=p.noise_kind)


class CountCombiner(Combiner):
    """DP count; accumulator = int (reference :178-208)."""
    AccumulatorType = int

    def __init__(self, params: CombinerParams):
        self._params = params

    def create_accumulator(self, values: Sized) -> int:
        return len(values)

    def merge_accumulators(self, count1: int, count2: int) -> int:
        return count1 + count2

    def compute_metrics(self, count: int) -> dict:
        return {
            "count":
                dp_computations.compute_dp_count(
                    count, self._params.scalar_noise_params)
        }

    def metrics_names(self) -> List[str]:
        return ["count"]

    def explain_computation(self):
        return lambda: (f"Computed count with (eps={self._params.eps} "
                        f"delta={self._params.delta})")


class PrivacyIdCountCombiner(Combiner):
    """DP count of distinct privacy units; each create() contributes 0/1
    (reference :211-239)."""
    AccumulatorType = int

    def __init__(self, params: CombinerParams):
        self._params = params

    def create_accumulator(self, values: Sized) -> int:
        return 1 if values else 0

    def merge_accumulators(self, c1: int, c2: int) -> int:
        return c1 + c2

    def compute_metrics(self, count: int) -> dict:
        return {
            "privacy_id_count":
                dp_computations.compute_dp_privacy_id_count(
                    count, self._params.scalar_noise_params)
        }

    def metrics_names(self) -> List[str]:
        return ["privacy_id_count"]

    def explain_computation(self):
        return lambda: (f"Computed privacy id count with "
                        f"(eps={self._params.eps} delta={self._params.delta})")


class SumCombiner(Combiner):
    """DP sum with either per-value clipping or per-partition-sum clipping
    (reference :242-279)."""
    AccumulatorType = float

    def __init__(self, params: CombinerParams):
        self._params = params
        self._bounding_per_partition = (
            params.aggregate_params.bounds_per_partition_are_set)

    def create_accumulator(self, values: Iterable[float]) -> float:
        p = self._params.aggregate_params
        values = np.asarray(list(values), dtype=np.float64)
        if self._bounding_per_partition:
            return float(
                np.clip(values.sum(), p.min_sum_per_partition,
                        p.max_sum_per_partition))
        return float(np.clip(values, p.min_value, p.max_value).sum())

    def merge_accumulators(self, sum1: float, sum2: float) -> float:
        return sum1 + sum2

    def compute_metrics(self, sum_: float) -> dict:
        return {
            "sum":
                dp_computations.compute_dp_sum(
                    sum_, self._params.scalar_noise_params)
        }

    def metrics_names(self) -> List[str]:
        return ["sum"]

    def explain_computation(self):
        return lambda: (f"Computed sum with (eps={self._params.eps} "
                        f"delta={self._params.delta})")


class MeanCombiner(Combiner):
    """DP mean (optionally also count/sum); accumulator =
    (count, normalized_sum) (reference :280-334)."""
    AccumulatorType = Tuple[int, float]

    def __init__(self, params: CombinerParams,
                 metrics_to_compute: Iterable[str]):
        self._params = params
        metrics_to_compute = list(metrics_to_compute)
        if len(metrics_to_compute) != len(set(metrics_to_compute)):
            raise ValueError(f"{metrics_to_compute} cannot contain "
                             "duplicates")
        allowed = ["count", "sum", "mean"]
        for metric in metrics_to_compute:
            if metric not in allowed:
                raise ValueError(f"{metric} should be one of {allowed}")
        if "mean" not in metrics_to_compute:
            raise ValueError(
                f"one of the {metrics_to_compute} should be 'mean'")
        self._metrics_to_compute = metrics_to_compute

    def create_accumulator(self, values: Iterable[float]) -> Tuple[int,
                                                                   float]:
        p = self._params.aggregate_params
        values = np.asarray(list(values), dtype=np.float64)
        middle = dp_computations.compute_middle(p.min_value, p.max_value)
        normalized = np.clip(values, p.min_value, p.max_value) - middle
        return len(values), float(normalized.sum())

    def merge_accumulators(self, a1, a2):
        return a1[0] + a2[0], a1[1] + a2[1]

    def compute_metrics(self, accum) -> dict:
        count, normalized_sum = accum
        noisy_count, noisy_sum, noisy_mean = dp_computations.compute_dp_mean(
            count, normalized_sum, self._params.scalar_noise_params)
        out = {"mean": noisy_mean}
        if "count" in self._metrics_to_compute:
            out["count"] = noisy_count
        if "sum" in self._metrics_to_compute:
            out["sum"] = noisy_sum
        return out

    def metrics_names(self) -> List[str]:
        return self._metrics_to_compute

    def explain_computation(self):
        return lambda: (f"Computed mean with (eps={self._params.eps} "
                        f"delta={self._params.delta})")


class VarianceCombiner(Combiner):
    """DP variance (optionally also count/sum/mean); accumulator =
    (count, normalized_sum, normalized_sum_squares) (reference :337-400)."""
    AccumulatorType = Tuple[int, float, float]

    def __init__(self, params: CombinerParams,
                 metrics_to_compute: Iterable[str]):
        self._params = params
        metrics_to_compute = list(metrics_to_compute)
        if len(metrics_to_compute) != len(set(metrics_to_compute)):
            raise ValueError(f"{metrics_to_compute} cannot contain "
                             "duplicates")
        allowed = ["count", "sum", "mean", "variance"]
        for metric in metrics_to_compute:
            if metric not in allowed:
                raise ValueError(f"{metric} should be one of {allowed}")
        if "variance" not in metrics_to_compute:
            raise ValueError(
                f"one of the {metrics_to_compute} should be 'variance'")
        self._metrics_to_compute = metrics_to_compute

    def create_accumulator(self, values):
        p = self._params.aggregate_params
        values = np.asarray(list(values), dtype=np.float64)
        middle = dp_computations.compute_middle(p.min_value, p.max_value)
        normalized = np.clip(values, p.min_value, p.max_value) - middle
        return (len(values), float(normalized.sum()),
                float((normalized**2).sum()))

    def merge_accumulators(self, a1, a2):
        return a1[0] + a2[0], a1[1] + a2[1], a1[2] + a2[2]

    def compute_metrics(self, accum) -> dict:
        count, nsum, nsum_squares = accum
        (noisy_count, noisy_sum, noisy_mean,
         noisy_variance) = dp_computations.compute_dp_var(
             count, nsum, nsum_squares, self._params.scalar_noise_params)
        out = {"variance": noisy_variance}
        if "count" in self._metrics_to_compute:
            out["count"] = noisy_count
        if "sum" in self._metrics_to_compute:
            out["sum"] = noisy_sum
        if "mean" in self._metrics_to_compute:
            out["mean"] = noisy_mean
        return out

    def metrics_names(self) -> List[str]:
        return self._metrics_to_compute

    def explain_computation(self):
        return lambda: (f"Computed variance with (eps={self._params.eps} "
                        f"delta={self._params.delta})")


class QuantileCombiner(Combiner):
    """DP percentiles via the quantile tree (reference :402-476); the
    accumulator is the serialized tree bytes, so it flows through any
    backend's shuffle."""
    AccumulatorType = bytes

    def __init__(self, params: CombinerParams,
                 percentiles_to_compute: List[float]):
        self._params = params
        self._percentiles = percentiles_to_compute
        self._quantiles_to_compute = [p / 100 for p in
                                      percentiles_to_compute]

    def create_accumulator(self, values) -> bytes:
        tree = self._create_empty_quantile_tree()
        for value in values:
            tree.add_entry(value)
        return tree.serialize()

    def merge_accumulators(self, acc1: bytes, acc2: bytes) -> bytes:
        tree = self._create_empty_quantile_tree()
        tree.merge(acc1)
        tree.merge(acc2)
        return tree.serialize()

    def compute_metrics(self, accumulator: bytes) -> dict:
        tree = self._create_empty_quantile_tree()
        tree.merge(accumulator)
        p = self._params.aggregate_params
        # Total-cap mode maps to the concentration-safe (1, M) pair, the
        # same calculus as the fused path's noise scales.
        l0, linf = dp_computations.count_sensitivity_pair(
            p.max_partitions_contributed,
            p.max_contributions_per_partition, p.max_contributions)
        quantiles = tree.compute_quantiles(
            self._params.eps, self._params.delta, int(l0), int(linf),
            self._quantiles_to_compute, p.noise_kind)
        return dict(zip(self.metrics_names(), quantiles))

    def metrics_names(self) -> List[str]:

        def format_metric_name(p: float):
            int_p = int(round(p))
            if int_p == p:
                p = int_p
            else:
                p = str(p).replace(".", "_")
            return f"percentile_{p}"

        return [format_metric_name(p) for p in self._percentiles]

    def explain_computation(self):
        return lambda: (f"Computed percentiles {self._percentiles} with "
                        f"(eps={self._params.eps} "
                        f"delta={self._params.delta})")

    def _create_empty_quantile_tree(self):
        p = self._params.aggregate_params
        return quantile_tree_ops.QuantileTree(
            p.min_value, p.max_value, quantile_tree_ops.DEFAULT_TREE_HEIGHT,
            quantile_tree_ops.DEFAULT_BRANCHING_FACTOR)


class VectorSumCombiner(Combiner):
    """DP vector sum; accumulator = np.ndarray (reference :606-650)."""
    AccumulatorType = np.ndarray

    def __init__(self, params: CombinerParams):
        self._params = params

    def create_accumulator(self, values) -> np.ndarray:
        size = self._params.aggregate_params.vector_size
        array_sum = None
        for val in values:
            val = np.asarray(val)
            if val.shape != (size,):
                raise TypeError(
                    f"Shape mismatch: {val.shape} != {(size,)}")
            array_sum = val if array_sum is None else array_sum + val
        if array_sum is None:
            array_sum = np.zeros(size)
        return array_sum

    def merge_accumulators(self, s1: np.ndarray, s2: np.ndarray):
        return s1 + s2

    def compute_metrics(self, array_sum: np.ndarray) -> dict:
        return {
            "vector_sum":
                dp_computations.add_noise_vector(
                    array_sum, self._params.additive_vector_noise_params)
        }

    def metrics_names(self) -> List[str]:
        return ["vector_sum"]

    def explain_computation(self):
        return lambda: (f"Computed vector sum with (eps={self._params.eps} "
                        f"delta={self._params.delta})")


# --- MetricsTuple plumbing (reference :485-504): a cached namedtuple type
# with a custom __reduce__ so instances survive pickling across workers. ---

_named_tuple_cache = {}


def _get_or_create_named_tuple(type_name: str, field_names: tuple):
    cache_key = (type_name, field_names)
    named_tuple = _named_tuple_cache.get(cache_key)
    if named_tuple is None:
        named_tuple = collections.namedtuple(type_name, field_names)
        named_tuple.__reduce__ = lambda self: (_create_named_tuple_instance,
                                               (type_name, field_names,
                                                tuple(self)))
        _named_tuple_cache[cache_key] = named_tuple
    return named_tuple


def _create_named_tuple_instance(type_name: str, field_names: tuple, values):
    return _get_or_create_named_tuple(type_name, field_names)(*values)


class CompoundCombiner(Combiner):
    """Bundles several combiners; the accumulator is
    ``(row_count, (child_accumulators...))`` where ``row_count`` doubles as
    the raw privacy-id count used by partition selection (reference
    :507-604; consumption at ``dp_engine.py:339``)."""

    AccumulatorType = Tuple[int, Tuple]

    def __init__(self, combiners: Iterable[Combiner],
                 return_named_tuple: bool):
        self._combiners = list(combiners)
        self._return_named_tuple = return_named_tuple
        self._metrics_to_compute: Sequence[str] = []
        if not return_named_tuple:
            return
        metrics = []
        for combiner in self._combiners:
            metrics.extend(combiner.metrics_names())
        if len(metrics) != len(set(metrics)):
            raise ValueError(f"two combiners in {self._combiners} cannot "
                             "compute the same metrics")
        # The namedtuple class is deliberately not stored on self: dynamic
        # classes pickle by module-attribute reference, which fails when
        # the combiner ships to worker processes. compute_metrics creates
        # instances through the cached factory instead.
        self._metrics_to_compute = tuple(metrics)

    @property
    def combiners(self) -> List[Combiner]:
        return self._combiners

    def create_accumulator(self, values) -> AccumulatorType:
        return (1, tuple(c.create_accumulator(values)
                         for c in self._combiners))

    def merge_accumulators(self, acc1, acc2):
        row_count1, children1 = acc1
        row_count2, children2 = acc2
        merged = tuple(
            c.merge_accumulators(a1, a2)
            for c, a1, a2 in zip(self._combiners, children1, children2))
        return (row_count1 + row_count2, merged)

    def compute_metrics(self, compound_accumulator):
        _, children = compound_accumulator
        if not self._return_named_tuple:
            return tuple(
                c.compute_metrics(acc)
                for c, acc in zip(self._combiners, children))
        combined = {}
        for combiner, acc in zip(self._combiners, children):
            for metric, value in combiner.compute_metrics(acc).items():
                if metric in combined:
                    raise Exception(
                        f"{metric} computed by {combiner} was already "
                        "computed by another combiner")
                combined[metric] = value
        return _create_named_tuple_instance("MetricsTuple",
                                            tuple(combined.keys()),
                                            tuple(combined.values()))

    def metrics_names(self) -> List[str]:
        return list(self._metrics_to_compute)

    def explain_computation(self):
        return [c.explain_computation() for c in self._combiners]


def create_compound_combiner(
        aggregate_params: AggregateParams,
        budget_accountant: budget_accounting.BudgetAccountant
) -> CompoundCombiner:
    """Maps Metrics -> combiners with one budget request per metric;
    VARIANCE subsumes MEAN subsumes COUNT/SUM (reference :652-721)."""
    combiners: List[Combiner] = []
    mechanism_type = aggregate_params.noise_kind.convert_to_mechanism_type()
    metrics = aggregate_params.metrics
    weight = aggregate_params.budget_weight

    def request(metric: str, internal_splits: int = 1):
        # internal_splits declares how many sub-mechanisms the combiner
        # will evenly split the granted budget into (mean = count +
        # normalized sum, variance adds the normalized sum of squares,
        # vectors release per coordinate, quantile trees per level) — the
        # PLD accountant composes them individually. ``metric`` labels
        # the mechanism in the privacy audit record.
        return budget_accountant.request_budget(
            mechanism_type, weight=weight, internal_splits=internal_splits,
            metric=metric)

    if Metrics.VARIANCE in metrics:
        metrics_to_compute = ["variance"]
        if Metrics.MEAN in metrics:
            metrics_to_compute.append("mean")
        if Metrics.COUNT in metrics:
            metrics_to_compute.append("count")
        if Metrics.SUM in metrics:
            metrics_to_compute.append("sum")
        combiners.append(
            VarianceCombiner(
                CombinerParams(request("variance", internal_splits=3),
                               aggregate_params), metrics_to_compute))
    elif Metrics.MEAN in metrics:
        metrics_to_compute = ["mean"]
        if Metrics.COUNT in metrics:
            metrics_to_compute.append("count")
        if Metrics.SUM in metrics:
            metrics_to_compute.append("sum")
        combiners.append(
            MeanCombiner(
                CombinerParams(request("mean", internal_splits=2),
                               aggregate_params), metrics_to_compute))
    else:
        if Metrics.COUNT in metrics:
            combiners.append(
                CountCombiner(
                    CombinerParams(request("count"), aggregate_params)))
        if Metrics.SUM in metrics:
            combiners.append(
                SumCombiner(
                    CombinerParams(request("sum"), aggregate_params)))
    if Metrics.PRIVACY_ID_COUNT in metrics:
        combiners.append(
            PrivacyIdCountCombiner(
                CombinerParams(request("privacy_id_count"),
                               aggregate_params)))
    if Metrics.VECTOR_SUM in metrics:
        combiners.append(
            VectorSumCombiner(
                CombinerParams(
                    request("vector_sum",
                            internal_splits=aggregate_params.vector_size),
                    aggregate_params)))
    percentiles_to_compute = [
        m.parameter for m in metrics if m.is_percentile
    ]
    if percentiles_to_compute:
        combiners.append(
            QuantileCombiner(
                CombinerParams(
                    request("percentile", internal_splits=(
                        quantile_tree_ops.DEFAULT_TREE_HEIGHT)),
                    aggregate_params), percentiles_to_compute))
    return CompoundCombiner(combiners, return_named_tuple=True)


def create_compound_combiner_with_custom_combiners(
        aggregate_params: AggregateParams,
        budget_accountant: budget_accounting.BudgetAccountant,
        custom_combiners: Iterable[CustomCombiner]) -> CompoundCombiner:
    """reference :723-731"""
    for combiner in custom_combiners:
        combiner.request_budget(budget_accountant)
        combiner.set_aggregate_params(aggregate_params)
    return CompoundCombiner(custom_combiners, return_named_tuple=False)
