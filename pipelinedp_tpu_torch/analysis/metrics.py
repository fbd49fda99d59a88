"""Utility-analysis result dataclasses: a copy of
``pipelinedp_tpu/analysis/metrics.py`` on the port's own parameter types
(capability parity with the reference's ``analysis/metrics.py``)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from enum import Enum
from typing import List, Optional

from pipelinedp_tpu_torch.aggregate_params import (AggregateParams, Metric,
                                             NoiseKind,
                                             PartitionSelectionStrategy)


@dataclass
class SumMetrics:
    """Per-partition utility metrics for SUM (also reused for COUNT and
    PRIVACY_ID_COUNT — reference ``metrics.py:23-56``).

    Invariant: E(sum_after_bounding) = sum + per_partition_error_min +
    per_partition_error_max + expected_cross_partition_error."""
    sum: float
    per_partition_error_min: float
    per_partition_error_max: float
    expected_cross_partition_error: float
    std_cross_partition_error: float
    std_noise: float
    noise_kind: NoiseKind


class AggregateMetricType(Enum):
    PRIVACY_ID_COUNT = "privacy_id_count"
    COUNT = "count"
    SUM = "sum"


@dataclass
class AggregateErrorMetrics:
    """Cross-partition aggregate error metrics (averages across kept
    partitions; ratio_* are global data-drop ratios) — reference
    ``metrics.py:58-116``."""
    metric_type: AggregateMetricType

    ratio_data_dropped_l0: float
    ratio_data_dropped_linf: float
    ratio_data_dropped_partition_selection: float

    error_l0_expected: float
    error_linf_expected: float
    error_linf_min_expected: float
    error_linf_max_expected: float
    error_expected: float
    error_l0_variance: float
    error_variance: float
    error_quantiles: List[float]
    rel_error_l0_expected: float
    rel_error_linf_expected: float
    rel_error_linf_min_expected: float
    rel_error_linf_max_expected: float
    rel_error_expected: float
    rel_error_l0_variance: float
    rel_error_variance: float
    rel_error_quantiles: List[float]

    # Include the error contributed by entirely-dropped partitions.
    error_expected_w_dropped_partitions: float
    rel_error_expected_w_dropped_partitions: float

    noise_std: float

    def absolute_rmse(self) -> float:
        return math.sqrt(self.error_expected**2 + self.error_variance)

    def relative_rmse(self) -> float:
        return math.sqrt(self.rel_error_expected**2 +
                         self.rel_error_variance)


@dataclass
class PartitionSelectionMetrics:
    """Aggregate partition-selection metrics (reference :118-125)."""
    num_partitions: float
    dropped_partitions_expected: float
    dropped_partitions_variance: float


@dataclass
class AggregateMetrics:
    """Utility-analysis result for one parameter configuration
    (reference :127-146)."""
    input_aggregate_params: AggregateParams

    count_metrics: Optional[AggregateErrorMetrics] = None
    sum_metrics: Optional[AggregateErrorMetrics] = None
    privacy_id_count_metrics: Optional[AggregateErrorMetrics] = None
    partition_selection_metrics: Optional[PartitionSelectionMetrics] = None


# --- The "new" richer report schema (reference :149-302; present in the
# reference but not yet fully wired — provided for API completeness). ---


@dataclass
class MeanVariance:
    mean: float
    var: float


@dataclass
class ContributionBoundingErrors:
    l0: MeanVariance
    linf: float
    linf_min: float
    linf_max: float


@dataclass
class ValueErrors:
    bounding_errors: ContributionBoundingErrors
    bias: float
    variance: float
    rmse: float
    l1: float
    with_dropped_partitions: float


@dataclass
class DataDropInfo:
    l0: float
    linf: float
    partition_selection: float


@dataclass
class MetricUtility:
    metric: Metric
    num_dataset_partitions: int
    num_non_public_partitions: int
    num_empty_partitions: int
    noise_std: float
    noise_kind: NoiseKind
    ratio_data_dropped: DataDropInfo
    absolute_error: ValueErrors
    relative_error: ValueErrors


@dataclass
class PrivatePartitionSelectionUtility:
    strategy: PartitionSelectionStrategy
    num_partitions: float
    dropped_partitions: MeanVariance
    ratio_dropped_data: float


@dataclass
class UtilityReport:
    input_aggregate_params: AggregateParams
    metric_errors: Optional[List[MetricUtility]] = None
    partition_selection_metrics: Optional[
        PrivatePartitionSelectionUtility] = None


def _value_errors(m: AggregateErrorMetrics, relative: bool) -> ValueErrors:
    prefix = "rel_" if relative else ""

    def g(name):
        return getattr(m, prefix + name)

    bias = g("error_expected")
    variance = max(g("error_variance"), 0.0)  # guards fp cancellation
    std = math.sqrt(variance)
    # E|error| under the CLT Gaussian approximation of the error
    # distribution N(bias, variance) — the closest l1 derivable from the
    # stored moments.
    if std == 0:
        l1 = abs(bias)
    else:
        z = bias / std
        l1 = (std * math.sqrt(2.0 / math.pi) * math.exp(-0.5 * z * z) +
              bias * math.erf(z / math.sqrt(2.0)))
    return ValueErrors(
        bounding_errors=ContributionBoundingErrors(
            l0=MeanVariance(g("error_l0_expected"), g("error_l0_variance")),
            linf=g("error_linf_expected"),
            linf_min=g("error_linf_min_expected"),
            linf_max=g("error_linf_max_expected")),
        bias=bias,
        variance=variance,
        rmse=math.sqrt(bias**2 + variance),
        l1=l1,
        with_dropped_partitions=g("error_expected_w_dropped_partitions"))


def to_utility_report(aggregate: AggregateMetrics) -> UtilityReport:
    """Converts the flat result schema into the richer ``UtilityReport``
    (the reference carries this schema but never wires it — reference
    ``metrics.py:149-302``; this converter is this build's wiring).

    Fields the flat schema does not track default to 0
    (``num_non_public_partitions``, ``num_empty_partitions``); ``l1``
    error is derived from the stored moments under a Gaussian
    approximation of the error distribution.
    """
    from pipelinedp_tpu_torch.aggregate_params import Metrics

    params = aggregate.input_aggregate_params
    sel = aggregate.partition_selection_metrics
    n_partitions = int(sel.num_partitions) if sel is not None else 0

    pairs = [(Metrics.COUNT, aggregate.count_metrics),
             (Metrics.SUM, aggregate.sum_metrics),
             (Metrics.PRIVACY_ID_COUNT,
              aggregate.privacy_id_count_metrics)]
    errors = []
    ratio_dropped_sel = 0.0
    for metric, m in pairs:
        if m is None:
            continue
        ratio_dropped_sel = max(ratio_dropped_sel,
                                m.ratio_data_dropped_partition_selection)
        errors.append(MetricUtility(
            metric=metric,
            num_dataset_partitions=n_partitions,
            num_non_public_partitions=0,
            num_empty_partitions=0,
            noise_std=m.noise_std,
            noise_kind=params.noise_kind,
            ratio_data_dropped=DataDropInfo(
                l0=m.ratio_data_dropped_l0,
                linf=m.ratio_data_dropped_linf,
                partition_selection=(
                    m.ratio_data_dropped_partition_selection)),
            absolute_error=_value_errors(m, relative=False),
            relative_error=_value_errors(m, relative=True)))

    selection_utility = None
    if sel is not None:
        selection_utility = PrivatePartitionSelectionUtility(
            strategy=params.partition_selection_strategy,
            num_partitions=sel.num_partitions,
            dropped_partitions=MeanVariance(
                sel.dropped_partitions_expected,
                sel.dropped_partitions_variance),
            ratio_dropped_data=ratio_dropped_sel)
    return UtilityReport(input_aggregate_params=params,
                         metric_errors=errors or None,
                         partition_selection_metrics=selection_utility)
