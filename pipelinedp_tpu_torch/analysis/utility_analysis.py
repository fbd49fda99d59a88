"""Utility analysis: per-partition analysis, then per-configuration
aggregate metrics. The routing of
``pipelinedp_tpu/analysis/utility_analysis.py`` (capability parity with
the reference's ``analysis/utility_analysis.py``).

On a backend with the fused path (``TorchBackend``), input that passes
``torch_sweep.sweep_is_supported`` runs the whole multi-configuration
sweep on the backend's device: one result per parameter configuration,
bit for bit the JAX package's on the CPU. Everything else (a host
backend, params outside the sweep's gates, and per-partition rows past
the sweep's fetch cap) runs the host analysis graph,
``UtilityAnalysisEngine`` on the backend's host ops, exactly where the
JAX package runs it."""

from __future__ import annotations

from typing import List

from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch.aggregate_params import AggregateParams, Metrics
from pipelinedp_tpu_torch.analysis import combiners as ua_combiners
from pipelinedp_tpu_torch.analysis import data_structures, metrics
from pipelinedp_tpu_torch.analysis import utility_analysis_engine


def perform_utility_analysis(col, backend,
                             options: data_structures.UtilityAnalysisOptions,
                             data_extractors,
                             public_partitions=None,
                             return_per_partition: bool = False):
    """Runs utility analysis; returns a lazy 1-element collection with
    ``List[AggregateMetrics]``, one entry per parameter configuration
    (and, with ``return_per_partition``, the per-partition rows beside
    it). The fused sweep runs on first iteration, on ``backend.device``;
    the host graph runs when its result is iterated."""
    if getattr(backend, "supports_fused_aggregation", False):
        from pipelinedp_tpu_torch.analysis import torch_sweep
        if torch_sweep.sweep_is_supported(options, data_extractors,
                                          return_per_partition):
            utility_analysis_engine._check_utility_analysis_params(
                options, data_extractors)
            accountant = budget_accounting.NaiveBudgetAccountant(
                total_epsilon=options.epsilon, total_delta=options.delta)
            result = torch_sweep.build_fused_sweep(
                col, options, data_extractors, public_partitions,
                accountant, backend, device=backend.device,
                mesh=getattr(backend, "mesh", None),
                return_per_partition=return_per_partition,
                checkpoint=getattr(backend, "checkpoint", None))
            accountant.compute_budgets()
            if return_per_partition:
                return result, result.per_partition_rows()
            return result
    return _host_analysis(col, backend, options, data_extractors,
                          public_partitions, return_per_partition)


def _host_analysis(col, backend, options, data_extractors,
                   public_partitions, return_per_partition):
    """The host analysis graph: the oracle, and the path of what the fused
    sweep does not take."""
    budget_accountant = budget_accounting.NaiveBudgetAccountant(
        total_epsilon=options.epsilon, total_delta=options.delta)
    engine = utility_analysis_engine.UtilityAnalysisEngine(
        budget_accountant=budget_accountant, backend=backend)
    per_partition_result = engine.analyze(
        col, options=options, data_extractors=data_extractors,
        public_partitions=public_partitions)
    budget_accountant.compute_budgets()
    per_partition_result = backend.to_multi_transformable_collection(
        per_partition_result)

    aggregate_error_combiners = _create_aggregate_error_compound_combiner(
        options.aggregate_params, [0.1, 0.5, 0.9, 0.99],
        public_partitions is not None, options.n_configurations)
    keyed = backend.map(per_partition_result, lambda v: (None, v[1]),
                       "Rekey partitions by the same key")
    accumulators = backend.map_values(
        keyed, aggregate_error_combiners.create_accumulator,
        "Create accumulators for aggregating error metrics")
    aggregates = backend.combine_accumulators_per_key(
        accumulators, aggregate_error_combiners,
        "Combine aggregate metrics from per-partition error metrics")
    aggregates = backend.values(aggregates, "Drop key")
    aggregates = backend.map(aggregates,
                             aggregate_error_combiners.compute_metrics,
                             "Compute aggregate metrics")

    def pack_metrics(aggregate_metrics) -> List[metrics.AggregateMetrics]:
        # aggregate_metrics is a flat list; each configuration contributed
        # metrics_per_config sequential entries (reference :96-113).
        aggregate_params = list(
            data_structures.get_aggregate_params(options))
        n_configurations = len(aggregate_params)
        metrics_per_config = len(aggregate_metrics) // n_configurations
        out = []
        for i, params in enumerate(aggregate_params):
            packed = metrics.AggregateMetrics(input_aggregate_params=params)
            for j in range(i * metrics_per_config,
                           (i + 1) * metrics_per_config):
                _populate_packed_metrics(packed, aggregate_metrics[j])
            out.append(packed)
        return out

    result = backend.map(aggregates, pack_metrics,
                         "Pack metrics from the same run")
    if return_per_partition:
        return result, per_partition_result
    return result


def _populate_packed_metrics(packed: metrics.AggregateMetrics, metric):
    if isinstance(metric, metrics.PartitionSelectionMetrics):
        packed.partition_selection_metrics = metric
    elif metric.metric_type == metrics.AggregateMetricType.PRIVACY_ID_COUNT:
        packed.privacy_id_count_metrics = metric
    elif metric.metric_type == metrics.AggregateMetricType.COUNT:
        packed.count_metrics = metric
    elif metric.metric_type == metrics.AggregateMetricType.SUM:
        packed.sum_metrics = metric


def _create_aggregate_error_compound_combiner(
        aggregate_params: AggregateParams, error_quantiles: List[float],
        public_partitions: bool,
        n_configurations: int) -> ua_combiners.CompoundCombiner:
    internal_combiners = []
    for _ in range(n_configurations):
        if not public_partitions:
            internal_combiners.append(
                ua_combiners.
                PrivatePartitionSelectionAggregateErrorMetricsCombiner(
                    error_quantiles))
        # WARNING: this order mirrors
        # UtilityAnalysisEngine._create_compound_combiner().
        if Metrics.SUM in aggregate_params.metrics:
            internal_combiners.append(
                ua_combiners.SumAggregateErrorMetricsCombiner(
                    metrics.AggregateMetricType.SUM, error_quantiles))
        if Metrics.COUNT in aggregate_params.metrics:
            internal_combiners.append(
                ua_combiners.SumAggregateErrorMetricsCombiner(
                    metrics.AggregateMetricType.COUNT, error_quantiles))
        if Metrics.PRIVACY_ID_COUNT in aggregate_params.metrics:
            internal_combiners.append(
                ua_combiners.SumAggregateErrorMetricsCombiner(
                    metrics.AggregateMetricType.PRIVACY_ID_COUNT,
                    error_quantiles))
    return ua_combiners.AggregateErrorMetricsCompoundCombiner(
        internal_combiners, return_named_tuple=False)
