"""Utility analysis on the device: the fused branch of
``pipelinedp_tpu/analysis/utility_analysis.py``.

``perform_utility_analysis(col, TorchBackend(...), options, extractors)``
runs the whole multi-configuration sweep on the backend's device
(``torch_sweep``): one result per parameter configuration, bit for bit
the JAX package's on the CPU. The host analysis graph, which the JAX
package runs for what its fused path does not take, is ROADMAP step 2
here and raises."""

from __future__ import annotations

from pipelinedp_tpu_torch import budget_accounting
from pipelinedp_tpu_torch.aggregate_params import Metrics
from pipelinedp_tpu_torch.analysis import data_structures, torch_sweep


def perform_utility_analysis(col, backend,
                             options: data_structures.UtilityAnalysisOptions,
                             data_extractors,
                             public_partitions=None,
                             return_per_partition: bool = False):
    """Runs utility analysis; returns a lazy 1-element collection with
    ``List[AggregateMetrics]``, one entry per parameter configuration
    (and, with ``return_per_partition``, the per-partition rows beside
    it). The sweep runs on first iteration, on ``backend.device``."""
    if not getattr(backend, "supports_fused_aggregation", False):
        raise torch_sweep._not_ported(
            f"utility analysis on {type(backend).__name__} (the host "
            "analysis graph)", 2)
    if not torch_sweep.sweep_is_supported(options, data_extractors,
                                          return_per_partition):
        raise torch_sweep._not_ported(
            "utility analysis outside the fused sweep's gates (the host "
            "analysis graph)", 2)
    _check_utility_analysis_params(options, data_extractors)
    accountant = budget_accounting.NaiveBudgetAccountant(
        total_epsilon=options.epsilon, total_delta=options.delta)
    result = torch_sweep.build_fused_sweep(
        col, options, data_extractors, public_partitions, accountant,
        device=backend.device, mesh=getattr(backend, "mesh", None),
        return_per_partition=return_per_partition,
        checkpoint=getattr(backend, "checkpoint", None))
    accountant.compute_budgets()
    if return_per_partition:
        return result, result.per_partition_rows()
    return result


def preaggregate(col, backend, data_extractors,
                 partitions_sampling_prob: float = 1):
    """The host pre-aggregation graph of the JAX package: not ported."""
    raise torch_sweep._not_ported(
        "preaggregate (the host analysis graph)", 2)


def _check_utility_analysis_params(options, data_extractors):
    from pipelinedp_tpu_torch.dp_engine import DataExtractors
    if options.pre_aggregated_data:
        if not isinstance(data_extractors,
                          data_structures.PreAggregateExtractors):
            raise ValueError(
                "options.pre_aggregated_data is set to true but "
                "PreAggregateExtractors aren't provided. "
                "PreAggregateExtractors should be specified for "
                "pre-aggregated data.")
    elif not isinstance(data_extractors, DataExtractors):
        raise ValueError(
            "DataExtractors should be specified for raw data.")
    params = options.aggregate_params
    if params.custom_combiners is not None:
        raise NotImplementedError("custom combiners are not supported")
    if params.max_contributions is not None:
        raise NotImplementedError(
            "utility analysis models (l0, linf) bounding; "
            "max_contributions is not supported")
    supported = {Metrics.COUNT, Metrics.SUM, Metrics.PRIVACY_ID_COUNT}
    if not set(params.metrics).issubset(supported):
        unsupported = list(set(params.metrics) - supported)
        raise NotImplementedError(
            f"unsupported metric in metrics={unsupported}")
    if params.contribution_bounds_already_enforced:
        raise NotImplementedError(
            "utility analysis when contribution bounds are already "
            "enforced is not supported")
