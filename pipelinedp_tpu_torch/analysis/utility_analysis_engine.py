"""UtilityAnalysisEngine: the DPEngine graph with analysis nodes swapped
in. A copy of ``pipelinedp_tpu/analysis/utility_analysis_engine.py``
(capability parity with the reference's
``analysis/utility_analysis_engine.py``). It never takes the fused path."""

from __future__ import annotations

from pipelinedp_tpu_torch import combiners as dp_combiners
from pipelinedp_tpu_torch import dp_engine
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams,
                                                   MechanismType, Metrics)
from pipelinedp_tpu_torch.analysis import combiners as ua_combiners
from pipelinedp_tpu_torch.analysis import contribution_bounders as ua_bounders
from pipelinedp_tpu_torch.analysis import data_structures


class UtilityAnalysisEngine(dp_engine.DPEngine):
    """Performs utility analysis by subclassing DPEngine and swapping the
    bounder, compound combiner, and partition-selection nodes."""

    _supports_fused_dispatch = False  # analysis swaps graph nodes

    def __init__(self, budget_accountant, backend):
        super().__init__(budget_accountant, backend)
        self._is_public_partitions = None
        self._options = None

    def aggregate(self, col, params, data_extractors,
                  public_partitions=None):
        raise ValueError(
            "UtilityAnalysisEngine.aggregate can't be called.\n"
            "If you'd like to perform utility analysis, use "
            "UtilityAnalysisEngine.analyze.\n"
            "If you'd like to perform DP computations, use "
            "DPEngine.aggregate.")

    def analyze(self, col, options: data_structures.UtilityAnalysisOptions,
                data_extractors, public_partitions=None):
        """Per-partition utility analysis. Returns a collection of
        (partition_key, per-partition metrics tuple)."""
        _check_utility_analysis_params(options, data_extractors)
        self._options = options
        self._is_public_partitions = public_partitions is not None
        result = super(UtilityAnalysisEngine, self).aggregate(
            col, options.aggregate_params, data_extractors,
            public_partitions)
        self._is_public_partitions = None
        self._options = None
        return result

    # -- node swaps --

    def _create_contribution_bounder(self, params: AggregateParams):
        if self._options.pre_aggregated_data:
            return ua_bounders.NoOpContributionBounder()
        return ua_bounders.SamplingL0LinfContributionBounder(
            self._options.partitions_sampling_prob)

    def _create_compound_combiner(self, aggregate_params: AggregateParams):
        mechanism_type = data_structures.analysis_mechanism_type(
            self._options)
        if not self._is_public_partitions:
            selection_budget = self._budget_accountant.request_budget(
                MechanismType.GENERIC,
                weight=aggregate_params.budget_weight)
        budgets = {}
        for metric in aggregate_params.metrics:
            budgets[metric] = self._budget_accountant.request_budget(
                mechanism_type, weight=aggregate_params.budget_weight)

        internal_combiners = []
        for params in data_structures.get_aggregate_params(self._options):
            # WARNING: this order is the contract with
            # _create_aggregate_error_compound_combiner() in
            # utility_analysis.py — do not change it.
            if not self._is_public_partitions:
                internal_combiners.append(
                    ua_combiners.PartitionSelectionCombiner(
                        dp_combiners.CombinerParams(selection_budget,
                                                    params)))
            if Metrics.SUM in aggregate_params.metrics:
                internal_combiners.append(
                    ua_combiners.SumCombiner(
                        dp_combiners.CombinerParams(budgets[Metrics.SUM],
                                                    params)))
            if Metrics.COUNT in aggregate_params.metrics:
                internal_combiners.append(
                    ua_combiners.CountCombiner(
                        dp_combiners.CombinerParams(budgets[Metrics.COUNT],
                                                    params)))
            if Metrics.PRIVACY_ID_COUNT in aggregate_params.metrics:
                internal_combiners.append(
                    ua_combiners.PrivacyIdCountCombiner(
                        dp_combiners.CombinerParams(
                            budgets[Metrics.PRIVACY_ID_COUNT], params)))
        return ua_combiners.CompoundCombiner(internal_combiners,
                                             return_named_tuple=False)

    def _select_private_partitions_internal(self, col,
                                            max_partitions_contributed,
                                            max_rows_per_privacy_id,
                                            strategy, pre_threshold=None):
        # Selection probability is modeled inside the combiners; no-op.
        return col

    def _extract_columns(self, col, data_extractors):
        if self._options.pre_aggregated_data:
            return self._backend.map(
                col, lambda row: (data_extractors.partition_extractor(row),
                                  data_extractors.preaggregate_extractor(
                                      row)),
                "Extract (partition_key, preaggregate_data)")
        return super()._extract_columns(col, data_extractors)

    def _check_aggregate_params(self, col, params, data_extractors,
                                check_data_extractors=False):
        super()._check_aggregate_params(col, params, None,
                                        check_data_extractors=False)


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
