"""Parameter tuning: candidate bounds from contribution-histogram
quantiles, one utility-analysis sweep, argmin RMSE. A copy of
``pipelinedp_tpu/analysis/parameter_tuning.py`` on the port's modules
(capability parity with the reference's ``analysis/parameter_tuning.py``).
The candidate search and the argmin run on the host; the sweep runs on
the backend's device where ``perform_utility_analysis`` takes the fused
path, and as the host analysis graph elsewhere."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum
from typing import Callable, List, Tuple, Union

import numpy as np

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch.aggregate_params import AggregateParams, Metrics
from pipelinedp_tpu_torch.analysis import (data_structures, histograms,
                                           metrics, utility_analysis)

QUANTILES_TO_USE = [0.9, 0.95, 0.98, 0.99, 0.995]


@dataclass
class UtilityAnalysisRun:
    """One executed utility analysis: the options it ran with and the
    aggregate error metrics it produced. Public result-record type for
    callers pairing sweep inputs with outputs; like the reference, the
    tuning flow itself returns ``TuneResult`` and never constructs this
    (reference ``analysis/parameter_tuning.py:31-34``,
    ``analysis/__init__.py:26``)."""
    params: data_structures.UtilityAnalysisOptions
    result: metrics.AggregateErrorMetrics


class MinimizingFunction(Enum):
    ABSOLUTE_ERROR = "absolute_error"
    RELATIVE_ERROR = "relative_error"


@dataclass
class ParametersToTune:
    """Which parameters to tune (reference :41-53)."""
    max_partitions_contributed: bool = False
    max_contributions_per_partition: bool = False
    min_sum_per_partition: bool = False
    max_sum_per_partition: bool = False

    def __post_init__(self):
        if not any(dataclasses.asdict(self).values()):
            raise ValueError("ParametersToTune must have at least 1 "
                             "parameter to tune.")


@dataclass
class TuneOptions:
    """Options for the tuning process (reference :55-88)."""
    epsilon: float
    delta: float
    aggregate_params: AggregateParams
    function_to_minimize: Union[MinimizingFunction, Callable]
    parameters_to_tune: ParametersToTune
    partitions_sampling_prob: float = 1
    pre_aggregated_data: bool = False

    def __post_init__(self):
        input_validators.validate_epsilon_delta(self.epsilon, self.delta,
                                                "TuneOptions")


@dataclass
class TuneResult:
    """Tuning output (reference :90-111)."""
    options: TuneOptions
    contribution_histograms: histograms.DatasetHistograms
    utility_analysis_parameters: data_structures.MultiParameterConfiguration
    index_best: int
    utility_analysis_results: List[metrics.AggregateMetrics]


def _find_candidate_parameters(
        hist: histograms.DatasetHistograms,
        parameters_to_tune: ParametersToTune,
        metric) -> data_structures.MultiParameterConfiguration:
    """Candidate L0/Linf bounds from histogram quantiles + max,
    cross-product if both tuned (reference :113-152)."""

    def _find_candidates(histogram: histograms.Histogram) -> List:
        candidates = histogram.quantiles(QUANTILES_TO_USE)
        candidates.append(histogram.max_value)
        candidates = sorted(set(candidates))
        return candidates

    l0_candidates = linf_candidates = None
    if parameters_to_tune.max_partitions_contributed:
        l0_candidates = _find_candidates(hist.l0_contributions_histogram)
    if (parameters_to_tune.max_contributions_per_partition and
            metric == Metrics.COUNT):
        linf_candidates = _find_candidates(
            hist.linf_contributions_histogram)

    l0_bounds = linf_bounds = None
    if l0_candidates and linf_candidates:
        l0_bounds, linf_bounds = [], []
        for l0 in l0_candidates:
            for linf in linf_candidates:
                l0_bounds.append(l0)
                linf_bounds.append(linf)
    elif l0_candidates:
        l0_bounds = l0_candidates
    elif linf_candidates:
        linf_bounds = linf_candidates
    else:
        raise AssertionError("Nothing to tune.")
    return data_structures.MultiParameterConfiguration(
        max_partitions_contributed=l0_bounds,
        max_contributions_per_partition=linf_bounds)


def _convert_utility_analysis_to_tune_result(
        utility_analysis_result: Tuple, tune_options: TuneOptions,
        run_configurations: data_structures.MultiParameterConfiguration,
        use_public_partitions: bool,
        contribution_histograms: histograms.DatasetHistograms
) -> TuneResult:
    assert len(utility_analysis_result) == run_configurations.size
    assert (tune_options.function_to_minimize ==
            MinimizingFunction.ABSOLUTE_ERROR)
    metric = tune_options.aggregate_params.metrics[0]
    if metric == Metrics.COUNT:
        ms = [am.count_metrics for am in utility_analysis_result]
    elif metric == Metrics.SUM:
        ms = [am.sum_metrics for am in utility_analysis_result]
    else:
        ms = [am.privacy_id_count_metrics
              for am in utility_analysis_result]
    # Argmin over the batched error surface: one vectorized RMSE over
    # the [C] config axis (the per-config absolute_rmse closed form,
    # sqrt(E[err]^2 + Var[err]), evaluated as arrays) instead of C
    # Python method calls.
    exp = np.asarray([m.error_expected for m in ms], np.float64)
    var = np.asarray([m.error_variance for m in ms], np.float64)
    rmse = np.sqrt(exp * exp + var)
    index_best = int(np.argmin(rmse))
    return TuneResult(tune_options, contribution_histograms,
                      run_configurations, index_best,
                      utility_analysis_result)


def tune(col, backend,
         contribution_histograms: histograms.DatasetHistograms,
         options: TuneOptions, data_extractors, public_partitions=None,
         return_utility_analysis_per_partition: bool = False):
    """Tunes contribution-bounding parameters (reference :182-253):
    candidates from histogram quantiles -> one multi-configuration utility
    analysis -> argmin RMSE."""
    _check_tune_args(options)
    candidates = _find_candidate_parameters(
        contribution_histograms, options.parameters_to_tune,
        options.aggregate_params.metrics[0])
    ua_options = data_structures.UtilityAnalysisOptions(
        epsilon=options.epsilon,
        delta=options.delta,
        aggregate_params=options.aggregate_params,
        multi_param_configuration=candidates,
        partitions_sampling_prob=options.partitions_sampling_prob,
        pre_aggregated_data=options.pre_aggregated_data)
    result = utility_analysis.perform_utility_analysis(
        col, backend, ua_options, data_extractors, public_partitions,
        return_utility_analysis_per_partition)
    if return_utility_analysis_per_partition:
        ua_result, ua_per_partition = result
    else:
        ua_result = result
    use_public = public_partitions is not None
    tuned = backend.map(
        ua_result, lambda r: _convert_utility_analysis_to_tune_result(
            r, options, candidates, use_public, contribution_histograms),
        "To Tune result")
    if return_utility_analysis_per_partition:
        return tuned, ua_per_partition
    return tuned


def _check_tune_args(options: TuneOptions):
    metrics_list = options.aggregate_params.metrics
    if len(metrics_list) != 1:
        raise NotImplementedError(
            f"Tuning supports only one metric, but {metrics_list} given.")
    if metrics_list[0] not in [Metrics.COUNT, Metrics.PRIVACY_ID_COUNT,
                               Metrics.SUM]:
        raise NotImplementedError(
            "Tuning is supported only for COUNT, PRIVACY_ID_COUNT and "
            f"SUM, but {metrics_list[0]} given.")
    if metrics_list[0] == Metrics.SUM:
        # Exceeds the reference (its tuner rejects SUM outright,
        # reference parameter_tuning.py:255-270): the L0 bound is tuned
        # from the contribution histograms; the per-partition sum clip
        # bounds themselves are not tunable (no value histograms) and
        # must be supplied.
        p = options.aggregate_params
        if (p.min_sum_per_partition is None or
                p.max_sum_per_partition is None):
            raise ValueError(
                "Tuning SUM requires min/max_sum_per_partition on the "
                "aggregate params (the clip bounds are not tuned).")
        to_tune = options.parameters_to_tune
        if (not to_tune.max_partitions_contributed or
                to_tune.min_sum_per_partition or
                to_tune.max_sum_per_partition):
            raise NotImplementedError(
                "For SUM only max_partitions_contributed is tunable "
                "(linf does not enter the per-partition-sum clip model, "
                "and there are no value histograms to derive clip-bound "
                "candidates from).")
    if options.function_to_minimize != MinimizingFunction.ABSOLUTE_ERROR:
        raise NotImplementedError(
            f"Only {MinimizingFunction.ABSOLUTE_ERROR} is implemented.")
