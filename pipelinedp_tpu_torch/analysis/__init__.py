"""Utility analysis and parameter tuning on the device: the fused sweep of
``pipelinedp_tpu/analysis`` (capability parity with the reference's
``analysis/`` package). Simulates, without running real DP repeatedly, the
error a parameter set would produce, for many configurations in one
pass."""

from pipelinedp_tpu_torch.analysis.data_structures import (
    MultiParameterConfiguration,
    PreAggregateExtractors,
    UtilityAnalysisOptions,
    get_aggregate_params,
)
from pipelinedp_tpu_torch.analysis.histograms import (
    DatasetHistograms,
    compute_dataset_histograms,
    compute_dataset_histograms_on_preaggregated_data,
)
from pipelinedp_tpu_torch.analysis.metrics import (
    AggregateErrorMetrics,
    AggregateMetrics,
    AggregateMetricType,
    PartitionSelectionMetrics,
    SumMetrics,
    UtilityReport,
    to_utility_report,
)
from pipelinedp_tpu_torch.analysis.parameter_tuning import (
    MinimizingFunction,
    ParametersToTune,
    TuneOptions,
    TuneResult,
    UtilityAnalysisRun,
    tune,
)
from pipelinedp_tpu_torch.analysis.utility_analysis import (
    perform_utility_analysis,
    preaggregate,
)
