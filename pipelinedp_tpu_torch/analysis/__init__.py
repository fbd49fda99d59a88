"""Utility analysis and parameter tuning: ``pipelinedp_tpu/analysis`` on
the port (capability parity with the reference's ``analysis/`` package).
Simulates, without running real DP repeatedly, the error a parameter set
would produce, for many configurations in one pass: the fused sweep on a
``TorchBackend``'s device, the host analysis graph elsewhere."""

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
from pipelinedp_tpu_torch.analysis.pre_aggregation import preaggregate
from pipelinedp_tpu_torch.analysis.utility_analysis import (
    perform_utility_analysis,
)
from pipelinedp_tpu_torch.analysis.utility_analysis_engine import (
    UtilityAnalysisEngine,
)
