"""pipelinedp_tpu_torch — the PyTorch/CUDA port of ``pipelinedp_tpu``.

A second package beside the JAX one, held against it bit for bit. This
package runs the fused ``DPEngine.aggregate`` path (COUNT,
PRIVACY_ID_COUNT, SUM with per-value or per-partition sum bounds, MEAN,
VARIANCE, PERCENTILE, or VECTOR_SUM; public or private partitions; one
device, in one batch or, past ``PIPELINEDP_TPU_STREAM_CHUNK`` rows,
streamed in batches, serially or through the overlapped ingest executor,
with a pass-B device cache and checkpoint and resume) and
``select_partitions`` on a CUDA device, with hand-written CUDA kernels for
the per-partition segment sums of the scalar lanes and of VECTOR_SUM's
coordinate lanes, for the quantile walk's subtree histograms, and for the
ordered per-segment totals of the per-partition-bounds SUM. The
utility analysis (``pipelinedp_tpu_torch.analysis``:
``perform_utility_analysis``, ``compute_dataset_histograms``, ``tune``)
runs the JAX package's fused multi-configuration sweep on the device,
with a hand-written kernel for its ordered keyed float32 sums.

The generic host path runs the rest, where the JAX package runs it: the
host backends (``LocalBackend``, ``MultiProcLocalBackend``,
``SparkRDDBackend``), custom combiners (subclasses of ``CustomCombiner``),
non-fusable percentile params, and the host analysis graph;
``TorchBackend`` is a ``LocalBackend`` and falls back to it exactly where
``JaxBackend`` does. Sketch-first DP heavy hitters
(``aggregate(..., sketch_first=SketchParams(...))``) discover an
unbounded key axis with a counting sketch on the device, then run the
fused path over the selected candidates only. The fluent APIs
(``make_private``, ``private_spark``, ``private_beam`` with
``BeamBackend``) and the peeker (``pipelinedp_tpu_torch.peeker``) sit on
top of ``DPEngine``. Budgets compose naively (``NaiveBudgetAccountant``) or
through privacy-loss distributions (``PLDBudgetAccountant``), and
``ops.noise.set_secure_host_noise(True)`` hardens every host release with
the native snapping and discrete samplers. The package imports torch, numpy
and scipy, never JAX.

    import pipelinedp_tpu_torch as pdt
    accountant = pdt.NaiveBudgetAccountant(total_epsilon=1, total_delta=1e-6)
    engine = pdt.DPEngine(accountant, pdt.TorchBackend(rng_seed=0))
    result = engine.aggregate(pdt.ArrayDataset(pids, pks, values), params,
                              pdt.DataExtractors())
    accountant.compute_budgets()
    rows = list(result)
"""

from pipelinedp_tpu_torch.aggregate_params import (
    AggregateParams,
    CountParams,
    MeanParams,
    MechanismType,
    Metric,
    Metrics,
    NoiseKind,
    NormKind,
    PartitionSelectionStrategy,
    PrivacyIdCountParams,
    SelectPartitionsParams,
    SumParams,
    VarianceParams,
)
from pipelinedp_tpu_torch.backends import TorchBackend
from pipelinedp_tpu_torch.budget_accounting import (Budget, BudgetAccountant,
                                                    MechanismSpec,
                                                    NaiveBudgetAccountant,
                                                    PLDBudgetAccountant)
from pipelinedp_tpu_torch.combiners import Combiner, CustomCombiner
from pipelinedp_tpu_torch.dp_engine import DataExtractors, DPEngine
from pipelinedp_tpu_torch.pipeline_backend import (Annotator, LocalBackend,
                                                   MultiProcLocalBackend,
                                                   PipelineBackend,
                                                   SparkRDDBackend,
                                                   register_annotator)
from pipelinedp_tpu_torch.private_collection import (PrivateCollection,
                                                     make_private)
from pipelinedp_tpu_torch.report_generator import ExplainComputationReport
from pipelinedp_tpu_torch.sketch import SketchParams
from pipelinedp_tpu_torch.torch_engine import ArrayDataset

try:
    from pipelinedp_tpu_torch.pipeline_backend import BeamBackend
except ImportError:  # apache_beam not installed

    class BeamBackend:  # type: ignore
        """Placeholder kept for API parity with the reference (its
        ``BeamBackend`` name exists regardless of whether beam is
        installed): constructing it without apache_beam fails with a
        clear error instead of an AttributeError on the package."""

        def __init__(self, *args, **kwargs):
            raise ImportError(
                "apache_beam is required for BeamBackend; "
                "`pip install apache-beam` (see contributing/Dockerfile)")

__all__ = [
    "AggregateParams", "Annotator", "ArrayDataset", "BeamBackend", "Budget",
    "BudgetAccountant", "Combiner", "CountParams", "CustomCombiner",
    "DataExtractors", "DPEngine", "ExplainComputationReport",
    "LocalBackend", "MeanParams", "MechanismSpec", "MechanismType", "Metric",
    "Metrics", "MultiProcLocalBackend", "NaiveBudgetAccountant", "NoiseKind",
    "NormKind", "PartitionSelectionStrategy", "PipelineBackend",
    "PLDBudgetAccountant",
    "PrivacyIdCountParams", "PrivateCollection", "SelectPartitionsParams",
    "SketchParams", "SparkRDDBackend", "SumParams", "TorchBackend",
    "VarianceParams", "make_private", "register_annotator",
]
