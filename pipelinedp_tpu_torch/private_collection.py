"""Fluent 'private collection' API over any ``PipelineBackend`` (Local,
MultiProc, Spark or Torch). A port of ``pipelinedp_tpu/private_collection.py``.

A ``PrivateCollection`` internally holds ``(privacy_id, value)`` tuples;
only DP aggregation results can leave it. Each aggregation builds the
corresponding ``AggregateParams`` and delegates to a fresh ``DPEngine``
over the wrapped backend — on ``TorchBackend`` fusable params take the
fused device path, as ``DPEngine`` routes them."""

from __future__ import annotations

from typing import Callable, Optional

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import dp_engine as dp_engine_mod
from pipelinedp_tpu_torch import report_generator


class PrivateCollection:
    """A collection whose raw contents cannot be extracted — only DP
    aggregates (``PrivateRDD`` semantics)."""

    def __init__(self, col, backend, budget_accountant,
                 privacy_id_extractor: Optional[Callable] = None):
        if privacy_id_extractor:
            col = backend.map(col, lambda x: (privacy_id_extractor(x), x),
                              "Attach privacy id")
        # else: assumed already (privacy_id, value).
        # Several aggregations may read this collection — host generators
        # are single-shot, so make it multi-transformable (RDD/PCollection
        # semantics).
        self._col = backend.to_multi_transformable_collection(col)
        self._backend = backend
        self._budget_accountant = budget_accountant

    # -- value transforms that preserve privacy ids --

    def map(self, fn: Callable) -> "PrivateCollection":
        col = self._backend.map_values(self._col, fn, "Private map")
        return make_private(col, self._backend, self._budget_accountant,
                            None)

    def flat_map(self, fn: Callable) -> "PrivateCollection":
        col = self._backend.flat_map(
            self._col, lambda pid_x: ((pid_x[0], v) for v in fn(pid_x[1])),
            "Private flat_map")
        return make_private(col, self._backend, self._budget_accountant,
                            None)

    # -- DP aggregations --

    def _aggregate(self, params, metric_params, public_partitions,
                   out_report, metric_name):
        engine = dp_engine_mod.DPEngine(self._budget_accountant,
                                        self._backend)
        already = metric_params.contribution_bounds_already_enforced
        extractors = dp_engine_mod.DataExtractors(
            privacy_id_extractor=(None if already else lambda row: row[0]),
            partition_extractor=(
                lambda row: metric_params.partition_extractor(row[1])),
            value_extractor=(
                (lambda row: metric_params.value_extractor(row[1]))
                if metric_params.value_extractor else lambda row: 1),
        )
        col = self._col
        if already:
            # Input holds bare rows when bounds are pre-enforced.
            col = self._backend.map(col, lambda x: (None, x),
                                    "Wrap to (None, row)")
        result = engine.aggregate(col, params, extractors,
                                  public_partitions, out_report)
        return self._backend.map_values(
            result, lambda metrics_tuple: getattr(metrics_tuple,
                                                  metric_name),
            f"Extract {metric_name}")

    def count(self, count_params: agg.CountParams, public_partitions=None,
              out_explain_computation_report: Optional[
                  report_generator.ExplainComputationReport] = None):
        return self._aggregate(count_params.to_aggregate_params(),
                               count_params, public_partitions,
                               out_explain_computation_report, "count")

    def sum(self, sum_params: agg.SumParams, public_partitions=None,
            out_explain_computation_report=None):
        return self._aggregate(sum_params.to_aggregate_params(),
                               sum_params, public_partitions,
                               out_explain_computation_report, "sum")

    def mean(self, mean_params: agg.MeanParams, public_partitions=None,
             out_explain_computation_report=None):
        return self._aggregate(mean_params.to_aggregate_params(),
                               mean_params, public_partitions,
                               out_explain_computation_report, "mean")

    def variance(self, variance_params: agg.VarianceParams,
                 public_partitions=None,
                 out_explain_computation_report=None):
        return self._aggregate(variance_params.to_aggregate_params(),
                               variance_params, public_partitions,
                               out_explain_computation_report, "variance")

    def privacy_id_count(self, params: agg.PrivacyIdCountParams,
                         public_partitions=None,
                         out_explain_computation_report=None):
        return self._aggregate(params.to_aggregate_params(), params,
                               public_partitions,
                               out_explain_computation_report,
                               "privacy_id_count")

    def select_partitions(self, params: agg.SelectPartitionsParams,
                          partition_extractor: Callable):
        engine = dp_engine_mod.DPEngine(self._budget_accountant,
                                        self._backend)
        extractors = dp_engine_mod.DataExtractors(
            privacy_id_extractor=lambda row: row[0],
            partition_extractor=lambda row: partition_extractor(row[1]))
        return engine.select_partitions(self._col, params, extractors)


def make_private(col, backend, budget_accountant,
                 privacy_id_extractor: Optional[Callable]
                 ) -> PrivateCollection:
    """Wraps ``col`` into a ``PrivateCollection``."""
    return PrivateCollection(col, backend, budget_accountant,
                             privacy_id_extractor)
