"""Spark-idiomatic private API: ``make_private(rdd, ...)`` returns a
``PrivateRDD`` whose only outputs are DP aggregates, computed by
``DPEngine`` on the port's ``SparkRDDBackend``. A port of
``pipelinedp_tpu/private_spark.py``; it needs pyspark (or an RDD-shaped
stand-in) at call time, not at import time."""

from __future__ import annotations

from typing import Callable, Optional

from pipelinedp_tpu_torch import aggregate_params as agg
from pipelinedp_tpu_torch import dp_engine as dp_engine_mod
from pipelinedp_tpu_torch.pipeline_backend import SparkRDDBackend


class PrivateRDD:
    """Keeps (privacy_id, value) pairs internally; only DP aggregation
    results can be extracted."""

    def __init__(self, rdd, budget_accountant,
                 privacy_id_extractor: Optional[Callable] = None):
        if privacy_id_extractor:
            self._rdd = rdd.map(lambda x: (privacy_id_extractor(x), x))
        else:
            self._rdd = rdd
        self._budget_accountant = budget_accountant

    def map(self, fn: Callable) -> "PrivateRDD":
        return make_private(self._rdd.mapValues(fn),
                            self._budget_accountant, None)

    def flat_map(self, fn: Callable) -> "PrivateRDD":
        return make_private(self._rdd.flatMapValues(fn),
                            self._budget_accountant, None)

    def _aggregate(self, params, metric_params, public_partitions,
                   metric_name):
        backend = SparkRDDBackend(self._rdd.context)
        engine = dp_engine_mod.DPEngine(self._budget_accountant, backend)
        extractors = dp_engine_mod.DataExtractors(
            privacy_id_extractor=lambda row: row[0],
            partition_extractor=(
                lambda row: metric_params.partition_extractor(row[1])),
            value_extractor=(
                (lambda row: metric_params.value_extractor(row[1]))
                if metric_params.value_extractor else lambda row: 1),
        )
        result = engine.aggregate(self._rdd, params, extractors,
                                  public_partitions)
        return result.mapValues(lambda mt: getattr(mt, metric_name))

    def count(self, count_params: agg.CountParams, public_partitions=None):
        return self._aggregate(count_params.to_aggregate_params(),
                               count_params, public_partitions, "count")

    def sum(self, sum_params: agg.SumParams, public_partitions=None):
        return self._aggregate(sum_params.to_aggregate_params(),
                               sum_params, public_partitions, "sum")

    def mean(self, mean_params: agg.MeanParams, public_partitions=None):
        return self._aggregate(mean_params.to_aggregate_params(),
                               mean_params, public_partitions, "mean")

    def variance(self, variance_params: agg.VarianceParams,
                 public_partitions=None):
        return self._aggregate(variance_params.to_aggregate_params(),
                               variance_params, public_partitions,
                               "variance")

    def privacy_id_count(self, params: agg.PrivacyIdCountParams,
                         public_partitions=None):
        return self._aggregate(params.to_aggregate_params(), params,
                               public_partitions, "privacy_id_count")

    def select_partitions(self, params: agg.SelectPartitionsParams,
                          partition_extractor: Callable):
        backend = SparkRDDBackend(self._rdd.context)
        engine = dp_engine_mod.DPEngine(self._budget_accountant, backend)
        extractors = dp_engine_mod.DataExtractors(
            privacy_id_extractor=lambda row: row[0],
            partition_extractor=lambda row: partition_extractor(row[1]))
        return engine.select_partitions(self._rdd, params, extractors)


def make_private(rdd, budget_accountant,
                 privacy_id_extractor: Optional[Callable]) -> PrivateRDD:
    """Wraps ``rdd`` into a ``PrivateRDD``."""
    return PrivateRDD(rdd, budget_accountant, privacy_id_extractor)
