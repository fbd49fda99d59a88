"""PeekerEngine — approximate DP aggregation over sketches for fast
interactive utility analysis; explicitly NOT a releasable DP
aggregation. A port of ``pipelinedp_tpu/peeker/peeker_engine.py``: its
host noise comes from the port's ``ops.noise._host_rng``, so one
``seed_host_rng`` seed gives the same bits in both packages."""

from __future__ import annotations

import functools
from typing import Any, Tuple

from pipelinedp_tpu_torch import combiners as dp_combiners
from pipelinedp_tpu_torch import partition_selection
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams,
                                                   MechanismType, Metrics,
                                                   PartitionSelectionStrategy)
from pipelinedp_tpu_torch.ops import noise as noise_ops


def aggregate_sketch_true(backend, col, metric):
    """Raw aggregation over sketches."""
    if metric == Metrics.SUM:
        aggregator_fn = sum
    elif metric == Metrics.COUNT:
        aggregator_fn = len
    else:
        raise ValueError("Aggregate sketch only supports sum or count")
    col = backend.map_tuple(col, lambda pk, pval, _: (pk, pval),
                            "Drop partition count")
    col = backend.group_by_key(col, "Group by partition key")
    return backend.map_values(col, aggregator_fn,
                              "Aggregate by partition key")


class PeekerEngine:
    """Approximate DP aggregation over (pk, value, partition_count)
    sketches. Not for release — utility preview only."""

    def __init__(self, budget_accountant, backend):
        self._budget_accountant = budget_accountant
        self._be = backend

    def aggregate_sketches(self, col, params: AggregateParams):
        if len(params.metrics) != 1 or params.metrics[0] not in (
                Metrics.SUM, Metrics.COUNT):
            raise ValueError("Sketch only supports a single aggregation "
                             "and it must be COUNT or SUM.")
        combiner = dp_combiners.create_compound_combiner(
            params, self._budget_accountant)
        col = self._be.filter(
            col,
            functools.partial(_cross_partition_filter_fn,
                              params.max_partitions_contributed),
            "Cross partition bounding")
        col = self._be.map_tuple(
            col,
            functools.partial(_per_partition_bounding,
                              params.max_contributions_per_partition),
            "Per partition bounding")
        # (pk, bounded_value). The sketch value is already the per-user
        # aggregate, so it IS the single child accumulator (int count or
        # float sum) of the compound accumulator.
        col = self._be.map_values(
            col, lambda x: (1, (x,)),
            "Convert to compound accumulator format")
        col = self._be.combine_accumulators_per_key(
            col, combiner, "Aggregate by partition key")
        budget = self._budget_accountant.request_budget(
            mechanism_type=MechanismType.GENERIC)
        filter_fn = functools.partial(_partition_selection_filter_fn,
                                      budget,
                                      params.max_partitions_contributed)
        col = self._be.filter(col, filter_fn, "Filter private partitions")
        return self._be.map_values(col, combiner.compute_metrics,
                                   "Compute DP metrics")


def _cross_partition_filter_fn(max_partitions: int,
                               row: Tuple[Any, int, int]) -> bool:
    _, _value, partition_count = row
    if partition_count <= max_partitions:
        # The partition count, not the aggregated value, is what is
        # compared against max_partitions.
        return True
    # lint: disable=rng-purity(peeker keep decision from the seed_host_rng generator, the JAX package's order)
    return bool(noise_ops._host_rng.random() <
                max_partitions / partition_count)


def _per_partition_bounding(max_contributions_per_partition: int, pk, pval,
                            pcount) -> Tuple[Any, float]:
    del pcount
    return pk, min(pval, max_contributions_per_partition)


def _partition_selection_filter_fn(budget, max_partitions: int,
                                   row) -> bool:
    privacy_id_count, _ = row[1]
    strategy = partition_selection.create_partition_selection_strategy(
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC, budget.eps,
        budget.delta, max_partitions)
    return strategy.should_keep(privacy_id_count)
