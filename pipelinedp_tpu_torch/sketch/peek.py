"""Non-private peeker sketches — the ``DataPeeker.sketch`` plumbing,
owned by the sketch subsystem. A port of ``pipelinedp_tpu/sketch/peek.py``.

These are **NOT DP releases**: the rows carry raw per-(partition,
user) aggregates over a partition sample, for interactive utility
preview only ("not a DP aggregation, don't release").
``peeker.DataPeeker`` is a thin shim over this module; the genuinely
DP sketch path is ``sketch/engine.py`` (two-phase heavy hitters),
which shares none of this code's outputs.
"""

from __future__ import annotations

import functools


def _extract_fn(data_extractors, row):
    return (data_extractors.privacy_id_extractor(row),
            data_extractors.partition_extractor(row),
            data_extractors.value_extractor(row))


def sample_partitions(backend, col, n_partitions):
    """(pk, value) -> same, keeping only ``n_partitions`` sampled
    partition keys (NON-private reservoir sample)."""
    col = backend.group_by_key(col, "Group by pk")
    col = backend.map_tuple(col, lambda pk, vs: (1, (pk, vs)),
                            "Rekey to (1, (pk, values))")
    col = backend.sample_fixed_per_key(col, n_partitions,
                                       "Sample partitions")
    return backend.flat_map(col, lambda one_and_list: one_and_list[1],
                            "Extract sampled (pk, values)")


def non_private_sketch(backend, input_data, params, data_extractors):
    """One row (partition_key, aggregated_value, partition_count) per
    unique (pk, privacy_id), over a sample of partitions — raw values,
    NOT releasable."""
    from pipelinedp_tpu_torch.aggregate_params import Metrics
    from pipelinedp_tpu_torch.peeker import non_private_combiners

    if params.metrics is None:
        raise ValueError("Must provide aggregation metrics for sketch.")
    if len(params.metrics) != 1 or params.metrics[0] not in (
            Metrics.SUM, Metrics.COUNT):
        raise ValueError("Sketch only supports a single aggregation "
                         "and it must be COUNT or SUM.")
    combiner = non_private_combiners.create_compound_combiner(
        params.metrics)

    col = backend.map(input_data,
                      functools.partial(_extract_fn, data_extractors),
                      "Extract (privacy_id, partition_key, value)")
    col = backend.map_tuple(col, lambda pid, pk, v: (pk, (pid, v)),
                            "Rekey to (pk, (pid, value))")
    col = sample_partitions(backend, col,
                            params.number_of_sampled_partitions)

    def flatten_sampled(pk_and_pid_values):
        pk, pid_values = pk_and_pid_values
        return [((pk, pid), v) for pid, v in pid_values]

    col = backend.flat_map(col, flatten_sampled,
                           "Flatten to ((pk, pid), value)")
    col = backend.group_by_key(col, "Group by (pk, pid)")
    col = backend.map_values(col, combiner.create_accumulator,
                             "Aggregate per (pk, pid)")
    # ((pk, pid), compound_accumulator)
    col = backend.map_tuple(
        col, lambda pk_pid, acc: (pk_pid[1], (pk_pid[0], acc)),
        "Rekey to (pid, (pk, accumulator))")
    col = backend.group_by_key(col, "Group by privacy id")

    def attach_partition_count(pk_acc_list):
        partition_count = len(set(pk for pk, _ in pk_acc_list))
        return partition_count, pk_acc_list

    col = backend.map_values(col, attach_partition_count,
                             "Compute partition count")

    def flatten_results(pid_and_rest):
        _, (pcount, pk_acc_list) = pid_and_rest
        # Compound accumulator = (row_count, (child_acc,)); the single
        # raw child accumulator IS the aggregated value.
        return [(pk, acc[1][0], pcount) for pk, acc in pk_acc_list]

    return backend.flat_map(
        col, flatten_results,
        "Flatten to (pk, aggregated_value, partition_count)")
