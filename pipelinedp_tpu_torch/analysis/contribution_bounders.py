"""Contribution 'bounders' for utility analysis: they do not enforce
bounds, they record what bounding would do. A copy of
``pipelinedp_tpu/analysis/contribution_bounders.py`` (capability parity
with the reference's ``analysis/contribution_bounders.py``)."""

from __future__ import annotations

from pipelinedp_tpu_torch import contribution_bounders, sampling_utils


class SamplingL0LinfContributionBounder(
        contribution_bounders.ContributionBounder):
    """Groups all of each privacy id's data and emits
    ((pid, pk), (count, sum, n_partitions)) per contributed partition,
    optionally subsampling partitions deterministically
    (reference :19-75)."""

    def __init__(self, partitions_sampling_prob: float):
        super().__init__()
        self._sampling_probability = partitions_sampling_prob

    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn):
        col = backend.map_tuple(
            col, lambda pid, pk, v: (pid, (pk, v)),
            "Rekey to (privacy_id, (partition_key, value))")
        col = backend.group_by_key(col, "Group by privacy id")
        col = (contribution_bounders.
               collect_values_per_partition_key_per_privacy_id(col, backend))
        # (privacy_id, [(partition_key, [value])])

        sampler = (sampling_utils.ValueSampler(self._sampling_probability)
                   if self._sampling_probability < 1 else None)

        def unnest_with_partition_count(pid_and_partition_values):
            pid, partition_values = pid_and_partition_values
            n_partitions = len(partition_values)
            for pk, values in partition_values:
                if sampler is not None and not sampler.keep(pk):
                    continue
                yield (pid, pk), (len(values), sum(values), n_partitions)

        col = backend.flat_map(col, unnest_with_partition_count,
                               "Unnest per-privacy_id")
        return backend.map_values(col, aggregate_fn, "Apply aggregate_fn")


class NoOpContributionBounder(contribution_bounders.ContributionBounder):
    """Pre-aggregated path: rows are already (pk, (count, sum,
    n_partitions)); add a dummy privacy id (reference :78-88)."""

    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn):
        return backend.map_tuple(
            col, lambda pk, val: ((None, pk), aggregate_fn(val)),
            "Apply aggregate_fn")
