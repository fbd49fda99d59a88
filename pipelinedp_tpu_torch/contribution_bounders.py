"""Contribution bounding of the host graph: caps each privacy unit's
influence by sampling. A copy of ``pipelinedp_tpu/contribution_bounders.py``
(capability parity with the reference's
``pipeline_dp/contribution_bounders.py``; strategies at :56, :108, :153).

Expressed over abstract backend ops, so every backend runs the same
logical graph; the fused device path implements the same semantics
directly as per-segment sampling (``ops/segment.py``, ``torch_engine``).
"""

from __future__ import annotations

import abc
import collections
from typing import Callable, Iterable

from pipelinedp_tpu_torch import sampling_utils


class ContributionBounder(abc.ABC):
    """Interface for contribution bounding (reference :25-53). Also fuses
    the per-(privacy_id, partition_key) aggregation via ``aggregate_fn``
    (= ``combiner.create_accumulator``)."""

    @abc.abstractmethod
    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn: Callable):
        """Input elements: (privacy_id, partition_key, value). Output:
        ((privacy_id, partition_key), accumulator)."""


class SamplingCrossAndPerPartitionContributionBounder(ContributionBounder):
    """The default strategy (reference :56-105): linf cap by sampling per
    (pid, pk), then L0 cap by sampling partitions per pid."""

    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn):
        max_partitions = params.max_partitions_contributed
        max_per_partition = params.max_contributions_per_partition
        col = backend.map_tuple(
            col, lambda pid, pk, v: ((pid, pk), v),
            "Rekey to ((privacy_id, partition_key), value)")
        col = backend.sample_fixed_per_key(
            col, max_per_partition, "Sample per (privacy_id, partition_key)")
        report_generator.add_stage(
            f"Per-partition contribution bounding: for each privacy_id and "
            f"each partition, randomly select "
            f"max(actual_contributions_per_partition, {max_per_partition}) "
            f"contributions.")
        col = backend.map_values(
            col, aggregate_fn,
            "Apply aggregate_fn after per-partition bounding")
        # ((pid, pk), accumulator)
        col = backend.map_tuple(
            col, lambda pid_pk, acc: (pid_pk[0], (pid_pk[1], acc)),
            "Rekey to (privacy_id, (partition_key, accumulator))")
        col = backend.sample_fixed_per_key(col, max_partitions,
                                           "Sample per privacy_id")
        report_generator.add_stage(
            f"Cross-partition contribution bounding: for each privacy_id "
            f"randomly select max(actual_partition_contributed, "
            f"{max_partitions}) partitions")

        def unnest(pid_and_pk_accs):
            pid, pk_accs = pid_and_pk_accs
            return (((pid, pk), acc) for pk, acc in pk_accs)

        return backend.flat_map(col, unnest,
                                "Rekey by privacy_id and unnest")


class SamplingPerPrivacyIdContributionBounder(ContributionBounder):
    """Caps the *total* contributions of each privacy unit to
    ``max_contributions`` (reference :108-150)."""

    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn):
        max_contributions = params.max_contributions
        col = backend.map_tuple(
            col, lambda pid, pk, v: (pid, (pk, v)),
            "Rekey to (privacy_id, (partition_key, value))")
        col = backend.sample_fixed_per_key(col, max_contributions,
                                           "Sample per privacy_id")
        report_generator.add_stage(
            f"User contribution bounding: randomly selected not more than "
            f"{max_contributions} contributions")
        col = collect_values_per_partition_key_per_privacy_id(col, backend)

        def unnest(pid_and_partition_values):
            pid, partition_values = pid_and_partition_values
            for pk, values in partition_values:
                yield (pid, pk), values

        col = backend.flat_map(col, unnest, "Unnest")
        return backend.map_values(
            col, aggregate_fn,
            "Apply aggregate_fn after per-privacy-id bounding")


class SamplingCrossPartitionContributionBounder(ContributionBounder):
    """L0-only bounding (reference :153-194): samples partitions per pid;
    assumes ``aggregate_fn`` bounds per-partition contributions (used with
    per-partition-sum clipping)."""

    def bound_contributions(self, col, params, backend, report_generator,
                            aggregate_fn):
        col = backend.map_tuple(
            col, lambda pid, pk, v: (pid, (pk, v)),
            "Rekey to (privacy_id, (partition_key, value))")
        col = backend.group_by_key(col, "Group by privacy_id")
        col = collect_values_per_partition_key_per_privacy_id(col, backend)
        sample = sampling_utils.choose_from_list_without_replacement
        sample_size = params.max_partitions_contributed
        col = backend.map_values(col, lambda a: sample(a, sample_size),
                                 "Sample partitions per privacy_id")

        def unnest(pid_and_partition_values):
            pid, partition_values = pid_and_partition_values
            for pk, values in partition_values:
                yield (pid, pk), values

        col = backend.flat_map(col, unnest, "Unnest per privacy_id")
        return backend.map_values(
            col, aggregate_fn,
            "Apply aggregate_fn after cross-partition bounding")


def collect_values_per_partition_key_per_privacy_id(col, backend):
    """(pid, Iterable[(pk, value)]) -> (pid, [(pk, [values])])
    (reference :197-224)."""

    def collect_fn(pk_values: Iterable):
        d = collections.defaultdict(list)
        for pk, value in pk_values:
            d[pk].append(value)
        return list(d.items())

    return backend.map_values(
        col, collect_fn, "Collect values per privacy_id and partition_key")
