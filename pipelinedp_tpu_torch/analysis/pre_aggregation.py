"""Pre-aggregation: (pk, (count, sum, n_partitions)) per (pid, pk), a
materializable intermediate for repeated analysis runs. A copy of
``pipelinedp_tpu/analysis/pre_aggregation.py`` (capability parity with
the reference's ``analysis/pre_aggregation.py``)."""

from __future__ import annotations

from pipelinedp_tpu_torch.analysis import contribution_bounders as ua_bounders
from pipelinedp_tpu_torch.dp_engine import DataExtractors


def preaggregate(col, backend, data_extractors: DataExtractors,
                 partitions_sampling_prob: float = 1):
    """Returns a collection of (partition_key, (count, sum, n_partitions))
    rows, one per (privacy_id, partition_key) present in the data,
    optionally deterministically sampled by partition (reference :19-61)."""
    col = backend.map(
        col, lambda row: (data_extractors.privacy_id_extractor(row),
                          data_extractors.partition_extractor(row),
                          data_extractors.value_extractor(row)),
        "Extract (privacy_id, partition_key, value)")
    bounder = ua_bounders.SamplingL0LinfContributionBounder(
        partitions_sampling_prob)
    col = bounder.bound_contributions(col, params=None, backend=backend,
                                      report_generator=None,
                                      aggregate_fn=lambda x: x)
    return backend.map(col, lambda row: (row[0][1], row[1]),
                       "Drop privacy id")
