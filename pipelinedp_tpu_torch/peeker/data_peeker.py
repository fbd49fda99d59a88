"""DataPeeker — partition-sampled sketches, raw samples and true
aggregates for interactive utility analysis. A port of
``pipelinedp_tpu/peeker/data_peeker.py``.

The non-private sketch plumbing lives in
``pipelinedp_tpu_torch.sketch.peek`` (the sketch subsystem owns all
sketching); :meth:`DataPeeker.sketch` is a thin shim over it. These
outputs carry RAW values and are not releasable; the genuinely DP sketch
path is ``DPEngine.aggregate(..., sketch_first=...)``. Sampling draws
from the port's host RNG (``ops.noise._host_rng``), so one
``seed_host_rng`` seed samples the same partitions in both packages."""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

from pipelinedp_tpu_torch.aggregate_params import Metric
from pipelinedp_tpu_torch.dp_engine import DataExtractors
from pipelinedp_tpu_torch.peeker import non_private_combiners


@dataclasses.dataclass
class SampleParams:
    """Sampling parameters."""
    number_of_sampled_partitions: int
    metrics: Optional[List[Metric]] = None


def _extract_fn(data_extractors: DataExtractors, row):
    return (data_extractors.privacy_id_extractor(row),
            data_extractors.partition_extractor(row),
            data_extractors.value_extractor(row))


class DataPeeker:
    """Sketch/sample/aggregate-true helpers."""

    def __init__(self, backend):
        self._be = backend

    def _sample_partitions(self, col, n_partitions):
        """(pk, value) -> same, keeping only n sampled partition keys."""
        from pipelinedp_tpu_torch.sketch import peek
        return peek.sample_partitions(self._be, col, n_partitions)

    def sketch(self, input_data, params: SampleParams,
               data_extractors: DataExtractors):
        """Sketches: one row (partition_key, aggregated_value,
        partition_count) per unique (pk, privacy_id), over a sample of
        partitions. Thin shim over the sketch
        subsystem's non-private peek path — RAW values, not
        releasable."""
        from pipelinedp_tpu_torch.sketch import peek
        return peek.non_private_sketch(self._be, input_data, params,
                                       data_extractors)

    def sample(self, input_data, params: SampleParams,
               data_extractors: DataExtractors):
        """Raw rows of a partition sample: (pid, pk, value)."""
        col = self._be.map(input_data,
                           functools.partial(_extract_fn, data_extractors),
                           "Extract (privacy_id, partition_key, value)")
        col = self._be.map_tuple(col, lambda pid, pk, v: (pk, (pid, v)),
                                 "Rekey to (pk, (pid, value))")
        col = self._sample_partitions(
            col, params.number_of_sampled_partitions)

        def expand(pk_and_pid_values):
            pk, pid_values = pk_and_pid_values
            return [(pid, pk, v) for pid, v in pid_values]

        return self._be.flat_map(col, expand,
                                 "Transform to (pid, pk, value)")

    def aggregate_true(self, col, params: SampleParams,
                       data_extractors: DataExtractors):
        """Raw (non-DP) per-partition aggregates."""
        combiner = non_private_combiners.create_compound_combiner(
            params.metrics)
        col = self._be.map(col,
                           functools.partial(_extract_fn, data_extractors),
                           "Extract (privacy_id, partition_key, value)")
        col = self._be.map_tuple(col, lambda pid, pk, v: (pk, v),
                                 "Rekey to (pk, value)")
        col = self._be.group_by_key(col, "Group by pk")
        col = self._be.map_values(col, combiner.create_accumulator,
                                  "Create accumulators")
        return self._be.map_values(
            col, lambda acc: combiner.compute_metrics(acc),
            "Compute raw metrics")
