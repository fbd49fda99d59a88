"""Dataset-shape histograms for parameter tuning. A copy of
``pipelinedp_tpu/analysis/histograms.py`` (capability parity with the
reference's ``analysis/histograms.py``): L0 (partitions per privacy id),
Linf (rows per (pid, pk)), count per partition and privacy ids per
partition, with a binning that keeps 3 leading digits. On a backend with
the fused path they are computed on its device
(``torch_sweep.fused_dataset_histograms``); elsewhere, and always for
pre-aggregated rows, by the host graph of backend ops."""

from __future__ import annotations

import enum
import operator
from dataclasses import dataclass
from typing import List

from pipelinedp_tpu_torch.dp_engine import DataExtractors


@dataclass
class FrequencyBin:
    """One histogram bin [lower, next_bin.lower) (reference :26-50)."""
    lower: int
    count: int
    sum: int
    max: int

    def __add__(self, other: "FrequencyBin") -> "FrequencyBin":
        return FrequencyBin(self.lower, self.count + other.count,
                            self.sum + other.sum, max(self.max, other.max))


class HistogramType(enum.Enum):
    L0_CONTRIBUTIONS = "l0_contributions"
    LINF_CONTRIBUTIONS = "linf_contributions"
    COUNT_PER_PARTITION = "count_per_partition"
    COUNT_PRIVACY_ID_PER_PARTITION = "privacy_id_per_partition_count"


@dataclass
class Histogram:
    """Histogram over positive integers (reference :56-101)."""
    name: HistogramType
    bins: List[FrequencyBin]

    def total_count(self):
        return sum(b.count for b in self.bins)

    def total_sum(self):
        return sum(b.sum for b in self.bins)

    @property
    def max_value(self):
        return self.bins[-1].max

    def quantiles(self, q: List[float]) -> List[int]:
        """Lower-bound quantiles: for each q, the lower edge of the first
        bin such that the mass strictly left of it is <= q
        (reference :62-101; also fixes the reference's NameError on
        underflow, :100)."""
        assert sorted(q) == q, "Quantiles to compute must be sorted."
        result = []
        total = self.total_count()
        count_smaller = total
        i_q = len(q) - 1
        for b in self.bins[::-1]:
            count_smaller -= b.count
            ratio_smaller = count_smaller / total
            while i_q >= 0 and q[i_q] >= ratio_smaller:
                result.append(b.lower)
                i_q -= 1
        while i_q >= 0:
            result.append(self.bins[0].lower)
            i_q -= 1
        return result[::-1]


@dataclass
class DatasetHistograms:
    """All four tuning histograms (reference :92-99)."""
    l0_contributions_histogram: Histogram
    linf_contributions_histogram: Histogram
    count_per_partition_histogram: Histogram
    count_privacy_id_per_partition: Histogram


def _to_bin_lower(n: int) -> int:
    """Rounds down keeping 3 leading digits: 1234 -> 1230
    (reference :113-125)."""
    bound = 1000
    while n > bound:
        bound *= 10
    round_base = bound // 1000
    return n // round_base * round_base


def _compute_frequency_histogram(col, backend, name: HistogramType,
                                 deduplicate: bool = False):
    """count_per_element -> bin -> reduce_per_key -> sorted Histogram
    (reference :128-173); 1-element output collection."""
    col = backend.count_per_element(col, "Frequency of elements")
    if deduplicate:
        col = backend.map_tuple(
            col, lambda element, frequency:
            (element, int(round(frequency / element))), "Deduplicate")
    col = backend.map_tuple(
        col, lambda n, f:
        (_to_bin_lower(n),
         FrequencyBin(lower=_to_bin_lower(n), count=f, sum=f * n, max=n)),
        "To FrequencyBin")
    col = backend.reduce_per_key(col, operator.add, "Combine FrequencyBins")
    col = backend.values(col, "To FrequencyBin")
    col = backend.to_list(col, "To 1 element collection")

    def bins_to_histogram(bins):
        bins.sort(key=lambda b: b.lower)
        return Histogram(name, bins)

    return backend.map(col, bins_to_histogram, "To histogram")


def _list_to_contribution_histograms(
        histograms: List[Histogram]) -> DatasetHistograms:
    by_type = {h.name: h for h in histograms}
    return DatasetHistograms(
        by_type.get(HistogramType.L0_CONTRIBUTIONS),
        by_type.get(HistogramType.LINF_CONTRIBUTIONS),
        by_type.get(HistogramType.COUNT_PER_PARTITION),
        by_type.get(HistogramType.COUNT_PRIVACY_ID_PER_PARTITION))


def _to_dataset_histograms(histogram_list, backend):
    histograms = backend.flatten(histogram_list,
                                 "Histograms to one collection")
    histograms = backend.to_list(histograms, "Histograms to List")
    return backend.map(histograms, _list_to_contribution_histograms,
                       "To DatasetHistograms")


def _compute_l0_contributions_histogram(col_distinct, backend):
    """# of privacy ids contributing to 1, 2, ... partitions."""
    col = backend.keys(col_distinct, "Drop partition id")
    col = backend.count_per_element(col,
                                    "Compute partitions per privacy id")
    col = backend.values(col, "Drop privacy id")
    return _compute_frequency_histogram(col, backend,
                                        HistogramType.L0_CONTRIBUTIONS)


def _compute_linf_contributions_histogram(col, backend):
    """# of (pid, pk) pairs with 1, 2, ... rows."""
    col = backend.count_per_element(
        col, "Contributions per (privacy_id, partition)")
    col = backend.values(col, "Drop privacy id")
    return _compute_frequency_histogram(col, backend,
                                        HistogramType.LINF_CONTRIBUTIONS)


def _compute_partition_count_histogram(col, backend):
    """# of partitions with total row count 1, 2, ..."""
    col = backend.values(col, "Drop privacy keys")
    col = backend.count_per_element(col, "Count per partition")
    col = backend.values(col, "Drop partition key")
    return _compute_frequency_histogram(col, backend,
                                        HistogramType.COUNT_PER_PARTITION)


def _compute_partition_privacy_id_count_histogram(col_distinct, backend):
    """# of partitions with 1, 2, ... distinct privacy ids."""
    col = backend.values(col_distinct, "Drop privacy key")
    col = backend.count_per_element(col, "Privacy ids per partition")
    col = backend.values(col, "Drop partition key")
    return _compute_frequency_histogram(
        col, backend, HistogramType.COUNT_PRIVACY_ID_PER_PARTITION)


def compute_dataset_histograms(col, data_extractors: DataExtractors,
                               backend) -> "collection":
    """All four histograms in one pass graph; returns a 1-element
    collection with DatasetHistograms (reference :319-361). On a backend
    with the fused path the whole computation runs on its device
    (``torch_sweep.fused_dataset_histograms``)."""
    if getattr(backend, "supports_fused_aggregation", False):
        from pipelinedp_tpu_torch.analysis import torch_sweep
        return torch_sweep.fused_dataset_histograms(col, data_extractors,
                                                    backend.device)
    from pipelinedp_tpu_torch import torch_engine
    if isinstance(col, torch_engine.ArrayDataset):
        col, data_extractors = torch_engine.array_dataset_to_rows(
            col, data_extractors)
    col = backend.map(
        col, lambda row: (data_extractors.privacy_id_extractor(row),
                          data_extractors.partition_extractor(row)),
        "Extract (privacy_id, partition_key)")
    col = backend.to_multi_transformable_collection(col)
    col_distinct = backend.distinct(col, "Distinct (pid, pk)")
    col_distinct = backend.to_multi_transformable_collection(col_distinct)

    return _to_dataset_histograms([
        _compute_l0_contributions_histogram(col_distinct, backend),
        _compute_linf_contributions_histogram(col, backend),
        _compute_partition_count_histogram(col, backend),
        _compute_partition_privacy_id_count_histogram(
            col_distinct, backend),
    ], backend)


# --- Pre-aggregated variants (reference :369-513): rows are
# (partition_key, (count, sum, n_partitions)). ---


def _compute_l0_histogram_preaggregated(col, backend):
    col = backend.map_tuple(col, lambda _, x: x[2], "Extract n_partitions")
    return _compute_frequency_histogram(col, backend,
                                        HistogramType.L0_CONTRIBUTIONS,
                                        deduplicate=True)


def _compute_linf_histogram_preaggregated(col, backend):
    col = backend.map_tuple(col, lambda _, x: x[0], "Extract count")
    return _compute_frequency_histogram(col, backend,
                                        HistogramType.LINF_CONTRIBUTIONS)


def _compute_partition_count_histogram_preaggregated(col, backend):
    col = backend.map_tuple(col, lambda pk, x: (pk, x[0]),
                            "Extract (pk, count)")
    col = backend.sum_per_key(col, "Sum counts per partition")
    col = backend.values(col, "Drop partition key")
    return _compute_frequency_histogram(col, backend,
                                        HistogramType.COUNT_PER_PARTITION)


def _compute_partition_privacy_id_count_histogram_preaggregated(
        col, backend):
    col = backend.keys(col, "Partition keys")
    col = backend.count_per_element(col, "Privacy ids per partition")
    col = backend.values(col, "Drop partition key")
    return _compute_frequency_histogram(
        col, backend, HistogramType.COUNT_PRIVACY_ID_PER_PARTITION)


def compute_dataset_histograms_on_preaggregated_data(
        col, data_extractors, backend):
    """Histograms over pre-aggregated rows (reference :369-513)."""
    col = backend.map(
        col, lambda row: (data_extractors.partition_extractor(row),
                          data_extractors.preaggregate_extractor(row)),
        "Extract (partition_key, preaggregate)")
    col = backend.to_multi_transformable_collection(col)
    return _to_dataset_histograms([
        _compute_l0_histogram_preaggregated(col, backend),
        _compute_linf_histogram_preaggregated(col, backend),
        _compute_partition_count_histogram_preaggregated(col, backend),
        _compute_partition_privacy_id_count_histogram_preaggregated(
            col, backend),
    ], backend)
