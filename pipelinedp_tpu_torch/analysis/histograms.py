"""Dataset-shape histograms for parameter tuning: the data classes of
``pipelinedp_tpu/analysis/histograms.py`` and its fused branch. L0
(partitions per privacy id), Linf (rows per (pid, pk)), count per
partition and privacy ids per partition, with a binning that keeps 3
leading digits, computed on the backend's device
(``torch_sweep.fused_dataset_histograms``). The host graph is ROADMAP
step 2 here and raises."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List


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


def compute_dataset_histograms(col, data_extractors, backend):
    """All four histograms; returns a 1-element collection with
    DatasetHistograms, computed on ``backend.device``."""
    from pipelinedp_tpu_torch.analysis import torch_sweep
    if not getattr(backend, "supports_fused_aggregation", False):
        raise torch_sweep._not_ported(
            f"dataset histograms on {type(backend).__name__} (the host "
            "graph)", 2)
    return torch_sweep.fused_dataset_histograms(col, data_extractors,
                                                backend.device)


def compute_dataset_histograms_on_preaggregated_data(
        col, data_extractors, backend):
    """Histograms over pre-aggregated rows: a host graph in the JAX
    package, not ported."""
    from pipelinedp_tpu_torch.analysis import torch_sweep
    raise torch_sweep._not_ported(
        "dataset histograms on pre-aggregated data (the host graph)", 2)
