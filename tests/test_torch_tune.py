"""Dataset histograms and parameter tuning of the port
(``pipelinedp_tpu_torch/analysis``: ``compute_dataset_histograms`` on the
device and ``tune``) against the JAX package's fused histograms and its
``tune`` on ``JaxBackend``, on the CPU: every bin equal, the same candidate
grid, the same best index, and every ``AggregateMetrics`` field of the
tuning sweep bit-equal. The cases follow ``tests/test_analysis.py``'s
``TestFusedHistograms`` and ``TestTune``.
"""

import dataclasses
import operator

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
from pipelinedp_tpu import analysis as jan
from pipelinedp_tpu.analysis import jax_sweep
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pt
from pipelinedp_tpu_torch import analysis as tan
from pipelinedp_tpu_torch.analysis import histograms as thist
from pipelinedp_tpu_torch.analysis import torch_sweep


def _extractors(pmod):
    return pmod.DataExtractors(privacy_id_extractor=operator.itemgetter(0),
                               partition_extractor=operator.itemgetter(1),
                               value_extractor=operator.itemgetter(2))


def _hists(data):
    j = list(jan.compute_dataset_histograms(data, _extractors(pdp),
                                            JaxBackend()))[0]
    t = list(tan.compute_dataset_histograms(
        data, _extractors(pt), pt.TorchBackend(device="cpu")))[0]
    return j, t


def _bins(h):
    return [(b.lower, b.count, b.sum, b.max) for b in h.bins]


def _assert_hists_equal(j, t):
    for name in ("l0_contributions_histogram",
                 "linf_contributions_histogram",
                 "count_per_partition_histogram",
                 "count_privacy_id_per_partition"):
        assert _bins(getattr(j, name)) == _bins(getattr(t, name)), name
        assert getattr(j, name).name.value == getattr(t, name).name.value


class TestFusedHistograms:

    def test_matches_jax(self):
        rng = np.random.default_rng(11)
        data = [(int(u), int(p), 1.0)
                for u, p in zip(rng.integers(0, 60, 4000),
                                rng.integers(0, 25, 4000))]
        # Heavy-hitter user and a hot partition to spread bin decades.
        data += [(999, 7, 1.0)] * 2500
        _assert_hists_equal(*_hists(data))

    def test_wide_decades(self):
        """Counts past 1000 and 10000 reach the decade bins."""
        rng = np.random.default_rng(13)
        data = [(int(u), int(p), 1.0)
                for u, p in zip(rng.integers(0, 30000, 60000),
                                (rng.zipf(1.2, 60000) % 50))]
        j, t = _hists(data)
        _assert_hists_equal(j, t)
        assert max(b.lower for b in t.count_per_partition_histogram.bins
                   ) >= 1000

    def test_bin_ids_match_jax(self):
        import jax.numpy as jnp
        vals = np.array([1, 2, 999, 1000, 1001, 1010, 9999, 10000, 10001,
                         123456, 9876543, 2**30, 2**31 - 1], np.int32)
        jids = np.asarray(jax_sweep._bin_ids(jnp.asarray(vals)))
        tids = torch_sweep._bin_ids(torch.from_numpy(vals)).numpy()
        np.testing.assert_array_equal(jids, tids)
        lowers = torch_sweep._bin_lower_of_id(tids)
        assert lowers.tolist() == [thist._to_bin_lower(int(v))
                                   for v in vals]

    def test_quantiles_agree(self):
        rng = np.random.default_rng(12)
        data = [(int(u), int(p), 1.0)
                for u, p in zip(rng.integers(0, 100, 3000),
                                rng.zipf(1.5, 3000) % 40)]
        j, t = _hists(data)
        qs = [0.9, 0.95, 0.99]
        for name in ("l0_contributions_histogram",
                     "linf_contributions_histogram"):
            assert (getattr(j, name).quantiles(qs) ==
                    getattr(t, name).quantiles(qs))

    def test_value_1000_shares_bin_with_1001(self):
        data = ([(u, 0, 1.0) for u in range(1000)] +
                [(u, 1, 1.0) for u in range(1003)])
        j, t = _hists(data)
        _assert_hists_equal(j, t)
        fb = t.count_per_partition_histogram.bins
        assert len(fb) == 1 and fb[0].lower == 1000 and fb[0].count == 2

    def test_empty_input(self):
        t = list(tan.compute_dataset_histograms(
            [], _extractors(pt), pt.TorchBackend(device="cpu")))[0]
        assert t.l0_contributions_histogram.bins == []


def _tune_both(data, metric, to_tune, eps, **params):
    out = []
    for amod, pmod, backend in ((jan, pdp, JaxBackend()),
                                (tan, pt, pt.TorchBackend(device="cpu"))):
        hist = list(amod.compute_dataset_histograms(
            data, _extractors(pmod), backend))[0]
        options = amod.TuneOptions(
            epsilon=eps, delta=1e-5,
            aggregate_params=pmod.AggregateParams(
                metrics=[getattr(pmod.Metrics, metric)], **params),
            function_to_minimize=amod.MinimizingFunction.ABSOLUTE_ERROR,
            parameters_to_tune=amod.ParametersToTune(**to_tune))
        out.append(list(amod.tune(data, backend, hist, options,
                                  _extractors(pmod)))[0])
    return out


def _assert_tune_equal(j, t):
    assert j.index_best == t.index_best
    assert (dataclasses.asdict(j.utility_analysis_parameters) ==
            {k: v for k, v in dataclasses.asdict(
                t.utility_analysis_parameters).items()})
    assert len(j.utility_analysis_results) == len(t.utility_analysis_results)
    for a, b in zip(j.utility_analysis_results, t.utility_analysis_results):
        for f in ("count_metrics", "sum_metrics",
                  "privacy_id_count_metrics", "partition_selection_metrics"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None)
            if x is None:
                continue
            dx, dy = dataclasses.asdict(x), dataclasses.asdict(y)
            for k in dx:
                if k == "metric_type":
                    assert dx[k].value == dy[k].value
                    continue
                np.testing.assert_array_equal(
                    np.asarray(dx[k], np.float64).view(np.uint64),
                    np.asarray(dy[k], np.float64).view(np.uint64),
                    err_msg=f"{f}.{k}")


class TestTune:

    def test_tune_count(self):
        rng = np.random.default_rng(0)
        data = []
        for u in range(100):
            n_parts = rng.integers(1, 6)
            for pk in rng.choice(20, n_parts, replace=False):
                for _ in range(rng.integers(1, 4)):
                    data.append((u, int(pk), 1.0))
        j, t = _tune_both(data, "COUNT",
                          dict(max_partitions_contributed=True,
                               max_contributions_per_partition=True), 2.0,
                          max_partitions_contributed=1,
                          max_contributions_per_partition=1)
        assert isinstance(t, tan.TuneResult)
        assert 0 <= t.index_best < t.utility_analysis_parameters.size
        _assert_tune_equal(j, t)

    def test_tune_privacy_id_count(self):
        rng = np.random.default_rng(3)
        data = [(int(u), int(p), 1.0)
                for u, p in zip(rng.integers(0, 200, 3000),
                                rng.zipf(1.4, 3000) % 30)]
        j, t = _tune_both(data, "PRIVACY_ID_COUNT",
                          dict(max_partitions_contributed=True), 1.0,
                          max_partitions_contributed=1,
                          max_contributions_per_partition=1)
        _assert_tune_equal(j, t)

    def test_tune_sum(self):
        rng = np.random.default_rng(1)
        data = []
        for u in range(150):
            n_parts = 1 + min(int(rng.pareto(1.0) * 3), 40)
            for pk in rng.choice(50, n_parts, replace=False):
                data.append((u, int(pk), float(rng.uniform(0, 5))))
        j, t = _tune_both(data, "SUM", dict(max_partitions_contributed=True),
                          1.0, max_partitions_contributed=1,
                          max_contributions_per_partition=1,
                          min_sum_per_partition=0.0,
                          max_sum_per_partition=10.0)
        assert t.utility_analysis_parameters.size > 1
        _assert_tune_equal(j, t)

    def test_tune_rejects_unsupported(self):
        params = pt.AggregateParams(
            metrics=[pt.Metrics.SUM], max_partitions_contributed=1,
            max_contributions_per_partition=1, min_value=0.0,
            max_value=1.0)
        options = tan.TuneOptions(
            epsilon=1.0, delta=1e-5, aggregate_params=params,
            function_to_minimize=tan.MinimizingFunction.ABSOLUTE_ERROR,
            parameters_to_tune=tan.ParametersToTune(
                max_partitions_contributed=True))
        with pytest.raises(ValueError, match="min/max_sum_per_partition"):
            tan.tune([1], pt.TorchBackend(device="cpu"), None, options,
                     _extractors(pt))
