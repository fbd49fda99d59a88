"""The port's host analysis graph (``pipelinedp_tpu_torch/analysis``:
``UtilityAnalysisEngine``, the analysis combiners and bounders, the
Poisson-binomial and Monte-Carlo helpers, ``preaggregate``, the host
histogram graphs and ``tune()`` on a host backend) against the JAX
package's, on the CPU, bit for bit.

The host graph's randomness (the Laplace error quantiles' Monte Carlo)
comes from each package's module-global host RNG, so one
``seed_host_rng`` seed in both gives the same bits. The cases follow the
host-graph classes of ``tests/test_analysis.py``: Poisson binomial,
probability computations, the analysis bounders, multi-parameter
configurations, the analysis combiners, histograms, ``perform_utility_
analysis``, pre-aggregation, the host ``tune`` and the engine's
validation. Each case runs in both packages and compares every field.
"""

import dataclasses
import operator

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu import analysis as jan
from pipelinedp_tpu.analysis import combiners as juac
from pipelinedp_tpu.analysis import poisson_binomial as jpb
from pipelinedp_tpu.analysis import probability_computations as jpc
from pipelinedp_tpu.budget_accounting import MechanismSpec as JSpec
from pipelinedp_tpu.combiners import CombinerParams as JParams
from pipelinedp_tpu.ops import noise as jnoise

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import analysis as tan
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch.analysis import combiners as tuac
from pipelinedp_tpu_torch.analysis import poisson_binomial as tpb
from pipelinedp_tpu_torch.analysis import probability_computations as tpc
from pipelinedp_tpu_torch.budget_accounting import MechanismSpec as TSpec
from pipelinedp_tpu_torch.combiners import CombinerParams as TParams
from pipelinedp_tpu_torch.ops import noise as tnoise

M = pdp.Metrics
# (package, analysis package, host noise, MechanismSpec, CombinerParams,
#  analysis combiners)
J = (pdp, jan, jnoise, JSpec, JParams, juac)
T = (pdt, tan, tnoise, TSpec, TParams, tuac)


def _bits(x):
    """A comparable image of ``x``: floats by their float64 bits, arrays by
    dtype and bytes, dataclasses field by field (AggregateParams of either
    package by ``str``), enums by name."""
    if isinstance(x, (float, np.floating)):
        return ("f", np.float64(x).view(np.uint64).item())
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [type(x).__name__] + [_bits(v) for v in x]
    if type(x).__name__ == "AggregateParams":
        return str(x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: _bits(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if hasattr(x, "name") and hasattr(type(x), "__members__"):
        return ("enum", type(x).__name__, x.name)
    return x


def _ex(pkg):
    return pkg.DataExtractors(privacy_id_extractor=operator.itemgetter(0),
                              partition_extractor=operator.itemgetter(1),
                              value_extractor=operator.itemgetter(2))


def _count_params(pkg, l0=1, linf=1, **kw):
    p = pdp.AggregateParams(**dict(dict(metrics=[M.COUNT],
                                        max_partitions_contributed=l0,
                                        max_contributions_per_partition=linf),
                                   **kw))
    return p if pkg is pdp else convert.params_from_reference(p)


def _convert_options(opts, side):
    """The same ``UtilityAnalysisOptions`` (or ``TuneOptions``) for
    ``side``: built from the JAX package's by field name."""
    if side is J:
        return opts
    return convert.options_from_reference(opts)


def _rows(seed=0, n=400, users=60, parts=8):
    rng = np.random.default_rng(seed)
    return list(zip(rng.integers(0, users, n).tolist(),
                    rng.integers(0, parts, n).tolist(),
                    rng.uniform(0, 5, n).tolist()))


def _both(fn, seed=0):
    """``fn(side)`` in each package after seeding its host RNG."""
    out = []
    for side in (J, T):
        side[2].seed_host_rng(seed)
        out.append(fn(side))
    return out


def _assert_same(fn, seed=0):
    j, t = _both(fn, seed)
    assert _bits(j) == _bits(t)
    return t


class TestPoissonBinomial:

    def test_exact_pmf_bit_equal(self):
        probs = np.random.default_rng(0).uniform(0, 1, 57).tolist()
        t = _assert_same(lambda s: (tpb if s is T else jpb).compute_pmf(
            probs))
        from scipy.stats import binom
        pmf = tpb.compute_pmf([0.3] * 10)
        np.testing.assert_allclose(pmf.probabilities,
                                   binom.pmf(np.arange(11), 10, 0.3),
                                   atol=1e-12)
        assert t.start == 0

    @pytest.mark.parametrize("n", [1, 200])
    def test_approximation_bit_equal(self, n):
        probs = np.random.default_rng(n).uniform(0.2, 0.8, n).tolist()

        def run(side):
            mod = tpb if side is T else jpb
            exp, std, skew = mod.compute_exp_std_skewness(probs)
            return (exp, std, skew,
                    mod.compute_pmf_approximation(exp, std, skew, n))

        _assert_same(run)

    def test_zero_sigma(self):
        pmf = tpb.compute_pmf_approximation(5.0, 0.0, 0.0, 10)
        assert pmf.start == 5 and pmf.probabilities.tolist() == [1.0]


class TestProbabilityComputations:

    @pytest.mark.parametrize("b,sigma,qs", [
        (1.0, 2.0, [0.1, 0.5, 0.9]),
        (1.01, 0.55, [0.5, 0.7, 0.9, 0.99]),
    ])
    def test_quantiles_bit_equal_from_host_rng(self, b, sigma, qs):
        _assert_same(lambda s: (tpc if s is T else jpc).
                     compute_sum_laplace_gaussian_quantiles(
                         b, sigma, qs, 10**4), seed=3)

    def test_quantiles_match_analytic(self):
        got = tpc.compute_sum_laplace_gaussian_quantiles(
            1.0, 2.0, [0.1, 0.5, 0.9], 4 * 10**6,
            rng=np.random.default_rng(0))
        np.testing.assert_allclose(got, [-3.0874, 0.0, 3.0874], atol=0.02)

    def test_batch_bit_equal(self):
        _assert_same(lambda s: (tpc if s is T else jpc).
                     compute_sum_laplace_gaussian_quantiles_batch(
                         np.array([1.0, 3.0]), np.array([2.0, 0.5]),
                         [0.1, 0.5, 0.9], 10**4), seed=4)


class TestAnalysisContributionBounders:

    @pytest.mark.parametrize("prob", [1.0, 0.5])
    def test_sampling_l0_linf_bit_equal(self, prob):
        rows = ([("u1", pk, 1.0) for pk in range(60)] +
                [("u1", "a", 2.0), ("u2", "a", 7.0)] + _rows(seed=1))

        def run(side):
            from importlib import import_module
            mod = import_module(side[1].__name__ + ".contribution_bounders")
            out = mod.SamplingL0LinfContributionBounder(
                prob).bound_contributions(rows, None, side[0].LocalBackend(),
                                          None, lambda x: x)
            return list(out)

        t = _assert_same(run)
        got = dict(t)
        if prob == 1.0:
            assert got[("u1", "a")] == (1, 2.0, 61)
            assert got[("u2", "a")] == (1, 7.0, 1)
        else:
            assert 0 < sum(1 for (p, _) in got if p == "u1") < 61

    def test_noop_bounder_preaggregated(self):
        from pipelinedp_tpu_torch.analysis.contribution_bounders import (
            NoOpContributionBounder)
        rows = [("a", (2, 3.0, 4)), ("b", (1, 1.0, 4))]
        out = dict(NoOpContributionBounder().bound_contributions(
            rows, None, pdt.LocalBackend(), None, lambda x: x))
        assert out == {(None, "a"): (2, 3.0, 4), (None, "b"): (1, 1.0, 4)}


class TestMultiParameterConfiguration:

    def test_validation_alike(self):
        for kw in ({}, dict(max_partitions_contributed=[1, 2],
                            max_contributions_per_partition=[1])):
            errors = []
            for side in (J, T):
                with pytest.raises(ValueError) as err:
                    side[1].MultiParameterConfiguration(**kw)
                errors.append(str(err.value))
            assert errors[0] == errors[1]

    def test_get_aggregate_params_alike(self):

        def run(side):
            mpc = side[1].MultiParameterConfiguration(
                max_partitions_contributed=[1, 2],
                max_contributions_per_partition=[10, 11])
            base = _count_params(side[0], l0=5, linf=5)
            return [mpc.get_aggregate_params(base, i) for i in range(2)]

        j, t = _both(run)
        assert [str(p) for p in j] == [str(p) for p in t]


class TestAnalysisCombiners:

    @staticmethod
    def _params(side, agg, eps=1.0, delta=1e-6):
        spec = side[3](side[0].aggregate_params.MechanismType.LAPLACE,
                       _eps=eps, _delta=delta)
        return side[4](spec, agg)

    @pytest.mark.parametrize("name,data", [
        ("CountCombiner", (np.array([5, 1, 9]), np.zeros(3),
                           np.array([2, 1, 4]))),
        ("PrivacyIdCountCombiner", (np.array([7, 0]), np.zeros(2),
                                    np.array([4, 4]))),
        ("SumCombiner", (None, np.array([15.0, -5.0, 3.0]),
                         np.array([1, 3, 2]))),
        ("PartitionSelectionCombiner", (np.ones(150), np.zeros(150),
                                        np.arange(1, 151))),
    ])
    def test_per_partition_combiner_bit_equal(self, name, data):

        def run(side):
            agg = side[0].AggregateParams(
                metrics=[side[0].Metrics.SUM], max_partitions_contributed=2,
                max_contributions_per_partition=3,
                min_sum_per_partition=0.0, max_sum_per_partition=10.0)
            c = getattr(side[5], name)(self._params(side, agg, delta=1e-5))
            acc = c.create_accumulator(data)
            acc2 = c.merge_accumulators(acc, c.create_accumulator(data))
            return acc, acc2, c.compute_metrics(acc2)

        _assert_same(run)

    def test_sparse_to_dense_and_moments(self):

        def run(side):
            c = side[5].CountCombiner(self._params(side, _count_params(
                side[0], l0=1, linf=2)))
            compound = side[5].CompoundCombiner(
                [c, side[5].PrivacyIdCountCombiner(self._params(
                    side, _count_params(side[0])))],
                return_named_tuple=False)
            acc = compound.create_accumulator((1, 1.0, 1))
            for i in range(6):
                acc = compound.merge_accumulators(
                    acc, compound.create_accumulator((i + 1, 1.0, i % 3 + 1)))
            probs = [0.5] * (side[5].MAX_PROBABILITIES_IN_ACCUMULATOR + 1)
            merged = side[5]._merge_partition_selection_accumulators(
                (probs[:60], None), (probs[:60], None))
            return acc, compound.compute_metrics(acc), merged

        t = _assert_same(run)
        assert t[0][0] is None and t[2][0] is None and t[2][1].count == 120

    def test_aggregate_error_combiners_bit_equal(self):

        def run(side):
            metrics, uac = side[1].metrics, side[5]
            sel = uac.PrivatePartitionSelectionAggregateErrorMetricsCombiner(
                [0.1, 0.5, 0.9, 0.99])
            out = []
            for kind in ("GAUSSIAN", "LAPLACE"):
                mk = side[5].SumAggregateErrorMetricsCombiner(
                    metrics.AggregateMetricType.COUNT, [0.1, 0.5, 0.9, 0.99])
                compound = side[5].AggregateErrorMetricsCompoundCombiner(
                    [sel, mk, sel, mk], return_named_tuple=False)
                sm = metrics.SumMetrics(
                    sum=10.0, per_partition_error_min=0.0,
                    per_partition_error_max=-2.0,
                    expected_cross_partition_error=-4.0,
                    std_cross_partition_error=1.5, std_noise=1.0,
                    noise_kind=getattr(side[0].NoiseKind, kind))
                a = compound.create_accumulator((1.0, sm, 0.25, sm))
                b = compound.create_accumulator((0.5, sm, 0.75, sm))
                merged = compound.merge_accumulators(a, b)
                out.append((a, merged, compound.compute_metrics(merged)))
            return out

        t = _assert_same(run, seed=6)
        assert t[0][0][1][3].kept_partitions_expected == 0.25


class TestHistograms:

    def test_bin_lower_and_quantiles(self):
        from pipelinedp_tpu_torch.analysis import histograms
        assert [histograms._to_bin_lower(n) for n in (123, 1234, 12345)] \
            == [123, 1230, 12300]
        bins = [histograms.FrequencyBin(lower=i, count=10, sum=10 * i, max=i)
                for i in range(1, 11)]
        h = histograms.Histogram(histograms.HistogramType.L0_CONTRIBUTIONS,
                                 bins)
        assert h.quantiles([0.05, 0.5, 0.95]) == [1, 6, 10]

    def test_dataset_histograms_bit_equal(self):
        data = ([(0, "a", 1.0), (0, "b", 1.0)] + [(1, "a", 1.0)] * 3 +
                [(2, "b", 1.0)] + _rows(seed=2, n=1500, users=300,
                                        parts=40))

        def run(side):
            return list(side[1].compute_dataset_histograms(
                data, _ex(side[0]), side[0].LocalBackend()))[0]

        t = _assert_same(run)
        assert t.l0_contributions_histogram.total_count() == len(
            {u for u, _, _ in data})
        assert t.linf_contributions_histogram.total_sum() == len(data)

    def test_array_dataset_on_host_backend(self):
        rng = np.random.default_rng(5)
        cols = (rng.integers(0, 90, 700), rng.integers(0, 30, 700),
                rng.random(700))
        j, t = _both(lambda s: list(s[1].compute_dataset_histograms(
            s[0].ArrayDataset(*cols), s[0].DataExtractors(),
            s[0].LocalBackend()))[0])
        assert _bits(j) == _bits(t)
        # The fused histograms give the same bins on the port's device.
        fused = list(tan.compute_dataset_histograms(
            pdt.ArrayDataset(*cols), pdt.DataExtractors(),
            pdt.TorchBackend("cpu")))[0]
        assert _bits(fused) == _bits(t)

    def test_preaggregated_histograms_bit_equal(self):
        rows = _rows(seed=3, n=900, users=150, parts=25)

        def run(side):
            pre = list(side[1].preaggregate(rows, side[0].LocalBackend(),
                                            _ex(side[0])))
            ex = side[1].PreAggregateExtractors(
                partition_extractor=operator.itemgetter(0),
                preaggregate_extractor=operator.itemgetter(1))
            return pre, list(
                side[1].compute_dataset_histograms_on_preaggregated_data(
                    pre, ex, side[0].LocalBackend()))[0]

        _assert_same(run)


UA_CASES = {
    "private_count": dict(params=dict(metrics=[M.COUNT],
                                      max_partitions_contributed=2,
                                      max_contributions_per_partition=1)),
    "multi_config": dict(params=dict(metrics=[M.COUNT, M.PRIVACY_ID_COUNT],
                                     max_partitions_contributed=1,
                                     max_contributions_per_partition=1),
                         multi=dict(max_partitions_contributed=[1, 2, 4],
                                    max_contributions_per_partition=[1, 2,
                                                                     4])),
    "public_sum_gaussian": dict(
        params=dict(metrics=[M.SUM, M.COUNT], max_partitions_contributed=2,
                    max_contributions_per_partition=2,
                    min_sum_per_partition=0.0, max_sum_per_partition=6.0,
                    noise_kind=pdp.NoiseKind.GAUSSIAN),
        public=list(range(10))),
    "sampling_thresholding": dict(
        params=dict(metrics=[M.COUNT], max_partitions_contributed=2,
                    max_contributions_per_partition=2,
                    partition_selection_strategy=(
                        pdp.PartitionSelectionStrategy.LAPLACE_THRESHOLDING)),
        sampling=0.6),
    "many_users_moments": dict(
        params=dict(metrics=[M.PRIVACY_ID_COUNT],
                    max_partitions_contributed=3,
                    max_contributions_per_partition=1),
        rows=dict(n=1500, users=400, parts=3)),
}


def _ua_options(side, case):
    spec = UA_CASES[case]
    multi = (jan.MultiParameterConfiguration(**spec["multi"])
             if "multi" in spec else None)
    opts = jan.UtilityAnalysisOptions(
        epsilon=2.0, delta=1e-5,
        aggregate_params=pdp.AggregateParams(**spec["params"]),
        multi_param_configuration=multi,
        partitions_sampling_prob=spec.get("sampling", 1))
    return _convert_options(opts, side)


class TestPerformUtilityAnalysis:

    @pytest.mark.parametrize("case", sorted(UA_CASES))
    @pytest.mark.parametrize("per_partition", [False, True],
                             ids=["aggregate", "per_partition"])
    def test_local_backend_bit_equal(self, case, per_partition):
        rows = _rows(seed=len(case), **UA_CASES[case].get("rows", {}))
        public = UA_CASES[case].get("public")

        def run(side):
            out = side[1].perform_utility_analysis(
                rows, side[0].LocalBackend(), _ua_options(side, case),
                _ex(side[0]), public_partitions=public,
                return_per_partition=per_partition)
            if per_partition:
                res, pp = out
                return list(res)[0], sorted(pp, key=repr)
            return list(out)[0]

        t = _assert_same(run, seed=11)
        result = t[0] if per_partition else t
        assert len(result) == (3 if case == "multi_config" else 1)
        if public is None:
            assert result[0].partition_selection_metrics is not None

    def test_error_expectations(self):
        """``tests/test_analysis.py``'s closed-form expectations hold on the
        port: linf = 1 truncates 3 of 4 rows of each of 30 users."""
        data = [(u, "a", 1.0) for u in range(30) for _ in range(4)]
        opts = tan.UtilityAnalysisOptions(
            epsilon=2.0, delta=1e-5,
            aggregate_params=_count_params(pdt),
            multi_param_configuration=tan.MultiParameterConfiguration(
                max_contributions_per_partition=[1, 2, 4]))
        result = list(tan.perform_utility_analysis(
            data, pdt.LocalBackend(), opts, _ex(pdt)))[0]
        assert result[0].count_metrics.error_linf_expected == \
            pytest.approx(-90.0)
        assert result[2].count_metrics.error_linf_expected == \
            pytest.approx(0.0)

    def test_torch_backend_host_graph_bit_equal_to_jax_backend(self):
        """The host graph on ``TorchBackend``'s inherited host ops, as the
        byte-capped fetch runs it, equals the JAX package's on
        ``JaxBackend``."""
        from pipelinedp_tpu.analysis import utility_analysis as jua
        from pipelinedp_tpu.backends import JaxBackend
        from pipelinedp_tpu_torch.analysis import utility_analysis as tua
        rng = np.random.default_rng(8)
        cols = (rng.integers(0, 50, 500), rng.integers(0, 7, 500),
                rng.random(500) * 4)

        def run(side):
            ua, backend = ((tua, pdt.TorchBackend("cpu")) if side is T else
                           (jua, JaxBackend()))
            res, pp = ua._host_analysis(
                side[0].ArrayDataset(*cols), backend,
                _ua_options(side, "multi_config"), side[0].DataExtractors(),
                None, True)
            return list(res)[0], list(pp)

        _assert_same(run, seed=2)


class TestPreAggregation:

    @pytest.mark.parametrize("prob", [1, 0.5])
    def test_preaggregate_bit_equal(self, prob):
        rows = _rows(seed=4)
        t = _assert_same(lambda s: sorted(s[1].preaggregate(
            rows, s[0].LocalBackend(), _ex(s[0]),
            partitions_sampling_prob=prob), key=repr))
        assert len(t) > 0

    def test_preaggregate_output(self):
        data = [(0, "a", 2.0), (0, "a", 3.0), (0, "b", 1.0), (1, "a", 4.0)]
        result = list(tan.preaggregate(data, pdt.LocalBackend(), _ex(pdt)))
        assert ("a", (2, 5.0, 2)) in result
        assert ("b", (1, 1.0, 2)) in result
        assert ("a", (1, 4.0, 1)) in result

    def test_analysis_on_preaggregated_bit_equal(self):
        rows = _rows(seed=5)

        def run(side):
            pre = list(side[1].preaggregate(rows, side[0].LocalBackend(),
                                            _ex(side[0])))
            opts = _convert_options(jan.UtilityAnalysisOptions(
                epsilon=1.0, delta=1e-5,
                aggregate_params=_count_params(pdp, l0=2, linf=2),
                pre_aggregated_data=True), side)
            ex = side[1].PreAggregateExtractors(
                partition_extractor=operator.itemgetter(0),
                preaggregate_extractor=operator.itemgetter(1))
            return list(side[1].perform_utility_analysis(
                pre, side[0].LocalBackend(), opts, ex))[0]

        t = _assert_same(run, seed=7)
        assert t[0].count_metrics is not None


class TestTune:

    @staticmethod
    def _data():
        # Heavy-tailed L0 and Linf, so the histogram quantiles give several
        # candidates of each.
        rng = np.random.default_rng(1)
        data = []
        for u in range(150):
            n_parts = 1 + min(int(rng.pareto(1.0) * 3), 40)
            for pk in rng.choice(50, n_parts, replace=False):
                for _ in range(1 + min(int(rng.pareto(1.0) * 2), 12)):
                    data.append((u, int(pk), float(rng.uniform(0, 5))))
        return data

    @pytest.mark.parametrize("metric", ["COUNT", "SUM"])
    def test_tune_on_local_backend_bit_equal(self, metric):
        data = self._data()
        extra = ({} if metric == "COUNT" else
                 dict(min_sum_per_partition=0.0, max_sum_per_partition=8.0))

        def run(side):
            hist = list(side[1].compute_dataset_histograms(
                data, _ex(side[0]), side[0].LocalBackend()))[0]
            opts = _convert_options(jan.TuneOptions(
                epsilon=2.0, delta=1e-5,
                aggregate_params=pdp.AggregateParams(
                    metrics=[getattr(M, metric)],
                    max_partitions_contributed=1,
                    max_contributions_per_partition=1, **extra),
                function_to_minimize=jan.MinimizingFunction.ABSOLUTE_ERROR,
                parameters_to_tune=jan.ParametersToTune(
                    max_partitions_contributed=True,
                    max_contributions_per_partition=(metric == "COUNT"))),
                side)
            result = list(side[1].tune(data, side[0].LocalBackend(), hist,
                                       opts, _ex(side[0])))[0]
            return (result.index_best, result.utility_analysis_results,
                    result.utility_analysis_parameters)

        t = _assert_same(run, seed=9)
        assert t[2].size > 1 and 0 <= t[0] < t[2].size

    def test_tune_rejects_alike(self):
        errors = []
        for side in (J, T):
            params = side[0].AggregateParams(
                metrics=[side[0].Metrics.SUM], max_partitions_contributed=1,
                max_contributions_per_partition=1, min_value=0.0,
                max_value=1.0)
            with pytest.raises(ValueError) as err:
                side[1].tune([1], side[0].LocalBackend(), None,
                             side[1].TuneOptions(
                                 epsilon=1.0, delta=1e-5,
                                 aggregate_params=params,
                                 function_to_minimize=(
                                     side[1].MinimizingFunction.
                                     ABSOLUTE_ERROR),
                                 parameters_to_tune=side[1].ParametersToTune(
                                     max_partitions_contributed=True)),
                             _ex(side[0]))
            errors.append(str(err.value))
        assert errors[0] == errors[1]


class TestUtilityAnalysisEngineValidation:

    def test_aggregate_raises(self):
        engine = tan.UtilityAnalysisEngine(pdt.NaiveBudgetAccountant(
            1.0, 1e-6), pdt.LocalBackend())
        with pytest.raises(ValueError, match="can't be called"):
            engine.aggregate([1], _count_params(pdt), _ex(pdt))
        assert engine._supports_fused_dispatch is False

    @pytest.mark.parametrize("bad", ["mean", "max_contributions",
                                     "enforced", "extractors"])
    def test_rejected_alike(self, bad):
        errors = []
        for side in (J, T):
            pkg = side[0]
            kw = dict(metrics=[pkg.Metrics.COUNT],
                      max_partitions_contributed=1,
                      max_contributions_per_partition=1)
            if bad == "mean":
                kw.update(metrics=[pkg.Metrics.MEAN], min_value=0.0,
                          max_value=1.0)
            elif bad == "max_contributions":
                kw = dict(metrics=[pkg.Metrics.COUNT], max_contributions=2)
            elif bad == "enforced":
                kw.update(contribution_bounds_already_enforced=True)
            options = side[1].UtilityAnalysisOptions(
                epsilon=1.0, delta=1e-6,
                aggregate_params=pkg.AggregateParams(**kw))
            engine = side[1].UtilityAnalysisEngine(
                pkg.NaiveBudgetAccountant(1.0, 1e-6), pkg.LocalBackend())
            ex = object() if bad == "extractors" else _ex(pkg)
            with pytest.raises(Exception) as err:
                engine.analyze([(0, "a", 1.0)], options, ex)
            errors.append((err.type, str(err.value)))
        assert errors[0] == errors[1]
