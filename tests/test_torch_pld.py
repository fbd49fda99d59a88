"""The port's PLD engine (``pipelinedp_tpu_torch.pld``) and its
``PLDBudgetAccountant``, on the CPU.

The first half is the port's copy of ``tests/test_pld.py``: the engine
against closed-form ground truth, and the accountant driving ``DPEngine`` on
the port's ``LocalBackend`` and ``TorchBackend(device="cpu")``. The second
half holds the port to the JAX package bit for bit: the same mechanisms give
the same ``DiscretePLD`` arrays and the same minimum noise std, both
accountants grant every spec the same (eps, delta, stddev), and
``DPEngine.aggregate`` under PLD releases the same bytes at the same
``rng_seed`` (``TorchBackend`` against ``JaxBackend``, and the two
``LocalBackend``s under one ``seed_host_rng`` seed).
"""

import math

import numpy as np
import pytest

from pipelinedp_tpu_torch import pld
from pipelinedp_tpu_torch.aggregate_params import MechanismType
from pipelinedp_tpu_torch.budget_accounting import PLDBudgetAccountant


def analytic_gaussian_delta(eps: float, sigma: float, s: float = 1.0):
    """Exact delta(eps) of the Gaussian mechanism (Balle & Wang 2018)."""

    def phi(z):
        return 0.5 * (1 + math.erf(z / math.sqrt(2)))

    return phi(s / (2 * sigma) - eps * sigma / s) - math.exp(eps) * phi(
        -s / (2 * sigma) - eps * sigma / s)


class TestGaussianPLD:

    @pytest.mark.parametrize("sigma,eps", [(1.0, 1.0), (2.0, 0.5),
                                           (0.5, 3.0), (4.0, 0.1)])
    def test_delta_matches_analytic(self, sigma, eps):
        p = pld.gaussian_pld(sigma, sensitivity=1.0, discretization=1e-4)
        expected = analytic_gaussian_delta(eps, sigma)
        got = p.delta_for_epsilon(eps)
        # Pessimistic rounding: got >= expected, but close.
        assert got >= expected - 1e-6
        assert got == pytest.approx(expected, abs=5e-4)

    def test_composition_equals_scaled_sensitivity(self):
        # k-fold composition of Gaussian(sigma, s=1) == single Gaussian with
        # sensitivity sqrt(k) (losses are normal; means/variances add).
        k, sigma, eps = 4, 2.0, 1.0
        single = pld.gaussian_pld(sigma, discretization=1e-4)
        composed = single.self_compose(k)
        expected = analytic_gaussian_delta(eps, sigma, s=math.sqrt(k))
        assert composed.delta_for_epsilon(eps) == pytest.approx(expected,
                                                                abs=2e-3)

    def test_mass_conservation(self):
        p = pld.gaussian_pld(1.0)
        assert p.probs.sum() + p.infinity_mass == pytest.approx(1.0, abs=1e-9)


class TestLaplacePLD:

    def test_pure_dp_above_eps(self):
        # Laplace(b=1, s=1) is 1-DP: delta(eps) == 0 for eps >= 1.
        p = pld.laplace_pld(1.0, sensitivity=1.0)
        assert p.delta_for_epsilon(1.0 + 1e-3) == pytest.approx(0.0, abs=1e-9)

    def test_delta_at_zero_matches_tv_distance(self):
        # delta(0) = TV(Lap(0,b), Lap(s,b)) = 1 - e^(-s/(2b)).
        b, s = 1.0, 1.0
        p = pld.laplace_pld(b, sensitivity=s)
        expected = 1 - math.exp(-s / (2 * b))
        assert p.delta_for_epsilon(0.0) == pytest.approx(expected, abs=5e-4)

    def test_atom_at_max_loss(self):
        # P(L = s/b) = 1/2 (all x <= 0). The topmost bucket must hold ~1/2.
        p = pld.laplace_pld(1.0, sensitivity=1.0)
        assert p.probs[-1] == pytest.approx(0.5, abs=1e-3)

    def test_composition_of_two_laplace(self):
        # delta(eps) of 2 compositions at eps = 2*s/b must be 0 (pure DP
        # composition: eps totals add).
        p = pld.laplace_pld(1.0).self_compose(2)
        assert p.delta_for_epsilon(2.0 + 1e-2) == pytest.approx(0.0,
                                                                abs=1e-9)
        # And strictly positive below the total eps.
        assert p.delta_for_epsilon(1.0) > 1e-4


class TestPureDpPLD:

    def test_delta_profile(self):
        eps0, delta0 = 1.0, 1e-3
        p = pld.pure_dp_pld(eps0, delta0)
        assert p.delta_for_epsilon(eps0) == pytest.approx(delta0, abs=1e-9)
        assert p.delta_for_epsilon(0.0) > delta0


class TestFindMinimumNoiseStd:

    def test_single_gaussian_matches_analytic_calibration(self):
        eps, delta = 1.0, 1e-6
        std = pld.find_minimum_noise_std(
            [(MechanismType.GAUSSIAN, 1.0, 1.0)], eps, delta,
            discretization=1e-3)
        # Check the analytic delta at the found sigma is <= delta and that
        # slightly less noise would violate it.
        assert analytic_gaussian_delta(eps, std) <= delta
        assert analytic_gaussian_delta(eps, std * 0.9) > delta

    def test_single_laplace_close_to_pure_dp_scale(self):
        # One Laplace mechanism, delta tiny: b -> s/eps, std = b*sqrt(2).
        eps, delta = 1.0, 1e-9
        std = pld.find_minimum_noise_std(
            [(MechanismType.LAPLACE, 1.0, 1.0)], eps, delta,
            discretization=1e-3)
        expected = math.sqrt(2.0) / eps
        assert std == pytest.approx(expected, rel=0.05)

    def test_more_mechanisms_need_more_noise(self):
        eps, delta = 1.0, 1e-6
        one = pld.find_minimum_noise_std([(MechanismType.GAUSSIAN, 1.0, 1.0)],
                                         eps, delta, discretization=1e-3)
        four = pld.find_minimum_noise_std(
            [(MechanismType.GAUSSIAN, 1.0, 1.0)] * 4, eps, delta,
            discretization=1e-3)
        assert four > one
        # Advanced composition: roughly sqrt(4)=2x, certainly < 4x (naive).
        assert four < 4 * one
        assert four == pytest.approx(2 * one, rel=0.15)

    def test_weight_scales_noise(self):
        eps, delta = 1.0, 1e-6
        mechs = [(MechanismType.GAUSSIAN, 1.0, 1.0),
                 (MechanismType.GAUSSIAN, 1.0, 3.0)]
        std = pld.find_minimum_noise_std(mechs, eps, delta,
                                         discretization=1e-3)
        assert std > 0  # weighted mechanisms compose; smoke-level check


class TestPLDBudgetAccountant:

    def test_end_to_end_fills_noise_std(self):
        acc = PLDBudgetAccountant(total_epsilon=1.0, total_delta=1e-6,
                                  pld_discretization=1e-3)
        spec_g = acc.request_budget(MechanismType.GAUSSIAN, sensitivity=2.0)
        spec_l = acc.request_budget(MechanismType.LAPLACE, sensitivity=1.0)
        acc.compute_budgets()
        assert acc.minimum_noise_std is not None
        assert spec_g.noise_standard_deviation == pytest.approx(
            2.0 * acc.minimum_noise_std)
        assert spec_l.noise_standard_deviation == pytest.approx(
            acc.minimum_noise_std)

    def test_generic_mechanism_gets_eps_delta(self):
        acc = PLDBudgetAccountant(total_epsilon=1.0, total_delta=1e-6,
                                  pld_discretization=1e-3)
        spec = acc.request_budget(MechanismType.GENERIC)
        acc.compute_budgets()
        assert spec.eps > 0
        assert spec.delta > 0

    def test_zero_delta_uses_laplace_closed_form(self):
        # Reference budget_accounting.py:509-514: delta=0 =>
        # minimum_noise_std = sum(weights)/eps * sqrt(2).
        acc = PLDBudgetAccountant(total_epsilon=2.0, total_delta=0.0)
        spec = acc.request_budget(MechanismType.LAPLACE, weight=1.0)
        acc.request_budget(MechanismType.LAPLACE, weight=3.0)
        acc.compute_budgets()
        assert acc.minimum_noise_std == pytest.approx(4.0 / 2.0 *
                                                      math.sqrt(2.0))
        assert spec.noise_standard_deviation == pytest.approx(
            acc.minimum_noise_std)

    def test_compute_budgets_inside_scope_raises(self):
        acc = PLDBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        with pytest.raises(Exception, match="within a budget scope"):
            with acc.scope(weight=1.0):
                acc.request_budget(MechanismType.GAUSSIAN)
                acc.compute_budgets()

    def test_naive_compute_budgets_inside_scope_raises(self):
        from pipelinedp_tpu_torch.budget_accounting import NaiveBudgetAccountant
        acc = NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        with pytest.raises(Exception, match="within a budget scope"):
            with acc.scope(weight=1.0):
                acc.request_budget(MechanismType.LAPLACE)
                acc.compute_budgets()

    def test_less_noise_than_naive_for_many_mechanisms(self):
        # The whole point of PLD accounting: with many mechanisms the
        # required noise grows ~sqrt(k), not k.
        k, eps, delta = 9, 1.0, 1e-6
        acc = PLDBudgetAccountant(total_epsilon=eps, total_delta=delta,
                                  pld_discretization=1e-3)
        specs = [
            acc.request_budget(MechanismType.GAUSSIAN) for _ in range(k)
        ]
        acc.compute_budgets()
        pld_std = specs[0].noise_standard_deviation
        # Naive split: each mechanism gets eps/k -> sigma grows ~linearly.
        naive_single = pld.find_minimum_noise_std(
            [(MechanismType.GAUSSIAN, 1.0, 1.0)], eps / k, delta / k,
            discretization=1e-3)
        assert pld_std < naive_single


class TestPLDWithEngine:
    """The PLD accountant drives DPEngine end-to-end — a capability the
    reference's PLD accountant lacks (reference budget_accounting.py:406
    'not yet compatible with DPEngine'). The granted noise level is
    published as equivalent per-mechanism (eps, delta) whose standard
    calibration round-trips exactly."""

    @pytest.mark.parametrize("kind", ["laplace", "gaussian"])
    def test_engine_end_to_end(self, kind):
        import operator
        import pipelinedp_tpu_torch as pdp
        from pipelinedp_tpu_torch.ops import noise as noise_ops

        data = [(u, p, 1.0) for u in range(200) for p in ("a", "b")]
        ex = pdp.DataExtractors(
            privacy_id_extractor=operator.itemgetter(0),
            partition_extractor=operator.itemgetter(1),
            value_extractor=operator.itemgetter(2))
        params = pdp.AggregateParams(
            metrics=[pdp.Metrics.COUNT],
            noise_kind=pdp.NoiseKind(kind),
            max_partitions_contributed=2,
            max_contributions_per_partition=1)
        for backend in (pdp.LocalBackend(),
                        pdp.TorchBackend("cpu", rng_seed=3)):
            noise_ops.seed_host_rng(0)
            acc = PLDBudgetAccountant(
                total_epsilon=20.0, total_delta=1e-6)
            engine = pdp.DPEngine(acc, backend)
            result = engine.aggregate(data, params, ex)
            acc.compute_budgets()
            out = dict(result)
            assert sorted(out) == ["a", "b"]
            for v in out.values():
                assert v.count == pytest.approx(200, rel=0.15)

    def test_gaussian_equivalent_roundtrip(self):
        from pipelinedp_tpu_torch.ops import noise as noise_ops
        acc = PLDBudgetAccountant(total_epsilon=3.0,
                                                    total_delta=1e-6)
        spec = acc.request_budget(MechanismType.GAUSSIAN)
        acc.compute_budgets()
        granted = spec.noise_standard_deviation
        recomputed = noise_ops.gaussian_sigma(spec.eps, spec.delta, 1.0)
        assert recomputed == pytest.approx(granted, rel=1e-6)

    def test_laplace_equivalent_roundtrip(self):
        acc = PLDBudgetAccountant(total_epsilon=3.0,
                                                    total_delta=1e-6)
        spec = acc.request_budget(MechanismType.LAPLACE)
        acc.compute_budgets()
        # b = sens/eps; std = b*sqrt(2) must equal the granted std.
        import math
        assert (math.sqrt(2.0) / spec.eps == pytest.approx(
            spec.noise_standard_deviation, rel=1e-9))
        assert spec.delta == 0.0

    def test_pld_beats_naive_composition(self):
        # Many Gaussian mechanisms: PLD composition grants less noise per
        # mechanism than the naive equal split.
        from pipelinedp_tpu_torch.ops import noise as noise_ops
        n_mech = 16
        acc = PLDBudgetAccountant(total_epsilon=2.0,
                                                    total_delta=1e-6)
        specs = [acc.request_budget(MechanismType.GAUSSIAN)
                 for _ in range(n_mech)]
        acc.compute_budgets()
        pld_std = specs[0].noise_standard_deviation
        naive_std = noise_ops.gaussian_sigma(2.0 / n_mech,
                                             1e-6 / n_mech, 1.0)
        assert pld_std < naive_std

    @pytest.mark.parametrize("metrics,extra", [
        (["MEAN"], {}),
        (["VARIANCE", "COUNT"], {}),
        (["PERCENTILE(50)", "PERCENTILE(90)"], {}),
    ])
    def test_multi_mechanism_metrics_end_to_end(self, metrics, extra):
        # MEAN/VARIANCE/PERCENTILE split their budget into several internal
        # mechanisms; the accountant composes them via
        # request_budget(internal_splits=k) — every metric now runs under
        # PLD accounting (the reference's PLD accountant runs none,
        # reference budget_accounting.py:406).
        import operator
        import pipelinedp_tpu_torch as pdp
        from pipelinedp_tpu_torch.ops import noise as noise_ops

        def parse(name):
            if name.startswith("PERCENTILE"):
                return pdp.Metrics.PERCENTILE(int(name[11:-1]))
            return getattr(pdp.Metrics, name)

        data = [(u, p, float(u % 10)) for u in range(300)
                for p in ("a", "b")]
        ex = pdp.DataExtractors(
            privacy_id_extractor=operator.itemgetter(0),
            partition_extractor=operator.itemgetter(1),
            value_extractor=operator.itemgetter(2))
        params = pdp.AggregateParams(
            metrics=[parse(m) for m in metrics],
            noise_kind=pdp.NoiseKind.LAPLACE,
            max_partitions_contributed=2,
            max_contributions_per_partition=1,
            min_value=0.0, max_value=10.0, **extra)
        for backend in (pdp.LocalBackend(),
                        pdp.TorchBackend("cpu", rng_seed=3)):
            noise_ops.seed_host_rng(0)
            acc = PLDBudgetAccountant(total_epsilon=30.0,
                                      total_delta=1e-6)
            engine = pdp.DPEngine(acc, backend)
            result = engine.aggregate(data, params, ex)
            acc.compute_budgets()
            out = dict(result)
            assert sorted(out) == ["a", "b"]
            for v in out.values():
                if "MEAN" in metrics:
                    assert v.mean == pytest.approx(4.5, abs=1.5)
                if "VARIANCE" in metrics:
                    assert v.count == pytest.approx(300, rel=0.2)
                if metrics[0].startswith("PERCENTILE"):
                    assert 2.0 <= v.percentile_50 <= 7.0

    def test_vector_sum_under_pld(self):
        import operator
        import pipelinedp_tpu_torch as pdp
        data = [(u, "a", [1.0, 2.0, 3.0]) for u in range(300)]
        ex = pdp.DataExtractors(
            privacy_id_extractor=operator.itemgetter(0),
            partition_extractor=operator.itemgetter(1),
            value_extractor=operator.itemgetter(2))
        params = pdp.AggregateParams(
            metrics=[pdp.Metrics.VECTOR_SUM],
            noise_kind=pdp.NoiseKind.GAUSSIAN,
            max_partitions_contributed=1,
            max_contributions_per_partition=1,
            vector_size=3, vector_max_norm=2000.0,
            vector_norm_kind=pdp.NormKind.L2)
        acc = PLDBudgetAccountant(total_epsilon=30.0, total_delta=1e-4)
        engine = pdp.DPEngine(acc, pdp.LocalBackend())
        result = engine.aggregate(data, params, ex)
        acc.compute_budgets()
        out = dict(result)
        assert np.allclose(out["a"], [300.0, 600.0, 900.0], rtol=0.25)

    @pytest.mark.parametrize("kind", ["laplace", "gaussian"])
    def test_split_composition_certificate(self, kind):
        # The composition that actually runs (the combiner's even split of
        # each published budget, re-calibrated per sub-mechanism) must
        # satisfy the pipeline's total (eps, delta) when convolved — the
        # certificate the internal_splits machinery exists to preserve.
        import math

        from pipelinedp_tpu_torch import pld as pld_lib
        from pipelinedp_tpu_torch.ops import noise as noise_ops

        total_eps, total_delta = 2.0, 1e-6
        acc = PLDBudgetAccountant(total_epsilon=total_eps,
                                  total_delta=total_delta)
        mech = (MechanismType.LAPLACE if kind == "laplace" else
                MechanismType.GAUSSIAN)
        spec_var = acc.request_budget(mech, internal_splits=3)
        spec_sel = acc.request_budget(MechanismType.GENERIC)
        acc.compute_budgets()

        plds = []
        eps_m = spec_var.eps / 3
        delta_m = spec_var.delta / 3
        if kind == "laplace":
            sub = pld_lib.laplace_pld(parameter=1.0 / eps_m,
                                      sensitivity=1.0)
        else:
            sigma = noise_ops.gaussian_sigma(eps_m, delta_m, 1.0)
            sub = pld_lib.gaussian_pld(standard_deviation=sigma,
                                       sensitivity=1.0)
        plds.append(sub.self_compose(3))
        plds.append(pld_lib.pure_dp_pld(spec_sel.eps, spec_sel.delta))
        composed = pld_lib.compose_all(plds)
        # Bisection tolerance (1e-3 relative on the noise std) is the only
        # slack between the searched noise level and the published
        # equivalents.
        assert composed.delta_for_epsilon(total_eps) <= total_delta * 1.05
        # And the published split budget is genuinely cheaper than what a
        # naive accountant would have granted the same pipeline.
        if kind == "gaussian":
            naive_sigma = noise_ops.gaussian_sigma(
                total_eps / 4, total_delta / 4, 1.0)
            granted_sigma = noise_ops.gaussian_sigma(eps_m, delta_m, 1.0)
            assert granted_sigma < naive_sigma * 1.6


# ---------------------------------------------------------------------------
# The port against the JAX package, bit for bit
# ---------------------------------------------------------------------------

import operator  # noqa: E402

import pipelinedp_tpu as jpdp  # noqa: E402
from pipelinedp_tpu import budget_accounting as jba  # noqa: E402
from pipelinedp_tpu import jax_engine as je  # noqa: E402
from pipelinedp_tpu import pld as jpld  # noqa: E402
from pipelinedp_tpu.backends import JaxBackend  # noqa: E402
from pipelinedp_tpu.ops import noise as jnoise  # noqa: E402

import pipelinedp_tpu_torch as pdt  # noqa: E402
from pipelinedp_tpu_torch import budget_accounting as tba  # noqa: E402
from pipelinedp_tpu_torch import convert  # noqa: E402
from pipelinedp_tpu_torch.ops import noise as tnoise  # noqa: E402

L, G, X = "LAPLACE", "GAUSSIAN", "GENERIC"

#: (mechanisms as (type, sensitivity, weight), total eps, total delta,
#: discretization).
MIXES = {
    "laplace3_generic": ([(L, 1.0, 1.0)] * 3 + [(X, 1.0, 1.0)], 1.0, 1e-6,
                         1e-3),
    "gaussian4": ([(G, 1.0, 1.0)] * 4, 1.0, 1e-6, 1e-4),
    "split_mix": ([(L, 2.0, 1 / 3)] * 3 + [(G, 1.0, 0.5)] * 2 +
                  [(X, 1.0, 1.0)], 2.0, 1e-5, 1e-3),
    "weighted": ([(G, 1.0, 1.0), (G, 1.0, 3.0), (L, 0.5, 2.0)], 1.0, 1e-6,
                 1e-3),
    "coarsened_grid": ([(L, 1.0, 1.0)] * 2, 3000.0, 1e-6, 1e-3),
}


def _mechs(pkg_mechanism_type, mix):
    return [(pkg_mechanism_type[t], s, w) for t, s, w in mix]


@pytest.mark.parametrize("name", sorted(MIXES))
def test_find_minimum_noise_std_bit_equal(name):
    mix, eps, delta, h = MIXES[name]
    want = jpld.find_minimum_noise_std(
        _mechs(jpdp.MechanismType, mix), eps, delta, discretization=h)
    got = pld.find_minimum_noise_std(
        _mechs(pdt.MechanismType, mix), eps, delta, discretization=h)
    assert np.float64(got).tobytes() == np.float64(want).tobytes()


def _same_pld(a, b):
    assert a.discretization == b.discretization
    assert a.lowest_index == b.lowest_index
    assert np.float64(a.infinity_mass).tobytes() == np.float64(
        b.infinity_mass).tobytes()
    assert a.probs.dtype == b.probs.dtype
    assert a.probs.tobytes() == b.probs.tobytes()
    for eps in (0.0, 0.3, 1.0, 2.5):
        assert a.delta_for_epsilon(eps) == b.delta_for_epsilon(eps)


PLD_BUILDS = {
    "laplace": lambda m: m.laplace_pld(0.7, 1.5, 1e-3),
    "gaussian": lambda m: m.gaussian_pld(1.3, 2.0, 1e-3),
    "pure_dp": lambda m: m.pure_dp_pld(0.9, 1e-4, 1e-3),
    "compose": lambda m: m.laplace_pld(0.7, 1.5, 1e-3).compose(
        m.gaussian_pld(1.3, 2.0, 1e-3)),
    "self_compose": lambda m: m.gaussian_pld(2.0, 1.0, 1e-3).self_compose(5),
    "compose_all": lambda m: m.compose_all(
        [m.laplace_pld(1.0), m.pure_dp_pld(0.5, 1e-5),
         m.gaussian_pld(3.0)]),
}


@pytest.mark.parametrize("name", sorted(PLD_BUILDS))
def test_discrete_pld_arrays_equal(name):
    _same_pld(PLD_BUILDS[name](pld), PLD_BUILDS[name](jpld))


#: (registrations as (type, sensitivity, weight, internal_splits), eps,
#: delta, discretization, scope weight or None).
ACCOUNTANT_CASES = {
    "laplace_gaussian": ([(L, 1.0, 1.0, 1), (G, 2.0, 1.0, 1)], 1.0, 1e-6,
                         1e-3, None),
    "generic_split_laplace": ([(X, 1.0, 1.0, 1), (L, 1.0, 1.0, 3)], 1.0,
                              1e-6, 1e-3, None),
    "gaussian_split_generic": ([(G, 1.5, 2.0, 2), (X, 1.0, 0.5, 1)], 2.0,
                               1e-5, 1e-3, None),
    "pure_dp_closed_form": ([(L, 1.0, 1.0, 1), (L, 3.0, 3.0, 2)], 2.0, 0.0,
                            1e-4, None),
    "scoped": ([(G, 1.0, 1.0, 1), (L, 2.0, 1.0, 1)], 1.0, 1e-6, 1e-3, 0.5),
}


def _register(pkg, registrations, eps, delta, h, scope):
    acc = pkg.PLDBudgetAccountant(total_epsilon=eps, total_delta=delta,
                                  pld_discretization=h)
    specs = []

    def request():
        for t, s, w, k in registrations:
            specs.append(acc.request_budget(pkg.MechanismType[t],
                                            sensitivity=s, weight=w,
                                            internal_splits=k))

    if scope is None:
        request()
    else:
        with acc.scope(weight=scope):
            request()
    acc.compute_budgets()
    return acc, specs


def _bits(x):
    return np.float64(x).tobytes()


@pytest.mark.parametrize("name", sorted(ACCOUNTANT_CASES))
def test_accountant_specs_bit_equal(name):
    case = ACCOUNTANT_CASES[name]
    jacc, jspecs = _register(jba, *case)
    tacc, tspecs = _register(tba, *case)
    assert _bits(tacc.minimum_noise_std) == _bits(jacc.minimum_noise_std)
    for j, t in zip(jspecs, tspecs):
        assert _bits(t.eps) == _bits(j.eps)
        assert _bits(t.delta) == _bits(j.delta)
        assert _bits(t.noise_standard_deviation) == _bits(
            j.noise_standard_deviation)


def _pld_data(seed, n=6000, users=2000, parts=150):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.2, n) % parts).astype(np.int64)
    values = rng.random(n) * 10.0
    return pid, pk, values


FM = jpdp.Metrics
ENGINE_CASES = {
    "count_sum_mean_laplace": (jpdp.AggregateParams(
        metrics=[FM.COUNT, FM.SUM, FM.MEAN], max_partitions_contributed=3,
        max_contributions_per_partition=2, min_value=0.0, max_value=10.0,
        noise_kind=jpdp.NoiseKind.LAPLACE), None),
    "variance_pid_count_gaussian": (jpdp.AggregateParams(
        metrics=[FM.VARIANCE, FM.PRIVACY_ID_COUNT],
        max_partitions_contributed=2, max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0,
        noise_kind=jpdp.NoiseKind.GAUSSIAN), None),
    "per_partition_sum_public": (jpdp.AggregateParams(
        metrics=[FM.SUM, FM.COUNT], max_partitions_contributed=3,
        max_contributions_per_partition=2, min_sum_per_partition=-5.0,
        max_sum_per_partition=15.0), list(range(60)) + [900]),
}


def _released_bits(rows):
    return [(k, tuple(_bits(x) for x in v)) for k, v in rows]


@pytest.mark.parametrize("name", sorted(ENGINE_CASES))
def test_fused_aggregate_under_pld_bit_identical(name):
    params, public = ENGINE_CASES[name]
    pid, pk, values = _pld_data(len(name))
    jacc = jba.PLDBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    jres = jpdp.DPEngine(jacc, JaxBackend(rng_seed=17)).aggregate(
        je.ArrayDataset(pid, pk, values), params, jpdp.DataExtractors(),
        public_partitions=public)
    jacc.compute_budgets()
    want = list(jres)
    tacc = pdt.PLDBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    tres = pdt.DPEngine(tacc, pdt.TorchBackend("cpu", rng_seed=17)).aggregate(
        convert.dataset_from_arrays(pid, pk, values),
        convert.params_from_reference(params), pdt.DataExtractors(),
        public_partitions=public)
    tacc.compute_budgets()
    got = list(tres)
    assert len(want) > 0
    assert _bits(tacc.minimum_noise_std) == _bits(jacc.minimum_noise_std)
    assert [v._fields for _, v in got] == [v._fields for _, v in want]
    assert _released_bits(got) == _released_bits(want)


@pytest.mark.parametrize("kind", ["LAPLACE", "GAUSSIAN"])
def test_local_backend_under_pld_bit_identical(kind):
    pid, pk, values = _pld_data(4, n=800, users=300, parts=6)
    rows = list(zip(pid.tolist(), pk.tolist(), values.tolist()))
    getters = dict(privacy_id_extractor=operator.itemgetter(0),
                   partition_extractor=operator.itemgetter(1),
                   value_extractor=operator.itemgetter(2))
    params = jpdp.AggregateParams(
        metrics=[FM.COUNT, FM.SUM, FM.MEAN, FM.PRIVACY_ID_COUNT],
        max_partitions_contributed=2, max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0, noise_kind=jpdp.NoiseKind[kind])
    out = []
    for pkg, noise, p in ((jpdp, jnoise, params),
                          (pdt, tnoise, convert.params_from_reference(
                              params))):
        noise.seed_host_rng(23)
        acc = pkg.PLDBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
        res = pkg.DPEngine(acc, pkg.LocalBackend()).aggregate(
            rows, p, pkg.DataExtractors(**getters))
        acc.compute_budgets()
        out.append((acc.minimum_noise_std, sorted(res)))
    (jstd, want), (tstd, got) = out
    assert len(want) > 0
    assert _bits(tstd) == _bits(jstd)
    assert _released_bits(got) == _released_bits(want)
