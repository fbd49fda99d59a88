"""The port's host combiners (``pipelinedp_tpu_torch.combiners``) and host
``QuantileTree`` (``ops/quantile_tree.py``) against the JAX package's, on
the CPU, bit for bit.

Each combiner is built in both packages from the same params and the same
(eps, delta); the same values go through ``create_accumulator``,
``merge_accumulators`` and ``compute_metrics``, with one ``seed_host_rng``
seed in both. Accumulators, released values, metric names and the
explained computation must be identical. The cases follow
``tests/test_combiners.py``: each scalar combiner, the quantile tree,
VECTOR_SUM in each norm, the compound combiner and its factory (including
custom combiners), at a small eps so the noise shows in every bit.
"""

import pickle

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu import budget_accounting as jba
from pipelinedp_tpu import combiners as jc
from pipelinedp_tpu.ops import noise as jnoise
from pipelinedp_tpu.ops import quantile_tree as jqt

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import budget_accounting as tba
from pipelinedp_tpu_torch import combiners as tc
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch.ops import noise as tnoise
from pipelinedp_tpu_torch.ops import quantile_tree as tqt

M = pdp.Metrics
SIDES = ((pdp, jc, jba, jnoise), (pdt, tc, tba, tnoise))


def _bits(x):
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_bits(v) for v in x)
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, (float, np.floating)):
        return ("f", np.float64(x).view(np.uint64).item())
    return x


def _agg(pkg, metrics, **kw):
    base = dict(max_partitions_contributed=2,
                max_contributions_per_partition=3, min_value=0.0,
                max_value=10.0)
    base.update(kw)
    p = pdp.AggregateParams(metrics=metrics, **base)
    return p if pkg is pdp else convert.params_from_reference(p)


def _combiner_params(pkg, combiners, ba, agg, eps=0.7, delta=1e-5,
                     mech="LAPLACE"):
    mech_type = getattr(pkg.aggregate_params.MechanismType, mech)
    spec = ba.MechanismSpec(mech_type, _eps=eps, _delta=delta)
    return combiners.CombinerParams(spec, agg)


def _values(seed, n=40, hi=12.0):
    return (np.random.default_rng(seed).random(n) * hi - 1.0).tolist()


def _drive(make, chunks, seed=5):
    """(accumulators, merged, metrics, names, explanation) of ``make()``'s
    combiner in each package under one host seed."""
    out = []
    for pkg, combiners, ba, noise in SIDES:
        c = make(pkg, combiners, ba)
        noise.seed_host_rng(seed)
        accs = [c.create_accumulator(ch) for ch in chunks]
        merged = accs[0]
        for a in accs[1:]:
            merged = c.merge_accumulators(merged, a)
        metrics = c.compute_metrics(merged)
        explain = c.explain_computation()
        explain = explain() if callable(explain) else explain
        out.append((_bits(accs), _bits(merged), _bits(metrics),
                    c.metrics_names(), explain))
    return out


SCALAR = {
    "count": lambda pkg, combiners, ba: combiners.CountCombiner(
        _combiner_params(pkg, combiners, ba, _agg(pkg, [M.COUNT]))),
    "privacy_id_count": lambda pkg, combiners, ba:
        combiners.PrivacyIdCountCombiner(_combiner_params(
            pkg, combiners, ba, _agg(pkg, [M.PRIVACY_ID_COUNT]))),
    "sum": lambda pkg, combiners, ba: combiners.SumCombiner(
        _combiner_params(pkg, combiners, ba, _agg(pkg, [M.SUM]))),
    "sum_per_partition": lambda pkg, combiners, ba: combiners.SumCombiner(
        _combiner_params(pkg, combiners, ba, _agg(
            pkg, [M.SUM], min_value=None, max_value=None,
            min_sum_per_partition=-2.0, max_sum_per_partition=15.0))),
    "sum_gaussian": lambda pkg, combiners, ba: combiners.SumCombiner(
        _combiner_params(pkg, combiners, ba, _agg(
            pkg, [M.SUM], noise_kind=pkg.NoiseKind.GAUSSIAN),
            mech="GAUSSIAN")),
    "mean": lambda pkg, combiners, ba: combiners.MeanCombiner(
        _combiner_params(pkg, combiners, ba, _agg(
            pkg, [M.MEAN, M.COUNT, M.SUM])), ["mean", "count", "sum"]),
    "variance": lambda pkg, combiners, ba: combiners.VarianceCombiner(
        _combiner_params(pkg, combiners, ba, _agg(
            pkg, [M.VARIANCE, M.MEAN])), ["variance", "mean"]),
    "variance_gaussian_total_cap": lambda pkg, combiners, ba:
        combiners.VarianceCombiner(_combiner_params(pkg, combiners, ba, _agg(
            pkg, [M.VARIANCE, M.COUNT, M.SUM, M.MEAN],
            max_partitions_contributed=None,
            max_contributions_per_partition=None, max_contributions=4,
            noise_kind=pkg.NoiseKind.GAUSSIAN), mech="GAUSSIAN"),
            ["variance", "count", "sum", "mean"]),
    "percentiles": lambda pkg, combiners, ba: combiners.QuantileCombiner(
        _combiner_params(pkg, combiners, ba, _agg(
            pkg, [M.PERCENTILE(50), M.PERCENTILE(90), M.PERCENTILE(12.5)])),
        [50, 90, 12.5]),
    "percentiles_gaussian": lambda pkg, combiners, ba:
        combiners.QuantileCombiner(_combiner_params(pkg, combiners, ba, _agg(
            pkg, [M.PERCENTILE(1), M.PERCENTILE(99)],
            noise_kind=pkg.NoiseKind.GAUSSIAN), mech="GAUSSIAN"), [1, 99]),
}


@pytest.mark.parametrize("case", sorted(SCALAR))
@pytest.mark.parametrize("chunks", [1, 3])
def test_combiner_bit_equal(case, chunks):
    values = [_values(s) for s in range(chunks)] + [[]]
    j, t = _drive(SCALAR[case], values)
    assert j == t


@pytest.mark.parametrize("kind", ["Linf", "L1", "L2"])
@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_vector_sum_bit_equal(kind, noise):

    def make(pkg, combiners, ba):
        return combiners.VectorSumCombiner(_combiner_params(
            pkg, combiners, ba, _agg(
                pkg, [M.VECTOR_SUM], min_value=None, max_value=None,
                vector_size=3, vector_max_norm=2.5,
                vector_norm_kind=getattr(pkg.NormKind, kind),
                noise_kind=getattr(pkg.NoiseKind, noise)), mech=noise))

    rng = np.random.default_rng(3)
    chunks = [[rng.normal(size=3) for _ in range(4)] for _ in range(3)]
    j, t = _drive(make, chunks)
    assert j == t


def test_vector_sum_shape_mismatch_raises_alike():
    errors = []
    for pkg, combiners, ba, _ in SIDES:
        c = combiners.VectorSumCombiner(_combiner_params(
            pkg, combiners, ba, _agg(pkg, [M.VECTOR_SUM], min_value=None,
                                     max_value=None, vector_size=2,
                                     vector_max_norm=1.0)))
        with pytest.raises(TypeError) as err:
            c.create_accumulator([np.array([1.0, 2.0, 3.0])])
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_mean_and_variance_reject_bad_metric_lists_alike():
    for metrics in (["count"], ["mean", "mean"], ["mean", "median"]):
        errors = []
        for pkg, combiners, ba, _ in SIDES:
            with pytest.raises(ValueError) as err:
                combiners.MeanCombiner(_combiner_params(
                    pkg, combiners, ba, _agg(pkg, [M.MEAN])), metrics)
            errors.append(str(err.value))
        assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# The compound combiner and its factories
# ---------------------------------------------------------------------------

FACTORY_CASES = {
    "count_sum": [M.COUNT, M.SUM],
    "mean_folds_count_sum": [M.MEAN, M.COUNT, M.SUM],
    "variance_folds_all": [M.VARIANCE, M.MEAN, M.COUNT, M.SUM,
                           M.PRIVACY_ID_COUNT],
    "percentiles_and_count": [M.PERCENTILE(50), M.PERCENTILE(75), M.COUNT],
    "privacy_id_count": [M.PRIVACY_ID_COUNT],
}


def _compound(pkg, combiners, ba, metrics, eps=2.0, **kw):
    acc = ba.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    compound = combiners.create_compound_combiner(_agg(pkg, metrics, **kw),
                                                  acc)
    acc.compute_budgets()
    specs = [(m.mechanism_spec.eps, m.mechanism_spec.delta,
              m.internal_splits, m.mechanism_spec.metric)
             for m in acc._mechanisms]
    return compound, specs


@pytest.mark.parametrize("case", sorted(FACTORY_CASES))
def test_compound_factory_bit_equal(case):
    out = []
    for pkg, combiners, ba, noise in SIDES:
        compound, specs = _compound(pkg, combiners, ba, FACTORY_CASES[case])
        noise.seed_host_rng(13)
        accs = [compound.create_accumulator(_values(s, n=7))
                for s in range(4)]
        merged = accs[0]
        for a in accs[1:]:
            merged = compound.merge_accumulators(merged, a)
        metrics = compound.compute_metrics(merged)
        out.append((_bits(specs), [type(c).__name__
                                   for c in compound.combiners],
                    _bits(merged), metrics._fields, _bits(tuple(metrics)),
                    compound.metrics_names(),
                    [e() for e in compound.explain_computation()]))
    assert out[0] == out[1]
    assert out[1][2][0] == 4  # the row count: one per create


def test_compound_metrics_tuple_pickles():
    compound, _ = _compound(pdt, tc, tba, [M.COUNT, M.SUM])
    out = compound.compute_metrics(compound.create_accumulator([1.0]))
    back = pickle.loads(pickle.dumps(out))
    assert back == out and back._fields == ("count", "sum")


def test_compound_without_named_tuple_bit_equal():
    out = []
    for pkg, combiners, ba, noise in SIDES:
        compound = combiners.CompoundCombiner([], return_named_tuple=False)
        acc = compound.create_accumulator([])
        acc = compound.merge_accumulators(acc, compound.create_accumulator(
            [1.0]))
        out.append((acc, compound.compute_metrics(acc)))
    assert out[0] == out[1] == ((2, ()), ())


def test_duplicate_metrics_rejected_alike():
    errors = []
    for pkg, combiners, ba, _ in SIDES:
        count = combiners.CountCombiner(_combiner_params(
            pkg, combiners, ba, _agg(pkg, [M.COUNT])))
        with pytest.raises(ValueError) as err:
            combiners.CompoundCombiner([count, count],
                                       return_named_tuple=True)
        errors.append(type(err.value))
    assert errors[0] is errors[1]


def test_custom_combiners_factory_bit_equal():
    out = []
    for pkg, combiners, ba, noise in SIDES:

        class Noisy(combiners.CustomCombiner):
            _noise = noise
            _gaussian = pkg.aggregate_params.MechanismType.GAUSSIAN

            def request_budget(self, budget_accountant):
                self._spec = budget_accountant.request_budget(
                    self._gaussian)

            def create_accumulator(self, values):
                return float(np.sum(values))

            def merge_accumulators(self, a, b):
                return a + b

            def compute_metrics(self, acc):
                return acc + self._noise.np_gaussian(1.0 / self._spec.eps)

            def explain_computation(self):
                return lambda: "noisy sum"

        acc = ba.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        params = pkg.AggregateParams(max_partitions_contributed=1,
                                     max_contributions_per_partition=1,
                                     custom_combiners=[Noisy(), Noisy()])
        compound = combiners.create_compound_combiner_with_custom_combiners(
            params, acc, params.custom_combiners)
        acc.compute_budgets()
        noise.seed_host_rng(2)
        merged = compound.merge_accumulators(
            compound.create_accumulator([1.0, 2.0]),
            compound.create_accumulator([4.0]))
        out.append((_bits(merged), _bits(compound.compute_metrics(merged)),
                    compound.combiners[0].metrics_names(),
                    compound.combiners[1]._aggregate_params is params))
    assert out[0] == out[1]
    assert out[1][2] == ["Noisy"] and out[1][3]


# ---------------------------------------------------------------------------
# The host QuantileTree
# ---------------------------------------------------------------------------


def _tree(mod, values, lower=-1.0, upper=11.0, height=4, branching=16):
    tree = mod.QuantileTree(lower, upper, height, branching)
    for v in values:
        tree.add_entry(v)
    return tree


@pytest.mark.parametrize("noise_kind", ["laplace", "gaussian"])
@pytest.mark.parametrize("shape", [(4, 16), (3, 4), (2, 10)])
def test_quantile_tree_bit_equal(noise_kind, shape):
    height, branching = shape
    values = _values(7, n=300)
    j = _tree(jqt, values[:150], height=height, branching=branching)
    t = _tree(tqt, values[:150], height=height, branching=branching)
    assert j.serialize() == t.serialize()
    j.merge(_tree(jqt, values[150:], height=height,
                  branching=branching).serialize())
    t.merge(_tree(tqt, values[150:], height=height, branching=branching))
    np.testing.assert_array_equal(j.to_dense(), t.to_dense())
    qs = [0.0, 0.1, 0.5, 0.5, 0.9, 0.99, 1.0]
    jnoise.seed_host_rng(4)
    want = j.compute_quantiles(0.8, 1e-5, 2, 3, qs, noise_kind)
    tnoise.seed_host_rng(4)
    got = t.compute_quantiles(0.8, 1e-5, 2, 3, qs, noise_kind)
    assert _bits(got) == _bits(want)
    assert got == sorted(got)


def test_quantile_tree_dense_round_trip_and_helpers():
    values = np.asarray(_values(9, n=200))
    t = _tree(tqt, values)
    dense = t.to_dense()
    assert dense.shape == (t.num_dense_nodes(),)
    back = tqt.QuantileTree.from_dense(dense, -1.0, 11.0)
    np.testing.assert_array_equal(back.to_dense(), dense)
    assert back._counts == t._counts
    assert tqt.dense_level_slices() == jqt.dense_level_slices()
    assert tqt.dense_level_slices(3, 4) == jqt.dense_level_slices(3, 4)
    np.testing.assert_array_equal(
        tqt.values_to_dense_paths(values, -1.0, 11.0),
        jqt.values_to_dense_paths(values, -1.0, 11.0))
    # Each value adds one to one node per level.
    assert dense.sum() == len(values) * 4
    assert tqt.tree_constants() == jqt.tree_constants()


def test_quantile_tree_rejects_alike():
    for bad in (dict(lower=1.0, upper=1.0), dict(lower=0.0, upper=1.0,
                                                height=0)):
        errors = []
        for mod in (jqt, tqt):
            with pytest.raises(ValueError) as err:
                mod.QuantileTree(**bad)
            errors.append(str(err.value))
        assert errors[0] == errors[1]
    a = _tree(tqt, [1.0], lower=0.0, upper=2.0)
    with pytest.raises(ValueError, match="different shapes"):
        a.merge(_tree(tqt, [1.0], lower=0.0, upper=3.0))
    with pytest.raises(ValueError, match="outside"):
        a.compute_quantiles(1.0, 0.0, 1, 1, [1.5])
