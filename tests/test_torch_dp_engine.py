"""The port's generic host path (``pipelinedp_tpu_torch.dp_engine`` on
``LocalBackend``, and ``TorchBackend``'s fallback to it) against the JAX
package's, on the CPU, bit for bit.

Both packages draw host randomness (noise, the quantile tree's node noise,
the bounding samples, partition selection) from a module-global
``np.random.default_rng``. So with one ``seed_host_rng`` seed in both, the
same rows and the same params release the same float64 values, in the same
order: every comparison here is exact. The cases follow
``tests/test_dp_engine.py`` and ``tests/test_dp_engine_graph.py``: each
scalar metric, PERCENTILE, VECTOR_SUM, public and private partitions, each
selection strategy, bounds already enforced, ``max_contributions``,
``select_partitions``, custom combiners, the graph's nodes, the rebind and
clear seams and the structured explain report. On ``TorchBackend`` the
route is the JAX package's: fusable params give the fused path's lazy
result, the rest the host graph.
"""

import dataclasses
import operator
from unittest import mock

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu.backends import JaxBackend
from pipelinedp_tpu.ops import noise as jnoise

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import dp_engine as tdp_engine
from pipelinedp_tpu_torch import pipeline_backend as tpb
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.ops import noise as tnoise

M = pdp.Metrics
PSS = pdp.PartitionSelectionStrategy
NK = pdp.NoiseKind


def _same(a, b, where="release"):
    """Exact equality: floats by their float64 bits, containers and
    dataclasses field by field, namedtuples with their field names."""
    if isinstance(a, (float, np.floating)):
        assert isinstance(b, (float, np.floating)), (where, a, b)
        assert (np.float64(a).view(np.uint64) ==
                np.float64(b).view(np.uint64)), (where, a, b)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, where
        assert a.shape == b.shape and a.tobytes() == b.tobytes(), where
    elif isinstance(a, tuple) and hasattr(a, "_fields"):
        assert a._fields == b._fields, (where, a._fields, b._fields)
        for f, x, y in zip(a._fields, a, b):
            _same(x, y, f"{where}.{f}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), (where, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
    elif dataclasses.is_dataclass(a) and not isinstance(a, type):
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name),
                  f"{where}.{f.name}")
    else:
        assert a == b, (where, a, b)


def _rows(seed=0, n=600, users=120, parts=("a", "b", "c", "d", "e"),
          hi=10.0):
    rng = np.random.default_rng(seed)
    pks = rng.integers(0, len(parts), n)
    return list(zip(rng.integers(0, users, n).tolist(),
                    [parts[i] for i in pks],
                    (rng.random(n) * hi).tolist()))


def _extractors(pkg, pid=True):
    return pkg.DataExtractors(
        privacy_id_extractor=operator.itemgetter(0) if pid else None,
        partition_extractor=operator.itemgetter(1 if pid else 0),
        value_extractor=operator.itemgetter(2 if pid else 1))


def _params(pkg, **kw):
    """``pkg``'s AggregateParams (the port's through ``convert``)."""
    p = pdp.AggregateParams(**kw)
    return p if pkg is pdp else convert.params_from_reference(p)


def _release(pkg, backend, rows, params_kw, public=None, seed=0, eps=5.0,
             delta=1e-4, pid=True, method="aggregate"):
    (jnoise if pkg is pdp else tnoise).seed_host_rng(seed)
    acc = pkg.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = pkg.DPEngine(acc, backend)
    if method == "aggregate":
        result = engine.aggregate(rows, _params(pkg, **params_kw),
                                  _extractors(pkg, pid),
                                  public_partitions=public)
    else:
        p = pdp.SelectPartitionsParams(**params_kw)
        if pkg is pdt:
            p = convert.params_from_reference(p)
        result = engine.select_partitions(
            rows, p, pkg.DataExtractors(
                privacy_id_extractor=operator.itemgetter(0),
                partition_extractor=operator.itemgetter(1)))
    acc.compute_budgets()
    return list(result), engine, result


def _both_local(rows, params_kw, **kw):
    j, _, _ = _release(pdp, pdp.LocalBackend(), rows, params_kw, **kw)
    t, _, _ = _release(pdt, pdt.LocalBackend(), rows, params_kw, **kw)
    _same(j, t)
    return t


BASE = dict(max_partitions_contributed=3, max_contributions_per_partition=2)
VALUE = dict(BASE, min_value=0.0, max_value=10.0)

AGGREGATE_CASES = {
    "count": (dict(BASE, metrics=[M.COUNT]), {}),
    "count_big_eps": (dict(BASE, metrics=[M.COUNT]), dict(eps=1e5)),
    "privacy_id_count": (dict(BASE, metrics=[M.PRIVACY_ID_COUNT]), {}),
    "sum": (dict(VALUE, metrics=[M.SUM]), {}),
    "count_sum_mean": (dict(VALUE, metrics=[M.COUNT, M.SUM, M.MEAN]), {}),
    "variance_all": (dict(VALUE, metrics=[M.VARIANCE, M.MEAN, M.COUNT,
                                          M.SUM, M.PRIVACY_ID_COUNT]), {}),
    "percentiles": (dict(VALUE, metrics=[M.PERCENTILE(50), M.PERCENTILE(90),
                                         M.PERCENTILE(99.5)]), {}),
    "percentile_gaussian_count": (
        dict(VALUE, metrics=[M.COUNT, M.PERCENTILE(10)],
             noise_kind=NK.GAUSSIAN), {}),
    "gaussian_sum_mean": (dict(VALUE, metrics=[M.SUM, M.MEAN],
                               noise_kind=NK.GAUSSIAN), {}),
    "sum_per_partition_bounds": (
        dict(BASE, metrics=[M.COUNT, M.SUM], min_sum_per_partition=-1.0,
             max_sum_per_partition=12.0), {}),
    "vector_sum": (dict(BASE, metrics=[M.VECTOR_SUM], vector_size=2,
                        vector_max_norm=5.0), {}),
    "public": (dict(BASE, metrics=[M.COUNT, M.SUM], min_value=0.0,
                    max_value=10.0), dict(public=["a", "c", "zz"])),
    "public_already_filtered": (
        dict(BASE, metrics=[M.COUNT], public_partitions_already_filtered=True),
        dict(public=["a", "b", "c", "d", "e", "yy"])),
    "laplace_thresholding": (
        dict(BASE, metrics=[M.COUNT],
             partition_selection_strategy=PSS.LAPLACE_THRESHOLDING), {}),
    "gaussian_thresholding": (
        dict(BASE, metrics=[M.COUNT],
             partition_selection_strategy=PSS.GAUSSIAN_THRESHOLDING), {}),
    "pre_threshold": (dict(BASE, metrics=[M.COUNT], pre_threshold=20), {}),
    "l0_1_linf_1": (dict(metrics=[M.COUNT, M.PRIVACY_ID_COUNT],
                         max_partitions_contributed=1,
                         max_contributions_per_partition=1), {}),
    "max_contributions": (dict(metrics=[M.COUNT, M.SUM, M.PRIVACY_ID_COUNT],
                               max_contributions=4, min_value=0.0,
                               max_value=10.0), {}),
    "max_contributions_percentile": (
        dict(metrics=[M.PERCENTILE(50), M.COUNT], max_contributions=3,
             min_value=0.0, max_value=10.0), {}),
    "tiny_percentile_range": (
        dict(BASE, metrics=[M.COUNT, M.PERCENTILE(50)], min_value=0.0,
             max_value=1e-35), {}),
}


@pytest.mark.parametrize("case", sorted(AGGREGATE_CASES))
def test_local_aggregate_bit_equal(case):
    params_kw, kw = AGGREGATE_CASES[case]
    rows = _rows(seed=len(case))
    if case == "vector_sum":
        rows = [(u, k, np.array([v / 2.0, -v])) for u, k, v in rows]
    t = _both_local(rows, params_kw, **kw)
    assert len(t) > 0, case


def test_local_bounds_already_enforced_bit_equal():
    rows = [(k, v) for _, k, v in _rows(seed=4)]
    t = _both_local(rows, dict(BASE, metrics=[M.COUNT, M.SUM],
                               min_value=0.0, max_value=10.0,
                               contribution_bounds_already_enforced=True),
                    pid=False)
    assert len(t) == 5


@pytest.mark.parametrize("strategy", list(PSS), ids=lambda s: s.name)
def test_local_select_partitions_bit_equal(strategy):
    rows = [(u, k) for u, k, _ in _rows(seed=9, n=900, users=300)]
    rows += [(1000 + i, f"tiny{i}") for i in range(20)]
    kw = dict(max_partitions_contributed=2,
              partition_selection_strategy=strategy)
    j, _, _ = _release(pdp, pdp.LocalBackend(), rows, kw, method="select",
                       eps=1.0, delta=1e-5)
    t, _, _ = _release(pdt, pdt.LocalBackend(), rows, kw, method="select",
                       eps=1.0, delta=1e-5)
    _same(j, t)
    assert set("abcde") <= set(t)


def test_select_partitions_route_does_not_depend_on_device():
    """``select_partitions`` on ``TorchBackend`` always takes the fused
    path, as on ``JaxBackend``; on ``LocalBackend`` the host graph."""
    rows = [(u, k) for u, k, _ in _rows(seed=2)]
    kw = dict(max_partitions_contributed=2)
    kept_fused, _, fused = _release(pdt, pdt.TorchBackend("cpu", rng_seed=0),
                                    rows, kw, method="select")
    kept_host, _, host = _release(pdt, pdt.LocalBackend(), rows, kw,
                                  method="select")
    assert kept_fused and kept_host
    assert isinstance(fused, te.LazySelectResult)
    assert not isinstance(host, te.LazySelectResult)


def _custom_combiner_classes():
    """A noisy-count custom combiner for each package (each subclasses
    its own package's ``CustomCombiner``), drawing from its host RNG."""
    out = {}
    for pkg, noise in ((pdp, jnoise), (pdt, tnoise)):

        class NoisyCount(pkg.combiners.CustomCombiner):
            _noise = noise
            _laplace = pkg.aggregate_params.MechanismType.LAPLACE

            def request_budget(self, budget_accountant):
                self._spec = budget_accountant.request_budget(self._laplace)

            def create_accumulator(self, values):
                return len(list(values))

            def merge_accumulators(self, a, b):
                return a + b

            def compute_metrics(self, acc):
                return acc + self._noise.np_laplace(2.0 / self._spec.eps)

            def metrics_names(self):
                return ["noisy_count"]

            def explain_computation(self):
                return lambda: f"noisy count (eps={self._spec.eps})"

        out[pkg] = NoisyCount
    return out


def _custom_release(pkg, backend, rows, public=None):
    jnoise.seed_host_rng(21)
    tnoise.seed_host_rng(21)
    acc = pkg.NaiveBudgetAccountant(total_epsilon=5.0, total_delta=1e-4)
    engine = pkg.DPEngine(acc, backend)
    custom = _custom_combiner_classes()[pkg]()
    params = pkg.AggregateParams(max_partitions_contributed=2,
                                 max_contributions_per_partition=2,
                                 custom_combiners=[custom])
    result = engine.aggregate(rows, params, _extractors(pkg),
                              public_partitions=public)
    acc.compute_budgets()
    return result, list(result), engine


@pytest.mark.parametrize("public", [None, ["a", "b", "zz"]],
                         ids=["private", "public"])
def test_custom_combiners_bit_equal(public):
    rows = _rows(seed=6)
    _, j, jeng = _custom_release(pdp, pdp.LocalBackend(), rows, public)
    _, t, teng = _custom_release(pdt, pdt.LocalBackend(), rows, public)
    _same(j, t)
    assert len(t) > 0 and isinstance(t[0][1], tuple)
    _same(jeng.explain_computations_report(),
          teng.explain_computations_report())


# ---------------------------------------------------------------------------
# TorchBackend: the JAX package's route, bit for bit with JaxBackend
# ---------------------------------------------------------------------------


def test_torch_backend_is_a_local_backend():
    assert issubclass(pdt.TorchBackend, pdt.LocalBackend)
    assert issubclass(JaxBackend, pdp.LocalBackend)


@pytest.mark.parametrize("params_kw", [
    dict(VALUE, metrics=[M.COUNT, M.SUM, M.MEAN]),
    dict(VALUE, metrics=[M.VARIANCE, M.PERCENTILE(50)]),
    dict(BASE, metrics=[M.COUNT], min_sum_per_partition=0.0,
         max_sum_per_partition=5.0),
], ids=["flagship", "percentile", "sum_bounds_count"])
def test_fusable_params_give_lazy_fused_result(params_kw):
    """Fusable params never take the host path on ``TorchBackend``."""
    assert te.params_are_fusable(_params(pdt, **params_kw))
    _, _, result = _release(pdt, pdt.TorchBackend("cpu", rng_seed=0),
                            _rows(seed=1), params_kw)
    assert isinstance(result, te.LazyFusedResult)


def test_tiny_clip_range_falls_back_bit_equal_to_jax_backend():
    """A percentile range under about 1.9e-34 overflows the fused leaf
    constant: both packages run it on the host path, to the same bits."""
    kw = dict(BASE, metrics=[M.COUNT, M.PERCENTILE(50)], min_value=0.0,
              max_value=1e-35)
    rows = [(u, "ab"[u % 2], 0.5e-35) for u in range(300)]
    j, _, jres = _release(pdp, JaxBackend(rng_seed=29), rows, kw)
    t, _, tres = _release(pdt, pdt.TorchBackend("cpu", rng_seed=29), rows,
                          kw)
    assert not isinstance(tres, te.LazyFusedResult)
    _same(j, t)
    assert len(t) == 2 and all(0.0 <= m.percentile_50 <= 1e-35
                               for _, m in t)


def test_custom_combiners_fall_back_bit_equal_to_jax_backend():
    rows = _rows(seed=7)
    jres, j, _ = _custom_release(pdp, JaxBackend(rng_seed=3), rows)
    tres, t, _ = _custom_release(pdt, pdt.TorchBackend("cpu", rng_seed=3),
                                 rows)
    assert not isinstance(tres, te.LazyFusedResult)
    _same(j, t)
    assert len(t) > 0


def test_sum_per_partition_percentile_falls_back_like_jax_backend():
    """PERCENTILE under per-partition sum bounds (no per-value range) is
    not fusable; the host path's quantile tree has no bounds and raises
    the same error in both packages."""
    kw = dict(BASE, metrics=[M.SUM, M.PERCENTILE(50)],
              min_sum_per_partition=0.0, max_sum_per_partition=10.0)
    assert not te.params_are_fusable(_params(pdt, **kw))
    errors = []
    for pkg, backend in ((pdp, JaxBackend(rng_seed=0)),
                         (pdt, pdt.TorchBackend("cpu", rng_seed=0))):
        with pytest.raises(TypeError) as err:
            _release(pkg, backend, _rows(seed=3), kw)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_array_dataset_on_host_path_bit_equal():
    """An ``ArrayDataset`` on the host path expands to row tuples
    (``to_rows``) in both packages."""
    rng = np.random.default_rng(12)
    pid, pk = rng.integers(0, 80, 500), rng.integers(0, 6, 500)
    val = rng.random(500) * 10
    kw = dict(VALUE, metrics=[M.COUNT, M.SUM, M.PERCENTILE(50)])
    jnoise.seed_host_rng(4)
    acc = pdp.NaiveBudgetAccountant(5.0, 1e-4)
    j = pdp.DPEngine(acc, pdp.LocalBackend()).aggregate(
        pdp.ArrayDataset(pid, pk, val), _params(pdp, **kw),
        pdp.DataExtractors())
    acc.compute_budgets()
    j = list(j)
    tnoise.seed_host_rng(4)
    acc = pdt.NaiveBudgetAccountant(5.0, 1e-4)
    t = pdt.DPEngine(acc, pdt.LocalBackend()).aggregate(
        convert.dataset_from_arrays(pid, pk, val), _params(pdt, **kw),
        pdt.DataExtractors())
    acc.compute_budgets()
    t = list(t)
    _same(j, t)
    assert convert.dataset_from_arrays(pid, pk, val).to_rows() == \
        pdp.ArrayDataset(pid, pk, val).to_rows()


# ---------------------------------------------------------------------------
# The engine's seams, validation and reports
# ---------------------------------------------------------------------------


class TestSeams:

    def test_rebind_refuses_in_flight_then_swaps(self):
        for pkg in (pdp, pdt):
            acc = pkg.NaiveBudgetAccountant(1.0, 1e-6)
            engine = pkg.DPEngine(acc, pkg.LocalBackend())
            engine.aggregate(_rows(), _params(pkg, **dict(
                BASE, metrics=[M.COUNT])), _extractors(pkg))
            fresh = pkg.NaiveBudgetAccountant(2.0, 1e-6)
            with pytest.raises(RuntimeError, match="cannot rebind"):
                engine.rebind_budget_accountant(fresh)
            acc.compute_budgets()
            engine.rebind_budget_accountant(fresh, reset_reports=False)
            assert engine._budget_accountant is fresh
            assert len(engine.explain_computations_report()) == 1
            engine.rebind_budget_accountant(
                pkg.NaiveBudgetAccountant(3.0, 1e-6))
            assert engine.explain_computations_report() == []

    def test_clear_then_rebind(self):
        for pkg in (pdp, pdt):
            (jnoise if pkg is pdp else tnoise).seed_host_rng(0)
            acc = pkg.NaiveBudgetAccountant(5.0, 1e-4)
            engine = pkg.DPEngine(acc, pkg.LocalBackend())
            engine.aggregate(_rows(), _params(pkg, **dict(
                BASE, metrics=[M.COUNT])), _extractors(pkg))
            engine.clear_budget_accountant()
            assert engine._budget_accountant is None
            fresh = pkg.NaiveBudgetAccountant(5.0, 1e-4)
            engine.rebind_budget_accountant(fresh)
            result = engine.aggregate(_rows(), _params(pkg, **dict(
                BASE, metrics=[M.COUNT])), _extractors(pkg))
            fresh.compute_budgets()
            assert len(list(result)) > 0

    def test_rebound_engine_releases_bit_equal(self):
        """A warm engine rebound to a fresh accountant releases what a new
        engine would, in both packages."""
        out = []
        for pkg, backend in ((pdp, JaxBackend(rng_seed=1)),
                             (pdt, pdt.TorchBackend("cpu", rng_seed=1))):
            acc = pkg.NaiveBudgetAccountant(5.0, 1e-4)
            engine = pkg.DPEngine(acc, backend)
            kw = dict(BASE, metrics=[M.COUNT, M.PERCENTILE(50)],
                      min_value=0.0, max_value=1e-35)
            engine.aggregate(_rows(), _params(pkg, **kw), _extractors(pkg))
            acc.compute_budgets()
            fresh = pkg.NaiveBudgetAccountant(5.0, 1e-4)
            engine.rebind_budget_accountant(fresh)
            (jnoise if pkg is pdp else tnoise).seed_host_rng(8)
            result = engine.aggregate(_rows(seed=3), _params(pkg, **kw),
                                      _extractors(pkg))
            fresh.compute_budgets()
            out.append(list(result))
        _same(*out)


def test_explain_computations_structured_equal():
    reports = []
    for pkg in (pdp, pdt):
        acc = pkg.NaiveBudgetAccountant(total_epsilon=5.0, total_delta=1e-4)
        engine = pkg.DPEngine(acc, pkg.LocalBackend())
        engine.aggregate(_rows(), _params(pkg, **dict(
            VALUE, metrics=[M.COUNT, M.SUM, M.PERCENTILE(50)])),
            _extractors(pkg))
        engine.select_partitions(
            [(u, k) for u, k, _ in _rows()],
            pkg.SelectPartitionsParams(max_partitions_contributed=1),
            _extractors(pkg))
        acc.compute_budgets()
        reports.append((engine.explain_computations_structured(),
                        engine.explain_computations_report()))
    assert reports[0] == reports[1]
    structured = reports[1][0]
    assert [r["method"] for r in structured] == ["aggregate",
                                                  "select_partitions"]
    assert any("Private Partition selection" in str(s)
               for s in structured[0]["stages"])


class TestValidation:
    """``tests/test_dp_engine.py::TestValidation`` and the engine's checks,
    the same error in both packages."""

    @pytest.mark.parametrize("call", [
        "empty_col", "none_params", "wrong_params", "no_extractors",
        "wrong_extractors", "pid_with_enforced", "pid_count_enforced",
        "custom_with_max_contributions", "vector_sum_max_contributions",
        "sketch_first"])
    def test_same_error(self, call):
        errors = []
        for pkg in (pdp, pdt):
            engine = pkg.DPEngine(pkg.NaiveBudgetAccountant(1.0, 1e-6),
                                  pkg.LocalBackend())
            ex = _extractors(pkg)
            count = _params(pkg, **dict(BASE, metrics=[M.COUNT]))
            args = {
                "empty_col": lambda: ([], count, ex),
                "none_params": lambda: (_rows(), None, ex),
                "wrong_params": lambda: (_rows(), object(), ex),
                "no_extractors": lambda: (_rows(), count, None),
                "wrong_extractors": lambda: (_rows(), count, object()),
                "pid_with_enforced": lambda: (_rows(), _params(pkg, **dict(
                    BASE, metrics=[M.COUNT],
                    contribution_bounds_already_enforced=True)), ex),
                "pid_count_enforced": lambda: (_rows(), _params(pkg, **dict(
                    BASE, metrics=[M.PRIVACY_ID_COUNT],
                    contribution_bounds_already_enforced=True)),
                    _extractors(pkg, pid=False)),
                "vector_sum_max_contributions": lambda: (_rows(), _params(
                    pkg, metrics=[M.VECTOR_SUM], max_contributions=2,
                    vector_size=2, vector_max_norm=1.0), ex),
            }.get(call)
            with pytest.raises(Exception) as err:
                if call == "custom_with_max_contributions":
                    custom = _custom_combiner_classes()[pkg]()
                    engine.aggregate(_rows(), pkg.AggregateParams(
                        max_contributions=2, custom_combiners=[custom]), ex)
                elif call == "sketch_first":
                    engine.aggregate(_rows(), count, ex,
                                     sketch_first=object())
                else:
                    engine.aggregate(*args())
            errors.append(err)
        if call == "sketch_first":
            # The same check; each message names its own package's
            # SketchParams.
            assert errors[1].type is errors[0].type is TypeError
            assert str(errors[1].value) == str(errors[0].value).replace(
                "pipelinedp_tpu.", "pipelinedp_tpu_torch.")
            return
        assert errors[0].type is errors[1].type, call
        assert str(errors[0].value) == str(errors[1].value), call

    @pytest.mark.parametrize("params", [None, "wrong", 0, "no_extractors"])
    def test_select_partitions_same_error(self, params):
        errors = []
        for pkg in (pdp, pdt):
            engine = pkg.DPEngine(pkg.NaiveBudgetAccountant(1.0, 1e-6),
                                  pkg.LocalBackend())
            ex = None if params == "no_extractors" else _extractors(pkg)
            p = {None: None, "wrong": object(),
                 0: mock.Mock(spec=pkg.SelectPartitionsParams,
                              max_partitions_contributed=0),
                 "no_extractors": pkg.SelectPartitionsParams(
                     max_partitions_contributed=1)}[params]
            with pytest.raises(Exception) as err:
                engine.select_partitions(_rows(), p, ex)
            errors.append(err)
        assert errors[0].type is errors[1].type
        assert str(errors[0].value) == str(errors[1].value)


# ---------------------------------------------------------------------------
# Graph shape (``tests/test_dp_engine_graph.py`` on the port)
# ---------------------------------------------------------------------------


def _graph_data(n_users=10, n_parts=4, rows_per=3):
    return [(u, p, 1.0) for u in range(n_users) for p in range(n_parts)
            for _ in range(rows_per)]


def _count(**kw):
    return _params(pdt, **dict(dict(metrics=[M.COUNT],
                                    max_partitions_contributed=4,
                                    max_contributions_per_partition=4), **kw))


def _engine(eps=1e5, delta=1e-2):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    return pdt.DPEngine(acc, pdt.LocalBackend()), acc


class TestGraphShape:

    def test_bounder_receives_graph_arguments(self):
        engine, acc = _engine()
        params = _count()
        bounder = mock.MagicMock()
        bounder.bound_contributions.return_value = []
        with mock.patch.object(pdt.DPEngine, "_create_contribution_bounder",
                               return_value=bounder):
            engine.aggregate(_graph_data(), params, _extractors(pdt))
        acc.compute_budgets()
        args = bounder.bound_contributions.call_args[0]
        assert list(args[0]) == [(u, p, 1.0) for (u, p, _) in _graph_data()]
        assert args[1] is params
        assert isinstance(args[2], pdt.LocalBackend)
        assert callable(args[4])

    def test_bounder_choice_depends_on_params(self):
        from pipelinedp_tpu_torch import contribution_bounders as cb
        engine, _ = _engine()
        assert isinstance(
            engine._create_contribution_bounder(_count()),
            cb.SamplingCrossAndPerPartitionContributionBounder)
        assert isinstance(
            engine._create_contribution_bounder(_count(
                max_contributions=4, max_partitions_contributed=None,
                max_contributions_per_partition=None)),
            cb.SamplingPerPrivacyIdContributionBounder)

    def test_public_partitions_drop_node_built(self):
        engine, acc = _engine()
        original = pdt.DPEngine._drop_not_public_partitions
        with mock.patch.object(pdt.DPEngine, "_drop_not_public_partitions",
                               side_effect=original, autospec=True) as drop:
            out = engine.aggregate(_graph_data(), _count(), _extractors(pdt),
                                   public_partitions=[0, 1, 99])
            acc.compute_budgets()
            result = dict(out)
        assert drop.call_count == 1
        assert sorted(result) == [0, 1, 99]

    def test_public_partitions_already_filtered_skips_drop(self):
        engine, acc = _engine()
        with mock.patch.object(pdt.DPEngine,
                               "_drop_not_public_partitions") as drop:
            out = engine.aggregate(
                _graph_data(), _count(public_partitions_already_filtered=True),
                _extractors(pdt), public_partitions=[0, 1, 2, 3])
            acc.compute_budgets()
            list(out)
        drop.assert_not_called()

    def test_mock_selection_strategy_controls_kept_partitions(self):

        class MockStrategy:

            def should_keep(self, num_users):
                return num_users >= 8

        rows = [(u, p, 1.0) for u in range(10) for p in range(3)]
        rows += [(u, 3, 1.0) for u in range(5)]
        engine, acc = _engine()
        with mock.patch.object(tdp_engine,
                               "_cached_partition_selection_strategy",
                               return_value=MockStrategy()):
            out = engine.aggregate(rows, _count(), _extractors(pdt))
            acc.compute_budgets()
            result = dict(out)
        assert sorted(result) == [0, 1, 2]

    def test_custom_combiner_factory_node(self):
        from pipelinedp_tpu_torch import combiners as combiners_mod
        engine, acc = _engine()
        custom = _custom_combiner_classes()[pdt]()
        params = pdt.AggregateParams(max_partitions_contributed=2,
                                     max_contributions_per_partition=2,
                                     custom_combiners=[custom])
        with mock.patch.object(
                combiners_mod,
                "create_compound_combiner_with_custom_combiners",
                side_effect=combiners_mod.
                create_compound_combiner_with_custom_combiners) as factory:
            out = engine.aggregate(_graph_data(), params, _extractors(pdt))
            acc.compute_budgets()
            list(out)
        assert factory.call_count == 1
        assert factory.call_args[0][2] == [custom]

    def test_annotators_receive_per_aggregation_budget(self):
        seen = []

        class Recorder(tpb.Annotator):

            def annotate(self, col, params=None, budget=None):
                seen.append((params, budget))
                return col

        rec = Recorder()
        tpb.register_annotator(rec)
        try:
            acc = pdt.NaiveBudgetAccountant(total_epsilon=3.0,
                                            total_delta=3e-6,
                                            aggregation_weights=[1, 2])
            # TorchBackend is a LocalBackend: its annotate runs the
            # registered annotators too.
            engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=0))
            p1, p2 = _count(budget_weight=1), _count(budget_weight=2)
            r1 = engine.aggregate(_graph_data(), p1, _extractors(pdt))
            r2 = engine.aggregate(_graph_data(), p2, _extractors(pdt))
            acc.compute_budgets()
            list(r1), list(r2)
        finally:
            tpb._annotators.remove(rec)
        (params1, b1), (params2, b2) = seen
        assert params1 is p1 and params2 is p2
        assert b1.epsilon == pytest.approx(1.0)
        assert b2.epsilon == pytest.approx(2.0)
        assert b1.delta == pytest.approx(1e-6)
        assert b2.delta == pytest.approx(2e-6)

    def test_selection_budget_requested_only_for_private(self):
        engine, acc = _engine()
        engine.aggregate(_graph_data(), _count(), _extractors(pdt),
                         public_partitions=[0, 1])
        engine2, acc2 = _engine()
        engine2.aggregate(_graph_data(), _count(), _extractors(pdt))
        assert len(acc2._mechanisms) == len(acc._mechanisms) + 1

    def test_bounds_already_enforced_skips_bounder(self):
        engine, acc = _engine()
        rows = [(0, 1.0), (0, 2.0), (1, 1.0)]
        with mock.patch.object(pdt.DPEngine,
                               "_create_contribution_bounder") as bound:
            out = engine.aggregate(
                rows, _count(contribution_bounds_already_enforced=True),
                _extractors(pdt, pid=False))
            acc.compute_budgets()
            dict(out)
        bound.assert_not_called()


# ---------------------------------------------------------------------------
# MultiProcLocalBackend end to end (one spawn pool for the module)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def multiproc(request):
    backend = pdt.MultiProcLocalBackend(n_jobs=2, chunk_size=16)
    request.addfinalizer(backend.close)
    return backend


def test_count_on_multiproc(multiproc):
    """``tests/test_dp_engine.py::TestMultiProcEndToEnd`` on the port: a
    big-eps COUNT through the spawned pool (the combiners and the
    selection filter pickle to the workers)."""
    rows = [(u, pk, 1.0) for u in range(60) for pk in ("a", "b", "c")]
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1e5, total_delta=1e-6)
    engine = pdt.DPEngine(acc, multiproc)
    result = engine.aggregate(rows, _params(pdt, **dict(
        metrics=[M.COUNT, M.SUM], max_partitions_contributed=3,
        max_contributions_per_partition=1, min_value=0.0, max_value=2.0)),
        _extractors(pdt))
    acc.compute_budgets()
    out = dict(result)
    assert set(out) == {"a", "b", "c"}
    for v in out.values():
        assert v.count == pytest.approx(60, abs=0.5)
        assert v.sum == pytest.approx(60, abs=0.5)
    assert multiproc._pool_instance is not None
