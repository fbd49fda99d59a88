"""The fluent private-collection API and the peeker on the port
(``pipelinedp_tpu_torch.private_collection``, ``pipelinedp_tpu_torch.peeker``)
against the JAX package's, on the CPU.

Every case of ``tests/test_private_apis.py``, run once on each package
under one ``seed_host_rng`` seed. Both packages draw host randomness from
a module-global ``np.random.default_rng`` in the same order, so each case
checks its own expectation on the port's result and then that the port's
released values equal the JAX package's bit for bit (float64 bits, no
tolerance). The case on ``JaxBackend`` runs on ``TorchBackend("cpu")``,
where fusable params take the fused path.
"""

import operator

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu import peeker as jpeeker
from pipelinedp_tpu.backends import JaxBackend
from pipelinedp_tpu.ops import noise as jnoise

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import peeker
from pipelinedp_tpu_torch import private_collection
from pipelinedp_tpu_torch.ops import noise as tnoise

BIG_EPS = 1e5

PACKAGES = {
    "jax": (pdp, jpeeker, jnoise),
    "torch": (pdt, peeker, tnoise),
}


def movie_rows(n_users=40):
    # (user, movie, rating)
    return [(u, m, 4.0) for u in range(n_users) for m in ("m1", "m2")]


def extractors(mod):
    return mod.DataExtractors(privacy_id_extractor=operator.itemgetter(0),
                              partition_extractor=operator.itemgetter(1),
                              value_extractor=operator.itemgetter(2))


def _same(a, b):
    """Exact equality, floats by their float64 bits."""
    if isinstance(a, (float, np.floating)):
        assert np.float64(a).tobytes() == np.float64(b).tobytes(), (a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), (a, b)
        if hasattr(a, "_fields"):
            assert a._fields == b._fields
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert sorted(a, key=repr) == sorted(b, key=repr), (a, b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b, (a, b)


def _both(case, seed=0):
    """Runs ``case(mod, peeker_mod)`` on each package after seeding its
    host RNG with ``seed``; returns (port result, JAX result)."""
    out = {}
    for name, (mod, peek_mod, noise) in PACKAGES.items():
        noise.seed_host_rng(seed)
        out[name] = case(mod, peek_mod)
    return out["torch"], out["jax"]


class TestPrivateCollection:

    @staticmethod
    def _private(mod, backend=None, eps=BIG_EPS):
        backend = backend or mod.LocalBackend()
        acc = mod.NaiveBudgetAccountant(total_epsilon=eps,
                                        total_delta=1e-10)
        pcol = mod.make_private(movie_rows(), backend, acc,
                                operator.itemgetter(0))
        return pcol, acc

    def test_count(self):
        def case(mod, _):
            pcol, acc = self._private(mod)
            result = pcol.count(
                mod.CountParams(max_partitions_contributed=2,
                                max_contributions_per_partition=1,
                                partition_extractor=operator.itemgetter(1)))
            acc.compute_budgets()
            return dict(result)

        got, want = _both(case)
        assert got["m1"] == pytest.approx(40, abs=0.5)
        _same(got, want)

    def test_sum_and_mean(self):
        def case(mod, _):
            pcol, acc = self._private(mod)
            s = pcol.sum(
                mod.SumParams(max_partitions_contributed=2,
                              max_contributions_per_partition=1,
                              min_value=0.0, max_value=5.0,
                              partition_extractor=operator.itemgetter(1),
                              value_extractor=operator.itemgetter(2)))
            m = pcol.mean(
                mod.MeanParams(max_partitions_contributed=2,
                               max_contributions_per_partition=1,
                               min_value=0.0, max_value=5.0,
                               partition_extractor=operator.itemgetter(1),
                               value_extractor=operator.itemgetter(2)))
            acc.compute_budgets()
            return dict(s), dict(m)

        got, want = _both(case)
        assert got[0]["m1"] == pytest.approx(160.0, rel=0.01)
        assert got[1]["m2"] == pytest.approx(4.0, abs=0.05)
        _same(got, want)

    def test_privacy_id_count(self):
        def case(mod, _):
            pcol, acc = self._private(mod)
            result = pcol.privacy_id_count(
                mod.PrivacyIdCountParams(
                    max_partitions_contributed=2,
                    partition_extractor=operator.itemgetter(1)))
            acc.compute_budgets()
            return dict(result)

        got, want = _both(case)
        assert got["m1"] == pytest.approx(40, abs=0.5)
        _same(got, want)

    def test_variance(self):
        def case(mod, _):
            acc = mod.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                            total_delta=1e-10)
            data = [(u, "m", 2.0) for u in range(100)] + [
                (u, "m", 8.0) for u in range(100, 200)
            ]
            pcol = mod.make_private(data, mod.LocalBackend(), acc,
                                    operator.itemgetter(0))
            result = pcol.variance(
                mod.VarianceParams(
                    max_partitions_contributed=1,
                    max_contributions_per_partition=1,
                    min_value=0.0, max_value=10.0,
                    partition_extractor=operator.itemgetter(1),
                    value_extractor=operator.itemgetter(2)))
            acc.compute_budgets()
            return dict(result)

        got, want = _both(case)
        assert got["m"] == pytest.approx(9.0, abs=0.3)
        _same(got, want)

    def test_map_flat_map(self):
        def case(mod, _):
            pcol, acc = self._private(mod)
            doubled = pcol.map(lambda row: (row[0], row[1], row[2] * 2))
            result = doubled.sum(
                mod.SumParams(max_partitions_contributed=2,
                              max_contributions_per_partition=1,
                              min_value=0.0, max_value=10.0,
                              partition_extractor=operator.itemgetter(1),
                              value_extractor=operator.itemgetter(2)))
            # flat_map keeps each row's privacy id on every output row.
            tripled = pcol.flat_map(lambda row: [row, row, row])
            count = tripled.count(
                mod.CountParams(max_partitions_contributed=2,
                                max_contributions_per_partition=3,
                                partition_extractor=operator.itemgetter(1)))
            acc.compute_budgets()
            return dict(result), dict(count)

        got, want = _both(case)
        assert got[0]["m1"] == pytest.approx(320.0, rel=0.01)
        assert got[1]["m2"] == pytest.approx(120.0, abs=1.0)
        _same(got, want)

    def test_select_partitions(self):
        def case(mod, _):
            acc = mod.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            data = ([(u, "big", 1.0) for u in range(1000)] +
                    [(1, "small", 1.0)])
            pcol = mod.make_private(data, mod.LocalBackend(), acc,
                                    operator.itemgetter(0))
            result = pcol.select_partitions(
                mod.SelectPartitionsParams(max_partitions_contributed=1),
                partition_extractor=operator.itemgetter(1))
            acc.compute_budgets()
            return list(result)

        got, want = _both(case)
        assert "big" in got and "small" not in got
        _same(got, want)

    def test_on_jax_backend(self):
        """``JaxBackend`` of the JAX package and ``TorchBackend("cpu")`` of
        the port: fusable params take each package's fused path."""
        def case(mod, _):
            backend = (pdt.TorchBackend("cpu", rng_seed=0) if mod is pdt
                       else JaxBackend(rng_seed=0))
            pcol, acc = self._private(mod, backend=backend)
            result = pcol.count(
                mod.CountParams(max_partitions_contributed=2,
                                max_contributions_per_partition=1,
                                partition_extractor=operator.itemgetter(1)))
            acc.compute_budgets()
            return dict(result)

        got, want = _both(case)
        assert got["m1"] == pytest.approx(40, abs=0.5)
        _same(got, want)

    def test_fusable_params_take_the_fused_path(self, monkeypatch):
        from pipelinedp_tpu_torch import torch_engine
        built = []
        real = torch_engine.build_fused_aggregation

        def spy(*args, **kwargs):
            built.append(kwargs.get("device"))
            return real(*args, **kwargs)

        monkeypatch.setattr(torch_engine, "build_fused_aggregation", spy)
        tnoise.seed_host_rng(0)
        pcol, acc = self._private(pdt,
                                  backend=pdt.TorchBackend("cpu",
                                                           rng_seed=0))
        result = pcol.count(
            pdt.CountParams(max_partitions_contributed=2,
                            max_contributions_per_partition=1,
                            partition_extractor=operator.itemgetter(1)))
        acc.compute_budgets()
        assert dict(result)["m1"] == pytest.approx(40, abs=0.5)
        assert [str(d) for d in built] == ["cpu"]

    def test_bounds_already_enforced(self):
        def case(mod, _):
            acc = mod.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                            total_delta=1e-10)
            pcol = mod.make_private(movie_rows(), mod.LocalBackend(), acc,
                                    None)
            result = pcol.count(
                mod.CountParams(max_partitions_contributed=2,
                                max_contributions_per_partition=1,
                                partition_extractor=operator.itemgetter(1),
                                contribution_bounds_already_enforced=True))
            acc.compute_budgets()
            return dict(result)

        got, want = _both(case)
        # Rows are bare (pid, pk, value) tuples: every one counts.
        assert got["m1"] == pytest.approx(40, abs=0.5)
        _same(got, want)

    def test_make_private_returns_the_class(self):
        acc = pdt.NaiveBudgetAccountant(1.0, 1e-6)
        pcol = pdt.make_private([], pdt.LocalBackend(), acc, None)
        assert isinstance(pcol, private_collection.PrivateCollection)
        assert pdt.PrivateCollection is private_collection.PrivateCollection


class TestDataPeeker:

    def test_sample_keeps_n_partitions(self):
        def case(mod, peek_mod):
            data = [(u, f"p{p}", 1.0) for u in range(20) for p in range(10)]
            pk = peek_mod.DataPeeker(mod.LocalBackend())
            params = peek_mod.SampleParams(number_of_sampled_partitions=3)
            return list(pk.sample(data, params, extractors(mod)))

        got, want = _both(case)
        assert len({pk for _, pk, _ in got}) == 3
        assert all(len(row) == 3 for row in got)
        _same(got, want)

    def test_sketch_count(self):
        def case(mod, peek_mod):
            data = [(u, "a", 1.0) for u in range(10) for _ in range(3)]
            pk = peek_mod.DataPeeker(mod.LocalBackend())
            params = peek_mod.SampleParams(number_of_sampled_partitions=5,
                                           metrics=[mod.Metrics.COUNT])
            return list(pk.sketch(data, params, extractors(mod)))

        got, want = _both(case)
        # One sketch row per (pk, pid): 10 rows, each count 3, pcount 1.
        assert len(got) == 10
        for pk_, value, pcount in got:
            assert (pk_, value, pcount) == ("a", 3, 1)
        _same(got, want)

    def test_sketch_sum_over_sampled_partitions(self):
        def case(mod, peek_mod):
            data = [(u, f"p{u % 7}", 0.5 * u) for u in range(70)]
            pk = peek_mod.DataPeeker(mod.LocalBackend())
            params = peek_mod.SampleParams(number_of_sampled_partitions=3,
                                           metrics=[mod.Metrics.SUM])
            return list(pk.sketch(data, params, extractors(mod)))

        got, want = _both(case, seed=4)
        assert len({pk for pk, _, _ in got}) == 3
        _same(got, want)

    def test_aggregate_true(self):
        def case(mod, peek_mod):
            data = [(u, "a", 2.0) for u in range(10)]
            pk = peek_mod.DataPeeker(mod.LocalBackend())
            params = peek_mod.SampleParams(
                number_of_sampled_partitions=5,
                metrics=[mod.Metrics.SUM, mod.Metrics.MEAN,
                         mod.Metrics.VARIANCE, mod.Metrics.COUNT,
                         mod.Metrics.PRIVACY_ID_COUNT])
            return dict(pk.aggregate_true(data, params, extractors(mod)))

        got, want = _both(case)
        assert got["a"] == (20.0, 2.0, 0.0, 10, 1)
        _same(got, want)

    def test_raw_combiners_bit_equal(self):
        from pipelinedp_tpu.peeker import non_private_combiners as jnpc
        from pipelinedp_tpu_torch.peeker import non_private_combiners as tnpc
        values = np.random.default_rng(0).uniform(-3, 9, 37).tolist()
        for metric in ("COUNT", "PRIVACY_ID_COUNT", "SUM", "MEAN",
                       "VARIANCE"):
            t = tnpc.create_compound_combiner([getattr(pdt.Metrics,
                                                       metric)])
            j = jnpc.create_compound_combiner([getattr(pdp.Metrics,
                                                       metric)])
            ta = t.merge_accumulators(t.create_accumulator(values[:20]),
                                      t.create_accumulator(values[20:]))
            ja = j.merge_accumulators(j.create_accumulator(values[:20]),
                                      j.create_accumulator(values[20:]))
            _same(t.compute_metrics(ta), j.compute_metrics(ja))
            assert t.metrics_names() == j.metrics_names()
            assert t.explain_computation() == j.explain_computation()
        with pytest.raises(ValueError, match="unsupported"):
            tnpc.create_compound_combiner([pdt.Metrics.PERCENTILE(50)])


class TestPeekerEngine:

    def test_aggregate_sketches_count(self):
        def case(mod, peek_mod):
            # Sketches: (pk, per-user count, partition_count)
            sketches = [("a", 2, 1)] * 500 + [("b", 5, 3)] * 200
            acc = mod.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                            total_delta=1e-6)
            engine = peek_mod.PeekerEngine(acc, mod.LocalBackend())
            params = mod.AggregateParams(metrics=[mod.Metrics.COUNT],
                                         max_partitions_contributed=1,
                                         max_contributions_per_partition=2)
            result = engine.aggregate_sketches(sketches, params)
            acc.compute_budgets()
            return dict(result)

        got, want = _both(case)
        assert got["a"].count == pytest.approx(1000, rel=0.01)
        _same(got, want)

    def test_aggregate_sketches_checks_metrics(self):
        acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        engine = peeker.PeekerEngine(acc, pdt.LocalBackend())
        params = pdt.AggregateParams(metrics=[pdt.Metrics.MEAN],
                                     max_partitions_contributed=1,
                                     max_contributions_per_partition=2,
                                     min_value=0.0, max_value=1.0)
        with pytest.raises(ValueError, match="COUNT or SUM"):
            engine.aggregate_sketches([], params)

    def test_aggregate_sketch_true(self):
        def case(mod, peek_mod):
            sketches = [("a", 5.0, 1), ("a", 3.0, 2), ("b", 1.0, 1)]
            return (dict(peek_mod.aggregate_sketch_true(
                mod.LocalBackend(), sketches, mod.Metrics.SUM)),
                    dict(peek_mod.aggregate_sketch_true(
                        mod.LocalBackend(), sketches, mod.Metrics.COUNT)))

        got, want = _both(case)
        assert got[0] == {"a": 8.0, "b": 1.0}
        assert got[1] == {"a": 2, "b": 1}
        _same(got, want)
        with pytest.raises(ValueError, match="sum or count"):
            peeker.aggregate_sketch_true(pdt.LocalBackend(), [],
                                         pdt.Metrics.MEAN)
