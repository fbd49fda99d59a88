"""The port's Beam and Spark adapters (``pipelinedp_tpu_torch.beam_backend``,
``SparkRDDBackend``, ``private_beam``, ``private_spark``) against the JAX
package's, on the CPU.

apache_beam and pyspark are not installed here, so the adapters run
against the lazy structural fakes ``tests/fake_beam.py`` and
``tests/fake_spark.py``, installed exactly as
``tests/test_cluster_backends.py`` installs them: the fake beam module sits
in ``sys.modules`` only while the adapters import, then the session sees
the beam-optional behavior again. The cases are those of
``tests/test_cluster_backends.py`` that run on the fakes; the op
conformance matrix that ``tests/test_torch_pipeline_backend.py`` already
runs is parametrised there over the Beam adapter, and only its
distributed ``filter_by_key`` case is here. Every release is held to the
JAX package's under one ``seed_host_rng`` seed (and one seed of Python's
``random``, which the fake Beam sampler draws from), bit for bit.
"""

import importlib
import importlib.util
import operator
import random
import sys

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu.ops import noise as jnoise

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch.ops import noise as tnoise
from tests import fake_beam
from tests.fake_spark import FakeSparkContext

HAVE_BEAM = importlib.util.find_spec("apache_beam") is not None

BIG_EPS = 1e5

_ADAPTERS = ("beam_backend", "private_beam")


def load_beam_adapters():
    """The Beam adapters of both packages, imported under the fake
    ``apache_beam``: ``(beam, {"jax": (beam_backend, private_beam),
    "torch": (beam_backend, private_beam)})``. The fake and its
    submodules leave ``sys.modules`` again, and neither package's
    ``pipeline_backend`` keeps a ``BeamBackend`` it did not have."""
    from pipelinedp_tpu import pipeline_backend as jpb
    from pipelinedp_tpu_torch import pipeline_backend as tpb
    names = ("apache_beam", "apache_beam.combiners",
             "apache_beam.transforms", "apache_beam.transforms.ptransform")
    saved = {name: sys.modules.get(name) for name in names}
    had = {pb: hasattr(pb, "BeamBackend") for pb in (jpb, tpb)}
    beam = fake_beam.build_fake_beam_module()
    out = {}
    try:
        sys.modules.update({
            "apache_beam": beam,
            "apache_beam.combiners": beam.combiners,
            "apache_beam.transforms": beam.transforms,
            "apache_beam.transforms.ptransform": beam.transforms.ptransform,
        })
        for key, pkg, pb in (("jax", "pipelinedp_tpu", jpb),
                             ("torch", "pipelinedp_tpu_torch", tpb)):
            bb = importlib.import_module(f"{pkg}.beam_backend")
            pb.BeamBackend = bb.BeamBackend  # as if beam existed at start
            out[key] = (bb, importlib.import_module(f"{pkg}.private_beam"))
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
        for pb, present in had.items():
            if not present and hasattr(pb, "BeamBackend"):
                del pb.BeamBackend
    return beam, out


beam, ADAPTERS = load_beam_adapters()
PACKAGES = {"jax": (pdp, jnoise), "torch": (pdt, tnoise)}


# ---------------------------------------------------------------------------
# Harnesses: wrap list -> native collection, collect -> list
# ---------------------------------------------------------------------------


class BeamHarness:
    name = "beam"

    def __init__(self, key="torch"):
        self.backend = ADAPTERS[key][0].BeamBackend()
        self.pipeline = beam.Pipeline()

    def col(self, data):
        return self.pipeline | f"create{id(data)}" >> beam.Create(data)

    def collect(self, col):
        return list(col)


class SparkHarness:
    name = "spark"

    def __init__(self, key="torch"):
        self.sc = FakeSparkContext()
        mod = PACKAGES[key][0]
        self.backend = mod.SparkRDDBackend(self.sc)

    def col(self, data):
        return self.sc.parallelize(data)

    def collect(self, col):
        return list(col.collect())


HARNESSES = {"beam": BeamHarness, "spark": SparkHarness}

needs_fake_beam = pytest.mark.skipif(
    HAVE_BEAM, reason="real beam installed: the fake-backed harness is "
    "not used")


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
    """``case(key)`` for each package after seeding its host RNG and
    Python's ``random`` with ``seed``: (port result, JAX result)."""
    out = {}
    for key in ("jax", "torch"):
        PACKAGES[key][1].seed_host_rng(seed)
        random.seed(seed)
        out[key] = case(key)
    return out["torch"], out["jax"]


@pytest.fixture(params=["beam", "spark"])
def harness(request):
    if request.param == "beam" and HAVE_BEAM:
        pytest.skip("real beam installed: fake-backed harness not used")
    return HARNESSES[request.param]


def test_adapters_are_the_ports():
    bb, pb = ADAPTERS["torch"]
    assert bb.__name__ == "pipelinedp_tpu_torch.beam_backend"
    assert pb.__name__ == "pipelinedp_tpu_torch.private_beam"
    assert issubclass(bb.BeamBackend, pdt.PipelineBackend)
    assert issubclass(pb.PrivateCombineFn, pdt.CustomCombiner)
    # The session sees the beam-optional behavior again.
    assert "apache_beam" not in sys.modules or HAVE_BEAM
    with pytest.raises(ImportError, match="apache_beam is required"):
        pdt.BeamBackend()


class TestClusterBackendConformance:
    """The op of tests/test_cluster_backends.py's matrix that the port's
    conformance matrix (tests/test_torch_pipeline_backend.py) has no case
    for: ``filter_by_key`` with the keys as a distributed collection."""

    def test_filter_by_key_distributed(self, harness):
        h = harness()
        keys = h.col([1, 3])
        got = h.collect(h.backend.filter_by_key(
            h.col([(1, "a"), (2, "b"), (3, "c")]), keys, "fbk2"))
        assert sorted(got) == [(1, "a"), (3, "c")]


class TestBeamStageLabels:

    @needs_fake_beam
    def test_repeated_stage_names_stay_unique(self):
        hn = BeamHarness()
        col = hn.col([1, 2, 3])
        # Same stage name twice: the UniqueLabelsGenerator must suffix
        # them apart or the (fake = real beam semantics) pipeline raises.
        a = hn.backend.map(col, lambda x: x + 1, "stage")
        b = hn.backend.map(a, lambda x: x + 1, "stage")
        assert sorted(hn.collect(b)) == [3, 4, 5]
        assert hn.backend.unique_lable_generator.unique("stage") == \
            "stage_2"

    @needs_fake_beam
    def test_duplicate_raw_label_is_refused(self):
        hn = BeamHarness()
        col = hn.col([1])
        col | "same" >> beam.Map(lambda x: x)
        with pytest.raises(RuntimeError, match="unique"):
            col | "same" >> beam.Map(lambda x: x)


class TestEngineOnClusterBackends:
    """Full DPEngine aggregation through each adapter (huge eps: results
    pin to the exact aggregates), bit-equal to the JAX package's."""

    @staticmethod
    def _run_engine(harness, key, public=None):
        mod = PACKAGES[key][0]
        h = harness(key)
        data = [(u, p, 1.0) for u in range(30) for p in ("x", "y")]
        params = mod.AggregateParams(
            metrics=[mod.Metrics.COUNT, mod.Metrics.SUM],
            max_partitions_contributed=2,
            max_contributions_per_partition=1,
            min_value=0.0, max_value=1.0)
        ex = mod.DataExtractors(
            privacy_id_extractor=operator.itemgetter(0),
            partition_extractor=operator.itemgetter(1),
            value_extractor=operator.itemgetter(2))
        acc = mod.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                        total_delta=1e-2)
        engine = mod.DPEngine(acc, h.backend)
        result = engine.aggregate(h.col(data), params, ex,
                                  public_partitions=public)
        acc.compute_budgets()
        return dict(h.collect(result))

    def test_private_partitions(self, harness):
        out, want = _both(lambda key: self._run_engine(harness, key))
        assert sorted(out) == ["x", "y"]
        for v in out.values():
            assert v.count == pytest.approx(30, abs=0.5)
            assert v.sum == pytest.approx(30, abs=0.5)
        _same(out, want)

    def test_public_partitions(self, harness):
        out, want = _both(lambda key: self._run_engine(
            harness, key, public=["x", "z"]))
        assert sorted(out) == ["x", "z"]
        assert out["x"].count == pytest.approx(30, abs=0.5)
        assert out["z"].count == pytest.approx(0, abs=0.5)
        _same(out, want)

    def test_select_partitions(self, harness):
        def case(key):
            mod = PACKAGES[key][0]
            h = harness(key)
            data = [(u, "big") for u in range(1000)] + [(1, "small")]
            ex = mod.DataExtractors(
                privacy_id_extractor=operator.itemgetter(0),
                partition_extractor=operator.itemgetter(1))
            acc = mod.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            engine = mod.DPEngine(acc, h.backend)
            result = engine.select_partitions(
                h.col(data), mod.SelectPartitionsParams(
                    max_partitions_contributed=2), ex)
            acc.compute_budgets()
            return h.collect(result)

        got, want = _both(case)
        assert "big" in got and "small" not in got
        _same(got, want)


def _private_pcol(key, data, **kw):
    """(pipeline's private collection, accountant, private_beam)."""
    mod = PACKAGES[key][0]
    private_beam = ADAPTERS[key][1]
    p = beam.Pipeline()
    pcol = p | "create" >> beam.Create(data)
    acc = mod.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                    total_delta=1e-2)
    private = pcol | private_beam.MakePrivate(
        budget_accountant=acc, privacy_id_extractor=kw.get(
            "pid", operator.itemgetter(0)))
    return private, acc, private_beam


def _sum_combine_fn(key):
    """A ``PrivateCombineFn`` subclass of ``key``'s package: a clipped sum
    plus Laplace noise from that package's host RNG."""
    mod, noise = PACKAGES[key]
    private_beam = ADAPTERS[key][1]

    class SumCombineFn(private_beam.PrivateCombineFn):

        def create_accumulator_for_private_output(self):
            return 0.0

        def add_input_for_private_output(self, acc_, v):
            return acc_ + min(v, 5.0)

        def merge_accumulators(self, a, b):
            return a + b

        def extract_private_output(self, accumulator, budget):
            return accumulator + noise.np_laplace(5.0 / budget.eps)

        def request_budget(self, budget_accountant):
            self._budget = budget_accountant.request_budget(
                mod.MechanismType.LAPLACE)

        def explain_computation(self):
            return "private sum via CombineFn"

    return SumCombineFn


@needs_fake_beam
class TestPrivateBeamOnFake:

    def test_count_flow(self):
        def case(key):
            mod = PACKAGES[key][0]
            data = ([(u, "a") for u in range(40)] +
                    [(u, "b") for u in range(100, 125)])
            private, acc, private_beam = _private_pcol(key, data)
            counts = private | private_beam.Count(
                mod.CountParams(max_partitions_contributed=1,
                                max_contributions_per_partition=1,
                                partition_extractor=operator.itemgetter(1)))
            acc.compute_budgets()
            return dict(counts)

        got, want = _both(case)
        assert got["a"] == pytest.approx(40, abs=0.5)
        assert got["b"] == pytest.approx(25, abs=0.5)
        _same(got, want)

    def test_map_then_sum(self):
        def case(key):
            mod = PACKAGES[key][0]
            data = [(u, "a", 2.0) for u in range(30)]
            private, acc, private_beam = _private_pcol(key, data)
            doubled = private | private_beam.Map(
                lambda row: (row[1], row[2] * 2))
            sums = doubled | private_beam.Sum(
                mod.SumParams(max_partitions_contributed=1,
                              max_contributions_per_partition=1,
                              min_value=0.0, max_value=10.0,
                              partition_extractor=operator.itemgetter(0),
                              value_extractor=operator.itemgetter(1)))
            acc.compute_budgets()
            return dict(sums)

        got, want = _both(case)
        assert got["a"] == pytest.approx(120, abs=1.0)
        _same(got, want)

    def test_flat_map_mean_variance_pid_count(self):
        def case(key):
            mod = PACKAGES[key][0]
            data = [(u, "a", float(u % 5)) for u in range(50)]
            private, acc, private_beam = _private_pcol(key, data)
            twice = private | private_beam.FlatMap(lambda row: [row, row])
            kw = dict(max_partitions_contributed=1,
                      max_contributions_per_partition=2,
                      min_value=0.0, max_value=5.0,
                      partition_extractor=operator.itemgetter(1),
                      value_extractor=operator.itemgetter(2))
            mean = twice | private_beam.Mean(mod.MeanParams(**kw))
            var = twice | private_beam.Variance(mod.VarianceParams(**kw))
            pids = twice | private_beam.PrivacyIdCount(
                mod.PrivacyIdCountParams(
                    max_partitions_contributed=1,
                    partition_extractor=operator.itemgetter(1)))
            acc.compute_budgets()
            return dict(mean), dict(var), dict(pids)

        got, want = _both(case)
        assert got[0]["a"] == pytest.approx(2.0, abs=0.05)
        assert got[1]["a"] == pytest.approx(2.0, abs=0.1)
        assert got[2]["a"] == pytest.approx(50, abs=0.5)
        _same(got, want)

    def test_select_partitions(self):
        def case(key):
            mod = PACKAGES[key][0]
            data = [(u, "big") for u in range(1000)] + [(1, "small")]
            p = beam.Pipeline()
            acc = mod.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            private_beam = ADAPTERS[key][1]
            private = (p | "create" >> beam.Create(data)
                       | private_beam.MakePrivate(
                           budget_accountant=acc,
                           privacy_id_extractor=operator.itemgetter(0)))
            kept = private | private_beam.SelectPartitions(
                mod.SelectPartitionsParams(max_partitions_contributed=1),
                partition_extractor=operator.itemgetter(1))
            acc.compute_budgets()
            return list(kept)

        got, want = _both(case)
        assert "big" in got and "small" not in got
        _same(got, want)

    def test_combine_per_key_with_private_combine_fn(self):
        data = [(u, ("a", 2.0)) for u in range(30)]

        def case(key):
            private, acc, private_beam = _private_pcol(
                key, data, pid=lambda row: row[0])
            # CombinePerKey consumes (key, value) elements.
            private = private | private_beam.Map(lambda row: row[1])
            out = private | private_beam.CombinePerKey(
                _sum_combine_fn(key)(),
                private_beam.CombinePerKeyParams(
                    max_partitions_contributed=1,
                    max_contributions_per_partition=1))
            acc.compute_budgets()
            return dict(out)

        got, want = _both(case)
        # Unnested: the value is the combiner's scalar, not a 1-tuple.
        assert got["a"] == pytest.approx(60, abs=1.0)
        _same(got, want)

        # AggregateParams path: the combine_fn must appear in
        # custom_combiners; a single combiner is unnested the same way.
        def case2(key):
            mod = PACKAGES[key][0]
            fn = _sum_combine_fn(key)()
            private, acc, private_beam = _private_pcol(
                key, data, pid=lambda row: row[0])
            private = private | private_beam.Map(lambda row: row[1])
            out = private | private_beam.CombinePerKey(
                fn, mod.AggregateParams(metrics=None,
                                        max_partitions_contributed=1,
                                        max_contributions_per_partition=1,
                                        custom_combiners=[fn]))
            acc.compute_budgets()
            return dict(out)

        got2, want2 = _both(case2)
        assert got2["a"] == pytest.approx(60, abs=1.0)
        _same(got2, want2)

        # A params whose custom_combiners omit the combine_fn is an error.
        private, _, private_beam = _private_pcol("torch", data,
                                                 pid=lambda row: row[0])
        fn_cls = _sum_combine_fn("torch")
        with pytest.raises(ValueError, match="combine_fn"):
            private | private_beam.CombinePerKey(
                fn_cls(),
                pdt.AggregateParams(metrics=None,
                                    max_partitions_contributed=1,
                                    max_contributions_per_partition=1,
                                    custom_combiners=[fn_cls()]))

        # metrics=None without custom combiners is rejected at
        # construction with a clear message.
        with pytest.raises(ValueError, match="metrics must be set"):
            pdt.AggregateParams(metrics=None,
                                max_partitions_contributed=1,
                                max_contributions_per_partition=1)

    def test_private_pcollection_refuses_plain_transforms(self):
        private, _, _ = _private_pcol("torch", [(1, "a")])
        with pytest.raises(TypeError, match="PrivatePTransform"):
            private | beam.Map(lambda x: x)


class TestPrivateSparkOnFake:

    def test_count_and_privacy_id_count(self):
        from pipelinedp_tpu import private_spark as jps
        from pipelinedp_tpu_torch import private_spark as tps

        def case(key):
            mod = PACKAGES[key][0]
            private_spark = tps if key == "torch" else jps
            sc = FakeSparkContext()
            data = [(u, "a") for u in range(40)] + [(0, "a"), (0, "a")]
            acc = mod.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                            total_delta=1e-2)
            prdd = private_spark.make_private(
                sc.parallelize(data), acc,
                privacy_id_extractor=operator.itemgetter(0))
            counts = prdd.count(mod.CountParams(
                max_partitions_contributed=1,
                max_contributions_per_partition=1,
                partition_extractor=operator.itemgetter(1)))
            pid_counts = prdd.privacy_id_count(mod.PrivacyIdCountParams(
                max_partitions_contributed=1,
                partition_extractor=operator.itemgetter(1)))
            acc.compute_budgets()
            return dict(counts.collect()), dict(pid_counts.collect())

        got, want = _both(case)
        assert got[0]["a"] == pytest.approx(40, abs=0.5)
        assert got[1]["a"] == pytest.approx(40, abs=0.5)
        _same(got, want)

    def test_sum_mean_variance_map_and_select(self):
        from pipelinedp_tpu import private_spark as jps
        from pipelinedp_tpu_torch import private_spark as tps

        def case(key):
            mod = PACKAGES[key][0]
            private_spark = tps if key == "torch" else jps
            sc = FakeSparkContext()
            data = [(u, "a", float(u % 4)) for u in range(60)]
            acc = mod.NaiveBudgetAccountant(total_epsilon=BIG_EPS,
                                            total_delta=1e-2)
            prdd = private_spark.make_private(
                sc.parallelize(data), acc,
                privacy_id_extractor=operator.itemgetter(0))
            kw = dict(max_partitions_contributed=1,
                      max_contributions_per_partition=1,
                      min_value=0.0, max_value=4.0,
                      partition_extractor=operator.itemgetter(1),
                      value_extractor=operator.itemgetter(2))
            doubled = prdd.map(lambda row: (row[0], row[1], row[2] * 2))
            s = doubled.sum(mod.SumParams(**kw))
            m = prdd.mean(mod.MeanParams(**kw))
            v = prdd.variance(mod.VarianceParams(**kw))
            twice = prdd.flat_map(lambda row: [row, row])
            c = twice.count(mod.CountParams(
                max_partitions_contributed=1,
                max_contributions_per_partition=2,
                partition_extractor=operator.itemgetter(1)))
            kept = prdd.select_partitions(
                mod.SelectPartitionsParams(max_partitions_contributed=1),
                operator.itemgetter(1))
            acc.compute_budgets()
            return (dict(s.collect()), dict(m.collect()),
                    dict(v.collect()), dict(c.collect()),
                    list(kept.collect()))

        got, want = _both(case)
        assert got[0]["a"] == pytest.approx(sum(min(2.0 * (u % 4), 4.0)
                                                for u in range(60)),
                                            abs=1.0)
        assert got[1]["a"] == pytest.approx(1.5, abs=0.05)
        assert got[3]["a"] == pytest.approx(120, abs=1.0)
        assert got[4] == ["a"]
        _same(got, want)
