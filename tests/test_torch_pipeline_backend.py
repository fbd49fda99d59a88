"""Backend conformance of the port (``pipelinedp_tpu_torch.pipeline_backend``):
the cases of ``tests/test_pipeline_backend.py`` over the port's
``LocalBackend``, ``MultiProcLocalBackend`` (one ``spawn`` pool of two
workers for the module, closed by the fixture) and ``SparkRDDBackend``
(through ``tests/fake_spark.py``) and ``BeamBackend`` (through
``tests/fake_beam.py``), then the laziness, label, annotator and
worker-seeding cases, and ``sample_fixed_per_key`` bit for bit with the
JAX package's ``LocalBackend`` under one ``seed_host_rng`` seed.

The functions handed to the pool live at module level so they pickle into
the spawned workers, which import this module by name; the JAX package is
imported inside the tests that compare with it, so a worker does not
import it.
"""

import pytest

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import pipeline_backend
from pipelinedp_tpu_torch.ops import noise as noise_ops


def double(x):
    return 2 * x


def explode(x):
    return [x, x]


def add_pair(a, b):
    return a + b


def is_even(x):
    return x % 2 == 0


def kv_swap(k, v):
    return (v, k)


class _SumCombiner:

    def merge_accumulators(self, a, b):
        return a + b


def _run(col):
    """Materializes any backend collection (element order is not part of
    the op contract, so results are sorted)."""
    return sorted(list(col))


def _dict(col):
    """A keyed collection as a dict (an RDD has ``keys()``, so ``dict``
    would take it for a mapping)."""
    return dict(list(col))


@pytest.fixture(scope="module")
def multiproc(request):
    backend = pipeline_backend.MultiProcLocalBackend(n_jobs=2, chunk_size=4)
    request.addfinalizer(backend.close)
    return backend


class _BeamOnLists:
    """The port's ``BeamBackend`` on the fake Beam of
    ``tests/fake_beam.py``, taking the plain lists the cases pass: each
    input list becomes a ``beam.Create`` in one pipeline (the keys of an
    in-memory ``filter_by_key`` stay a list)."""

    def __init__(self):
        from tests.test_torch_cluster_backends import ADAPTERS, beam
        self._backend = ADAPTERS["torch"][0].BeamBackend()
        self._beam = beam
        self._pipeline = beam.Pipeline()
        self._inputs = 0

    def _col(self, data):
        if not isinstance(data, (list, tuple)):
            return data
        self._inputs += 1
        return self._pipeline | f"input{self._inputs}" >> self._beam.Create(
            data)

    def __getattr__(self, name):
        op = getattr(self._backend, name)

        def call(col, *args, **kwargs):
            col = (tuple(self._col(c) for c in col) if name == "flatten"
                   else self._col(col))
            return op(col, *args, **kwargs)

        return call


@pytest.fixture(params=["local", "multiproc", "spark", "beam"])
def backend(request):
    if request.param == "local":
        return pipeline_backend.LocalBackend()
    if request.param == "multiproc":
        return request.getfixturevalue("multiproc")
    if request.param == "beam":
        return _BeamOnLists()
    from tests.fake_spark import FakeSparkContext
    return pipeline_backend.SparkRDDBackend(FakeSparkContext())


class TestBackendConformance:

    def test_map(self, backend):
        assert _run(backend.map([1, 2, 3], double, "map")) == [2, 4, 6]

    def test_flat_map(self, backend):
        assert _run(backend.flat_map([1, 2], explode,
                                     "fm")) == [1, 1, 2, 2]

    def test_map_tuple(self, backend):
        got = _run(backend.map_tuple([(1, "a"), (2, "b")], kv_swap, "mt"))
        assert got == [("a", 1), ("b", 2)]

    def test_map_values(self, backend):
        got = _run(backend.map_values([(1, 2), (2, 3)], double, "mv"))
        assert got == [(1, 4), (2, 6)]

    def test_group_by_key(self, backend):
        got = _dict(backend.group_by_key([(1, "a"), (2, "b"), (1, "c")],
                                         "gbk"))
        assert sorted(got[1]) == ["a", "c"]
        assert got[2] == ["b"]

    def test_group_by_key_sharded(self, backend):
        # Past 2 * chunk_size rows the multiproc backend shards by key
        # and groups in its workers.
        col = [(i % 5, i) for i in range(40)]
        got = _dict(backend.group_by_key(col, "gbk"))
        assert {k: sorted(v) for k, v in got.items()} == {
            k: list(range(k, 40, 5)) for k in range(5)}

    def test_filter(self, backend):
        assert _run(backend.filter([1, 2, 3, 4], is_even, "f")) == [2, 4]

    def test_filter_by_key(self, backend):
        col = [(1, "a"), (2, "b"), (3, "c")]
        got = _run(backend.filter_by_key(col, [1, 3], "fbk"))
        assert got == [(1, "a"), (3, "c")]

    def test_keys_values(self, backend):
        col = [(1, "a"), (2, "b")]
        assert _run(backend.keys(col, "k")) == [1, 2]
        assert _run(backend.values(col, "v")) == ["a", "b"]

    def test_sample_fixed_per_key(self, backend):
        noise_ops.seed_host_rng(0)
        col = [(1, i) for i in range(100)] + [(2, 0)]
        got = _dict(backend.sample_fixed_per_key(col, 5, "sample"))
        assert len(got[1]) == 5
        assert set(got[1]) <= set(range(100))
        assert got[2] == [0]

    def test_count_per_element(self, backend):
        got = _dict(backend.count_per_element(["a", "b", "a"], "cpe"))
        assert got == {"a": 2, "b": 1}

    def test_sum_per_key(self, backend):
        got = _dict(backend.sum_per_key([(1, 2), (1, 3), (2, 5)], "spk"))
        assert got == {1: 5, 2: 5}

    def test_combine_accumulators_per_key(self, backend):
        got = _dict(
            backend.combine_accumulators_per_key(
                [(1, 2), (1, 3), (2, 5)], _SumCombiner(), "combine"))
        assert got == {1: 5, 2: 5}

    def test_reduce_per_key(self, backend):
        got = _dict(
            backend.reduce_per_key([(1, 2), (1, 3)], add_pair, "reduce"))
        assert got == {1: 5}

    def test_reduce_per_key_sharded(self, backend):
        col = [(i % 3, i) for i in range(30)]
        got = _dict(backend.reduce_per_key(col, add_pair, "reduce"))
        assert got == {k: sum(range(k, 30, 3)) for k in range(3)}

    def test_flatten(self, backend):
        got = _run(backend.flatten(([1, 2], [3]), "flat"))
        assert got == [1, 2, 3]

    def test_distinct(self, backend):
        assert _run(backend.distinct([1, 2, 1, 3], "d")) == [1, 2, 3]

    def test_to_list(self, backend):
        if isinstance(backend, pipeline_backend.SparkRDDBackend):
            # Spark leaves to_list unimplemented, as in the reference.
            with pytest.raises(NotImplementedError):
                backend.to_list([1, 2, 3], "tl")
            return
        got = list(backend.to_list([1, 2, 3], "tl"))
        assert got == [[1, 2, 3]]

    def test_laziness_chain(self, backend):
        col = backend.map([1, 2, 3, 4], double, "m")  # 2,4,6,8
        col = backend.filter(col, is_even, "f")  # all
        col = backend.map(col, double, "m2")  # 4,8,12,16
        assert _run(col) == [4, 8, 12, 16]

    def test_fan_out_chain(self, backend):
        # Large enough that the multiproc backend maps in its workers.
        col = backend.map(list(range(50)), double, "m")
        col = backend.filter(col, is_even, "f")
        col = backend.flat_map(col, explode, "fm")
        assert _run(col) == sorted(2 * list(range(0, 100, 2)))


class TestLocalBackendLaziness:

    def test_generators_are_lazy(self):
        calls = []

        def track(x):
            calls.append(x)
            return x

        backend = pipeline_backend.LocalBackend()
        col = backend.map([1, 2, 3], track, "m")
        assert calls == []
        list(col)
        assert calls == [1, 2, 3]

    def test_to_multi_transformable(self):
        backend = pipeline_backend.LocalBackend()
        col = backend.map([1, 2], double, "m")
        col = backend.to_multi_transformable_collection(col)
        assert list(col) == [2, 4]
        assert list(col) == [2, 4]

    def test_multiproc_is_lazy(self, multiproc):
        calls = []

        def track(x):
            calls.append(x)
            return x

        # An unpicklable function runs in process, when iterated.
        col = multiproc.map(list(range(20)), track, "m")
        assert calls == []
        assert _run(col) == list(range(20))
        assert calls == list(range(20))


class TestUniqueLabels:

    def test_unique_labels(self):
        gen = pipeline_backend.UniqueLabelsGenerator("sfx")
        a = gen.unique("stage")
        b = gen.unique("stage")
        c = gen.unique("")
        assert a == "stage_sfx"
        assert b == "stage_1_sfx"
        assert "UNDEFINED" in c
        assert len({a, b, c}) == 3


class TestAnnotators:

    @pytest.mark.parametrize("make", [
        pipeline_backend.LocalBackend,
        lambda: pdt.TorchBackend("cpu"),
    ], ids=["local", "torch"])
    def test_annotator_applied(self, make):

        class Recorder(pipeline_backend.Annotator):

            def __init__(self):
                self.calls = []

            def annotate(self, col, params=None, budget=None):
                self.calls.append((params, budget))
                return col

        rec = Recorder()
        pipeline_backend.register_annotator(rec)
        try:
            col = make().annotate([1, 2], "ann", params="p", budget="b")
            assert list(col) == [1, 2]
            assert rec.calls == [("p", "b")]
            assert rec in pipeline_backend.registered_annotators()
        finally:
            pipeline_backend._annotators.remove(rec)


def test_beam_backend_names_its_step():
    """Without apache_beam the package keeps the ``BeamBackend`` name, and
    constructing it raises the JAX package's ImportError."""
    import pipelinedp_tpu as pdp
    with pytest.raises(ImportError) as want:
        pdp.BeamBackend()
    with pytest.raises(ImportError, match="apache_beam is required") as got:
        pdt.BeamBackend()
    assert str(got.value) == str(want.value)
    assert not hasattr(pipeline_backend, "BeamBackend")


def _draw_worker_noise(_):
    """Draws from the worker's host RNG. The sleep keeps each worker busy
    long enough that no single worker drains the task queue, so every
    worker takes part."""
    import os
    import time
    from pipelinedp_tpu_torch.ops import noise
    draw = tuple(noise.np_laplace(1.0, shape=4).tolist())
    time.sleep(0.2)
    return os.getpid(), draw


class TestMultiProcWorkerSeeding:

    def test_workers_draw_distinct_noise(self, multiproc):
        """Pool workers must not draw from one RNG state: identical noise
        streams across workers cancel in pairwise partition differences,
        voiding DP. The parent's seed must not reach them either."""
        noise_ops.seed_host_rng(0)
        results = multiproc._pool().map(_draw_worker_noise, range(8),
                                        chunksize=1)
        first_draw_per_pid = {}
        for pid, draw in results:
            first_draw_per_pid.setdefault(pid, draw)
        assert len(first_draw_per_pid) >= 2, (
            "need at least two workers to exercise the regression")
        draws = list(first_draw_per_pid.values())
        assert len(set(draws)) == len(draws), (
            "two pool workers produced identical noise streams")
        parent = tuple(noise_ops.np_laplace(1.0, shape=4).tolist())
        assert parent not in draws

    def test_pool_is_spawned(self, multiproc):
        pool = multiproc._pool()
        assert pool._ctx.get_start_method() == "spawn"


class TestParityWithJaxPackage:
    """The port's host ops draw in the JAX package's order."""

    @pytest.mark.parametrize("n", [3, 5, 40])
    def test_sample_fixed_per_key_bit_equal(self, n):
        from pipelinedp_tpu import pipeline_backend as jpb
        from pipelinedp_tpu.ops import noise as jnoise
        col = ([(k, (k, i, i * 0.5)) for k in ("x", "y", "z")
                for i in range(60)] + [(7, (7, 0, 0.0))])
        jnoise.seed_host_rng(3)
        want = list(jpb.LocalBackend().sample_fixed_per_key(col, n, "s"))
        noise_ops.seed_host_rng(3)
        got = list(pipeline_backend.LocalBackend().sample_fixed_per_key(
            col, n, "s"))
        assert got == want
        noise_ops.seed_host_rng(3)
        got = list(pdt.TorchBackend("cpu").sample_fixed_per_key(col, n,
                                                                 "s"))
        assert got == want

    def test_choose_from_list_bit_equal(self):
        from pipelinedp_tpu import sampling_utils as jsu
        from pipelinedp_tpu.ops import noise as jnoise
        from pipelinedp_tpu_torch import sampling_utils as tsu
        a = [(i, str(i)) for i in range(50)]
        jnoise.seed_host_rng(11)
        noise_ops.seed_host_rng(11)
        for size in (1, 7, 49, 50, 80):
            assert (tsu.choose_from_list_without_replacement(a, size) ==
                    jsu.choose_from_list_without_replacement(a, size))

    @pytest.mark.parametrize("op", ["group_by_key", "count_per_element",
                                    "distinct", "reduce_per_key"])
    def test_local_op_order_matches(self, op):
        """Dict and set orders are the JAX package's, so later draws
        happen in the same order."""
        from pipelinedp_tpu import pipeline_backend as jpb
        col = [(("k", i % 7), i) for i in range(50)]
        args = {"group_by_key": (col,), "count_per_element": (col,),
                "distinct": ([k for k, _ in col],),
                "reduce_per_key": (col, add_pair)}[op]
        want = list(getattr(jpb.LocalBackend(), op)(*args))
        got = list(getattr(pipeline_backend.LocalBackend(), op)(*args))
        assert got == want
