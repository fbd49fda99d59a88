"""The port's overlapped ingest executor (``pipelinedp_tpu_torch/ingest``)
and the streamed ``select_partitions``, on the CPU.

The executor's primitives are held to the behaviour that
``tests/test_ingest.py`` asks of the JAX package's: the stager keeps
order and ends, passes its generator's exception on, and unblocks on
close; the fold worker folds in order, drains, passes exceptions on and
drops its queue on cancel; the ring gates buffer reuse. End to end the
overlapped stream releases the bits of the serial one, and both the bits
of the JAX package's serial stream; a failure inside the executor reaches
the caller and no worker thread outlives the run.
"""

import threading

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert, ingest
from pipelinedp_tpu_torch import torch_engine as te

M = pdp.Metrics
PSS = pdp.PartitionSelectionStrategy
CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"


@pytest.fixture(autouse=True)
def _serial_jax_stream(monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
    monkeypatch.setenv(CHUNK_ENV, "599")


def ingest_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith(ingest.THREAD_PREFIX) and t.is_alive()]


class TestExecutorPrimitives:

    def test_stager_orders_and_exhausts(self):
        with ingest.BackgroundStager(lambda c: iter(range(50)),
                                     depth=1) as st:
            assert list(st.items()) == list(range(50))

    def test_stager_propagates_generator_exception(self):
        def gen(cancelled):
            yield 1
            raise RuntimeError("stage boom")

        st = ingest.BackgroundStager(gen, depth=1)
        with pytest.raises(RuntimeError, match="stage boom"):
            list(st.items())
        st.close()  # the error was delivered: no second raise

    def test_stager_close_unblocks_full_queue(self):
        def gen(cancelled):
            yield from range(10_000)

        st = ingest.BackgroundStager(gen, depth=1)
        it = st.items()
        assert next(it) == 0
        st.close()
        assert not ingest_threads()

    def test_fold_worker_is_ordered_and_drains(self):
        seen = []
        w = ingest.OrderedFoldWorker(seen.append, depth=2)
        for i in range(100):
            w.submit(i)
        w.finish()
        assert seen == list(range(100))

    def test_fold_worker_propagates_exception(self):
        def fold(item):
            raise ValueError("fold boom")

        w = ingest.OrderedFoldWorker(fold, depth=2)
        with pytest.raises(ValueError, match="fold boom"):
            for i in range(100):
                w.submit(i)
            w.finish()
        w.cancel()

    def test_fold_worker_cancel_drops_queue(self):
        release = threading.Event()
        seen = []

        def fold(item):
            release.wait(10.0)
            seen.append(item)

        w = ingest.OrderedFoldWorker(fold, depth=3)
        for i in range(3):
            w.submit(i)
        canceller = threading.Thread(target=w.cancel)
        canceller.start()
        assert w._cancelled.wait(10.0)
        release.set()
        canceller.join(10.0)
        assert not canceller.is_alive()
        assert seen in ([], [0]), seen
        assert not ingest_threads()

    def test_staging_ring_gates_reuse(self):
        ring = ingest.StagingRing(2)
        ring.acquire()
        ring.acquire()
        cancelled = threading.Event()
        cancelled.set()
        with pytest.raises(ingest.IngestCancelled):
            ring.acquire(cancelled)
        ring.retire()
        ring.acquire()

    @pytest.mark.parametrize("raw,on", [(None, True), ("1", True),
                                        ("0", False), ("off", False),
                                        ("FALSE", False)])
    def test_executor_enabled_reads_the_knob(self, raw, on, monkeypatch):
        if raw is None:
            monkeypatch.delenv(ingest.executor.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(ingest.executor.ENV_VAR, raw)
        assert ingest.executor_enabled() is on


def _data(seed=0, n=6000, users=1500, parts=120, d=None):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.3, n) % parts).astype(np.int64)
    values = (rng.uniform(-1.0, 11.0, n) if d is None else
              rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32))
    return pid, pk, values


def _run_jax(pid, pk, values, params, public, seed):
    acc = pdp.NaiveBudgetAccountant(total_epsilon=3.0, total_delta=1e-6)
    result = pdp.DPEngine(acc, JaxBackend(rng_seed=seed)).aggregate(
        je.ArrayDataset(pid, pk, values), params, pdp.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    return list(result)


def _run_torch(pid, pk, values, params, public, seed, **backend):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=3.0, total_delta=1e-6)
    result = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed,
                                                **backend)).aggregate(
        convert.dataset_from_arrays(pid, pk, values),
        convert.params_from_reference(params), pdt.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    return list(result), result.timings


def _assert_identical(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a._fields == b._fields
        assert (np.asarray(a, np.float64).tobytes() ==
                np.asarray(b, np.float64).tobytes())


def _p(metrics, **kw):
    base = dict(max_partitions_contributed=3,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)
    base.update(kw)
    return pdp.AggregateParams(metrics=metrics, **base)


EXEC_CASES = {
    "scalars_private": (_p([M.COUNT, M.SUM, M.MEAN]), None),
    "percentile_public": (_p([M.PERCENTILE(50), M.VARIANCE]),
                          list(range(100))),
    "sum_bounds_private": (pdp.AggregateParams(
        metrics=[M.SUM, M.PRIVACY_ID_COUNT], max_partitions_contributed=3,
        max_contributions_per_partition=4, min_sum_per_partition=-2.0,
        max_sum_per_partition=7.3), None),
}


@pytest.mark.parametrize("case", sorted(EXEC_CASES))
def test_overlapped_equals_serial_equals_jax(case):
    params, public = EXEC_CASES[case]
    pid, pk, values = _data(len(case))
    want = _run_jax(pid, pk, values, params, public, 4)
    serial, ts = _run_torch(pid, pk, values, params, public, 4,
                            ingest_executor=False)
    overlapped, to = _run_torch(pid, pk, values, params, public, 4,
                                ingest_executor=True)
    assert len(want) > 3
    _assert_identical(serial, want)
    _assert_identical(overlapped, want)
    assert ts["stream_executor"] == "serial"
    assert to["stream_executor"] == "overlapped"
    for t in (ts, to):
        assert t["stream_batches"] > 5
        for k in ("stream_t_stage", "stream_t_fold", "stream_t_device",
                  "stream_t_total", "stream_stage_s", "stream_fold_wait_s"):
            assert t[k] >= 0.0, k
        assert 0.0 <= t["stream_overlap_frac"] <= 1.0
    assert not ingest_threads()


def test_executor_default_follows_the_knob(monkeypatch):
    pid, pk, values = _data(1)
    params = _p([M.COUNT])
    monkeypatch.delenv("PIPELINEDP_TPU_INGEST_EXECUTOR")
    _, t_on = _run_torch(pid, pk, values, params, None, 2)
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
    _, t_off = _run_torch(pid, pk, values, params, None, 2)
    assert (t_on["stream_executor"], t_off["stream_executor"]) == (
        "overlapped", "serial")


@pytest.mark.parametrize("where", ["launch", "fold"])
def test_executor_failure_reaches_the_caller(where, monkeypatch):
    """No quiet rerun of the serial path: an error on the dispatch thread
    or inside the fold worker surfaces, and the workers are joined."""
    pid, pk, values = _data(2)
    calls = {"n": 0}
    if where == "launch":
        orig = te._partials

        def boom(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 4:
                raise RuntimeError("device boom")
            return orig(*args, **kw)

        monkeypatch.setattr(te, "_partials", boom)
    else:
        orig = te._fold_fx_steps

        def boom(*args, **kw):
            calls["n"] += 1
            if calls["n"] == 3:
                raise RuntimeError("fold boom")
            return orig(*args, **kw)

        monkeypatch.setattr(te, "_fold_fx_steps", boom)
    with pytest.raises(RuntimeError, match="boom"):
        _run_torch(pid, pk, values, _p([M.COUNT, M.SUM]), None, 3,
                   ingest_executor=True)
    assert not ingest_threads()


def _select(pkg, backend, rows, sp):
    acc = pkg.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
    getters = dict(privacy_id_extractor=lambda r: r[0],
                   partition_extractor=lambda r: r[1])
    if pkg is pdt:
        sp = convert.params_from_reference(sp)
    kept = pkg.DPEngine(acc, backend).select_partitions(
        rows, sp, pkg.DataExtractors(**getters))
    acc.compute_budgets()
    return list(kept)


@pytest.mark.parametrize("executor", ["0", "1"])
@pytest.mark.parametrize("strategy", list(PSS))
def test_streamed_select_partitions_equals_jax(strategy, executor,
                                               monkeypatch):
    """The stream with no metrics: the same kept set as the JAX package's
    streamed ``select_partitions``, in ascending vocabulary order."""
    pid, pk, _ = _data(8, n=5000, parts=300)
    rows = list(zip(pid.tolist(), pk.tolist()))
    sp = pdp.SelectPartitionsParams(max_partitions_contributed=2,
                                    partition_selection_strategy=strategy)
    want = _select(pdp, JaxBackend(rng_seed=8), rows, sp)
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", executor)
    got = _select(pdt, pdt.TorchBackend("cpu", rng_seed=8), rows, sp)
    assert len(want) > 5
    assert got == want
    # Row tuples encode their vocabulary sorted by repr.
    assert got == sorted(got, key=repr)
