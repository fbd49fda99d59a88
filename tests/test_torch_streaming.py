"""The port's stream (``pipelinedp_tpu_torch/streaming.py``) against the JAX
package's serial stream, on the CPU.

The chunk is cut so that every aggregation streams in more than five
batches. Each run is bit-identical to the JAX package's: kept keys,
float32 percentiles and float64 scalars. The planner and the batch
assignment are held to their twins, the port's single batch to its own
stream under non-binding caps, and the int32 guards and the mesh, which
is not ported yet, must raise.
"""

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu import streaming as jstreaming
from pipelinedp_tpu.backends import JaxBackend
from pipelinedp_tpu.ingest import assign as jassign

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import streaming
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.ops.kernels import hist

M = pdp.Metrics
EPS, DELTA = 1.0, 1e-6
CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"
CAP_ENV = "PIPELINEDP_TPU_SUBHIST_CAP"
SPAN = 256


@pytest.fixture(autouse=True)
def _serial_jax_stream(monkeypatch):
    """The JAX package's serial stream: its ingest executor is a
    bit-identical overlap of the same loop."""
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
    monkeypatch.delenv(CHUNK_ENV, raising=False)
    monkeypatch.delenv(CAP_ENV, raising=False)


def _data(seed=0, n=6000, users=1500, parts=120):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.3, n) % parts).astype(np.int64)
    values = rng.uniform(-1.0, 11.0, n)
    return pid, pk, values


def _run_jax(pid, pk, values, params, public, seed):
    acc = pdp.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    result = pdp.DPEngine(acc, JaxBackend(rng_seed=seed)).aggregate(
        je.ArrayDataset(pid, pk, values), params, pdp.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    return list(result), result.timings


def _run_torch(pid, pk, values, params, public, seed, eps=EPS, delta=DELTA):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    result = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed)
                          ).aggregate(
        convert.dataset_from_arrays(pid, pk, values),
        convert.params_from_reference(params), pdt.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    return list(result), result.timings


def _assert_identical(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a._fields == b._fields
        for x, y in zip(a, b):
            assert np.float64(x).tobytes() == np.float64(y).tobytes()


def _params(metrics, noise="LAPLACE", **kw):
    base = dict(max_partitions_contributed=3,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)
    base.update(kw)
    return pdp.AggregateParams(metrics=metrics,
                               noise_kind=pdp.NoiseKind[noise], **base)


STREAM_CASES = {
    "scalars_private": (_params([M.COUNT, M.SUM, M.MEAN]), None, None),
    "scalars_gaussian_public": (
        _params([M.VARIANCE, M.PRIVACY_ID_COUNT], noise="GAUSSIAN"),
        list(range(80)), None),
    "percentile_private": (
        _params([M.PERCENTILE(90), M.PERCENTILE(10), M.COUNT]), None, None),
    "percentile_gaussian_public": (
        _params([M.PERCENTILE(50), M.VARIANCE], noise="GAUSSIAN"),
        list(range(100)), None),
    "percentile_total_cap_public": (pdp.AggregateParams(
        metrics=[M.PERCENTILE(75), M.SUM], max_contributions=5,
        min_value=0.0, max_value=10.0), list(range(40)), None),
    "percentile_bounds_enforced": (
        _params([M.PERCENTILE(50), M.PERCENTILE(99)],
                contribution_bounds_already_enforced=True), None, None),
    # 128 partitions x 3 quantiles under a cap of 40 [1, 1, 256] blocks:
    # pass B tiles the grid and packs the tiles into several sweeps.
    "percentile_capped_public": (
        _params([M.PERCENTILE(50), M.PERCENTILE(5), M.PERCENTILE(95)]),
        list(range(128)), 40 * SPAN * 4),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streamed_aggregate_bit_identical(case, monkeypatch):
    params, public, cap = STREAM_CASES[case]
    pid, pk, values = _data(len(case))
    if params.contribution_bounds_already_enforced:
        pid = None
    monkeypatch.setenv(CHUNK_ENV, "599")
    if cap is not None:
        monkeypatch.setenv(CAP_ENV, str(cap))
    want, jt = _run_jax(pid, pk, values, params, public, len(case))
    got, tt = _run_torch(pid, pk, values, params, public, len(case))
    assert len(want) > 5
    _assert_identical(got, want)
    assert tt["stream_batches"] == jt["stream_batches"] > 5
    if any(m.is_percentile for m in params.metrics):
        assert tt["stream_pass_b"] == jt["stream_pass_b"] == "device_cache"
        assert tt["stream_pass_b_sweeps"] == jt["stream_pass_b_sweeps"]
        assert tt["stream_pass_b_tiles"] == jt["stream_pass_b_tiles"]
        assert (tt["stream_pass_b_tiles"] > 1) == (cap is not None)
        if cap is not None:
            assert tt["stream_pass_b_sweeps"] > 1


def test_single_batch_equals_stream(monkeypatch):
    """Under caps no unit reaches, bounding keeps every row in any
    batching, so the port's single batch and its stream release the same
    kept set and the same percentiles (the JAX package's three-way check,
    ``tests/test_walk.py``, on the port's two serial paths)."""
    rng = np.random.default_rng(42)
    n = 12_000
    pid = rng.integers(0, 2_000, n)
    pk = (rng.zipf(1.6, n) % 40).astype(np.int64)
    values = rng.uniform(0, 10, n)
    params = _params([M.PERCENTILE(50), M.PERCENTILE(90), M.COUNT],
                     max_partitions_contributed=40,
                     max_contributions_per_partition=200)
    single, st = _run_torch(pid, pk, values, params, None, 11, 4.0, 1e-4)
    monkeypatch.setenv(CHUNK_ENV, "997")
    streamed, tt = _run_torch(pid, pk, values, params, None, 11, 4.0, 1e-4)
    assert "stream_batches" not in st and tt["stream_batches"] > 5
    assert len(single) > 5
    assert [k for k, _ in single] == [k for k, _ in streamed]
    for (_, a), (_, b) in zip(single, streamed):
        assert a.percentile_50 == b.percentile_50
        assert a.percentile_90 == b.percentile_90
        assert a.count == b.count


@pytest.mark.parametrize("P_pad", [8, 64, 1024])
@pytest.mark.parametrize("Q", [1, 3, 5])
@pytest.mark.parametrize("span", [16, 256])
def test_plan_pass_b_sweeps_matches_jax(P_pad, Q, span):
    unit = span * 4
    for cap in (unit, 3 * unit, 7 * unit, P_pad * unit, 2 * P_pad * Q * unit,
                P_pad * Q * unit - 1, 600 << 20):
        for q_chunk in (0, 1, 2, Q + 1):
            want = jstreaming.plan_pass_b_sweeps(P_pad, Q, span, cap,
                                                 q_chunk=q_chunk)
            got = streaming.plan_pass_b_sweeps(P_pad, Q, span, cap,
                                               q_chunk=q_chunk)
            assert (got.q_chunk, got.p_blk, got.tiles_per_sweep, got.tiles,
                    got.sweeps) == (want.q_chunk, want.p_blk,
                                    want.tiles_per_sweep, want.tiles,
                                    want.sweeps), (cap, q_chunk)
            assert (got.n_tiles, got.n_sweeps, got.chunked) == (
                want.n_tiles, want.n_sweeps, want.chunked)
    with pytest.raises(NotImplementedError):
        streaming.plan_pass_b_sweeps(P_pad, Q, span, unit - 1)


@pytest.mark.parametrize("enforced", [False, True])
@pytest.mark.parametrize("n_batches", [1, 7, 13])
def test_batch_assignment_matches_jax(enforced, n_batches):
    pid, pk, values = _data(3, n=5000)
    params = _params([M.COUNT], contribution_bounds_already_enforced=enforced)
    enc_j = je.encode(je.ArrayDataset(None if enforced else pid, pk, values),
                      None, None, require_pid=not enforced)
    enc_t = te.encode(convert.dataset_from_arrays(
        None if enforced else pid, pk, values), None, None,
        require_pid=not enforced)
    cfg_j = je.FusedConfig.from_params(params, public=False)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=False)
    order_j, counts_j = jstreaming._batch_assignment(cfg_j, enc_j, n_batches,
                                                     12345, 1)
    order_t, counts_t = streaming._batch_assignment(cfg_t, enc_t, n_batches,
                                                    12345)
    np.testing.assert_array_equal(counts_t, counts_j)
    if enforced:
        assert order_t is None and order_j is None
    else:
        np.testing.assert_array_equal(order_t, order_j)


@pytest.mark.parametrize("n_cells", [1, 5, 1 << 16, (1 << 16) + 3, 1 << 20])
def test_group_rows_by_cell_matches_jax(n_cells):
    rng = np.random.default_rng(n_cells % 1000)
    cells = rng.integers(0, n_cells, 20_000)
    order_j, counts_j = jassign.group_rows_by_cell(cells, n_cells)
    order_t, counts_t = streaming.group_rows_by_cell(cells, n_cells)
    np.testing.assert_array_equal(order_t, order_j)
    np.testing.assert_array_equal(counts_t, counts_j)


@pytest.mark.parametrize("metrics,vector", [
    ([M.COUNT, M.SUM], False), ([M.PERCENTILE(50), M.VARIANCE], False),
    ([M.VECTOR_SUM], True)])
def test_chunk_rows_and_rank1_names_match_jax(metrics, vector, monkeypatch):
    kw = (dict(vector_size=3, vector_max_norm=1.0, min_value=None,
               max_value=None) if vector else {})
    params = _params(metrics, **kw)
    cfg_j = je.FusedConfig.from_params(params, public=False)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=False)
    for chunk in (None, "997", str(1 << 30)):
        if chunk is None:
            monkeypatch.delenv(CHUNK_ENV, raising=False)
        else:
            monkeypatch.setenv(CHUNK_ENV, chunk)
        assert streaming.stream_chunk_rows() == jstreaming.stream_chunk_rows()
        assert (streaming.chunk_target_rows(cfg_t) ==
                jstreaming.chunk_target_rows(cfg_j, 1))
        for n in (996, 997, 998, 1 << 26, (1 << 26) + 1):
            assert (streaming.should_stream(cfg_t, n) ==
                    jstreaming.should_stream(cfg_j, n, None))
    for fx_bits in (12, 7, 4):
        assert (streaming._rank1_names(cfg_t, fx_bits) ==
                jstreaming._rank1_names(cfg_j, fx_bits))


def _aggregate_torch(params, monkeypatch, n=3000, chunk="499", **backend):
    pid, pk, values = _data(9, n=n)
    if params.vector_size:
        values = np.zeros((n, params.vector_size), np.float32)
    monkeypatch.setenv(CHUNK_ENV, chunk)
    acc = pdt.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=1, **backend))
    result = engine.aggregate(convert.dataset_from_arrays(pid, pk, values),
                              params, pdt.DataExtractors())
    acc.compute_budgets()
    return list(result)


def test_guards_fire(monkeypatch):
    """The int32 guards of the JAX stream, pinned through their seams:
    privacy units per partition at selection, kept rows per partition in
    the tree histograms, and a byte cap below one [1, 1, span] block."""
    params = convert.params_from_reference(
        _params([M.PERCENTILE(50), M.COUNT]))
    monkeypatch.setattr(streaming, "_SELECT_UNITS_CAP", 5)
    with pytest.raises(NotImplementedError, match="privacy units"):
        _aggregate_torch(params, monkeypatch)
    monkeypatch.setattr(streaming, "_SELECT_UNITS_CAP", 1 << 31)
    monkeypatch.setattr(streaming, "_TREE_ROWS_CAP", 5)
    with pytest.raises(NotImplementedError, match="kept rows"):
        _aggregate_torch(params, monkeypatch)
    monkeypatch.setattr(streaming, "_TREE_ROWS_CAP", 1 << 31)
    monkeypatch.setenv(CAP_ENV, str(SPAN * 4 - 1))
    with pytest.raises(NotImplementedError, match="subhist byte cap"):
        _aggregate_torch(params, monkeypatch)


@pytest.mark.parametrize("unported", ["mesh"])
def test_not_in_slice_raises(unported):
    """Every option of the JAX backend's stream is ported now
    (``test_torch_ingest.py``, ``test_torch_resume.py``,
    ``test_torch_stream_vector.py``; the mesh, ROADMAP step 5a,
    ``test_torch_stream_mesh.py``): the backend takes a ``parallel.Mesh``
    and refuses anything else by name."""
    with pytest.raises(TypeError, match="parallel.Mesh"):
        pdt.TorchBackend("cpu", **{unported: object()})


def test_streamed_pass_b_takes_plain_version_on_cpu(monkeypatch):
    """On the CPU the stream bins with the plain version, once per batch
    per sweep, and counts no kernel launch."""
    calls = []
    orig = te._subtree_counts_multi

    def spy(*args, **kw):
        calls.append(args[4].shape[0])
        return orig(*args, **kw)

    monkeypatch.setattr(te, "_subtree_counts_multi", spy)
    before = hist.LAUNCHES["subtree_counts_multi"]
    params = convert.params_from_reference(
        _params([M.PERCENTILE(50), M.PERCENTILE(10)]))
    monkeypatch.setenv(CAP_ENV, str(40 * SPAN * 4))
    pid, pk, values = _data(9, n=3000)
    monkeypatch.setenv(CHUNK_ENV, "499")
    acc = pdt.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    result = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=1)).aggregate(
        convert.dataset_from_arrays(pid, pk, values), params,
        pdt.DataExtractors(), public_partitions=list(range(128)))
    acc.compute_budgets()
    assert len(list(result)) == 128
    t = result.timings
    assert len(calls) == t["stream_batches"] * t["stream_pass_b_sweeps"]
    assert sum(calls) == t["stream_batches"] * t["stream_pass_b_tiles"]
    assert hist.LAUNCHES["subtree_counts_multi"] == before
