"""Streamed VECTOR_SUM on the port against the JAX package's stream, on the
CPU.

Under ``fx`` each batch's [P, n_lanes * D] lane sums fold into exact
float64 step totals with that batch's count, and the scale divides once at
release, so the streamed release is bit-identical to the JAX package's
stream and to the port's own single batch, serially and through the
overlapped executor. Under ``f32`` each batch's float32 sums are added in
float64 in batch order; the per-batch float32 sums are taken in another
order than the JAX package's, so the released vectors agree within the
summation bound stated in ``tests/test_torch_vector.py``.
"""

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch.ops.kernels import segsum

M = pdp.Metrics
ACC_ENV = "PIPELINEDP_TPU_VECTOR_ACCUMULATOR"
CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"
PUBLIC = list(range(0, 90)) + [500, 501]


@pytest.fixture(autouse=True)
def _stream(monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
    monkeypatch.setenv(CHUNK_ENV, "599")
    monkeypatch.setenv(ACC_ENV, "fx")


def _data(seed=0, n=6000, users=2000, parts=120, d=5):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.2, n) % parts).astype(np.int64)
    values = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    return pid, pk, values


def _params(**kw):
    base = dict(metrics=[M.VECTOR_SUM], vector_size=5, vector_max_norm=3.0,
                vector_norm_kind=pdp.NormKind.L2,
                noise_kind=pdp.NoiseKind.GAUSSIAN,
                max_partitions_contributed=2,
                max_contributions_per_partition=2)
    base.update(kw)
    return pdp.AggregateParams(**base)


def _run_jax(pid, pk, values, params, public, seed):
    acc = pdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    result = pdp.DPEngine(acc, JaxBackend(rng_seed=seed)).aggregate(
        je.ArrayDataset(pid, pk, values), params, pdp.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    return list(result), result.timings


def _run_torch(pid, pk, values, params, public, seed, **backend):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    result = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed,
                                                **backend)).aggregate(
        convert.dataset_from_arrays(pid, pk, values),
        convert.params_from_reference(params), pdt.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    return list(result), result.timings


def _vectors(rows):
    return np.stack([np.asarray(m.vector_sum, np.float64) for _, m in rows])


def _assert_identical(got, want):
    assert len(want) > 0
    assert [k for k, _ in got] == [k for k, _ in want]
    assert _vectors(got).tobytes() == _vectors(want).tobytes()


@pytest.mark.parametrize("public", [False, True], ids=["private", "public"])
@pytest.mark.parametrize("noise,norm", [("GAUSSIAN", "L2"),
                                        ("LAPLACE", "L1"),
                                        ("LAPLACE", "Linf")])
def test_streamed_fx_bit_identical_to_jax_stream(noise, norm, public):
    params = _params(noise_kind=pdp.NoiseKind[noise],
                     vector_norm_kind=pdp.NormKind[norm])
    pid, pk, values = _data(len(norm) + 3 * public)
    public = PUBLIC if public else None
    want, jt = _run_jax(pid, pk, values, params, public, 13)
    got, tt = _run_torch(pid, pk, values, params, public, 13)
    _assert_identical(got, want)
    assert tt["stream_batches"] == jt["stream_batches"] > 5


@pytest.mark.parametrize("executor", [False, True],
                         ids=["serial", "overlapped"])
def test_streamed_fx_equals_single_batch(executor, monkeypatch):
    """Offset removal is linear and the steps are exact integers, so the
    stream's release does not depend on the batching: a stream releases
    the single batch's bits under caps no unit reaches."""
    params = _params(max_partitions_contributed=120,
                     max_contributions_per_partition=100)
    pid, pk, values = _data(3)
    streamed, t = _run_torch(pid, pk, values, params, PUBLIC, 5,
                             ingest_executor=executor)
    monkeypatch.delenv(CHUNK_ENV)
    single, t1 = _run_torch(pid, pk, values, params, PUBLIC, 5)
    assert t["stream_batches"] > 5 and "stream_batches" not in t1
    _assert_identical(streamed, single)


def test_streamed_fx_bounds_enforced_bit_identical():
    params = _params(contribution_bounds_already_enforced=True)
    _, pk, values = _data(8)
    want, _ = _run_jax(None, pk, values, params, None, 3)
    got, _ = _run_torch(None, pk, values, params, None, 3)
    _assert_identical(got, want)


def test_streamed_fx_takes_the_plain_wide_sum_on_cpu(monkeypatch):
    """One ``segment_sum_wide`` per batch, the plain version on the CPU,
    no kernel launch counted."""
    calls = []
    orig = segsum.segment_sum_wide_plain

    def spy(cols, pk, P):
        calls.append(cols.shape)
        return orig(cols, pk, P)

    monkeypatch.setattr(segsum, "segment_sum_wide_plain", spy)
    before = dict(segsum.LAUNCHES)
    pid, pk, values = _data(9)
    _, t = _run_torch(pid, pk, values, _params(), PUBLIC, 1)
    assert len(calls) == t["stream_batches"]
    assert segsum.LAUNCHES == before


@pytest.mark.parametrize("public", [False, True], ids=["private", "public"])
def test_streamed_f32_within_the_summation_bound(public, monkeypatch):
    """Per batch both packages sum in float32 in different orders (bounded
    as in ``tests/test_torch_vector.py``); the batches then add in float64
    in the same order, which adds no more than float64 rounding. So the
    released vectors stay within 4 * n_max * 2^-24 * S_max plus a float64
    term far below it."""
    monkeypatch.setenv(ACC_ENV, "f32")
    params = _params(noise_kind=pdp.NoiseKind.LAPLACE,
                     max_contributions_per_partition=3)
    pid, pk, values = _data(6)
    public = PUBLIC if public else None
    want, _ = _run_jax(pid, pk, values, params, public, 23)
    got, t = _run_torch(pid, pk, values, params, public, 23)
    assert t["stream_batches"] > 5
    assert len(want) > 0
    assert [k for k, _ in got] == [k for k, _ in want]
    n_max = int(np.bincount(pk).max())
    s_max = float(np.bincount(pk, weights=np.abs(values).sum(axis=1)).max())
    tol = 4 * n_max * 2.0**-24 * s_max
    np.testing.assert_allclose(_vectors(got), _vectors(want), rtol=0,
                               atol=tol)
