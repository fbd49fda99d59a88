"""The port's stream on a 4-rank gloo mesh against the JAX package's
stream on ``make_mesh(4)``, bit for bit, on the CPU.

Ports ``tests/test_streaming.py::TestStreamedOnMesh`` and
``tests/test_walk.py::TestPartitionBlockChunkedWalk::
test_streamed_blocks_on_mesh_bit_identical``: every batch splits into one
cell per rank, each rank bounds and reduces its cell, and the ranks'
exact int32 partials combine, so the port's multi-process stream gives
the JAX package's single-controller mesh stream's bits. With caps that do
not bind, the streamed mesh also equals the single-batch mesh; a stream
killed at a batch resumes from the checkpoint to the same bits.
"""

import os

import pytest

import pipelinedp_tpu as pdp

from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch.parallel import launch

import test_torch_mesh_ranks as ranks
from test_torch_mesh import assert_same_release, jax_run, N_RANKS

M = pdp.Metrics
CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"
SUBHIST_ENV = "PIPELINEDP_TPU_SUBHIST_CAP"
EXECUTOR_ENV = "PIPELINEDP_TPU_INGEST_EXECUTOR"
VEC_ENV = "PIPELINEDP_TPU_VECTOR_ACCUMULATOR"
SPAN_BYTES = 256 * 4  # one [1, 1, span] int32 subtree block


@pytest.fixture(scope="module")
def pool():
    return ranks.shared_pool()


def _both(pool, monkeypatch, params, data, seed, env, eps=1.0,
          public=None, select=False, **kw):
    """(JAX mesh release, every rank's (release, timings, ...))."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    want = jax_run(params, data, seed, eps=eps, public=public,
                   select=select)
    outs = pool.run(ranks.aggregate, convert.params_from_reference(params),
                    data, seed, eps=eps, public=public, select=select,
                    env=env, **kw)
    for other in outs[1:]:
        assert_same_release(other[0], outs[0][0])
    return want, outs


def _scalar_case():
    params = pdp.AggregateParams(
        metrics=[M.COUNT, M.SUM, M.MEAN, M.PRIVACY_ID_COUNT],
        max_partitions_contributed=3, max_contributions_per_partition=4,
        min_value=0.0, max_value=10.0)
    return params, ranks.dataset(seed=40, n=9000, users=1500, parts=15)


def _percentile_case():
    params = pdp.AggregateParams(
        metrics=[M.COUNT, M.PERCENTILE(50), M.PERCENTILE(90)],
        max_partitions_contributed=3, max_contributions_per_partition=6,
        min_value=0.0, max_value=10.0)
    return params, ranks.dataset(seed=41, n=8000, users=1200, parts=8)


def test_scalars_stream_bit_equal(pool, monkeypatch):
    params, data = _scalar_case()
    want, outs = _both(pool, monkeypatch, params, data, 5,
                       {CHUNK_ENV: "500", EXECUTOR_ENV: "0"}, eps=2.0)
    got, timings = outs[0][0], outs[0][1]
    assert timings["stream_batches"] >= 3
    assert timings["stream_executor"] == "serial"
    assert len(want) > 5
    assert_same_release(got, want)


def test_executor_is_forced_serial_on_a_mesh(pool, monkeypatch):
    """The overlapped executor is asked for and turned off, visibly: the
    JAX package's multi-process rule."""
    params, data = _scalar_case()
    want, outs = _both(pool, monkeypatch, params, data, 5,
                       {CHUNK_ENV: "500"}, eps=2.0, ingest_executor=True)
    _, timings, counters, events = outs[0]
    assert timings["stream_executor"] == "serial"
    assert counters["ingest.forced_serial"] == 1
    assert [e["name"] for e in events].count("ingest.forced_serial") == 1
    assert_same_release(outs[0][0], want)


@pytest.mark.parametrize("public", [False, True])
def test_percentiles_stream_bit_equal(pool, monkeypatch, public):
    params, data = _percentile_case()
    parts = list(range(8)) if public else None
    want, outs = _both(pool, monkeypatch, params, data, 7,
                       {CHUNK_ENV: "400"}, eps=4.0, public=parts)
    assert outs[0][1]["stream_batches"] >= 3
    assert len(want) >= 4
    assert_same_release(outs[0][0], want)


def test_pass_b_blocks_on_mesh_bit_equal(pool, monkeypatch):
    """A subhist cap of 4 subtree blocks tiles pass B into several
    rounds; the tiled mesh stream still gives the JAX mesh's bits."""
    params, data = _percentile_case()
    env = {CHUNK_ENV: "400", SUBHIST_ENV: str(4 * SPAN_BYTES)}
    want, outs = _both(pool, monkeypatch, params, data, 3, env, eps=4.0,
                       public=list(range(8)))
    assert outs[0][1]["stream_pass_b_tiles"] > 1
    assert_same_release(outs[0][0], want)


def test_vector_sum_fx_streams_bit_equal(pool, monkeypatch):
    params = pdp.AggregateParams(
        metrics=[M.VECTOR_SUM], vector_size=3, vector_max_norm=2.0,
        vector_norm_kind=pdp.NormKind.Linf, max_partitions_contributed=3,
        max_contributions_per_partition=4)
    data = ranks.dataset(seed=42, n=6000, users=1500, parts=5, vector=3)
    want, outs = _both(pool, monkeypatch, params, data, 9,
                       {CHUNK_ENV: "300", VEC_ENV: "fx"}, eps=2.0,
                       public=list(range(5)))
    assert outs[0][1]["stream_batches"] >= 3
    assert_same_release(outs[0][0], want)


def test_select_partitions_streams_bit_equal(pool, monkeypatch):
    params = pdp.SelectPartitionsParams(max_partitions_contributed=2)
    data = ranks.dataset(seed=43, n=12000, users=3000, parts=200)
    want, outs = _both(pool, monkeypatch, params, data, 11,
                       {CHUNK_ENV: "500"}, select=True)
    assert len(want) > 5
    assert outs[0][0] == want


def test_hier_stream_equals_flat(pool):
    """The stream's replicating exchanges under ``hier`` (two simulated
    hosts) give ``flat``'s bits, with fewer bytes across the hosts."""
    params, data = _percentile_case()
    p = convert.params_from_reference(params)
    env = {CHUNK_ENV: "400", "PIPELINEDP_TPU_MESH_HOSTS": "2"}
    flat = pool.run(ranks.aggregate, p, data, 31, eps=4.0, env=env)
    hier = pool.run(ranks.aggregate, p, data, 31, eps=4.0, env=dict(
        env, PIPELINEDP_TPU_MESH_TOPOLOGY="hier"))
    assert hier[0][1]["stream_batches"] >= 3
    assert hier[0][2]["comms.dcn_bytes"] < flat[0][2]["comms.dcn_bytes"]
    for h in hier:
        assert_same_release(h[0], flat[0][0])


def test_streamed_mesh_equals_single_batch_mesh(pool):
    """Caps that do not bind: the streamed mesh, the single-batch mesh and
    the single device release the same bits (the three-way parity)."""
    params = pdp.AggregateParams(
        metrics=[M.COUNT, M.SUM, M.PERCENTILE(50)],
        max_partitions_contributed=40, max_contributions_per_partition=40,
        min_value=0.0, max_value=10.0)
    data = ranks.dataset(seed=44, n=6000, users=3000, parts=6)
    p = convert.params_from_reference(params)
    streamed = pool.run(ranks.aggregate, p, data, 13, eps=1e4,
                        env={CHUNK_ENV: "300"})
    single = pool.run(ranks.aggregate, p, data, 13, eps=1e4)
    one = pool.run(ranks.aggregate, p, data, 13, eps=1e4, mesh=False)
    assert streamed[0][1]["stream_batches"] >= 3
    assert "stream_batches" not in single[0][1]
    assert len(one[0][0]) == 6
    assert_same_release(streamed[0][0], single[0][0])
    assert_same_release(streamed[0][0], one[0][0])


def test_killed_stream_resumes_bit_equal(pool, tmp_path):
    """A mesh stream killed at batch 2 resumes from the checkpoint (written
    by the rank at position 0, read by every rank) to the bits of an
    unbroken run."""
    params, data = _percentile_case()
    p = convert.params_from_reference(params)
    env = {CHUNK_ENV: "400"}
    path = str(tmp_path / "mesh.ckpt")
    whole = pool.run(ranks.aggregate, p, data, 21, eps=4.0, env=env)
    killed = pool.run(ranks.aggregate, p, data, 21, eps=4.0, env=env,
                      checkpoint=path, fail_chunks=(2,))
    assert [k[0] for k in killed] == ["killed"] * N_RANKS
    assert os.path.exists(path)
    resumed = pool.run(ranks.aggregate, p, data, 21, eps=4.0, env=env,
                       checkpoint=path)
    for r in resumed:
        # The serial stream folds one batch behind its launches: at the
        # kill in batch 2's launch only batch 0 is folded and saved.
        assert r[1]["stream_resumed_from"] == 1
        assert_same_release(r[0], whole[0][0])
    assert not os.path.exists(path)
