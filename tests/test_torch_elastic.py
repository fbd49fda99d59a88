"""The port's elastic mesh on gloo ranks on the CPU, against the JAX
package, bit for bit.

Ports ``tests/test_faults.py::TestElasticMeshRecovery`` to four ranks,
``tests/test_topology.py::TestElasticShrinkUnderHier`` and
``TestTopologyRegistry::test_reform_preserves_hier_within_hosts`` as
hier(2,2) -> hier(2,1), and the two-process shape of
``tests/test_multihost.py::test_elastic_reshard_resume_parity_across_process_loss``.

An injected ``DeviceLost`` (every rank holds the plan through
``PIPELINEDP_TPU_FAULTS`` and raises at the same dispatch) is the JAX
package's single-controller loss: the port's four ranks shrink as its
``make_mesh(4)`` does, so the port's elastic release equals the JAX
package's own elastic run with the caps binding, and, where they do not
bind, its clean ``make_mesh(k)`` run at the surviving shape. A rank that
really dies (``os._exit`` on its own chunk fault, or inside an
all-reduce) is found by the survivors' beat files; they agree on their
set, re-form a group of their own and resume from the last checkpoint,
that of position 0 when the writer itself died.
"""

import contextlib
import os

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu.backends import JaxBackend
from pipelinedp_tpu.ingest import assign as jassign
from pipelinedp_tpu.ops import noise as jnoise
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.resilience import faults as jfaults

from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch.ingest import assign as tassign
from pipelinedp_tpu_torch.parallel import launch
from pipelinedp_tpu_torch.resilience import checkpoint as tckpt
from pipelinedp_tpu_torch.resilience import faults as tfaults

import test_torch_elastic_ranks as eranks
import test_torch_mesh_ranks as ranks
from test_torch_mesh import assert_same_release

M = pdp.Metrics
CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"
VEC_ENV = "PIPELINEDP_TPU_VECTOR_ACCUMULATOR"
EXECUTOR_ENV = "PIPELINEDP_TPU_INGEST_EXECUTOR"
FAULTS_ENV = tfaults.ENV_VAR
#: Seconds one call of an elastic pool may take, and its collectives'
#: timeout (what a survivor stuck in an all-reduce with a dead peer waits).
DEADLINE_S = 120
COLLECTIVE_TIMEOUT_S = 20.0


class BoundedPool:
    """The test process's shared pool, each call under this file's
    deadline."""

    def run(self, fn, *args, **kw):
        kw.setdefault("deadline_s", DEADLINE_S)
        return ranks.shared_pool().run(fn, *args, **kw)


@pytest.fixture(scope="module")
def pool():
    return BoundedPool()


@contextlib.contextmanager
def elastic_pool(n=4):
    """A fresh elastic pool of ``n`` gloo ranks (its ranks may die)."""
    saved = {k: os.environ.pop(k) for k in list(os.environ)
             if k.startswith("PIPELINEDP_TPU_")}
    try:
        p = launch.RankPool(n, threads=ranks.RANK_THREADS,
                            deadline_s=DEADLINE_S,
                            timeout_s=COLLECTIVE_TIMEOUT_S, elastic=True)
        p.start()
    finally:
        os.environ.update(saved)
    try:
        yield p
    finally:
        p.close()


def _data(seed=8, n=14_000, users=2_000, parts=12, vector=None):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = rng.integers(0, parts, n)
    values = (rng.uniform(-1.0, 1.0, (n, vector)) if vector
              else rng.uniform(0.0, 10.0, n))
    return pid, pk, values


def _params(parts=12, binding=False):
    if binding:
        return pdp.AggregateParams(
            metrics=[M.COUNT, M.SUM], max_partitions_contributed=2,
            max_contributions_per_partition=3, min_value=0.0,
            max_value=10.0)
    return pdp.AggregateParams(
        metrics=[M.COUNT, M.SUM], max_partitions_contributed=parts,
        max_contributions_per_partition=50, min_value=0.0, max_value=10.0)


def jax_stream(params, data, seed, n_dev, plan=None, checkpoint=None,
               eps=1e4):
    """The JAX package's streamed release on its ``make_mesh(n_dev)``
    (with ``plan`` injected), and its timings."""
    jnoise.seed_host_rng(0)
    ds = pdp.ArrayDataset(privacy_ids=data[0], partition_keys=data[1],
                          values=data[2])
    acc = pdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    engine = pdp.DPEngine(acc, JaxBackend(mesh=jax_make_mesh(n_dev),
                                          rng_seed=seed,
                                          checkpoint=checkpoint))
    res = engine.aggregate(ds, params, pdp.DataExtractors())
    acc.compute_budgets()
    ctx = (jfaults.injected_faults(plan) if plan is not None
           else contextlib.nullcontext())
    with ctx:
        out = ranks.released(res)
    return out, res.timings


def _survivors(outs, n):
    """The results of the ranks that finished (every one the same), after
    checking that exactly ``n`` did."""
    done = [o for o in outs if not isinstance(o, launch.RankGone)]
    assert len(done) == n, outs
    for other in done[1:]:
        assert_same_release(other[0], done[0][0])
    return done


class TestElasticMeshRecovery:

    @pytest.mark.parametrize("binding", [False, True])
    def test_single_device_loss_reforms_and_matches(self, pool, tmp_path,
                                                    monkeypatch, binding):
        monkeypatch.setenv(CHUNK_ENV, "500")
        # The JAX package's serial stream: where the caps bind, the
        # release depends on which batches the first mesh folded, and the
        # port's mesh stream is serial.
        monkeypatch.setenv(EXECUTOR_ENV, "0")
        data = _data()
        params = _params(binding=binding)
        plan = jfaults.FaultPlan(lose_device_chunks=(2,))
        want_elastic, jt = jax_stream(params, data, 21, 4, plan,
                                      checkpoint=str(tmp_path / "j.ckpt"))
        assert jt["stream_mesh_reshards"] == 1
        path = str(tmp_path / "t.ckpt")
        outs = pool.run(eranks.elastic_aggregate,
                        convert.params_from_reference(params), data, 21,
                        checkpoint=path,
                        env={CHUNK_ENV: "500", FAULTS_ENV: plan.to_env()})
        assert [o.reason for o in outs[2:]] == ["departed"] * 2
        got, timings, counters, events = _survivors(outs, 2)[0]
        assert timings["stream_mesh_reshards"] == 1
        (rec,) = timings["stream_reshard_history"]
        assert (rec["old_devices"], rec["new_devices"]) == (4, 2)
        assert rec["reason"] == "device_lost"
        assert rec["chunk"] == jt["stream_reshard_history"][0]["chunk"]
        assert timings["stream_resumed_from"] >= 1
        assert counters["checkpoint.elastic_adoptions"] == 1
        assert counters["mesh.reshards"] == 1
        assert [e["name"] for e in events].count("mesh.reshard") == 1
        assert not os.path.exists(path)
        assert_same_release(got, want_elastic)
        if not binding:
            clean, _ = jax_stream(params, data, 21, 2)
            assert_same_release(got, clean)

    def test_double_loss_shrinks_to_single_device(self, pool, tmp_path,
                                                  monkeypatch):
        """4 -> 2 -> 1: two reshard records, and the one rank left releases
        the bits of a clean one-device mesh."""
        monkeypatch.setenv(CHUNK_ENV, "500")
        monkeypatch.setenv(EXECUTOR_ENV, "0")
        data = _data(n=9_000)
        params = _params()
        plan = jfaults.FaultPlan(lose_device_chunks=(1, 3))
        clean, _ = jax_stream(params, data, 23, 1)
        want, _ = jax_stream(params, data, 23, 4, plan,
                             checkpoint=str(tmp_path / "j.ckpt"))
        outs = pool.run(eranks.elastic_aggregate,
                        convert.params_from_reference(params), data, 23,
                        checkpoint=str(tmp_path / "double.ckpt"),
                        env={CHUNK_ENV: "500", FAULTS_ENV: plan.to_env()})
        got, timings, _, _ = _survivors(outs, 1)[0]
        hist = timings["stream_reshard_history"]
        assert [(h["old_devices"], h["new_devices"]) for h in hist] == [
            (4, 2), (2, 1)]
        assert timings["stream_mesh_reshards"] == 2
        assert_same_release(got, clean)
        assert_same_release(got, want)

    def test_loss_on_last_mesh_reraises(self, pool, monkeypatch):
        """A one-rank mesh has nothing to re-form from: the third loss
        (4 -> 2 -> 1, then lost again) propagates."""
        outs = pool.run(eranks.elastic_aggregate,
                        convert.params_from_reference(_params()),
                        _data(n=9_000), 23,
                        env={CHUNK_ENV: "500", FAULTS_ENV: tfaults.FaultPlan(
                            lose_device_chunks=(0, 1, 2)).to_env()})
        assert [o.reason for o in outs[1:]] == ["departed"] * 3
        assert outs[0] == ("raised", "DeviceLost")

    def test_loss_without_fixed_seed_reraises(self, pool):
        """No fixed rng_seed: a replay would draw new noise, so the loss
        re-raises on every rank instead of re-forming."""
        outs = pool.run(eranks.elastic_aggregate,
                        convert.params_from_reference(_params()),
                        _data(n=5_000), None,
                        env={CHUNK_ENV: "500", FAULTS_ENV: tfaults.FaultPlan(
                            lose_device_chunks=(1,)).to_env()})
        assert outs == [("raised", "DeviceLost")] * 4

    @pytest.mark.parametrize("accumulator", ["fx", "f32"])
    def test_vector_sum_survives_mid_stream_shrink(self, pool, tmp_path,
                                                   monkeypatch, accumulator):
        """VECTOR_SUM shrinks 4 -> 2 mid-stream: under ``fx`` (K2's int32
        lanes) bit for bit against the JAX package's surviving shape and
        its own elastic run; under ``f32`` within rtol=1e-6 of the JAX
        package's elastic run, whose float32 sums group the rows as the
        port's do (a fresh run at the surviving shape shards the rows
        otherwise, and float32 sums follow the grouping)."""
        monkeypatch.setenv(CHUNK_ENV, "500")
        monkeypatch.setenv(VEC_ENV, accumulator)
        monkeypatch.setenv(EXECUTOR_ENV, "0")
        plan = jfaults.FaultPlan(lose_device_chunks=(2,))
        parts, d = 12, 16
        data = _data(seed=29, parts=parts, vector=d)
        params = pdp.AggregateParams(
            metrics=[M.VECTOR_SUM], max_partitions_contributed=parts,
            max_contributions_per_partition=50, vector_size=d,
            vector_max_norm=4.0, vector_norm_kind=pdp.NormKind.L2)
        want, _ = jax_stream(params, data, 31, 4, plan,
                             checkpoint=str(tmp_path / "j.ckpt"))
        outs = pool.run(eranks.elastic_aggregate,
                        convert.params_from_reference(params), data, 31,
                        checkpoint=str(tmp_path / "vec.ckpt"),
                        env={CHUNK_ENV: "500", VEC_ENV: accumulator,
                             FAULTS_ENV: plan.to_env()})
        got, timings, _, _ = _survivors(outs, 2)[0]
        (rec,) = timings["stream_reshard_history"]
        assert (rec["old_devices"], rec["new_devices"]) == (4, 2)
        assert timings["stream_resumed_from"] >= 1
        if accumulator == "fx":
            assert_same_release(got, want)
            assert_same_release(got, jax_stream(params, data, 31, 2)[0])
        else:
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k]["vector_sum"],
                                           want[k]["vector_sum"], rtol=1e-6)


class TestElasticShrinkUnderHier:

    def test_reform_preserves_hier_within_hosts(self, pool):
        """4 -> 2 -> 1 under hier(2,2): the divisor prefix of the
        interleave [0, 2, 1, 3] is [0, 2], hier(2,1) (each host sheds its
        highest slot); then [0], flat. The JAX package's mesh reforms
        through the same positions, and every re-formed group sums."""
        from pipelinedp_tpu.parallel import sharded as jpsh
        env = {"PIPELINEDP_TPU_MESH_TOPOLOGY": "hier",
               "PIPELINEDP_TPU_MESH_HOSTS": "2"}
        outs = pool.run(eranks.reform_positions, 2, env=env)
        first, events = outs[0]
        assert [s[0] for s in first] == [[0, 2, 1, 3], [0, 2], [0]]
        assert [s[1] for s in first] == [("hier", 2, 2, True),
                                         ("hier", 2, 1, False),
                                         ("flat", 1, 1, False)]
        assert [s[2] for s in first] == [10, 1 + 3, 1]
        assert [e["topology"] for e in events] == ["hier", "flat"]
        assert outs[2][0][-1] == "departed"     # rank 2 left at 2 -> 1
        assert outs[1][0][-1] == "departed"     # ranks 1, 3 at 4 -> 2
        assert outs[3][0][-1] == "departed"
        with pytest.MonkeyPatch.context() as mp:
            for k, v in env.items():
                mp.setenv(k, v)
            jmesh = jpsh.make_mesh(4)
        ids = [[d.id for d in jmesh.devices.ravel()]]
        jm = jmesh
        for _ in range(2):
            jm = jpsh.reform_mesh(jm)
            ids.append([d.id for d in jm.devices.ravel()])
        assert ids == [s[0] for s in first]

    def test_loss_under_hier_matches_flat_surviving_shape(
            self, pool, tmp_path, monkeypatch):
        monkeypatch.setenv(CHUNK_ENV, "500")
        data = _data()
        params = _params()
        clean, _ = jax_stream(params, data, 21, 2)
        outs = pool.run(eranks.elastic_aggregate,
                        convert.params_from_reference(params), data, 21,
                        checkpoint=str(tmp_path / "topo.ckpt"),
                        env={CHUNK_ENV: "500",
                             "PIPELINEDP_TPU_MESH_TOPOLOGY": "hier",
                             "PIPELINEDP_TPU_MESH_HOSTS": "2",
                             FAULTS_ENV: tfaults.FaultPlan(
                                 lose_device_chunks=(2,)).to_env()})
        assert [o.reason for o in (outs[1], outs[3])] == ["departed"] * 2
        got, timings, counters, events = _survivors(outs, 2)[0]
        reformed = [e for e in events if e["name"] == "mesh.reformed"]
        assert [(e["topology"], e["hosts"], e["per_host"])
                for e in reformed] == [("hier", 2, 1)]
        assert counters["checkpoint.elastic_adoptions"] == 1
        assert timings["stream_mesh_reshards"] == 1
        assert_same_release(got, clean)


class TestRealProcessLoss:
    """Ranks that really die. The survivors find the loss through the beat
    files (at their next gate, or by confirming a collective's failure),
    agree on their set, re-form over the survivors with a group of their
    own, and resume from the last complete checkpoint."""

    def _case(self, monkeypatch, tmp_path):
        monkeypatch.setenv(CHUNK_ENV, "500")
        data = _data(seed=12)
        params = _params()
        clean, _ = jax_stream(params, data, 11, 2)
        return data, params, clean

    @pytest.mark.parametrize("victim", [3, 0])
    def test_dead_rank_reshards_4_to_2(self, tmp_path, monkeypatch, victim):
        """A rank that is not the checkpoint's writer (3), and the writer
        itself (position 0): three survivors shrink to two (the divisor
        rule), the third leaves, and the release equals the surviving
        shape."""
        data, params, clean = self._case(monkeypatch, tmp_path)
        path = str(tmp_path / "dead.ckpt")
        with elastic_pool() as p:
            outs = p.run(eranks.elastic_aggregate,
                         convert.params_from_reference(params), data, 11,
                         checkpoint=path, env={CHUNK_ENV: "500"},
                         rank_env={victim: {FAULTS_ENV: "fail_chunks=2"}})
        assert outs[victim] == launch.RankGone(victim, "died")
        assert outs[victim].detail == str(eranks.DIE_CODE)
        gone = [o for o in outs if isinstance(o, launch.RankGone)]
        assert sorted(o.reason for o in gone) == ["departed", "died"]
        got, timings, counters, events = _survivors(outs, 2)[0]
        (rec,) = timings["stream_reshard_history"]
        assert (rec["old_devices"], rec["new_devices"]) == (4, 2)
        assert rec["reason"] == "participant_lost"
        assert timings["stream_resumed_from"] >= 1
        assert counters["mesh.participant_lost"] >= 1
        assert len(timings["stream_recover_s"]) == 1
        assert len(timings["stream_reform_s"]) == 1
        assert timings["stream_reform_s"][0] <= timings["stream_recover_s"][0]
        assert not os.path.exists(path)
        assert_same_release(got, clean)

    def test_rank_dies_inside_an_all_reduce(self, tmp_path, monkeypatch):
        """Rank 2 passes its gate and dies in batch 2's all-reduce: its
        peers' collective fails (at once, or at the collective timeout),
        ``collective_failure_to_loss`` proves the death from the beat
        files, and the mesh re-forms."""
        data, params, clean = self._case(monkeypatch, tmp_path)
        with elastic_pool() as p:
            outs = p.run(eranks.elastic_aggregate,
                         convert.params_from_reference(params), data, 11,
                         checkpoint=str(tmp_path / "coll.ckpt"),
                         env={CHUNK_ENV: "500"}, die_in_collective=(2, 3))
        assert outs[2] == launch.RankGone(2, "died")
        got, timings, counters, _ = _survivors(outs, 2)[0]
        (rec,) = timings["stream_reshard_history"]
        assert rec["reason"] == "participant_lost"
        assert "collective" in rec["detail"] or "lost" in rec["detail"]
        assert_same_release(got, clean)

    def test_two_ranks_lose_one_through_the_fault_variable(
            self, tmp_path, monkeypatch):
        """The JAX multihost test's shape: two ranks, the victim's plan in
        its own ``PIPELINEDP_TPU_FAULTS``; the survivor goes on alone and
        releases the bits of a clean one-device mesh, resumed from the
        checkpoint."""
        monkeypatch.setenv(CHUNK_ENV, "500")
        data = _data(seed=0, n=20_000, parts=40)
        params = pdp.AggregateParams(
            metrics=[M.COUNT, M.SUM], max_partitions_contributed=50,
            max_contributions_per_partition=50, min_value=0.0,
            max_value=10.0)
        clean, _ = jax_stream(params, data, 11, 1)
        with elastic_pool(2) as p:
            outs = p.run(eranks.elastic_aggregate,
                         convert.params_from_reference(params), data, 11,
                         checkpoint=str(tmp_path / "two.ckpt"),
                         env={CHUNK_ENV: "500"},
                         rank_env={1: {FAULTS_ENV: tfaults.FaultPlan(
                             fail_chunks=(2,)).to_env()}})
        assert outs[1] == launch.RankGone(1, "died")
        got, timings, _, events = outs[0]
        assert timings["stream_batches"] >= 3
        (rec,) = timings["stream_reshard_history"]
        assert (rec["old_devices"], rec["new_devices"]) == (2, 1)
        assert rec["reason"] == "participant_lost"
        assert timings["stream_resumed_from"] >= 1
        assert [e["name"] for e in events].count("mesh.reshard") == 1
        assert_same_release(got, clean)


class TestAssignAndCheckpoint:

    @pytest.mark.parametrize("shape,n_new", [((5, 4), 2), ((3, 8), 4),
                                             ((7, 4), 1), ((1, 2), 1)])
    def test_regroup_cells_matches_jax(self, shape, n_new):
        counts = np.random.default_rng(sum(shape)).integers(0, 1000, shape)
        np.testing.assert_array_equal(tassign.regroup_cells(counts, n_new),
                                      jassign.regroup_cells(counts, n_new))

    def test_regroup_cells_refuses_a_non_divisor(self):
        with pytest.raises(ValueError):
            tassign.regroup_cells(np.ones((2, 4), np.int64), 3)
        with pytest.raises(ValueError):
            jassign.regroup_cells(np.ones((2, 4), np.int64), 3)

    def test_assign_and_reshards_round_trip(self, tmp_path):
        store = tckpt.CheckpointStore(str(tmp_path / "a.ckpt"))
        assign = {"n_batches": 7, "n_dev": 4, "num_partitions": 16,
                  "fx_bits": 12}
        reshards = [{"old_devices": 4, "new_devices": 2,
                     "reason": "participant_lost", "chunk": -1,
                     "detail": "lost"}]
        store.save(tckpt.StreamCheckpoint(
            "fp", 3, {"acc:count": np.arange(4)}, assign=assign,
            reshards=reshards))
        back = store.load()
        assert back.assign == assign and back.reshards == reshards
        np.testing.assert_array_equal(back.arrays["acc:count"], np.arange(4))
        # The JSON meta carries the JAX package's field names: its store
        # reads the port's assignment and history.
        from pipelinedp_tpu.resilience.checkpoint import CheckpointStore
        jback = CheckpointStore(store.path).load()
        assert jback.assign == assign and jback.reshards == reshards
        plain = tckpt.CheckpointStore(str(tmp_path / "b.ckpt"))
        plain.save(tckpt.StreamCheckpoint("fp", 1, {}))
        assert plain.load().assign is None and plain.load().reshards == []
