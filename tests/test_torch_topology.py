"""Topology-aware collectives on the port's mesh: the two-axis ("dcn",
"ici") view of ``parallel/sharded.py``, held to the JAX package's
``tests/test_topology.py`` on 4 gloo ranks.

The hierarchical exchange (``mesh_topology=hier``) must give the flat
exchange's bits for every released value and kept set while moving fewer
bytes across the host boundary. Hosts are simulated with
``PIPELINEDP_TPU_MESH_HOSTS=2`` (two hosts of two ranks), and every case
is held to the JAX package's ``make_mesh(4)`` under the same environment:
the position order, the topology, the comms counters and the results.
``test_reform_preserves_hier_within_hosts`` and the elastic shrink under
``hier`` are in ``test_torch_elastic.py``.
"""

import contextlib
import os

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu import obs as jobs
from pipelinedp_tpu.parallel import sharded as jpsh

from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.obs import metrics as tmetrics
from pipelinedp_tpu_torch.obs import monitor as tmonitor
from pipelinedp_tpu_torch.parallel import launch
from pipelinedp_tpu_torch.parallel import sharded as psh
from pipelinedp_tpu_torch.sketch import device as sk_dev

import test_torch_mesh_ranks as ranks
from test_topology import _run_collective, _run_replicated
from test_torch_mesh import assert_same_release, jax_run, N_RANKS

TOPOLOGY_ENV = "PIPELINEDP_TPU_MESH_TOPOLOGY"
HOSTS_ENV = psh._MESH_HOSTS_ENV


@pytest.fixture(scope="module")
def pool():
    return ranks.shared_pool()


@pytest.fixture(autouse=True)
def _isolated_jax_topology_registry():
    """The JAX package registers each mesh's topology by device ids; a
    flat mesh with simulated hosts must not leak into other files."""
    saved = dict(jpsh._TOPOLOGIES)
    yield
    jpsh._TOPOLOGIES.clear()
    jpsh._TOPOLOGIES.update(saved)


def env_of(mode=None, hosts=None):
    return {TOPOLOGY_ENV: mode, HOSTS_ENV: None if hosts is None
            else str(hosts)}


@contextlib.contextmanager
def topology_env(mode=None, hosts=None):
    """The same variables in this process, for the JAX package's side."""
    pairs = env_of(mode, hosts)
    saved = {k: os.environ.get(k) for k in pairs}
    for k, v in pairs.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jax_mesh(mode=None, hosts=None):
    with topology_env(mode, hosts):
        return jpsh.make_mesh(N_RANKS)


def jax_topo(mesh):
    t = jpsh.topology_of(mesh)
    return (t.mode, t.n_hosts, t.per_host, t.simulated, t.hierarchical,
            t.multi_host)


def jax_ids(mesh):
    return [int(d.id) for d in mesh.devices.reshape(-1)]


# ---------------------------------------------------------------------------
# The registry: interleave order and fallbacks
# ---------------------------------------------------------------------------

class TestTopologyRegistry:

    @pytest.mark.parametrize("mode,hosts", [
        (None, None), ("hier", 2), ("hier", None), ("auto", 2),
        ("auto", None), ("flat", 2)])
    def test_position_order_and_topology_match_jax(self, pool, mode,
                                                   hosts):
        want = jax_mesh(mode, hosts)
        outs = pool.run(ranks.mesh_info, env=env_of(mode, hosts))
        for devices, topo, _, _, events in outs:
            assert devices == jax_ids(want)
            assert topo == jax_topo(want)
            created = [e for e in events if e["name"] == "mesh.created"]
            assert len(created) == 1

    def test_hier_interleaves_simulated_hosts(self, pool):
        outs = pool.run(ranks.mesh_info, env=env_of("hier", 2))
        devices, topo, _, _, _ = outs[0]
        # Position p = j*H + h holds host h's j-th rank: hosts are the
        # rank halves [0, 1] and [2, 3], interleaved.
        assert devices == [0, 2, 1, 3]
        assert topo[:4] == ("hier", 2, 2, True)
        t = psh.MeshTopology("hier", 2, 2, True)
        assert psh._ici_groups(t) == [[0, 2], [1, 3]]
        assert psh._dcn_groups(t) == [[0, 1], [2, 3]]
        # Each rank's subgroups, by global rank in member order.
        ici = {r: o[2] for r, o in enumerate(outs)}
        dcn = {r: o[3] for r, o in enumerate(outs)}
        assert ici == {0: [0, 1], 1: [0, 1], 2: [2, 3], 3: [2, 3]}
        assert dcn == {0: [0, 2], 2: [0, 2], 1: [1, 3], 3: [1, 3]}

    def test_ragged_hosts_fall_back_with_event(self, pool):
        outs = pool.run(ranks.mesh_info, True, env=env_of("hier", None))
        for devices, topo, _, _, events in outs:
            assert topo[0] == "flat"
            assert devices == [0, 1, 2, 3]
            fallback = [e for e in events
                        if e["name"] == "mesh.topology_fallback"]
            assert fallback and fallback[0]["reason"] == "ragged_hosts"
            assert fallback[0]["sizes"] == [1, 3]

    def test_no_mesh_is_one_flat_device(self):
        assert psh.topology_of(None).n_devices == 1
        assert psh.topology_of(None).mode == "flat"

    def test_created_event_matches_jax(self, pool):
        jobs.reset()
        jax_mesh("hier", 2)
        want = [e for e in jobs.ledger().snapshot()["events"]
                if e["name"] == "mesh.created"][0]
        outs = pool.run(ranks.mesh_info, env=env_of("hier", 2))
        got = [e for e in outs[0][4] if e["name"] == "mesh.created"][0]
        assert ({k: v for k, v in got.items() if k != "ts"} ==
                {k: v for k, v in want.items() if k != "ts"})


# ---------------------------------------------------------------------------
# Collective-level parity + the comms byte meter
# ---------------------------------------------------------------------------

def _data(cols, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 20, (N_RANKS, cols)).astype(np.int32)


def _jax_counters(fn):
    jobs.reset()
    out = fn()
    return out, {k: v for k, v in jobs.ledger().snapshot()["counters"].items()
                 if k.startswith("comms.")}


class TestCollectiveParity:

    def _both(self, pool, kind, x, mode, hosts, replicate=False):
        """(JAX result and comms counters, every rank's (result, counters,
        position))."""
        mesh = jax_mesh(mode, hosts)
        if kind == "scatter":
            body = lambda v, axis, topo: jpsh.scatter_to_owner(
                v, axis, dim=0, topo=topo)
            run = _run_collective
        elif kind == "gather":
            body = lambda v, axis, topo: jpsh.gather_blocks(
                v, axis, dim=0, topo=topo)
            run = _run_replicated
        else:
            body = lambda v, axis, topo: jpsh.combine_shards(
                v, axis, 0, True, topo=topo)
            run = _run_replicated
        want, jc = _jax_counters(lambda: run(mesh, x, body))
        outs = pool.run(ranks.collective, kind, x, replicate,
                        env=env_of(mode, hosts))
        return want, jc, outs

    @pytest.mark.parametrize("mode", ["flat", "hier"])
    def test_owner_scatter_bit_equal_and_counters_match(self, pool, mode):
        x = _data(N_RANKS * 288)
        want, jc, outs = self._both(pool, "scatter", x, mode, 2)
        full = x.sum(axis=0, dtype=np.int32)
        block = full.shape[0] // N_RANKS
        for got, counters, pos, _, _ in outs:
            np.testing.assert_array_equal(
                got, full[pos * block:(pos + 1) * block])
            np.testing.assert_array_equal(
                got, want[pos * block:(pos + 1) * block])
            assert counters == jc
        assert jc.get("comms.dcn_bytes", 0) > 0

    def test_hier_moves_fewer_dcn_bytes(self, pool):
        x = _data(N_RANKS * 160, seed=4)
        _, flat_c, flat = self._both(pool, "scatter", x, "flat", 2)
        _, hier_c, hier = self._both(pool, "scatter", x, "hier", 2)
        assert flat[0][1] == flat_c and hier[0][1] == hier_c
        assert hier_c["comms.dcn_bytes"] < flat_c["comms.dcn_bytes"]
        assert hier_c.get("comms.ici_bytes", 0) > 0
        assert hier_c["comms.collectives"] >= 2

    @pytest.mark.parametrize("mode", ["flat", "hier"])
    def test_replicating_psum_bit_equal(self, pool, mode):
        x = _data(N_RANKS * 40, seed=5)
        want, jc, outs = self._both(pool, "combine", x, mode, 2,
                                    replicate=True)
        for got, counters, _, _, _ in outs:
            np.testing.assert_array_equal(got,
                                          x.sum(axis=0, dtype=np.int32))
            np.testing.assert_array_equal(got, want)
            assert counters == jc

    def test_replicate_indivisible_block_falls_back_flat(self, pool):
        """A payload the per-host split cannot tile (size % per_host != 0)
        keeps the flat all-reduce."""
        x = _data(41, seed=6)
        want, jc, outs = self._both(pool, "combine", x, "hier", 2,
                                    replicate=True)
        for got, counters, _, _, _ in outs:
            np.testing.assert_array_equal(got,
                                          x.sum(axis=0, dtype=np.int32))
            assert counters == jc

    @pytest.mark.parametrize("mode", ["flat", "hier"])
    def test_gather_blocks_byte_identical(self, pool, mode):
        x = _data(64, seed=7)
        want, jc, outs = self._both(pool, "gather", x, mode, 2)
        for got, counters, _, _, _ in outs:
            np.testing.assert_array_equal(got, x.reshape(-1))
            np.testing.assert_array_equal(got, want)
            assert counters == jc

    def test_single_host_flat_records_no_dcn(self, pool):
        x = _data(N_RANKS * 96, seed=8)
        outs = pool.run(ranks.collective, "scatter", x,
                        env=env_of(None, None))
        for _, counters, _, _, _ in outs:
            assert counters.get("comms.dcn_bytes", 0) == 0
            assert counters.get("comms.ici_bytes", 0) > 0

    def test_repeat_records_nothing(self, pool):
        """A second exchange of the same site and shape records nothing, as
        a warm dispatch of a traced JAX program records nothing."""
        x = _data(N_RANKS * 72, seed=9)
        first = pool.run(ranks.collective, "scatter", x,
                         env=env_of(None, None))
        again = pool.run(ranks.collective, "scatter", x,
                         env=env_of(None, None))
        assert first[0][1].get("comms.collectives", 0) == 1
        assert again[0][1] == {}
        np.testing.assert_array_equal(again[0][0], first[0][0])


class TestCommsSurfaces:

    def test_metrics_endpoint_renders_comms_counters(self):
        from pipelinedp_tpu.obs import metrics as jmetrics
        counters = {"comms.collectives": 3, "comms.ici_bytes": 128,
                    "comms.dcn_bytes": 64}
        text = tmetrics.render_prometheus(counters)
        assert "pdp_comms_ici_bytes_total 128" in text
        assert "pdp_comms_dcn_bytes_total 64" in text
        assert "pdp_comms_collectives_total 3" in text
        comms = [ln for ln in text.splitlines() if "comms" in ln]
        assert comms == [ln for ln in
                         jmetrics.render_prometheus(counters).splitlines()
                         if "comms" in ln]

    def test_heartbeat_carries_comms_section(self, tmp_path):
        mon = tmonitor.Monitor(heartbeat_path=str(tmp_path / "hb.json"),
                               run_name="t")
        counters = {"comms.collectives": 5, "comms.ici_bytes": 1024,
                    "comms.dcn_bytes": 256}
        hb = mon._build_heartbeat(mon._t_start + 1.0, [], [], counters,
                                  False, 0.0)
        assert hb["comms"] == {"collectives": 5, "ici_bytes": 1024,
                               "dcn_bytes": 256}
        hb2 = mon._build_heartbeat(mon._t_start + 1.0, [], [], {}, False,
                                   0.0)
        assert "comms" not in hb2


# ---------------------------------------------------------------------------
# End-to-end engine parity: hier vs flat release bit-identity
# ---------------------------------------------------------------------------

def _engine_data(n=3000, parts=6, seed=5):
    rng = np.random.default_rng(seed)
    return (np.arange(n), np.arange(n) % parts, rng.uniform(0, 100, n))


def _engine_params():
    return pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM,
                 pdp.Metrics.PERCENTILE(50)],
        max_partitions_contributed=2, max_contributions_per_partition=4,
        min_value=0.0, max_value=100.0)


class TestEngineBitParity:
    """Real noise, real private selection, moderate eps: any grouping drift
    in the two-stage exchange would show as a float mismatch."""

    def test_hier_matches_flat_and_the_jax_mesh(self, pool):
        data, params = _engine_data(), _engine_params()
        p = convert.params_from_reference(params)
        flat = pool.run(ranks.aggregate, p, data, 20, eps=5.0,
                        env=env_of("flat", 2))
        hier = pool.run(ranks.aggregate, p, data, 20, eps=5.0,
                        env=env_of("hier", 2))
        with topology_env("hier", 2):
            want = jax_run(params, data, 20, eps=5.0)
        assert len(want) == 6
        for f, h in zip(flat, hier):
            assert_same_release(h[0], f[0])
            assert_same_release(h[0], want)
        assert (hier[0][2]["comms.dcn_bytes"] <
                flat[0][2]["comms.dcn_bytes"])

    def test_hier_knob_is_noop_on_one_rank(self):
        data, params = _engine_data(n=800), _engine_params()
        p = convert.params_from_reference(params)
        one = launch.run_ranks(1, ranks.aggregate, p, data, 20, eps=5.0,
                               env=env_of("hier", None), deadline_s=120,
                               threads=ranks.RANK_THREADS)[0]
        assert [e["topology"] for e in one[3]
                if e["name"] == "mesh.created"] == ["flat"]
        assert_same_release(one[0], jax_run(params, data, 20, eps=5.0,
                                            mesh=False))


# ---------------------------------------------------------------------------
# The sketch's sharded accumulation
# ---------------------------------------------------------------------------

class TestShardedSketchParity:

    def _buckets(self, depth=3, n=5000, width=512, seed=9):
        rng = np.random.default_rng(seed)
        return rng.integers(0, width, (depth, n)).astype(np.int32)

    @pytest.mark.parametrize("backend", ["matmul", "xla"])
    @pytest.mark.parametrize("mode", ["flat", "hier"])
    def test_accumulate_stream_matches_single_device(self, pool, backend,
                                                     mode):
        width = 512
        raw = self._buckets(n=7000, width=width, seed=10)
        want, chunks = ranks.accumulate_stream(raw, width, backend, 1500,
                                               mesh=False)
        assert chunks > 1
        outs = pool.run(ranks.accumulate_stream, raw, width, backend, 1500,
                        env=env_of(mode, 2))
        for got, got_chunks in outs:
            assert got_chunks == chunks
            np.testing.assert_array_equal(got, want)

    def test_pad_chunk_aligns_to_shard_blocks(self):
        from pipelinedp_tpu.sketch import device as jsk_dev
        raw = self._buckets(n=1000)
        out = sk_dev.pad_chunk(raw, n_shards=N_RANKS)
        unit = sk_dev.ROW_BLOCK * N_RANKS
        assert out.shape[1] % unit == 0
        np.testing.assert_array_equal(out[:, :1000], raw)
        assert (out[:, 1000:] == -1).all()
        np.testing.assert_array_equal(out, jsk_dev.pad_chunk(
            raw, n_shards=N_RANKS))
