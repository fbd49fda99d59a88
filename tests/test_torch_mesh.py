"""The port's fused path on a 4-rank gloo mesh against the JAX package's
``JaxBackend(mesh=make_mesh(4))``, bit for bit, on the CPU.

Each case runs ``DPEngine`` on every rank of one pool of 4 ranks
(``parallel.launch``, reused by the whole module) and the JAX package's
engine on its 4-device CPU mesh in this process, on the same numpy data
and seed. Every payload that crosses ranks is exact int32 data, so the
int32 accumulators, the kept set and every released float64 must match,
and every rank must return the same release. Ports the mesh cases of
``tests/test_jax_engine.py`` (``TestShardedMultiChip*``,
``TestPartitionAxisSharding``, ``TestFusedSelectPartitions::test_on_mesh``),
``tests/test_walk.py``'s three-way parity and
``tests/test_vector_fx.py``'s mesh case. Where the caps do not bind, the
port's mesh also equals its single device.
"""

import numpy as np
import pytest

import jax

import pipelinedp_tpu as pdp
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.backends import JaxBackend
from pipelinedp_tpu.ops import noise as jnoise
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.parallel import sharded_fused_aggregate as jax_sharded

from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.parallel import launch

import test_torch_mesh_ranks as ranks

M = pdp.Metrics
PSS = pdp.PartitionSelectionStrategy
N_RANKS = 4
VEC_ENV = "PIPELINEDP_TPU_VECTOR_ACCUMULATOR"


@pytest.fixture(scope="module")
def pool():
    return ranks.shared_pool()


def jax_run(params, data, seed, eps=1.0, delta=1e-6, public=None,
            mesh=True, select=False):
    """The JAX package's release on its 4-device mesh (or one device)."""
    jnoise.seed_host_rng(0)
    ds = pdp.ArrayDataset(privacy_ids=data[0], partition_keys=data[1],
                          values=data[2])
    acc = pdp.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    backend = JaxBackend(mesh=jax_make_mesh(N_RANKS) if mesh else None,
                         rng_seed=seed)
    engine = pdp.DPEngine(acc, backend)
    if select:
        res = engine.select_partitions(ds, params, pdp.DataExtractors())
    else:
        res = engine.aggregate(ds, params, pdp.DataExtractors(),
                               public_partitions=public)
    acc.compute_budgets()
    return sorted(res) if select else ranks.released(res)


def port_run(pool, params, data, seed, env=None, **kw):
    """Every rank's release; asserts they agree and returns rank 0's."""
    outs = pool.run(ranks.aggregate, convert.params_from_reference(params),
                    data, seed, env=env, **kw)
    first = outs[0][0]
    for other in outs[1:]:
        assert_same_release(other[0], first)
    return outs


def assert_same_release(got, want):
    """The kept set and every released value, exactly."""
    if isinstance(want, list):
        assert got == want
        return
    assert set(got) == set(want), sorted(set(got) ^ set(want))[:10]
    for k in want:
        assert set(got[k]) == set(want[k])
        for f in want[k]:
            np.testing.assert_array_equal(got[k][f], want[k][f],
                                          err_msg=f"{k}.{f}")


def _params(**kw):
    base = dict(max_partitions_contributed=2,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)
    base.update(kw)
    return pdp.AggregateParams(**base)


# Each case: (params, dataset keyword arguments, public partitions,
# eps). The caps bind in every case, so the ranks' per-position bounding
# keys are exercised.
CASES = {
    "count_sum_mean": (_params(metrics=[M.COUNT, M.SUM, M.MEAN]), {},
                       None, 1.0),
    "variance": (_params(metrics=[M.VARIANCE, M.PRIVACY_ID_COUNT]), {},
                 None, 1.0),
    "laplace_thresholding": (_params(
        metrics=[M.COUNT], partition_selection_strategy=(
            PSS.LAPLACE_THRESHOLDING), pre_threshold=3), {}, None, 1.0),
    "gaussian_thresholding": (_params(
        metrics=[M.SUM], partition_selection_strategy=(
            PSS.GAUSSIAN_THRESHOLDING)), {}, None, 1.0),
    "public_partitions": (_params(metrics=[M.COUNT, M.SUM]), {},
                          list(range(0, 50, 2)), 1.0),
    "max_contributions": (pdp.AggregateParams(
        metrics=[M.COUNT, M.SUM], max_contributions=3, min_value=-2.0,
        max_value=7.5), {}, None, 1.0),
    "per_partition_sum_bounds": (pdp.AggregateParams(
        metrics=[M.SUM, M.COUNT], max_partitions_contributed=2,
        max_contributions_per_partition=3, min_sum_per_partition=-1.0,
        max_sum_per_partition=12.0), {}, None, 1.0),
    "bounds_enforced": (_params(metrics=[M.COUNT, M.SUM],
                                contribution_bounds_already_enforced=True),
                        {"enforced": True}, None, 1.0),
    "uneven_shards": (_params(metrics=[M.COUNT, M.SUM],
                              max_partitions_contributed=3,
                              max_contributions_per_partition=10),
                      {"users": 60, "n": 900, "parts": 5, "zipf": 1.1},
                      None, 20.0),
    "percentile_walk": (_params(
        metrics=[M.COUNT, M.PERCENTILE(50), M.PERCENTILE(90),
                 M.PERCENTILE(99)], max_contributions_per_partition=4),
        {"n": 6000, "parts": 20}, None, 4.0),
    "percentile_variance": (_params(
        metrics=[M.PERCENTILE(10), M.PERCENTILE(50), M.VARIANCE],
        max_partitions_contributed=3), {"n": 5000, "parts": 24}, None,
        3.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_release_bit_equal_to_jax_mesh(pool, case):
    params, data_kw, public, eps = CASES[case]
    data = ranks.dataset(seed=len(case), **data_kw)
    want = jax_run(params, data, 17, eps=eps, public=public)
    outs = port_run(pool, params, data, 17, eps=eps, public=public)
    assert len(want) > 2, "a case must keep several partitions"
    assert_same_release(outs[0][0], want)


def test_vector_sum_fx_bit_equal_to_jax_mesh(pool, monkeypatch):
    """VECTOR_SUM under the fixed-point lanes (K2 on each rank's rows),
    the port of ``tests/test_vector_fx.py``'s mesh case."""
    params = pdp.AggregateParams(
        metrics=[M.VECTOR_SUM], max_partitions_contributed=2,
        max_contributions_per_partition=2, vector_size=6,
        vector_max_norm=3.0, vector_norm_kind=pdp.NormKind.L2)
    data = ranks.dataset(seed=5, vector=6)
    monkeypatch.setenv(VEC_ENV, "fx")
    want = jax_run(params, data, 23, eps=2.0)
    outs = port_run(pool, params, data, 23, eps=2.0, env={VEC_ENV: "fx"})
    assert_same_release(outs[0][0], want)


@pytest.mark.parametrize("strategy", [PSS.TRUNCATED_GEOMETRIC,
                                      PSS.LAPLACE_THRESHOLDING])
def test_select_partitions_bit_equal_to_jax_mesh(pool, strategy):
    params = pdp.SelectPartitionsParams(max_partitions_contributed=2,
                                        partition_selection_strategy=strategy)
    data = ranks.dataset(seed=9, n=5000, parts=60)
    want = jax_run(params, data, 41, select=True)
    outs = port_run(pool, params, data, 41, select=True)
    assert len(want) > 5
    assert outs[0][0] == want


def _sharded_inputs(params, data, P=None):
    enforced = params.contribution_bounds_already_enforced
    enc = je.encode(je.ArrayDataset(*data), None, None, None,
                    require_pid=not enforced)
    cfg_j = je.FusedConfig.from_params(params, public=False)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=False)
    P = P or je._pad_pow2(len(enc.pk_vocab))
    fx_bits = je._fx_plan(enc.n_rows)[0]
    keep_table, thr, s_scale, min_count = je.selection_inputs(
        cfg_j, 1e5, 1e-6, None)
    scales = np.zeros(0, np.float32)
    return enc, cfg_j, cfg_t, P, fx_bits, (scales, keep_table, thr,
                                           s_scale, min_count, 1.0)


@pytest.mark.parametrize("case", ["count_sum_mean", "variance",
                                  "max_contributions",
                                  "per_partition_sum_bounds"])
def test_accumulators_bit_equal_to_jax_mesh(pool, case):
    """The int32 accumulator columns and the keep vector of
    ``sharded_fused_aggregate``, gathered, against the JAX package's."""
    params, data_kw, _, _ = CASES[case]
    data = ranks.dataset(seed=3, **data_kw)
    enc, cfg_j, cfg_t, P, fx_bits, sel = _sharded_inputs(params, data)
    key = jax.random.PRNGKey(8)
    values = enc.values if cfg_j.needs_values else None
    keep_j, out_j = jax_sharded(jax_make_mesh(N_RANKS), cfg_j, P, enc.pid,
                                enc.pk, values, np.ones(enc.n_rows, bool),
                                *sel, key, fx_bits)
    outs = pool.run(ranks.sharded_partials, cfg_t, P, enc.pid, enc.pk,
                    values, np.asarray(key), fx_bits, *sel)
    for keep_t, out_t in outs:
        np.testing.assert_array_equal(keep_t, np.asarray(keep_j))
        assert sorted(out_t) == sorted(out_j)
        for name in out_j:
            np.testing.assert_array_equal(out_t[name], np.asarray(out_j[name]),
                                          err_msg=name)


def test_large_partition_axis(pool):
    """A partition axis of 2^18 over 4 ranks: owner blocks of 2^16, the
    counts exact against ``np.bincount`` and equal to the JAX mesh's."""
    P = 1 << 18
    rng = np.random.default_rng(1)
    n = 1 << 14
    pid = rng.integers(0, 2000, n)
    pk = rng.integers(0, P, n)
    params = pdp.AggregateParams(metrics=[M.COUNT],
                                 max_partitions_contributed=1 << 18,
                                 max_contributions_per_partition=8)
    cfg_j = je.FusedConfig.from_params(params, public=False)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=False)
    keep_table, thr, s_scale, min_count = je.selection_inputs(
        cfg_j, 1e5, 1e-6, None)
    key = jax.random.PRNGKey(5)
    pid32, pk32 = pid.astype(np.int32), pk.astype(np.int32)
    keep_j, out_j = jax_sharded(
        jax_make_mesh(N_RANKS), cfg_j, P, pid32, pk32, None,
        np.ones(n, bool), np.zeros(0, np.float32), keep_table, thr, s_scale,
        min_count, 1.0, key)
    outs = pool.run(ranks.sharded_partials, cfg_t, P, pid32, pk32, None,
                    np.asarray(key), 12, np.zeros(0, np.float32),
                    keep_table, thr, s_scale, min_count, 1.0)
    expected = np.bincount(pk, minlength=P)
    for keep_t, out_t in outs:
        np.testing.assert_array_equal(out_t["count"], expected)
        np.testing.assert_array_equal(out_t["count"],
                                      np.asarray(out_j["count"]))
        np.testing.assert_array_equal(keep_t, np.asarray(keep_j))


NONBINDING = {
    "scalars": _params(metrics=[M.COUNT, M.SUM, M.VARIANCE],
                       max_partitions_contributed=50,
                       max_contributions_per_partition=50),
    "percentiles": _params(metrics=[M.PERCENTILE(50), M.PERCENTILE(90),
                                    M.COUNT],
                           max_partitions_contributed=50,
                           max_contributions_per_partition=50),
}


@pytest.mark.parametrize("case", sorted(NONBINDING))
def test_mesh_equals_single_device_where_caps_do_not_bind(pool, case):
    """With caps above every unit's contribution, bounding keeps every row
    on any sharding, so the port's mesh equals its single device (and the
    JAX package's single device) bit for bit."""
    params = NONBINDING[case]
    data = ranks.dataset(seed=12, n=3000, users=2000, parts=12)
    single = pool.run(ranks.aggregate, convert.params_from_reference(params),
                      data, 29, eps=1e4, mesh=False)[0][0]
    mesh = port_run(pool, params, data, 29, eps=1e4)[0][0]
    assert len(single) > 5
    assert_same_release(mesh, single)
    assert_same_release(mesh, jax_run(params, data, 29, eps=1e4,
                                      mesh=False))


def test_ledger_fingerprint_keys_the_mesh_shape(pool):
    """A traced run's ledger entry is keyed on the mesh it ran on, as the
    JAX package's is."""
    from pipelinedp_tpu import obs as jobs
    want = jobs.environment_fingerprint(
        mesh=jax_make_mesh(N_RANKS))["mesh_shape"]
    assert want == {"data": N_RANKS}
    assert pool.run(ranks.mesh_fingerprint) == [want] * N_RANKS


def test_backend_reports_mesh_and_events(pool):
    """``TorchBackend(mesh=...)`` runs (it used to raise); the
    ``backend.created`` and ``mesh.created`` events carry the JAX
    package's fields."""
    from pipelinedp_tpu import obs as jobs
    params = _params(metrics=[M.COUNT])
    data = ranks.dataset(seed=2)
    jobs.reset()
    jax_run(params, data, 3)
    jev = {e["name"]: e for e in jobs.ledger().snapshot()["events"]
           if e["name"] in ("mesh.created", "backend.created")}
    outs = pool.run(ranks.aggregate, convert.params_from_reference(params),
                    data, 3)
    for _, _, _, events in outs:
        tev = {e["name"]: e for e in events}
        for name in ("mesh.created", "backend.created"):
            want = {k: v for k, v in jev[name].items()
                    if k not in ("ts", "device")}
            got = {k: v for k, v in tev[name].items()
                   if k not in ("ts", "device")}
            assert got == want, name
