"""The utility-analysis sweep and sketch-first heavy hitters on a 4-rank
gloo mesh, on the CPU.

The sweep splits each chunk's configurations over the ranks (K5 on each
rank's slice); it is held to the port's single device bit for bit (the
JAX package's own mesh sweep case,
``TestMegasweepWidthParity::test_walked_vs_batched_bit_identical_on_mesh``,
is intermittent). Sketch-first bins each rank's slice of every chunk and
runs phase 2 on the mesh: it is held to the JAX package's sketch-first on
``make_mesh(4)``, and with every bucket kept to the dense mesh path
(``tests/test_sketch.py::TestEndToEnd::test_parity_with_dense_8_device_mesh``
on 4 ranks).
"""

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu.backends import JaxBackend
from pipelinedp_tpu.parallel import make_mesh as jax_make_mesh
from pipelinedp_tpu.sketch import SketchParams as JaxSketchParams

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import analysis as tan
from pipelinedp_tpu_torch.parallel import launch

import test_torch_mesh_ranks as ranks
from test_torch_mesh import assert_same_release, N_RANKS

M = pdp.Metrics
BATCH_ENV = "PIPELINEDP_TPU_SWEEP_CONFIG_BATCH"


@pytest.fixture(scope="module")
def pool():
    return ranks.shared_pool()


def _sweep_options(metrics=("COUNT", "SUM"), **multi):
    multi = multi or dict(max_partitions_contributed=[1, 2, 3, 4, 5, 6],
                          max_contributions_per_partition=[1, 2, 1, 3, 2,
                                                           4])
    return tan.UtilityAnalysisOptions(
        epsilon=2.0, delta=1e-6,
        aggregate_params=pdt.AggregateParams(
            metrics=[getattr(pdt.Metrics, m) for m in metrics],
            max_partitions_contributed=2,
            max_contributions_per_partition=2, min_sum_per_partition=0.0,
            max_sum_per_partition=8.0),
        multi_param_configuration=tan.MultiParameterConfiguration(**multi))


def _cols(n=3000, users=300, parts=30, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, users, n), rng.integers(0, parts, n),
            rng.uniform(0, 5, n))


@pytest.mark.parametrize("batch", ["0", "4"])
@pytest.mark.parametrize("public", [False, True])
def test_sweep_on_mesh_equals_single_device(pool, batch, public):
    """Each chunk's configs split over the ranks; ``batch`` 4 pins one
    config per rank per chunk (several chunks), 0 the auto width."""
    opts = _sweep_options()
    cols = _cols(seed=3)
    parts = list(range(0, 40, 3)) if public else None
    env = {BATCH_ENV: batch}
    mesh = pool.run(ranks.sweep, opts, cols, parts, env=env)
    single = pool.run(ranks.sweep, opts, cols, parts, mesh=False,
                      env=env)[0]
    for got in mesh:
        assert got[0] == single[0]
        assert got[2] % N_RANKS == 0
    if batch == "4":
        assert mesh[0][3] > 1


def test_sweep_per_partition_rows_on_mesh(pool):
    """``return_per_partition`` gathers the [P, Cc] blocks along their
    configuration axis."""
    opts = _sweep_options(metrics=("COUNT",))
    cols = _cols(seed=4)
    env = {BATCH_ENV: "4"}
    mesh = pool.run(ranks.sweep, opts, cols, None, True, env=env)
    single = pool.run(ranks.sweep, opts, cols, None, True, mesh=False,
                      env=env)[0]
    for got in mesh:
        assert got[:2] == single[:2]


def _sketch_cols(n=6000, n_users=500, n_keys=80, seed=1, zipf=1.4):
    rng = np.random.default_rng(seed)
    raw = rng.zipf(zipf, n) % n_keys
    return (rng.integers(0, n_users, n),
            np.char.add("key/", raw.astype("U6")),
            rng.uniform(0.0, 10.0, n))


def _sketch_params(mod):
    return mod.AggregateParams(
        metrics=[mod.Metrics.COUNT, mod.Metrics.SUM],
        max_partitions_contributed=3, max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0)


SKETCH = dict(eps=2.0, delta=1e-6, width=1024, depth=2, candidate_cap=64,
              chunk_rows=2000)
KEEP_ALL = dict(eps=1e6, delta=1e-6, width=2048, depth=2,
                candidate_cap=2048, threshold=0.5, chunk_rows=2000)


@pytest.mark.parametrize("backend", ["matmul", "xla"])
def test_sketch_first_bit_equal_to_jax_mesh(pool, backend):
    cols = _sketch_cols(seed=5)
    sk = dict(SKETCH, backend=backend)
    acc = pdp.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = pdp.DPEngine(acc, JaxBackend(mesh=jax_make_mesh(N_RANKS),
                                          rng_seed=7))
    res = engine.aggregate(
        pdp.ArrayDataset(privacy_ids=cols[0], partition_keys=cols[1],
                         values=cols[2]), _sketch_params(pdp),
        pdp.DataExtractors(), sketch_first=JaxSketchParams(**sk))
    acc.compute_budgets()
    want = ranks.released(res)
    outs = pool.run(ranks.sketch_first, _sketch_params(pdt), sk, cols, 7)
    assert len(want) > 3
    for got, events in outs:
        assert_same_release(got, want)
        assert events and events[0]["devices"] == N_RANKS


def test_sketch_first_mesh_equals_single_device_where_caps_do_not_bind(
        pool):
    """Caps above every user's contribution: phase 2's bounding keeps every
    row on any sharding, so sketch-first on the mesh releases one
    device's bits."""
    cols = _sketch_cols(seed=6, n=4000)
    params = pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
        max_partitions_contributed=80, max_contributions_per_partition=60,
        min_value=0.0, max_value=10.0)
    # Phase 1 bounds by the same L0 (80): its own eps must cover it.
    sk = dict(SKETCH, eps=1e4)
    mesh = pool.run(ranks.sketch_first, params, sk, cols, 17, eps=1e5)
    single = pool.run(ranks.sketch_first, params, sk, cols, 17, eps=1e5,
                      mesh=False)[0][0]
    assert len(single) > 3
    for got, _ in mesh:
        assert_same_release(got, single)


def test_keep_all_sketch_equals_dense_on_mesh(pool):
    """Every populated bucket kept: the candidate rows are the input rows,
    and sketch-first on the mesh equals the dense mesh path."""
    cols = _sketch_cols(seed=2)
    params = _sketch_params(pdt)
    sketchy = pool.run(ranks.sketch_first, params, KEEP_ALL, cols, 13)
    dense = pool.run(ranks.sketch_first, params, KEEP_ALL, cols, 13,
                     dense=True)
    assert len(dense[0][0]) > 0
    for (got, _), (want, _) in zip(sketchy, dense):
        assert_same_release(got, want)
