"""Checkpoint and resume of the port's stream, and its pass-B sources, on
the CPU.

A run killed at a batch by the port's ``FaultPlan`` and resumed from its
checkpoint releases the bits of the uninterrupted run (and of the JAX
package's serial stream), serially and through the overlapped executor,
in pass A and in a percentile pass-B sweep; success clears the store; a
checkpoint of another run is refused. The three pass-B sources
(``device_cache``, ``hybrid``, ``reship``) are bit-identical, the hybrid
one with multi-tile sweeps too, and each reports its source and the bytes
it re-shipped (the pattern of ``tests/test_faults.py`` and
``tests/test_pass_b.py``). The utility-analysis sweep killed at a config
chunk (``check_sweep_config_chunk``) resumes from its ``.sweep`` checkpoint
and equals the unbroken sweep bit for bit; a checkpoint of another sweep is
refused.
"""

import os

import numpy as np
import pytest

import pipelinedp_tpu as pdp
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch.resilience import (CheckpointMismatch,
                                             CheckpointStore, ChunkFailure,
                                             FaultPlan, injected_faults)
from pipelinedp_tpu_torch.resilience import checkpoint as ckpt_mod
from pipelinedp_tpu_torch.resilience import faults

M = pdp.Metrics
CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"
CAP_ENV = "PIPELINEDP_TPU_SUBHIST_CAP"
SPAN = 256


@pytest.fixture(autouse=True)
def _tiny_chunks(monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
    monkeypatch.setenv(CHUNK_ENV, "997")
    monkeypatch.delenv(CAP_ENV, raising=False)
    monkeypatch.delenv("PIPELINEDP_TPU_CKPT_EVERY", raising=False)


def make_ds(seed=1, n=9_000, users=2_000, parts=12):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, users, n), rng.integers(0, parts, n),
            rng.uniform(0.0, 10.0, n))


SCALARS = pdp.AggregateParams(
    metrics=[M.COUNT, M.SUM, M.MEAN, M.PRIVACY_ID_COUNT],
    max_partitions_contributed=12, max_contributions_per_partition=50,
    min_value=0.0, max_value=10.0)
PERCENTILES = pdp.AggregateParams(
    metrics=[M.PERCENTILE(50), M.PERCENTILE(90), M.VARIANCE],
    max_partitions_contributed=4, max_contributions_per_partition=3,
    min_value=0.0, max_value=10.0)


def run_torch(ds, params, seed=42, public=None, **backend):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=5.0, total_delta=1e-6)
    engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed,
                                                **backend))
    result = engine.aggregate(convert.dataset_from_arrays(*ds),
                              convert.params_from_reference(params),
                              pdt.DataExtractors(),
                              public_partitions=public)
    acc.compute_budgets()
    rows = list(result)
    assert result.timings["stream_batches"] > 1
    return rows, result.timings


def run_jax(ds, params, seed=42, public=None):
    acc = pdp.NaiveBudgetAccountant(total_epsilon=5.0, total_delta=1e-6)
    result = pdp.DPEngine(acc, JaxBackend(rng_seed=seed)).aggregate(
        je.ArrayDataset(*ds), params, pdp.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    return list(result), result.timings


def assert_bit_identical(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a._fields == b._fields
        assert (np.asarray(a, np.float64).tobytes() ==
                np.asarray(b, np.float64).tobytes())


@pytest.mark.parametrize("executor", [False, True],
                         ids=["serial", "overlapped"])
@pytest.mark.parametrize("params", [SCALARS, PERCENTILES],
                         ids=["scalars", "percentiles"])
def test_killed_and_resumed_run_is_bit_identical(params, executor,
                                                 tmp_path):
    ds = make_ds(seed=1)
    public = None if params is SCALARS else list(range(12))
    baseline, _ = run_torch(ds, params, public=public,
                            ingest_executor=executor)
    want, _ = run_jax(ds, params, public=public)
    assert_bit_identical(baseline, want)
    store = CheckpointStore(str(tmp_path / "stream.ckpt"))
    with injected_faults(FaultPlan(fail_chunks=(3,))):
        with pytest.raises(ChunkFailure):
            run_torch(ds, params, public=public, ingest_executor=executor,
                      checkpoint=store)
    assert store.exists(), "no checkpoint survived the kill"
    assert 1 <= store.load().next_batch <= 3
    resumed, t = run_torch(ds, params, public=public,
                           ingest_executor=executor, checkpoint=store)
    assert t["stream_resumed_from"] >= 1
    assert t["stream_checkpoint_saves"] == (
        t["stream_batches"] - t["stream_resumed_from"])
    assert_bit_identical(resumed, baseline)
    assert not store.exists(), "success must clear the checkpoint"
    if params is PERCENTILES:
        # A resumed run never caches: pass B re-ships every batch.
        assert t["stream_pass_b"] == "reship"


@pytest.mark.parametrize("executor", [False, True],
                         ids=["serial", "overlapped"])
def test_kill_in_pass_b_resumes_from_the_folded_pass_a(executor, tmp_path):
    ds = make_ds(seed=2)
    baseline, _ = run_torch(ds, PERCENTILES, public=list(range(12)))
    path = str(tmp_path / "pass_b.ckpt")
    with injected_faults(FaultPlan(fail_pass_b_chunks=(2,))):
        with pytest.raises(ChunkFailure, match="pass-B"):
            run_torch(ds, PERCENTILES, public=list(range(12)),
                      ingest_executor=executor, checkpoint=path,
                      stream_cache=0)
    resumed, t = run_torch(ds, PERCENTILES, public=list(range(12)),
                           ingest_executor=executor, checkpoint=path)
    assert t["stream_resumed_from"] == t["stream_batches"]
    assert t["stream_checkpoint_saves"] == 0
    assert_bit_identical(resumed, baseline)


def test_checkpoint_every_two_folds(tmp_path, monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_CKPT_EVERY", "2")
    ds = make_ds(seed=3)
    baseline, _ = run_torch(ds, SCALARS)
    path = str(tmp_path / "every2.ckpt")
    with injected_faults(FaultPlan(fail_chunks=(5,))):
        with pytest.raises(ChunkFailure):
            run_torch(ds, SCALARS, checkpoint=path)
    assert CheckpointStore(path).load().next_batch % 2 == 0
    resumed, _ = run_torch(ds, SCALARS, checkpoint=path)
    assert_bit_identical(resumed, baseline)


@pytest.mark.parametrize("site", ["chunk", "pass_b", "sweep"])
def test_fault_plan_is_cleared_after_its_block(site):
    """``injected_faults`` installs its plan for the block only."""
    plan = {"chunk": FaultPlan(fail_chunks=(2,)),
            "pass_b": FaultPlan(fail_pass_b_chunks=(2,)),
            "sweep": FaultPlan(fail_sweep_config_chunks=(2,))}[site]
    check = {"chunk": faults.check_chunk,
             "pass_b": faults.check_pass_b_chunk,
             "sweep": faults.check_sweep_config_chunk}[site]
    with injected_faults(plan):
        check(1)
        with pytest.raises(ChunkFailure):
            check(2)
    check(2)


@pytest.mark.parametrize("change", ["seed", "data", "config"])
def test_mismatched_checkpoint_is_refused(change, tmp_path):
    ds = make_ds(seed=5)
    store = CheckpointStore(str(tmp_path / "run.ckpt"))
    with injected_faults(FaultPlan(fail_chunks=(4,))):
        with pytest.raises(ChunkFailure):
            run_torch(ds, SCALARS, checkpoint=store)
    kw = dict(seed=42)
    params = SCALARS
    if change == "seed":
        kw["seed"] = 43
    elif change == "data":
        ds = (ds[0], ds[1], ds[2] + 0.5)
    else:
        params = pdp.AggregateParams(
            metrics=[M.COUNT, M.SUM], max_partitions_contributed=12,
            max_contributions_per_partition=50, min_value=0.0,
            max_value=10.0)
    with pytest.raises(CheckpointMismatch):
        run_torch(ds, params, checkpoint=store, **kw)
    assert store.exists(), "a refused checkpoint must stay on disk"


def test_checkpoint_needs_a_fixed_seed(tmp_path):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=5.0, total_delta=1e-6)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(
        "cpu", checkpoint=str(tmp_path / "x.ckpt")))
    result = engine.aggregate(convert.dataset_from_arrays(*make_ds(6)),
                              convert.params_from_reference(SCALARS),
                              pdt.DataExtractors())
    acc.compute_budgets()
    with pytest.raises(ValueError, match="rng_seed"):
        list(result)


def test_store_round_trip_and_json_helpers(tmp_path):
    store = ckpt_mod.as_store(str(tmp_path / "s.ckpt"))
    assert ckpt_mod.as_store(store) is store and ckpt_mod.as_store(None) is None
    arrays = {"acc:count": np.arange(5, dtype=np.int64),
              "val:nsum": np.linspace(0, 1, 5)}
    store.save(ckpt_mod.StreamCheckpoint("fp", 3, arrays))
    back = store.load_for("fp")
    assert back.next_batch == 3
    for k, v in arrays.items():
        np.testing.assert_array_equal(back.arrays[k], v)
    with pytest.raises(CheckpointMismatch):
        store.load_for("other")
    store.clear()
    assert not store.exists() and store.load() is None
    path = str(tmp_path / "doc.json")
    assert ckpt_mod.read_json(path) is None
    ckpt_mod.atomic_write_json(path, {"b": 1, "a": [1, 2]})
    assert ckpt_mod.read_json(path) == {"a": [1, 2], "b": 1}
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


@pytest.mark.parametrize("executor", [False, True],
                         ids=["serial", "overlapped"])
@pytest.mark.parametrize("capped", [False, True],
                         ids=["one_tile", "multi_tile"])
def test_three_pass_b_sources_bit_identical(capped, executor, monkeypatch):
    """device_cache, hybrid and reship release the same bits, also when
    pass B tiles the grid into several sweeps, and equal the JAX
    package's stream."""
    ds = make_ds(seed=21, parts=40)
    params = pdp.AggregateParams(
        metrics=[M.PERCENTILE(50), M.PERCENTILE(5), M.PERCENTILE(95)],
        max_partitions_contributed=4, max_contributions_per_partition=3,
        min_value=0.0, max_value=10.0)
    public = list(range(40))
    cap = 40 * SPAN * 4 if capped else None
    if cap is not None:
        monkeypatch.setenv(CAP_ENV, str(cap))
    want, _ = run_jax(ds, params, public=public)
    cached, t_c = run_torch(ds, params, public=public,
                            ingest_executor=executor, stream_cache=1 << 30)
    reship, t_r = run_torch(ds, params, public=public,
                            ingest_executor=executor, stream_cache=0)
    assert t_c["stream_pass_b"] == "device_cache"
    assert t_c["stream_pass_b_reshipped_bytes"] == 0
    assert t_c["stream_pass_b_cached_batches"] == t_c["stream_batches"]
    assert t_r["stream_pass_b"] == "reship"
    assert t_r["stream_pass_b_cached_batches"] == 0
    full_bytes = t_r["stream_pass_b_reshipped_bytes"]
    n_batches = t_r["stream_batches"]
    assert full_bytes > 0
    per_batch = full_bytes // (n_batches * t_r["stream_pass_b_sweeps"])
    hybrid, t_h = run_torch(ds, params, public=public,
                            ingest_executor=executor,
                            stream_cache=per_batch * 5 // 2)
    assert t_h["stream_pass_b"] == "hybrid"
    assert 1 <= t_h["stream_pass_b_cached_batches"] < n_batches
    assert 0 < t_h["stream_pass_b_reshipped_bytes"] < full_bytes
    assert (t_h["stream_pass_b_sweeps"] > 1) == capped
    for got in (cached, reship, hybrid):
        assert_bit_identical(got, want)


def test_cache_knob_default_and_env(monkeypatch):
    from pipelinedp_tpu_torch import streaming
    monkeypatch.delenv("PIPELINEDP_TPU_STREAM_CACHE", raising=False)
    assert streaming.stream_cache_bytes() == 4 << 30
    monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CACHE", "0")
    ds = make_ds(seed=7)
    _, t = run_torch(ds, PERCENTILES, public=list(range(12)))
    assert t["stream_pass_b"] == "reship"


# ---------------------------------------------------------------------------
# The utility-analysis sweep's chunk-prefix checkpoint
# ---------------------------------------------------------------------------


def _sweep(checkpoint=None, l0s=(1, 2, 3, 4, 5, 6, 7)):
    from pipelinedp_tpu_torch import analysis
    rng = np.random.default_rng(17)
    ds = pdt.ArrayDataset(rng.integers(0, 300, 3000),
                          rng.integers(0, 20, 3000), rng.uniform(0, 5, 3000))
    options = analysis.UtilityAnalysisOptions(
        epsilon=1.0, delta=1e-6,
        aggregate_params=pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT], max_partitions_contributed=2,
            max_contributions_per_partition=2),
        multi_param_configuration=analysis.MultiParameterConfiguration(
            max_partitions_contributed=list(l0s),
            max_contributions_per_partition=[2] * len(l0s)))
    res = analysis.perform_utility_analysis(
        ds, pdt.TorchBackend("cpu", checkpoint=checkpoint), options,
        pdt.DataExtractors())
    return res, list(res)[0]


def _sweep_bits(result):
    """Every float of every config's count and selection metrics, as
    float64 bits."""
    import dataclasses
    out = []
    for m in result:
        for part in (m.count_metrics, m.partition_selection_metrics):
            for v in dataclasses.astuple(part):
                if isinstance(v, (float, list)):
                    out += list(np.asarray(v, np.float64).ravel())
    return np.asarray(out, np.float64).view(np.uint64)


@pytest.mark.parametrize("kill_at", [1, 3])
def test_killed_sweep_resumes_bit_identical(kill_at, tmp_path, monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_SWEEP_CONFIG_BATCH", "2")
    _, baseline = _sweep()
    path = str(tmp_path / "sweep.ckpt")
    with injected_faults(FaultPlan(fail_sweep_config_chunks=(kill_at,))):
        with pytest.raises(ChunkFailure):
            _sweep(checkpoint=path)
    store = CheckpointStore(path + ".sweep")
    assert store.load().next_batch == kill_at
    assert not os.path.exists(path), "the sweep writes a sibling file"
    lazy, resumed = _sweep(checkpoint=path)
    assert lazy._resumed_from_chunk == kill_at
    assert not store.exists(), "a finished sweep clears its checkpoint"
    np.testing.assert_array_equal(_sweep_bits(resumed),
                                  _sweep_bits(baseline))


def test_sweep_checkpoint_every_two_chunks(tmp_path, monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_SWEEP_CONFIG_BATCH", "2")
    monkeypatch.setenv("PIPELINEDP_TPU_CKPT_EVERY", "2")
    _, baseline = _sweep()
    path = str(tmp_path / "sweep.ckpt")
    with injected_faults(FaultPlan(fail_sweep_config_chunks=(3,))):
        with pytest.raises(ChunkFailure):
            _sweep(checkpoint=path)
    assert CheckpointStore(path + ".sweep").load().next_batch == 2
    _, resumed = _sweep(checkpoint=path)
    np.testing.assert_array_equal(_sweep_bits(resumed),
                                  _sweep_bits(baseline))


def test_other_sweep_checkpoint_is_refused(tmp_path, monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_SWEEP_CONFIG_BATCH", "2")
    path = str(tmp_path / "sweep.ckpt")
    with injected_faults(FaultPlan(fail_sweep_config_chunks=(2,))):
        with pytest.raises(ChunkFailure):
            _sweep(checkpoint=path)
    with pytest.raises(CheckpointMismatch):
        _sweep(checkpoint=path, l0s=(1, 2, 3, 4, 5, 6, 8))
