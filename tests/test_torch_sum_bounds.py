"""The per-partition-sum-bounds SUM on the port against the JAX package, on
the CPU, bit for bit.

``min_sum_per_partition`` / ``max_sum_per_partition`` clip each
(privacy unit, partition) segment's float32 total, added in row order
(kernel K4 on the card, its plain version here), and contribute it once
per segment through the fixed-point ``sum`` lane. Held here: the device
partials of all three bounding modes (``(l0, linf)``,
``max_contributions``, bounds already enforced) and the released float64
values and kept keys through ``DPEngine.aggregate``, with public and
private partitions, alone and with COUNT / PRIVACY_ID_COUNT, with a bound
float32 cannot hold (2.7), in one batch and streamed.
"""

import numpy as np
import pytest
import torch

import jax

import pipelinedp_tpu as pdp
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import torch_engine as te

M = pdp.Metrics
CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"


@pytest.fixture(autouse=True)
def _serial_jax_stream(monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
    monkeypatch.delenv(CHUNK_ENV, raising=False)


def _data(seed, n=6000, users=600, parts=40):
    """Several rows per (user, partition), so segments have totals to
    clip; values straddle zero."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.4, n) % parts).astype(np.int64)
    values = rng.uniform(-3.0, 6.0, n)
    return pid, pk, values


MODES = {
    "l0_linf": dict(max_partitions_contributed=3,
                    max_contributions_per_partition=4),
    "max_contributions": dict(max_contributions=7),
    "bounds_enforced": dict(max_partitions_contributed=3,
                            max_contributions_per_partition=4,
                            contribution_bounds_already_enforced=True),
}


def _params(mode, metrics=(M.SUM,), lo=-1.0, hi=2.7):
    return pdp.AggregateParams(metrics=list(metrics),
                               min_sum_per_partition=lo,
                               max_sum_per_partition=hi, **MODES[mode])


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("bounds", [(-1.0, 2.7), (0.5, 1e6)])
def test_partials_bit_equal(mode, bounds):
    params = _params(mode, (M.SUM, M.COUNT), *bounds)
    pid, pk, values = _data(1)
    enforced = params.contribution_bounds_already_enforced
    cfg_j = je.FusedConfig.from_params(params, public=False)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=False)
    enc = je.encode(je.ArrayDataset(None if enforced else pid, pk, values),
                    None, None, None, require_pid=not enforced)
    P = je._pad_pow2(len(enc.pk_vocab))
    fx_bits = je._fx_plan(enc.n_rows)[0]
    k_bound = jax.random.split(jax.random.PRNGKey(9), 3)[0]
    jpid, jpk, jvals, valid = je.pad_and_put(enc, None, with_values=True)
    partials = jax.jit(je._partials, static_argnums=(0, 1, 7))
    part_j, nseg_j, _ = partials(cfg_j, P, jpid, jpk, jvals, valid, k_bound,
                                 fx_bits)
    tenc = te.encode(convert.dataset_from_arrays(
        None if enforced else pid, pk, values), None, None,
        require_pid=not enforced)
    tpid, tpk, tvals = te.put_on_device(tenc, torch.device("cpu"))
    part_t, nseg_t, _ = te._partials(cfg_t, P, tpid, tpk, tvals,
                                     convert.key_from_jax(k_bound), fx_bits)
    assert sorted(part_t) == sorted(part_j)
    assert any(name.startswith("sum_fx") for name in part_t)
    for name in part_j:
        np.testing.assert_array_equal(part_t[name].numpy(),
                                      np.asarray(part_j[name]), err_msg=name)
    np.testing.assert_array_equal(nseg_t.numpy(), np.asarray(nseg_j))


def test_bound_rows_clips_each_segment_total_once():
    """The contribution is the segment's clipped total on its marker row
    and zero elsewhere; a total that float32 rounds stays rounded."""
    params = convert.params_from_reference(_params("l0_linf", hi=2.7))
    cfg = te.FusedConfig.from_params(params, public=False)
    pid = torch.tensor([5, 5, 5, 9, 9], dtype=torch.int32)
    pk = torch.tensor([0, 0, 0, 0, 1], dtype=torch.int32)
    values = torch.tensor([2.0, 0.5, 1.25, -4.0, 0.1])
    from pipelinedp_tpu_torch.ops import prng
    b = te._bound_rows(cfg, pid, pk, values, prng.PRNGKey(0))
    got = sorted(float(x) for x in b.contrib[b.seg_marker])
    assert got == sorted([float(np.float32(2.7)), -1.0, float(
        np.float32(0.1))])
    assert float(b.contrib[~b.seg_marker].abs().sum()) == 0.0


def _run(pkg, backend, pid, pk, values, params, public, eps):
    acc = pkg.NaiveBudgetAccountant(total_epsilon=eps, total_delta=1e-6)
    engine = pkg.DPEngine(acc, backend)
    if pkg is pdt:
        ds = convert.dataset_from_arrays(pid, pk, values)
        params = convert.params_from_reference(params)
        ex = pdt.DataExtractors()
    else:
        ds, ex = je.ArrayDataset(pid, pk, values), pdp.DataExtractors()
    result = engine.aggregate(ds, params, ex, public_partitions=public)
    acc.compute_budgets()
    return list(result), result.timings


def _assert_identical(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a._fields == b._fields
        for x, y in zip(a, b):
            assert np.float64(x).tobytes() == np.float64(y).tobytes()


AGG_CASES = {
    "sum_l0_linf_private": ("l0_linf", (M.SUM,), None),
    "sum_count_l0_linf_public": ("l0_linf", (M.SUM, M.COUNT), 30),
    "sum_pid_count_max_contributions_private": (
        "max_contributions", (M.SUM, M.PRIVACY_ID_COUNT), None),
    "sum_count_max_contributions_public": (
        "max_contributions", (M.COUNT, M.SUM), 45),
    "sum_enforced_private": ("bounds_enforced", (M.SUM, M.COUNT), None),
    "sum_enforced_public": ("bounds_enforced", (M.SUM,), 30),
}


@pytest.mark.parametrize("streamed", [False, True],
                         ids=["single", "streamed"])
@pytest.mark.parametrize("case", sorted(AGG_CASES))
def test_aggregate_bit_identical(case, streamed, monkeypatch):
    mode, metrics, n_public = AGG_CASES[case]
    params = _params(mode, metrics)
    pid, pk, values = _data(len(case))
    if params.contribution_bounds_already_enforced:
        pid = None
    public = None if n_public is None else list(range(n_public))
    if streamed:
        monkeypatch.setenv(CHUNK_ENV, "997")
    seed = len(case) + 3
    want, jt = _run(pdp, JaxBackend(rng_seed=seed), pid, pk, values, params,
                    public, 8.0)
    got, tt = _run(pdt, pdt.TorchBackend("cpu", rng_seed=seed), pid, pk,
                   values, params, public, 8.0)
    assert len(want) > 3
    _assert_identical(got, want)
    if streamed:
        assert tt["stream_batches"] == jt["stream_batches"] > 5
    else:
        assert "stream_batches" not in tt


def test_twenty_users_clipped_to_ten_each():
    """``tests/test_jax_engine.py::test_sum_per_partition_bounds`` on the
    port: 20 users each sum 100 in one partition, clipped to 10 each; the
    port releases the JAX package's bits."""
    rows = [(u, "a", 100.0) for u in range(20)]
    params = pdp.AggregateParams(
        metrics=[M.SUM], max_partitions_contributed=1,
        max_contributions_per_partition=5, min_sum_per_partition=0.0,
        max_sum_per_partition=10.0)
    getters = dict(privacy_id_extractor=lambda r: r[0],
                   partition_extractor=lambda r: r[1],
                   value_extractor=lambda r: r[2])
    acc = pdp.NaiveBudgetAccountant(total_epsilon=1e5, total_delta=1e-6)
    want = pdp.DPEngine(acc, JaxBackend(rng_seed=3)).aggregate(
        rows, params, pdp.DataExtractors(**getters), public_partitions=["a"])
    acc.compute_budgets()
    want = dict(want)
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1e5, total_delta=1e-6)
    got = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=3)).aggregate(
        rows, convert.params_from_reference(params),
        pdt.DataExtractors(**getters), public_partitions=["a"])
    acc.compute_budgets()
    got = dict(got)
    assert got["a"].sum == pytest.approx(200.0, rel=0.01)
    assert np.float64(got["a"].sum).tobytes() == np.float64(
        want["a"].sum).tobytes()
