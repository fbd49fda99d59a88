"""The port's fused path (``pipelinedp_tpu_torch.torch_engine``) against
the JAX package's (``pipelinedp_tpu.jax_engine``), on the CPU.

Every comparison is exact: the int32 accumulator columns, the keep
decisions, the kept partition keys and the released float64 values are
bit-identical for the same inputs and the same ``rng_seed``. The inputs
are made with numpy from a seed and handed to both packages; the JAX
side stays at the engine's 8192-row padding so its compiles stay few.
"""

import operator

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pipelinedp_tpu as pdp
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.ops import prng

M = pdp.Metrics
PSS = pdp.PartitionSelectionStrategy
EPS, DELTA = 1.0, 1e-6


def _data(seed=0, n=8000, users=3000, parts=300):
    """Zipf-skewed partition keys, so some partitions sit near the
    selection threshold and some far above it."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.2, n) % parts).astype(np.int64)
    values = rng.random(n) * 10.0
    return pid, pk, values


def _params(**kw):
    base = dict(max_partitions_contributed=3,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)
    base.update(kw)
    return pdp.AggregateParams(**base)


# ---------------------------------------------------------------------------
# Device path, part by part
# ---------------------------------------------------------------------------

PARTIAL_CASES = {
    "count": _params(metrics=[M.COUNT]),
    "sum_mean": _params(metrics=[M.COUNT, M.SUM, M.MEAN]),
    "variance": _params(metrics=[M.VARIANCE, M.PRIVACY_ID_COUNT]),
    "max_contributions": pdp.AggregateParams(
        metrics=[M.COUNT, M.SUM], max_contributions=4, min_value=-2.0,
        max_value=7.5),
    "l0_1_linf_3": _params(metrics=[M.PRIVACY_ID_COUNT, M.COUNT],
                           max_partitions_contributed=1,
                           max_contributions_per_partition=3),
    "bounds_enforced": _params(metrics=[M.COUNT, M.SUM],
                               contribution_bounds_already_enforced=True),
}


@pytest.mark.parametrize("case", sorted(PARTIAL_CASES))
@pytest.mark.parametrize("seed", [0, 11])
def test_partials_bit_equal(case, seed):
    params = PARTIAL_CASES[case]
    pid, pk, values = _data(seed)
    enforced = params.contribution_bounds_already_enforced
    ds = je.ArrayDataset(None if enforced else pid, pk, values)
    cfg_j = je.FusedConfig.from_params(params, public=False)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=False)
    enc = je.encode(ds, None, None, None, require_pid=not enforced)
    P = je._pad_pow2(len(enc.pk_vocab))
    fx_bits = je._fx_plan(enc.n_rows)[0]
    k_bound = jax.random.split(jax.random.PRNGKey(seed + 5), 3)[0]

    jpid, jpk, jvals, valid = je.pad_and_put(enc, None,
                                             with_values=cfg_j.needs_values)
    partials = jax.jit(je._partials, static_argnums=(0, 1, 7))
    part_j, nseg_j, _ = partials(cfg_j, P, jpid, jpk, jvals, valid, k_bound,
                                 fx_bits)

    tenc = te.encode(convert.dataset_from_arrays(
        None if enforced else pid, pk, values), None, None,
        require_pid=not enforced)
    tpid, tpk, tvals = te.put_on_device(tenc, torch.device("cpu"),
                                        with_values=cfg_t.needs_values)
    part_t, nseg_t, qrows_t = te._partials(cfg_t, P, tpid, tpk, tvals,
                                           convert.key_from_jax(k_bound),
                                           fx_bits)
    assert qrows_t is None

    assert sorted(part_t) == sorted(part_j)
    for name in part_j:
        assert part_t[name].dtype == torch.int32
        np.testing.assert_array_equal(part_t[name].numpy(),
                                      np.asarray(part_j[name]), err_msg=name)
    np.testing.assert_array_equal(nseg_t.numpy(), np.asarray(nseg_j))


SELECTION_CASES = [
    (PSS.TRUNCATED_GEOMETRIC, None, 1.0),
    (PSS.TRUNCATED_GEOMETRIC, 5, 1.0),
    (PSS.LAPLACE_THRESHOLDING, None, 1.0),
    (PSS.LAPLACE_THRESHOLDING, 4, 3.0),
    (PSS.GAUSSIAN_THRESHOLDING, None, 1.0),
    (PSS.GAUSSIAN_THRESHOLDING, 3, 2.0),
]


@pytest.mark.parametrize("strategy,pre_threshold,rows_per_uid",
                         SELECTION_CASES)
def test_keep_pk_bit_equal(strategy, pre_threshold, rows_per_uid):
    """Privacy-id counts spread around the threshold over 2^14
    partitions: every keep decision agrees with the jitted JAX stage."""
    P = 1 << 14
    rng = np.random.default_rng(P)
    nseg = rng.integers(0, 150, P).astype(np.int32)
    nseg[:100] = 0
    params = _params(metrics=[M.PRIVACY_ID_COUNT],
                     partition_selection_strategy=strategy,
                     pre_threshold=pre_threshold)
    cfg_j = je.FusedConfig.from_params(params, public=False)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=False)
    table, thr, scale, min_count = je.selection_inputs(cfg_j, 0.5, 1e-5,
                                                       pre_threshold)
    key = jax.random.PRNGKey(9)
    _, k_sel, k_noise = jax.random.split(key, 3)

    def stage(nseg, table, thr, scale, min_count, rows, k_sel, k_noise):
        keep, _ = je._selection_and_metrics(
            cfg_j, P, {"count": nseg}, nseg, jnp.zeros(0, jnp.float32),
            table, thr, scale, min_count, rows, k_sel, k_noise)
        return keep

    keep_j = jax.jit(stage)(jnp.asarray(nseg), jnp.asarray(table),
                            jnp.float32(thr), jnp.float32(scale),
                            jnp.float32(min_count),
                            jnp.float32(rows_per_uid), k_sel, k_noise)
    t_nseg = torch.from_numpy(nseg)
    keep_t, _ = te._selection_and_metrics(
        cfg_t, P, {"count": t_nseg}, t_nseg, table, thr, scale, min_count,
        rows_per_uid, convert.key_from_jax(k_sel))
    keep_j = np.asarray(keep_j)
    assert 0 < keep_j.sum() < P
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)


def test_root_split_matches_engine_key_streams():
    key_t = prng.PRNGKey(1234)
    k_bound, k_sel, k_noise = prng.split(key_t, 3)
    ref = jax.random.split(jax.random.PRNGKey(1234), 3)
    for got, want in zip((k_bound, k_sel, k_noise), ref):
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).astype(np.int64))


# ---------------------------------------------------------------------------
# The whole slice: DPEngine.aggregate / select_partitions
# ---------------------------------------------------------------------------

E2E_CASES = {
    "count": (_params(metrics=[M.COUNT]), None),
    "pid_count_truncated_geometric": (
        _params(metrics=[M.PRIVACY_ID_COUNT],
                partition_selection_strategy=PSS.TRUNCATED_GEOMETRIC), None),
    "pid_count_laplace_thresholding": (
        _params(metrics=[M.PRIVACY_ID_COUNT],
                partition_selection_strategy=PSS.LAPLACE_THRESHOLDING),
        None),
    "pid_count_gaussian_thresholding": (
        _params(metrics=[M.PRIVACY_ID_COUNT],
                partition_selection_strategy=PSS.GAUSSIAN_THRESHOLDING),
        None),
    "count_sum_mean": (
        _params(metrics=[M.COUNT, M.SUM, M.MEAN], max_partitions_contributed=4,
                noise_kind=pdp.NoiseKind.LAPLACE), None),
    "count_sum_mean_gaussian": (
        _params(metrics=[M.COUNT, M.SUM, M.MEAN],
                noise_kind=pdp.NoiseKind.GAUSSIAN, pre_threshold=3), None),
    "variance": (_params(metrics=[M.VARIANCE, M.COUNT, M.SUM, M.MEAN,
                                  M.PRIVACY_ID_COUNT], min_value=-3.0,
                         max_value=8.0), None),
    "max_contributions": (
        pdp.AggregateParams(metrics=[M.COUNT, M.SUM, M.PRIVACY_ID_COUNT],
                            max_contributions=5, min_value=0.0,
                            max_value=10.0), None),
    "public_partitions": (_params(metrics=[M.COUNT, M.SUM]),
                          list(range(0, 40)) + [1000, 1001]),
    "contribution_bounds_already_enforced": (
        _params(metrics=[M.COUNT, M.SUM],
                contribution_bounds_already_enforced=True), None),
}


def _run_jax(col, params, extractors, public, seed):
    acc = pdp.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    engine = pdp.DPEngine(acc, JaxBackend(rng_seed=seed))
    result = engine.aggregate(col, params, extractors,
                              public_partitions=public)
    acc.compute_budgets()
    return list(result)


def _run_torch(col, params, extractors, public, seed):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(device="cpu",
                                                rng_seed=seed))
    result = engine.aggregate(col, convert.params_from_reference(params),
                              extractors, public_partitions=public)
    acc.compute_budgets()
    return list(result), result


def _assert_identical(got, want):
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a._fields == b._fields
        for x, y in zip(a, b):
            assert np.float64(x).tobytes() == np.float64(y).tobytes()


@pytest.mark.parametrize("case", sorted(E2E_CASES))
@pytest.mark.parametrize("seed", [3, 21])
def test_aggregate_bit_identical(case, seed):
    params, public = E2E_CASES[case]
    pid, pk, values = _data(seed)
    if params.contribution_bounds_already_enforced:
        pid = None
    want = _run_jax(je.ArrayDataset(pid, pk, values), params,
                    pdp.DataExtractors(), public, seed)
    got, result = _run_torch(convert.dataset_from_arrays(pid, pk, values),
                             params, pdt.DataExtractors(), public, seed)
    assert len(want) > 0
    _assert_identical(got, want)
    assert set(result.timings) == {"host_encode_s", "device_s",
                                   "host_decode_s"}


def test_aggregate_rows_with_extractors_bit_identical():
    """Row tuples with itemgetter extractors take the same encode (and so
    the same pk order and host-noise order) as in the JAX package."""
    pid, pk, values = _data(5)
    rows = list(zip(pid.tolist(), pk.tolist(), values.tolist()))
    params = _params(metrics=[M.COUNT, M.SUM])
    getters = dict(privacy_id_extractor=operator.itemgetter(0),
                   partition_extractor=operator.itemgetter(1),
                   value_extractor=operator.itemgetter(2))
    want = _run_jax(rows, params, pdp.DataExtractors(**getters), None, 5)
    got, _ = _run_torch(rows, params, pdt.DataExtractors(**getters), None, 5)
    assert len(want) > 0
    _assert_identical(got, want)


@pytest.mark.parametrize("strategy", list(PSS))
def test_select_partitions_identical(strategy):
    pid, pk, _ = _data(8)
    rows = list(zip(pid.tolist(), pk.tolist()))
    getters = dict(privacy_id_extractor=operator.itemgetter(0),
                   partition_extractor=operator.itemgetter(1))
    sp = pdp.SelectPartitionsParams(max_partitions_contributed=2,
                                    partition_selection_strategy=strategy)
    acc = pdp.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    want = pdp.DPEngine(acc, JaxBackend(rng_seed=8)).select_partitions(
        rows, sp, pdp.DataExtractors(**getters))
    acc.compute_budgets()
    want = list(want)
    acc_t = pdt.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    got = pdt.DPEngine(acc_t, pdt.TorchBackend("cpu", rng_seed=8)
                       ).select_partitions(
        rows, convert.params_from_reference(sp),
        pdt.DataExtractors(**getters))
    acc_t.compute_budgets()
    assert len(want) > 0
    assert list(got) == want


def test_torch_backend_without_cuda_raises():
    if torch.cuda.is_available():
        assert pdt.TorchBackend().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        pdt.TorchBackend()
    with pytest.raises(RuntimeError, match="CUDA"):
        pdt.TorchBackend(device="cuda", rng_seed=1)


@pytest.mark.parametrize("params", [
    _params(metrics=[M.PERCENTILE(50)], min_value=0.0, max_value=1e-35),
], ids=["percentile"])
def test_unported_params_raise(params):
    """Params the fused path does not take run the host path, as on
    ``JaxBackend`` (the test's name is from when the port raised here): a
    percentile range so small that the fused walk's float32 leaf constant
    overflows. The release is bit-equal to the JAX package's under one
    ``seed_host_rng`` seed, and no fused result comes back."""
    from pipelinedp_tpu.ops import noise as jnoise
    from pipelinedp_tpu_torch.ops import noise as tnoise
    assert not je.params_are_fusable(params)
    assert not te.params_are_fusable(convert.params_from_reference(params))
    pid, pk, values = _data(0, n=400, users=60, parts=8)
    out = []
    for pkg, backend, ds, p, noise in (
            (pdp, JaxBackend(rng_seed=0), je.ArrayDataset(pid, pk, values),
             params, jnoise),
            (pdt, pdt.TorchBackend("cpu", rng_seed=0),
             convert.dataset_from_arrays(pid, pk, values),
             convert.params_from_reference(params), tnoise)):
        noise.seed_host_rng(17)
        acc = pkg.NaiveBudgetAccountant(total_epsilon=50.0, total_delta=1e-3)
        result = pkg.DPEngine(acc, backend).aggregate(ds, p,
                                                      pkg.DataExtractors())
        assert not isinstance(result, te.LazyFusedResult)
        acc.compute_budgets()
        out.append(sorted(result, key=lambda r: r[0]))
    assert len(out[1]) > 0
    assert [k for k, _ in out[0]] == [k for k, _ in out[1]]
    for (_, a), (_, b) in zip(*out):
        assert a._fields == b._fields
        assert (np.asarray(a, np.float64).tobytes() ==
                np.asarray(b, np.float64).tobytes())


def test_pld_accountant_raises():
    """The port's PLD accountant refuses what the JAX package's refuses,
    and grants the specs it accepts the JAX package's (eps, delta, stddev)
    bit for bit."""
    from pipelinedp_tpu import budget_accounting as jba
    from pipelinedp_tpu_torch import budget_accounting as tba
    MT = pdp.MechanismType
    refusals = [
        (1.0, 1e-6, dict(mechanism_type=MT.LAPLACE, count=2),
         NotImplementedError),
        (1.0, 1e-6, dict(mechanism_type=MT.LAPLACE,
                         noise_standard_deviation=1.0), NotImplementedError),
        (1.0, 0.0, dict(mechanism_type=MT.GAUSSIAN), AssertionError),
        (1.0, 1e-6, dict(mechanism_type=MT.LAPLACE, internal_splits=0),
         ValueError),
    ]
    for eps, delta, kwargs, error in refusals:
        for pkg, mt in ((jba, MT), (tba, pdt.MechanismType)):
            acc = pkg.PLDBudgetAccountant(total_epsilon=eps,
                                          total_delta=delta)
            kw = dict(kwargs, mechanism_type=mt[kwargs["mechanism_type"]
                                                .name])
            with pytest.raises(error):
                acc.request_budget(**kw)
    specs = []
    for pkg, mt in ((jba, MT), (tba, pdt.MechanismType)):
        acc = pkg.PLDBudgetAccountant(total_epsilon=1.0, total_delta=1e-6,
                                      pld_discretization=1e-3)
        got = [acc.request_budget(mt.GAUSSIAN, sensitivity=2.0),
               acc.request_budget(mt.LAPLACE, internal_splits=2),
               acc.request_budget(mt.GENERIC)]
        acc.compute_budgets()
        specs.append(np.array(
            [v for s in got
             for v in (s.eps, s.delta, s.noise_standard_deviation)] +
            [acc.minimum_noise_std]))
    assert specs[1].tobytes() == specs[0].tobytes()
