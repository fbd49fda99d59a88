"""VECTOR_SUM in the port against the JAX package, on the CPU.

Under the ``fx`` accumulator every comparison is exact: the fixed-point
coordinate lanes, the ``[P, W]`` per-partition lane sums, the counter-keyed
vector noise, the kept partition keys and the released float64 vectors.
Under ``f32`` the per-partition sums are float32 sums taken in another
order, so they agree within a stated bound. Both packages read the
accumulator from ``PIPELINEDP_TPU_VECTOR_ACCUMULATOR``, set per test.
"""

import operator

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pipelinedp_tpu as pdp
from pipelinedp_tpu import dp_computations as jax_dpc
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.backends import JaxBackend
from pipelinedp_tpu.ops import vector_noise as jax_vector_noise

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import dp_computations as dpc
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.ops import vector_noise

M = pdp.Metrics
EPS, DELTA = 1.0, 1e-6
ACC_ENV = "PIPELINEDP_TPU_VECTOR_ACCUMULATOR"


def _data(seed=0, n=6000, users=2000, parts=120, d=5):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.2, n) % parts).astype(np.int64)
    values = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    return pid, pk, values


def _params(d=5, **kw):
    base = dict(metrics=[M.VECTOR_SUM], vector_size=d, vector_max_norm=3.0,
                vector_norm_kind=pdp.NormKind.L2,
                noise_kind=pdp.NoiseKind.GAUSSIAN,
                max_partitions_contributed=2,
                max_contributions_per_partition=2)
    base.update(kw)
    return pdp.AggregateParams(**base)


# ---------------------------------------------------------------------------
# The noise: counter-keyed draws and the host clip
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(pdp.NoiseKind))
@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1, 2**40 + 3])
def test_unit_noise_block_bit_equal(kind, seed):
    rng = np.random.default_rng(seed % 1000)
    pk_index = np.concatenate([np.arange(50),
                               rng.integers(0, 2**31, 200)])
    a = jax_vector_noise.unit_noise_block(kind, seed, pk_index, 96)
    b = vector_noise.unit_noise_block(pdt.NoiseKind[kind.name], seed,
                                      pk_index, 96)
    assert b.dtype == np.float32 and b.shape == (250, 96)
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("norm", list(pdp.NormKind))
def test_clip_and_host_noise_match_the_reference(norm):
    """``AdditiveVectorNoiseParams``, ``_clip_vector`` and
    ``add_noise_vector`` of the port's ``dp_computations`` against the
    JAX package's; the L0 norm is refused by both."""
    import dataclasses
    assert ([f.name for f in dataclasses.fields(dpc.AdditiveVectorNoiseParams)]
            == [f.name for f in dataclasses.fields(
                jax_dpc.AdditiveVectorNoiseParams)])
    vec = np.random.default_rng(1).normal(0, 3, (40, 7))
    vec[0] = 0.0
    if norm.name == "L0":
        with pytest.raises(NotImplementedError):
            jax_dpc._clip_vector(vec, 2.5, norm)
        with pytest.raises(NotImplementedError):
            dpc._clip_vector(vec, 2.5, pdt.NormKind.L0)
        return
    got = dpc._clip_vector(vec, 2.5, pdt.NormKind[norm.name])
    want = jax_dpc._clip_vector(vec, 2.5, norm)
    assert got.tobytes() == want.tobytes()
    for kind in pdp.NoiseKind:
        kw = dict(eps_per_coordinate=0.2, delta_per_coordinate=1e-7,
                  max_norm=2.5, l0_sensitivity=2, linf_sensitivity=3)
        got = dpc.add_noise_vector(vec, dpc.AdditiveVectorNoiseParams(
            norm_kind=pdt.NormKind[norm.name],
            noise_kind=pdt.NoiseKind[kind.name], **kw),
            np.random.default_rng(5))
        want = jax_dpc.add_noise_vector(vec, jax_dpc.AdditiveVectorNoiseParams(
            norm_kind=norm, noise_kind=kind, **kw), np.random.default_rng(5))
        assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# The lanes and the per-partition partials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fx_bits", [12, 10, 7, 4])
def test_vector_lanes_bit_equal(fx_bits, monkeypatch):
    """The lane formula of ``jax_engine._reduce_per_pk`` (quantize, clamp,
    offset, split lane-major) against ``torch_engine._vector_lanes``, on
    values that include the clip bound, half steps of the grid and
    masked rows."""
    monkeypatch.setenv(ACC_ENV, "fx")
    params = _params(d=9, vector_max_norm=1.5)
    cfg_j = je.FusedConfig.from_params(params, public=True)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=True)
    assert cfg_j.vector_accumulator == cfg_t.vector_accumulator == "fx"
    rng = np.random.default_rng(fx_bits)
    masked = rng.uniform(-2.0, 2.0, (3000, 9)).astype(np.float32)
    scale = np.float32(je._vector_fx_scale(cfg_j))
    masked[:20] = ((np.arange(20)[:, None] + 0.5) / scale).astype(np.float32)
    masked[20:40] = np.float32(1.5) * np.sign(masked[20:40])
    keep = rng.random(3000) < 0.7
    masked[~keep] = 0.0
    n_lanes = -(-je._FX_PAYLOAD_BITS // fx_bits)

    @jax.jit
    def jax_lanes(masked, keep):
        q = jnp.clip(jnp.round(masked * je._vector_fx_scale(cfg_j)),
                     -(je._FX_STEPS - 1), je._FX_STEPS - 1).astype(jnp.int32)
        u = jnp.where(keep[:, None], q + je._FX_OFFSET, 0)
        return jnp.concatenate([(u >> (k * fx_bits)) & ((1 << fx_bits) - 1)
                                for k in range(n_lanes)], axis=1)

    want = np.asarray(jax_lanes(jnp.asarray(masked), jnp.asarray(keep)))
    got = te._vector_lanes(cfg_t, torch.from_numpy(masked),
                           torch.from_numpy(keep), fx_bits)
    assert got.dtype == torch.int32 and got.shape == (3000, 9 * n_lanes)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("enforced", [False, True],
                         ids=["l0_linf", "bounds_enforced"])
@pytest.mark.parametrize("fx_bits", [12, 7])
def test_vector_partials_bit_equal(enforced, fx_bits, monkeypatch):
    monkeypatch.setenv(ACC_ENV, "fx")
    params = _params(d=6, contribution_bounds_already_enforced=enforced)
    pid, pk, values = _data(fx_bits, d=6)
    ds = je.ArrayDataset(None if enforced else pid, pk, values)
    cfg_j = je.FusedConfig.from_params(params, public=False)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=False)
    enc = je.encode(ds, None, 6, None, require_pid=not enforced)
    P = je._pad_pow2(len(enc.pk_vocab))
    k_bound = jax.random.split(jax.random.PRNGKey(fx_bits), 3)[0]
    jpid, jpk, jvals, valid = je.pad_and_put(enc, 6)
    partials = jax.jit(je._partials, static_argnums=(0, 1, 7))
    part_j, nseg_j, _ = partials(cfg_j, P, jpid, jpk, jvals, valid, k_bound,
                                 fx_bits)

    tenc = te.encode(convert.dataset_from_arrays(
        None if enforced else pid, pk, values), None, None,
        require_pid=not enforced, vector_size=6)
    tpid, tpk, tvals = te.put_on_device(tenc, torch.device("cpu"))
    part_t, nseg_t, qrows_t = te._partials(cfg_t, P, tpid, tpk, tvals,
                                           convert.key_from_jax(k_bound),
                                           fx_bits)
    assert qrows_t is None
    assert sorted(part_t) == sorted(part_j) == ["count", "vector_sum"]
    n_lanes = -(-te._FX_PAYLOAD_BITS // fx_bits)
    assert tuple(part_t["vector_sum"].shape) == (P, 6 * n_lanes)
    for name in part_j:
        assert part_t[name].dtype == torch.int32
        np.testing.assert_array_equal(part_t[name].numpy(),
                                      np.asarray(part_j[name]), err_msg=name)
    np.testing.assert_array_equal(nseg_t.numpy(), np.asarray(nseg_j))


# ---------------------------------------------------------------------------
# The whole slice: DPEngine.aggregate(VECTOR_SUM)
# ---------------------------------------------------------------------------


def _run_jax(col, params, public, seed, extractors=None):
    acc = pdp.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    result = pdp.DPEngine(acc, JaxBackend(rng_seed=seed)).aggregate(
        col, params, extractors or pdp.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    return list(result)


def _run_torch(col, params, public, seed, extractors=None):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    result = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed)
                          ).aggregate(col, convert.params_from_reference(
                              params), extractors or pdt.DataExtractors(),
                              public_partitions=public)
    acc.compute_budgets()
    return list(result)


def _vectors(rows):
    return np.stack([np.asarray(m.vector_sum, np.float64) for _, m in rows])


def _assert_identical(got, want):
    assert len(want) > 0
    assert [k for k, _ in got] == [k for k, _ in want]
    assert all(m._fields == ("vector_sum",) for _, m in got)
    assert _vectors(got).tobytes() == _vectors(want).tobytes()


PUBLIC = list(range(0, 90)) + [500, 501]
E2E = [(noise, norm, public)
       for noise in ("LAPLACE", "GAUSSIAN")
       for norm in ("L1", "L2", "Linf")
       for public in (False, True)]


@pytest.mark.parametrize("noise,norm,public", E2E)
def test_aggregate_fx_bit_identical(noise, norm, public, monkeypatch):
    monkeypatch.setenv(ACC_ENV, "fx")
    params = _params(noise_kind=pdp.NoiseKind[noise],
                     vector_norm_kind=pdp.NormKind[norm])
    pid, pk, values = _data(len(norm))
    public = PUBLIC if public else None
    want = _run_jax(je.ArrayDataset(pid, pk, values), params, public, 13)
    got = _run_torch(convert.dataset_from_arrays(pid, pk, values), params,
                     public, 13)
    _assert_identical(got, want)


@pytest.mark.parametrize("case", ["bounds_enforced", "full_fetch",
                                  "row_tuples", "jax_pallas_kernels"])
def test_aggregate_fx_bit_identical_paths(case, monkeypatch):
    """Bounds already enforced; the full fetch (more partitions kept than
    the compact cap, so the noise is keyed by arange over the vocab);
    row tuples with itemgetter extractors; and the JAX side on its Pallas
    kernels (K1 and K2 in interpret mode)."""
    monkeypatch.setenv(ACC_ENV, "fx")
    params = _params()
    pid, pk, values = _data(4)
    jcol = je.ArrayDataset(pid, pk, values)
    tcol = convert.dataset_from_arrays(pid, pk, values)
    jx = tx = None
    if case == "bounds_enforced":
        params = _params(contribution_bounds_already_enforced=True)
        jcol = je.ArrayDataset(None, pk, values)
        tcol = convert.dataset_from_arrays(None, pk, values)
    elif case == "full_fetch":
        monkeypatch.setattr(je, "_COMPACT_FETCH_CAP", 2)
        monkeypatch.setattr(te, "_COMPACT_FETCH_CAP", 2)
    elif case == "row_tuples":
        jcol = tcol = list(zip(pid.tolist(), pk.tolist(), list(values)))
        getters = dict(privacy_id_extractor=operator.itemgetter(0),
                       partition_extractor=operator.itemgetter(1),
                       value_extractor=operator.itemgetter(2))
        jx, tx = pdp.DataExtractors(**getters), pdt.DataExtractors(**getters)
    else:
        monkeypatch.setenv("PIPELINEDP_TPU_KERNEL_BACKEND", "pallas")
        pid, pk, values = _data(4, n=1500, parts=40)
        jcol = je.ArrayDataset(pid, pk, values)
        tcol = convert.dataset_from_arrays(pid, pk, values)
    want = _run_jax(jcol, params, None, 17, jx)
    got = _run_torch(tcol, params, None, 17, tx)
    if case == "full_fetch":
        assert len(want) > 2
    _assert_identical(got, want)


@pytest.mark.parametrize("public", [False, True])
def test_aggregate_f32_within_the_summation_bound(public, monkeypatch):
    """Under ``f32`` both packages sum the kept rows of a partition in
    float32, in different orders. Each sum of n terms then sits within
    (n - 1) * 2^-24 * sum|x| of the exact sum (the standard bound for
    recursive summation; pairwise or atomic orders do no worse), so two
    orders differ by at most twice that. Clipping to a norm ball moves
    two vectors no further apart than 2x their distance (L1 and L2
    rescaling, Linf clip: 1x), and the noise is bit-identical, so the
    released vectors stay within 4 * n_max * 2^-24 * S_max, with n_max the
    most rows and S_max the largest sum|x| in one partition."""
    monkeypatch.setenv(ACC_ENV, "f32")
    params = _params(noise_kind=pdp.NoiseKind.LAPLACE,
                     max_contributions_per_partition=3)
    pid, pk, values = _data(6)
    public = PUBLIC if public else None
    want = _run_jax(je.ArrayDataset(pid, pk, values), params, public, 23)
    got = _run_torch(convert.dataset_from_arrays(pid, pk, values), params,
                     public, 23)
    assert len(want) > 0
    assert [k for k, _ in got] == [k for k, _ in want]
    # Bound from the raw rows of each partition (bounding only drops rows).
    n_max = int(np.bincount(pk).max())
    s_max = float(np.bincount(pk, weights=np.abs(values).sum(axis=1)).max())
    tol = 4 * n_max * 2.0**-24 * s_max
    np.testing.assert_allclose(_vectors(got), _vectors(want), rtol=0,
                               atol=tol)


def test_accumulator_resolution(monkeypatch):
    """Environment, then the module seam, then "f32", as the JAX knob
    resolves; only params with a vector_size resolve it."""
    tparams = convert.params_from_reference(_params())
    monkeypatch.delenv(ACC_ENV, raising=False)
    assert te.FusedConfig.from_params(tparams, True).vector_accumulator == (
        "f32")
    monkeypatch.setattr(te, "_VECTOR_ACCUMULATOR", "fx")
    assert te.FusedConfig.from_params(tparams, True).vector_accumulator == (
        "fx")
    monkeypatch.setenv(ACC_ENV, "F32 ")
    assert te.FusedConfig.from_params(tparams, True).vector_accumulator == (
        "f32")
    monkeypatch.setenv(ACC_ENV, "bogus")
    assert te.FusedConfig.from_params(tparams, True).vector_accumulator == (
        "f32")
    monkeypatch.setenv(ACC_ENV, "fx")
    scalar = convert.params_from_reference(pdp.AggregateParams(
        metrics=[M.COUNT], max_partitions_contributed=1,
        max_contributions_per_partition=1))
    assert te.FusedConfig.from_params(scalar, True).vector_accumulator == (
        "f32")


def test_unseeded_release_has_the_expected_shape(monkeypatch):
    monkeypatch.setenv(ACC_ENV, "fx")
    pid, pk, values = _data(8)
    got = _run_torch(convert.dataset_from_arrays(pid, pk, values),
                     _params(), PUBLIC, None)
    vec = _vectors(got)
    assert vec.shape == (len(PUBLIC), 5) and np.isfinite(vec).all()


@pytest.mark.parametrize("case", ["max_contributions", "beside_count"])
def test_rejections_in_both_packages(case):
    pid, pk, values = _data(0, n=200)
    if case == "max_contributions":
        kw = dict(metrics=[M.VECTOR_SUM], vector_size=5, vector_max_norm=1.0,
                  max_contributions=3)
        params = pdp.AggregateParams(**kw)
        with pytest.raises(NotImplementedError, match="max_contributions"):
            _run_jax(je.ArrayDataset(pid, pk, values), params, None, 0)
        with pytest.raises(NotImplementedError, match="max_contributions"):
            _run_torch(convert.dataset_from_arrays(pid, pk, values), params,
                       None, 0)
    else:
        kw = dict(metrics=[M.VECTOR_SUM, M.COUNT], vector_size=5,
                  vector_max_norm=1.0, max_partitions_contributed=1,
                  max_contributions_per_partition=1)
        with pytest.raises(ValueError, match="VECTOR_SUM"):
            pdp.AggregateParams(**kw)
        kw["metrics"] = [pdt.Metrics.VECTOR_SUM, pdt.Metrics.COUNT]
        with pytest.raises(ValueError, match="VECTOR_SUM"):
            pdt.AggregateParams(**kw)
