"""PERCENTILE in the port (``torch_engine``'s quantile walk) against the JAX
package's, on the CPU.

Every comparison is exact: the leaf mapping, the node noise, the level
counts, each descent step, the whole walk (one block, partition blocks
under a shrunken byte cap, and at a cap that sends the JAX package to its
per-level-scatter path), and ``DPEngine.aggregate`` end to end (kept keys,
float32 percentiles, float64 scalars). The JAX side runs jitted, as the
engine runs it: XLA's CPU code decides the float32 order of the walk's
sums and which multiply-adds it contracts, and the port follows it.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pipelinedp_tpu as pdp
from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.aggregate_params import NoiseKind as JNoiseKind
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import convert
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.ops import quantile_tree
from pipelinedp_tpu_torch.ops.kernels import hist

M = pdp.Metrics
EPS, DELTA = 1.0, 1e-6
B, SPAN = 16, 256
CAP_ENV = "PIPELINEDP_TPU_SUBHIST_CAP"


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _assert_bit_equal(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


def _config(percentiles=(50, 90), noise="LAPLACE", lo=0.0, hi=10.0,
            public=False, **kw):
    kw.setdefault("max_partitions_contributed", 3)
    kw.setdefault("max_contributions_per_partition", 2)
    params = pdp.AggregateParams(
        metrics=[M.PERCENTILE(p) for p in percentiles],
        noise_kind=pdp.NoiseKind[noise], min_value=lo, max_value=hi, **kw)
    return (je.FusedConfig.from_params(params, public),
            te.FusedConfig.from_params(
                convert.params_from_reference(params), public), params)


def test_tree_constants_match():
    from pipelinedp_tpu.ops import quantile_tree as jqt
    assert quantile_tree.tree_constants() == jqt.tree_constants() == (
        16, 4, 256, 256)
    assert (quantile_tree.DEFAULT_TREE_HEIGHT,
            quantile_tree.DEFAULT_BRANCHING_FACTOR) == (
                jqt.DEFAULT_TREE_HEIGHT, jqt.DEFAULT_BRANCHING_FACTOR)


def test_config_budgets_and_field_order():
    cfg_j, cfg_t, params = _config(percentiles=(90, 10, 99.9, 50))
    assert cfg_t.metrics == cfg_j.metrics == ("PERCENTILE",)
    assert cfg_t.percentiles == cfg_j.percentiles
    params = pdp.AggregateParams(
        metrics=[M.COUNT, M.PERCENTILE(75), M.VARIANCE, M.PERCENTILE(5.5)],
        min_value=-1.0, max_value=4.0, max_partitions_contributed=2,
        max_contributions_per_partition=3)
    cfg_j = je.FusedConfig.from_params(params, public=True)
    cfg_t = te.FusedConfig.from_params(convert.params_from_reference(params),
                                       public=True)
    assert te._metric_field_order(cfg_t) == je._metric_field_order(cfg_j)
    assert te._metric_field_order(cfg_t)[-2:] == ["percentile_75",
                                                  "percentile_5_5"]
    acc_j = pdp.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    acc_t = pdt.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    specs_j = je.request_budgets(cfg_j, params, acc_j)
    specs_t = te.request_budgets(cfg_t, convert.params_from_reference(params),
                                 acc_t)
    acc_j.compute_budgets()
    acc_t.compute_budgets()
    assert list(specs_t) == list(specs_j)
    for name in specs_j:
        assert (specs_t[name].eps, specs_t[name].delta) == (
            specs_j[name].eps, specs_j[name].delta)

    class _Spec:
        eps, delta = 0.7, 1e-6

    for noise in pdp.NoiseKind:
        for total_cap in (None, 7):
            kw = dict(noise_kind=noise, max_contributions=total_cap)
            if total_cap:
                kw.update(l0=None, linf=None)
            cfg_j2 = dataclasses.replace(cfg_j, **kw)
            kw["noise_kind"] = pdt.NoiseKind[noise.name]
            cfg_t2 = dataclasses.replace(cfg_t, **kw)
            _assert_bit_equal(te._noise_scales(cfg_t2, {"percentile": _Spec}),
                              je._noise_scales(cfg_j2, {"percentile": _Spec}),
                              noise.name)


@pytest.mark.parametrize("percentile_range", [(0.0, 10.0), (-3.5, 2.25),
                                              (1e-3, 1e6)])
def test_qrows_bit_equal(percentile_range):
    """The range edges, values beyond both, the top leaf (the upper bound
    maps past the last leaf and is clamped back), and rows not kept."""
    lo, hi = percentile_range
    cfg_j, cfg_t, _ = _config(lo=lo, hi=hi)
    rng = np.random.default_rng(7)
    n = 5000
    span = hi - lo
    values = np.concatenate([
        rng.uniform(lo - span, hi + span, n - 8),
        [lo, hi, np.nextafter(np.float32(hi), np.float32(-np.inf)),
         np.nextafter(np.float32(lo), np.float32(np.inf)), lo - 1, hi + 1,
         lo + span / 2, lo + span * (65535 / 65536)]]).astype(np.float32)
    pk = rng.integers(0, 37, n).astype(np.int32)
    kept = rng.random(n) < 0.7
    want = jax.jit(functools.partial(je._qrows, cfg_j))(
        jnp.asarray(pk), jnp.asarray(values), jnp.asarray(kept))
    got = te._qrows(cfg_t, torch.from_numpy(pk), torch.from_numpy(values),
                    torch.from_numpy(kept))
    for name, g, w in zip(("qpk", "leaf", "kept"), got, want):
        _assert_bit_equal(g, w, name)
    assert int(got[1].max()) == 65535 and int(got[1].min()) == 0


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
def test_node_noise_bit_equal(noise):
    rng = np.random.default_rng(3)
    key = jax.random.PRNGKey(17)
    node_ids = rng.integers(0, 69904, (40, 3, B)).astype(np.int32)
    pk_index = rng.integers(0, 2**31, 40).astype(np.uint32)
    for pki in (None, pk_index):
        want = jax.jit(functools.partial(
            je._node_noise, JNoiseKind[noise], key))(
                jnp.asarray(node_ids),
                None if pki is None else jnp.asarray(pki))
        got = te._node_noise(pdt.NoiseKind[noise], convert.key_from_jax(key),
                             torch.from_numpy(node_ids),
                             None if pki is None else
                             torch.from_numpy(pki.astype(np.int64)))
        _assert_bit_equal(got, want, noise)


def test_mid_and_sub_level_counts_bit_equal():
    rng = np.random.default_rng(11)
    P, Q = 32, 3
    mid = rng.integers(0, 500, (P, 256)).astype(np.int32)
    for w, base_hi in ((4096, 1), (256, 16)):
        base = (rng.integers(0, base_hi, (P, Q)) * 16 // max(1, base_hi)
                ).astype(np.int32) if base_hi > 1 else np.zeros((P, Q),
                                                                np.int32)
        want = jax.jit(je._mid_level_counts, static_argnums=(2, 3, 4))(
            jnp.asarray(mid), jnp.asarray(base), w, 256, B)
        got = te._mid_level_counts(torch.from_numpy(mid),
                                   torch.from_numpy(base), w, 256, B)
        _assert_bit_equal(got, want, f"mid w={w}")
    sub = rng.integers(0, 300, (P, Q, SPAN)).astype(np.int32)
    sub_start = (rng.integers(0, 256, (P, Q)) * 256).astype(np.int32)
    for w, step in ((16, 256), (1, 16)):
        leaf_lo = sub_start + (rng.integers(0, 16, (P, Q)) * 16 *
                               (step == 16)).astype(np.int32)
        want = jax.jit(je._sub_level_counts, static_argnums=(3, 4))(
            jnp.asarray(sub), jnp.asarray(sub_start), jnp.asarray(leaf_lo),
            w, B)
        got = te._sub_level_counts(torch.from_numpy(sub),
                                   torch.from_numpy(sub_start),
                                   torch.from_numpy(leaf_lo), w, B)
        _assert_bit_equal(got, want, f"sub w={w}")


def _walk_state(rng, P, Q, zeros=0.3):
    """Noisy child counts with zero rows, zero children and ties, and a
    walk state with some rows already done."""
    noisy = (rng.integers(0, 40, (P, Q, B)) +
             rng.laplace(0, 5, (P, Q, B))).astype(np.float32)
    noisy = np.maximum(noisy, 0).astype(np.float32)
    noisy[rng.random((P, Q, B)) < zeros] = 0.0
    noisy[:3] = 0.0  # whole nodes without signal
    noisy[3:6] = 2.5  # ties everywhere
    lo = rng.uniform(0, 5, (P, Q)).astype(np.float32)
    hi = (lo + rng.uniform(0.001, 5, (P, Q))).astype(np.float32)
    target = rng.random((P, Q)).astype(np.float32)
    target[6:8] = 0.0
    target[8:10] = 1.0
    leaf_lo = (rng.integers(0, 16, (P, Q)) * 4096).astype(np.int32)
    done = rng.random((P, Q)) < 0.15
    return noisy, lo, hi, target, leaf_lo, done


def test_walk_step_bit_equal():
    rng = np.random.default_rng(5)
    noisy, *state = _walk_state(rng, 200, 3)
    want = jax.jit(je._walk_step, static_argnums=(6, 7))(
        jnp.asarray(noisy), *(jnp.asarray(x) for x in state), B, 256)
    got = te._walk_step(torch.from_numpy(noisy),
                        *(torch.from_numpy(x) for x in state), B, 256)
    for name, g, w in zip(("lo", "hi", "target", "leaf_lo", "done"), got,
                          want):
        _assert_bit_equal(g, w, name)


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("level", [1, 2, 3])
def test_walk_level_bit_equal(noise, level):
    """One level below the root as its own program."""
    rng = np.random.default_rng(level + 10)
    P, Q = 64, 3
    key = jax.random.PRNGKey(level)
    scale = np.float32(3.7)
    w = B**(3 - level)
    level_offset = sum(B**(lv + 1) for lv in range(level))
    raw = rng.integers(0, 60, (P, Q, B)).astype(np.float32)
    raw[rng.random((P, Q, B)) < 0.4] = 0.0
    _, lo, hi, target, _, done = _walk_state(rng, P, Q)
    leaf_lo = (rng.integers(0, 65536 // (w * B), (P, Q)) * w * B).astype(
        np.int32)
    base = leaf_lo // w
    pk_index = (rng.integers(0, 1000) + np.arange(P)).astype(np.uint32)

    def jax_level(raw, base, lo, hi, target, leaf_lo, done, scale, pki):
        return je._walk_level(JNoiseKind[noise], key, scale, raw, base,
                              level_offset, lo, hi, target, leaf_lo, done,
                              B, w, pk_index=pki)

    want = jax.jit(jax_level)(*(jnp.asarray(x) for x in (
        raw, base, lo, hi, target, leaf_lo, done)), jnp.float32(scale),
        jnp.asarray(pk_index))
    got = te._walk_level(pdt.NoiseKind[noise], convert.key_from_jax(key),
                         float(scale), *(torch.from_numpy(x) for x in (
                             raw, base)), level_offset,
                         *(torch.from_numpy(x) for x in (
                             lo, hi, target, leaf_lo, done)), B, w,
                         pk_index=torch.from_numpy(pk_index.astype(np.int64)))
    for name, g, wv in zip(("lo", "hi", "target", "leaf_lo", "done"), got,
                           want):
        _assert_bit_equal(g, wv, name)


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("P,Q", [(64, 3), (512, 5)])
def test_walk_level_root_bit_equal(noise, P, Q):
    """The root level (one draw per (partition, child), broadcast over the
    quantiles) in the program every walk runs it in: its child counts
    gathered from the mid histogram. XLA's CPU code rounds the root's
    noisy counts differently when they arrive as a bare input, so the
    root is held to the JAX package in its real context."""
    rng = np.random.default_rng(P + Q)
    mid = rng.integers(0, 60, (P, 256)).astype(np.int32)
    mid[rng.random((P, 256)) < 0.4] = 0
    key = jax.random.PRNGKey(P)
    scale = np.float32(3.7)
    quantiles = np.asarray([0.5, 0.1, 0.99, 0.3, 0.7][:Q], np.float32)
    w = B**3

    def jax_root(mid, scale):
        leaf_lo = jnp.zeros((P, Q), jnp.int32)
        raw = je._mid_level_counts(mid, leaf_lo, w, SPAN, B)
        return je._walk_level(
            JNoiseKind[noise], key, scale, raw, leaf_lo, 0,
            jnp.full((P, Q), 0.0, jnp.float32),
            jnp.full((P, Q), 10.0, jnp.float32),
            jnp.broadcast_to(quantiles[None, :], (P, Q)), leaf_lo,
            jnp.zeros((P, Q), bool), B, w)

    want = jax.jit(jax_root)(jnp.asarray(mid), jnp.float32(scale))
    leaf_lo = torch.zeros((P, Q), dtype=torch.int32)
    raw = te._mid_level_counts(torch.from_numpy(mid), leaf_lo, w, SPAN, B)
    got = te._walk_level(
        pdt.NoiseKind[noise], convert.key_from_jax(key), float(scale), raw,
        leaf_lo, 0, torch.full((P, Q), 0.0), torch.full((P, Q), 10.0),
        torch.from_numpy(quantiles).expand(P, Q), leaf_lo,
        torch.zeros((P, Q), dtype=torch.bool), B, w)
    for name, g, wv in zip(("lo", "hi", "target", "leaf_lo", "done"), got,
                           want):
        _assert_bit_equal(g, wv, name)


def test_monotone_in_q_bit_equal():
    rng = np.random.default_rng(2)
    vals = rng.uniform(0, 10, (50, 5)).astype(np.float32)
    quantiles = np.asarray([0.9, 0.1, 0.5, 0.999, 0.25], np.float32)
    want = jax.jit(functools.partial(je._monotone_in_q,
                                     quantiles=quantiles))(jnp.asarray(vals))
    got = te._monotone_in_q(torch.from_numpy(vals), quantiles)
    _assert_bit_equal(got, want)


# ---------------------------------------------------------------------------
# The whole single-batch walk
# ---------------------------------------------------------------------------


def _qrows_case(seed, P, n=30_000):
    """Rows over ``P`` partitions with clustered leaves, so the walks
    descend into few subtrees and the bottom levels see real counts."""
    rng = np.random.default_rng(seed)
    qpk = rng.integers(0, P, n).astype(np.int32)
    centre = rng.integers(0, 65536, P)
    leaf = np.clip(centre[qpk] + rng.normal(0, 3000, n), 0, 65535).astype(
        np.int32)
    kept = rng.random(n) < 0.8
    return qpk * kept, leaf, kept


@pytest.mark.parametrize("noise", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("cap,blocks", [(None, 1), ("pair", 8),
                                        ("per_level", 64)])
def test_percentile_values_bit_equal(noise, cap, blocks, monkeypatch):
    """One block; partition blocks of 2 under a shrunken cap (the JAX
    package's block-chunked walk); and a cap below one partition's
    [1, Q, span] block, where the JAX package takes its per-level row
    scatters and the port walks 64 one-partition blocks."""
    P, Q = (16 if cap == "pair" else 64), 3
    cfg_j, cfg_t, _ = _config(percentiles=(50, 10, 99), noise=noise)
    if cap == "pair":
        monkeypatch.setenv(CAP_ENV, str(2 * Q * SPAN * 4))
    elif cap == "per_level":
        monkeypatch.setenv(CAP_ENV, str(Q * SPAN * 4 - 1))
    qrows = _qrows_case(P + len(noise), P)
    key = jax.random.PRNGKey(P)
    scale = np.float32(2.75)
    want = jax.jit(functools.partial(je._percentile_values, cfg_j, P))(
        tuple(jnp.asarray(x) for x in qrows), jnp.float32(scale), key)
    before = hist.LAUNCHES["subtree_counts_multi"]
    seen = []
    orig = te._subtree_counts_multi

    def spy(qpk, leaf, kept, sub_starts, p_offsets, Pb, span, out=None):
        seen.append(Pb)
        return orig(qpk, leaf, kept, sub_starts, p_offsets, Pb, span, out)

    monkeypatch.setattr(te, "_subtree_counts_multi", spy)
    got = te._percentile_values(cfg_t, P,
                                tuple(torch.from_numpy(x) for x in qrows),
                                float(scale), convert.key_from_jax(key))
    assert len(seen) == blocks and sum(seen) == P
    assert hist.LAUNCHES["subtree_counts_multi"] == before  # CPU: plain
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("scale,seed", [(0.2, 4), (0.05, 1), (1.0, 3)])
def test_percentile_values_one_quantile_bit_equal(scale, seed):
    """One quantile and a small noise scale: with nothing to broadcast
    over Q, XLA's root step takes its running sum and its total over the
    fused noisy counts. (0.2, 4) released a value one float32 step off
    the JAX package's while the port summed a second, unfused copy
    there."""
    P = 12
    cfg_j, cfg_t, _ = _config(percentiles=(50,))
    rng = np.random.default_rng(seed)
    n = 600
    qpk = rng.integers(0, P, n).astype(np.int32)
    leaf = rng.integers(0, 65536, n).astype(np.int32)
    kept = rng.random(n) < 0.8
    qrows = (qpk * kept, leaf, kept)
    key = jax.random.PRNGKey(seed)
    want = jax.jit(functools.partial(je._percentile_values, cfg_j, P))(
        tuple(jnp.asarray(x) for x in qrows), jnp.float32(scale), key)
    got = te._percentile_values(cfg_t, P,
                                tuple(torch.from_numpy(x) for x in qrows),
                                float(np.float32(scale)),
                                convert.key_from_jax(key))
    _assert_bit_equal(got, want)


# ---------------------------------------------------------------------------
# The whole slice: DPEngine.aggregate with PERCENTILE
# ---------------------------------------------------------------------------


def _data(seed=0, n=8000, users=3000, parts=300):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.2, n) % parts).astype(np.int64)
    values = rng.uniform(-1.0, 11.0, n)
    return pid, pk, values


def _params(percentiles=(50, 90), extra=(), noise="LAPLACE", **kw):
    base = dict(max_partitions_contributed=3,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)
    base.update(kw)
    return pdp.AggregateParams(
        metrics=[M.PERCENTILE(p) for p in percentiles] + list(extra),
        noise_kind=pdp.NoiseKind[noise], **base)


E2E_CASES = {
    "alone_laplace_private": (_params(), None),
    "alone_gaussian_public": (_params(noise="GAUSSIAN"), list(range(60))),
    "with_scalars_laplace_public": (
        _params((25, 75), extra=[M.COUNT, M.SUM, M.VARIANCE]),
        list(range(40)) + [999]),
    "with_scalars_gaussian_private": (
        _params((99, 1, 50), extra=[M.COUNT, M.SUM, M.VARIANCE],
                noise="GAUSSIAN"), None),
    "unsorted_many": (_params((90, 10, 99.9, 50, 5.5)), None),
    "total_cap": (pdp.AggregateParams(
        metrics=[M.PERCENTILE(50), M.PERCENTILE(95), M.COUNT],
        max_contributions=6, min_value=-2.0, max_value=12.0), None),
    "total_cap_gaussian_public": (pdp.AggregateParams(
        metrics=[M.PERCENTILE(20), M.SUM], max_contributions=5,
        noise_kind=pdp.NoiseKind.GAUSSIAN, min_value=0.0, max_value=10.0),
        list(range(50))),
    "bounds_enforced": (_params((50, 90), extra=[M.COUNT],
                                contribution_bounds_already_enforced=True),
                        None),
    "bounds_enforced_gaussian_public": (
        _params((30,), noise="GAUSSIAN",
                contribution_bounds_already_enforced=True), list(range(30))),
}


def _run_jax(col, params, public, seed):
    acc = pdp.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    result = pdp.DPEngine(acc, JaxBackend(rng_seed=seed)).aggregate(
        col, params, pdp.DataExtractors(), public_partitions=public)
    acc.compute_budgets()
    return list(result)


def _run_torch(col, params, public, seed):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=EPS, total_delta=DELTA)
    result = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed)
                          ).aggregate(col, convert.params_from_reference(
                              params), pdt.DataExtractors(),
                              public_partitions=public)
    acc.compute_budgets()
    return list(result), result


def _assert_identical(got, want):
    """Kept keys in order; every field bit-identical (percentiles are
    float32 values, scalars float64)."""
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, a), (_, b) in zip(got, want):
        assert a._fields == b._fields
        for x, y in zip(a, b):
            assert np.float64(x).tobytes() == np.float64(y).tobytes()


@pytest.mark.parametrize("case", sorted(E2E_CASES))
def test_aggregate_percentile_bit_identical(case):
    params, public = E2E_CASES[case]
    seed = len(case)
    pid, pk, values = _data(seed)
    if params.contribution_bounds_already_enforced:
        pid = None
    want = _run_jax(je.ArrayDataset(pid, pk, values), params, public, seed)
    got, result = _run_torch(convert.dataset_from_arrays(pid, pk, values),
                             params, public, seed)
    assert len(want) > 0
    _assert_identical(got, want)
    assert any(f.startswith("percentile_") for f in got[0][1]._fields)
    assert set(result.timings) == {"host_encode_s", "device_s",
                                   "host_decode_s"}


def test_aggregate_full_fetch_bit_identical(monkeypatch):
    """More kept partitions than the compact block holds: both packages
    fetch every partition and release them all, the float32 percentile
    columns bitcast through the int32 block."""
    monkeypatch.setattr(te, "_COMPACT_FETCH_CAP", 4)
    monkeypatch.setattr(je, "_COMPACT_FETCH_CAP", 4)
    params = _params((50, 75), extra=[M.COUNT], max_partitions_contributed=5)
    pid, pk, values = _data(4, n=20000, parts=40)
    want = _run_jax(je.ArrayDataset(pid, pk, values), params, None, 4)
    got, _ = _run_torch(convert.dataset_from_arrays(pid, pk, values),
                        params, None, 4)
    assert len(want) > 4
    _assert_identical(got, want)


@pytest.mark.parametrize("seed", [7, 17, 19, 104])
def test_aggregate_one_percentile_bit_identical(seed):
    """COUNT and one PERCENTILE at a large budget (the resident service's
    cross-package case): each seed here released one percentile one
    float32 step off the JAX package's before the port's root step
    followed XLA's one-quantile program."""
    rng = np.random.default_rng(17)
    n = 3000
    pid = rng.integers(0, 150, n)
    pk = rng.integers(0, 12, n)
    values = rng.uniform(0.0, 10.0, n)
    params = pdp.AggregateParams(
        metrics=[M.COUNT, M.PERCENTILE(50)], min_value=0.0, max_value=10.0,
        noise_kind=pdp.NoiseKind.LAPLACE, max_partitions_contributed=3,
        max_contributions_per_partition=2)
    acc = pdp.NaiveBudgetAccountant(total_epsilon=20.0, total_delta=1e-6)
    result = pdp.DPEngine(acc, JaxBackend(rng_seed=seed)).aggregate(
        je.ArrayDataset(pid, pk, values), params, pdp.DataExtractors())
    acc.compute_budgets()
    want = list(result)
    acc = pdt.NaiveBudgetAccountant(total_epsilon=20.0, total_delta=1e-6)
    result = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=seed)
                          ).aggregate(
        convert.dataset_from_arrays(pid, pk, values),
        convert.params_from_reference(params), pdt.DataExtractors())
    acc.compute_budgets()
    got = list(result)
    assert len(want) > 0
    _assert_identical(got, want)
