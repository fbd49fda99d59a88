"""The port's native library (``pipelinedp_tpu_torch.native``), on the CPU.

The first half is the port's copy of ``tests/test_native.py``: the build,
the CSPRNG stream, the snapping mechanism's invariants (Mironov 2012), the
discrete samplers, the factorizer, and the opt-in wiring through the host
release. The second half holds the port to the JAX package's library bit
for bit: the same ``seed(n)`` gives the same draws from every sampler, each
library keeps its own stream in one process, the factorizers agree, and
under ``set_secure_host_noise(True)`` and ``seed_host_rng(s)`` the port's
hardened releases (the fused path's scalar metrics and VECTOR_SUM, a
streamed run, private selection, the host path) equal the JAX package's,
with the integer and float samplers called where the JAX package calls
them.
"""

import math

import numpy as np
import pytest

from pipelinedp_tpu_torch import native



@pytest.fixture(autouse=True)
def _native_library():
    """Builds (at first use) and loads the port's libraries; skips where
    ``g++`` cannot build them. Decided here, not at import, so every
    test worker collects the same tests."""
    if not (native.available() and native.encode_available()):
        pytest.skip("native toolchain unavailable")


class TestCSPRNG:

    def test_deterministic_under_seed(self):
        native.seed(42)
        a = native.uniform(1000)
        native.seed(42)
        b = native.uniform(1000)
        np.testing.assert_array_equal(a, b)
        native.seed(43)
        c = native.uniform(1000)
        assert not np.array_equal(a, c)

    def test_uniform_range_and_moments(self):
        native.seed(0)
        u = native.uniform(200_000)
        assert u.min() > 0.0 and u.max() <= 1.0
        assert u.mean() == pytest.approx(0.5, abs=0.005)
        assert u.var() == pytest.approx(1 / 12, rel=0.02)

    def test_os_seeding_differs(self):
        native.seed_from_os()
        a = native.uniform(64)
        native.seed_from_os()
        b = native.uniform(64)
        assert not np.array_equal(a, b)


class TestSnappingLaplace:

    def test_outputs_are_multiples_of_lambda(self):
        native.seed(1)
        scale = 3.0  # Lambda = 4
        out = native.snapping_laplace(np.zeros(5000), scale)
        lam = 4.0
        np.testing.assert_allclose(out / lam, np.round(out / lam),
                                   atol=1e-12)

    def test_statistics_match_laplace(self):
        native.seed(2)
        scale = 2.0
        out = native.snapping_laplace(np.full(200_000, 10.0), scale)
        noise = out - 10.0
        # Snapping adds <= Lambda/2 rounding, preserving the moments.
        assert noise.mean() == pytest.approx(0.0, abs=0.05)
        assert noise.std() == pytest.approx(scale * math.sqrt(2),
                                            rel=0.02)

    def test_clamping(self):
        native.seed(3)
        with pytest.warns(UserWarning, match="clamp bound"):
            out = native.snapping_laplace(np.array([1e9, -1e9]), 1.0,
                                          bound=100.0)
        assert out[0] == 100.0 and out[1] == -100.0

    def test_value_plus_noise_not_raw_float(self):
        # The release must NOT equal value + ieee-laplace noise bit
        # pattern: its mantissa below Lambda is zero.
        native.seed(4)
        out = native.snapping_laplace(np.full(100, math.pi), 1.0)
        lam = 1.0
        assert np.all(out == np.round(out / lam) * lam)


class TestDiscreteLaplace:

    def test_integer_noise_distribution(self):
        native.seed(5)
        b = 2.0
        out = native.discrete_laplace(np.zeros(200_000, np.int64), b)
        assert out.dtype == np.int64
        q = math.exp(-1.0 / b)
        # Two-sided geometric: Var = 2q/(1-q)^2.
        assert out.mean() == pytest.approx(0.0, abs=0.05)
        assert out.var() == pytest.approx(2 * q / (1 - q)**2, rel=0.03)
        # P(0) = (1-q)/(1+q).
        p0 = (out == 0).mean()
        assert p0 == pytest.approx((1 - q) / (1 + q), abs=0.01)


class TestDiscreteGaussian:

    def test_integer_noise_distribution(self):
        native.seed(9)
        sigma = 7.5
        out = native.discrete_gaussian(np.zeros(200_000, np.int64), sigma)
        assert out.dtype == np.int64
        # For sigma >> 1 the discrete Gaussian's moments match the
        # continuous one's to O(exp(-2 pi^2 sigma^2)) — far below the
        # sampling error here.
        assert out.mean() == pytest.approx(0.0, abs=0.08)
        assert out.std() == pytest.approx(sigma, rel=0.02)
        # P(0) ~ 1 / (sqrt(2 pi) sigma).
        p0 = (out == 0).mean()
        assert p0 == pytest.approx(1.0 / (math.sqrt(2 * math.pi) * sigma),
                                   abs=0.005)

    def test_small_sigma(self):
        native.seed(10)
        out = native.discrete_gaussian(np.zeros(100_000, np.int64), 0.3)
        # Heavily concentrated at 0; variance matches the theta-function
        # sum, computed directly.
        ks = np.arange(-20, 21)
        w = np.exp(-(ks**2) / (2 * 0.3**2))
        var = float((w * ks**2).sum() / w.sum())
        assert out.var() == pytest.approx(var, rel=0.05)

    def test_sigma_bounds(self):
        with pytest.raises(ValueError):
            native.discrete_gaussian(np.array([0]), 0.0)
        with pytest.raises(ValueError):
            native.discrete_gaussian(np.array([0]), 2.0**41)


class TestSecureGaussian:

    def test_outputs_on_granularity_grid(self):
        native.seed(11)
        sigma = 2.0
        out = native.secure_gaussian(np.full(5000, math.pi), sigma)
        g = 2.0 * 2.0**-40  # lambda_for(2.0) = 2 -> g = 2 * 2^-40
        np.testing.assert_allclose(out / g, np.round(out / g), atol=1e-6)

    def test_statistics_match_gaussian(self):
        native.seed(12)
        sigma = 3.25
        out = native.secure_gaussian(np.full(100_000, 10.0), sigma)
        noise = out - 10.0
        assert noise.mean() == pytest.approx(0.0, abs=0.05)
        assert noise.std() == pytest.approx(sigma, rel=0.02)
        # Normality probe: fourth standardized moment (kurtosis) = 3.
        z = noise / noise.std()
        assert np.mean(z**4) == pytest.approx(3.0, abs=0.15)

    def test_clamping_and_warning(self):
        native.seed(13)
        with pytest.warns(UserWarning, match="clamp bound"):
            out = native.secure_gaussian(np.array([1e9, -1e9]), 1.0,
                                         bound=50.0)
        # Inputs clamp to +/-50 BEFORE noise; the release stays within
        # the bound and within a few sigma of it.
        assert np.all(np.abs(out) <= 50.0)
        assert out[0] == pytest.approx(50.0, abs=6.0)
        assert out[1] == pytest.approx(-50.0, abs=6.0)


class TestHostPathWiring:

    def test_secure_laplace_release_is_snapped(self):
        import pipelinedp_tpu_torch as pdp
        from pipelinedp_tpu_torch import dp_computations
        from pipelinedp_tpu_torch.ops import noise as noise_ops

        params = dp_computations.ScalarNoiseParams(
            eps=1.0, delta=0.0, min_value=0.0, max_value=1.0,
            min_sum_per_partition=None, max_sum_per_partition=None,
            max_partitions_contributed=1,
            max_contributions_per_partition=1,
            noise_kind=pdp.NoiseKind.LAPLACE)
        noise_ops.set_secure_host_noise(True)
        try:
            native.seed(6)
            # Integer query (count): exact discrete Laplace — the release
            # is an integer, not a float with noise bits.
            out = dp_computations.compute_dp_count(1000, params)
            assert out == int(out)
            assert out == pytest.approx(1000, abs=30)
            # Float query (sum): snapping mechanism — multiples of Lambda.
            native.seed(7)
            sums = dp_computations.compute_dp_sum(
                np.full(50, 123.456), dp_computations.ScalarNoiseParams(
                    eps=1.0, delta=0.0, min_value=0.0, max_value=200.0,
                    min_sum_per_partition=None, max_sum_per_partition=None,
                    max_partitions_contributed=1,
                    max_contributions_per_partition=1,
                    noise_kind=pdp.NoiseKind.LAPLACE))
            lam = 256.0  # scale = 200 -> Lambda = 256
            np.testing.assert_allclose(np.asarray(sums) / lam,
                                       np.round(np.asarray(sums) / lam),
                                       atol=1e-9)
        finally:
            noise_ops.set_secure_host_noise(False)

    def test_secure_gaussian_release_is_hardened(self):
        import pipelinedp_tpu_torch as pdp
        from pipelinedp_tpu_torch import dp_computations
        from pipelinedp_tpu_torch.ops import noise as noise_ops

        params = dp_computations.ScalarNoiseParams(
            eps=1.0, delta=1e-6, min_value=0.0, max_value=1.0,
            min_sum_per_partition=None, max_sum_per_partition=None,
            max_partitions_contributed=1,
            max_contributions_per_partition=1,
            noise_kind=pdp.NoiseKind.GAUSSIAN)
        noise_ops.set_secure_host_noise(True)
        try:
            native.seed(14)
            # Integer query (count): exact discrete Gaussian — integer
            # release.
            out = dp_computations.compute_dp_count(1000, params)
            assert out == int(out)
            assert out == pytest.approx(1000, abs=60)
            # Float query: granularity-snapped discrete Gaussian.
            native.seed(15)
            sums = np.asarray(dp_computations.compute_dp_sum(
                np.full(50, 123.456), dp_computations.ScalarNoiseParams(
                    eps=1.0, delta=1e-6, min_value=0.0, max_value=200.0,
                    min_sum_per_partition=None, max_sum_per_partition=None,
                    max_partitions_contributed=1,
                    max_contributions_per_partition=1,
                    noise_kind=pdp.NoiseKind.GAUSSIAN)))
            sigma = noise_ops.gaussian_sigma(1.0, 1e-6, 200.0)
            g = 2.0**math.ceil(math.log2(sigma)) * 2.0**-40
            np.testing.assert_allclose(sums / g, np.round(sums / g),
                                       atol=1e-5)
        finally:
            noise_ops.set_secure_host_noise(False)

    @pytest.mark.parametrize("noise_kind", ["LAPLACE", "GAUSSIAN"])
    def test_secure_mode_fused_engine_matches_oracle(self, noise_kind,
                                                     monkeypatch):
        """Secure host noise enabled end to end on the fused plane, both
        noise kinds: at huge eps the hardened release still matches the
        exact aggregates (the snapping/granularity grids shrink with the
        noise scale, so no precision is lost). The engine must run with
        rng_seed=None — a seeded reproducible rng bypasses the hardened
        path by design — so the test also counts the native calls to
        prove the hardened samplers actually released the metrics."""
        import pipelinedp_tpu_torch as pdp
        from pipelinedp_tpu_torch.ops import noise as noise_ops

        calls = {"int": 0, "float": 0}
        int_fn = (native.discrete_laplace if noise_kind == "LAPLACE"
                  else native.discrete_gaussian)
        float_fn = (native.snapping_laplace if noise_kind == "LAPLACE"
                    else native.secure_gaussian)

        def count_int(vals_, scale, **kw):
            calls["int"] += 1
            return int_fn(vals_, scale, **kw)

        def count_float(vals_, scale, **kw):
            calls["float"] += 1
            return float_fn(vals_, scale, **kw)

        monkeypatch.setattr(
            native,
            "discrete_laplace" if noise_kind == "LAPLACE"
            else "discrete_gaussian", count_int)
        monkeypatch.setattr(
            native,
            "snapping_laplace" if noise_kind == "LAPLACE"
            else "secure_gaussian", count_float)

        rng = np.random.default_rng(16)
        n = 2000
        vals = rng.uniform(0.0, 10.0, n)
        pk = rng.integers(0, 5, n)
        ds = pdp.ArrayDataset(privacy_ids=np.arange(n),
                              partition_keys=pk, values=vals)
        params = pdp.AggregateParams(
            metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM, pdp.Metrics.MEAN],
            max_partitions_contributed=5,
            max_contributions_per_partition=1,
            min_value=0.0, max_value=10.0,
            noise_kind=getattr(pdp.NoiseKind, noise_kind))
        noise_ops.set_secure_host_noise(True)
        try:
            native.seed(16)
            acc = pdp.NaiveBudgetAccountant(total_epsilon=1e12,
                                            total_delta=1e-2)
            engine = pdp.DPEngine(acc, pdp.TorchBackend("cpu"))
            res = engine.aggregate(ds, params, pdp.DataExtractors(),
                                   public_partitions=list(range(5)))
            acc.compute_budgets()
            got = dict(res)
        finally:
            noise_ops.set_secure_host_noise(False)
        # COUNT releases through the integer sampler, SUM (and MEAN's
        # normalized sum) through the float one.
        assert calls["int"] >= 1 and calls["float"] >= 1
        for p in range(5):
            mask = pk == p
            assert got[p].count == pytest.approx(mask.sum(), rel=1e-3)
            assert got[p].sum == pytest.approx(vals[mask].sum(), rel=1e-3)
            assert got[p].mean == pytest.approx(vals[mask].mean(),
                                                rel=1e-3)

    def test_clamp_warning_on_oversized_release(self):
        with pytest.warns(UserWarning, match="clamp bound"):
            native.snapping_laplace(np.array([1e20]), 1e-6)

    def test_small_scale_keeps_large_release_range(self):
        # scale 1e-6 must not shrink the clamp below realistic values.
        native.seed(8)
        out = native.snapping_laplace(np.array([2.0e8]), 1e-6)
        assert out[0] == pytest.approx(2.0e8, rel=1e-6)

    def test_disabled_by_default(self):
        from pipelinedp_tpu_torch.ops import noise as noise_ops
        assert not noise_ops.secure_host_noise_enabled()


class TestFactorize:
    """The native hash factorizer must be bit-identical to
    np.unique(return_inverse=True)."""

    @pytest.mark.parametrize("gen", [
        lambda rng: rng.integers(-1000, 1000, 10_000),
        lambda rng: rng.integers(0, 2**62, 10_000),       # wide range
        lambda rng: rng.integers(0, 50, 100_000),         # heavy duplicates
        lambda rng: rng.integers(0, 2**62, 2_000_000),    # big + wide
        lambda rng: np.array([7]),                        # single element
        lambda rng: np.array([5, 5, 5, 5]),               # one unique
    ])
    def test_matches_np_unique(self, gen):
        rng = np.random.default_rng(0)
        arr = gen(rng).astype(np.int64)
        uniq, inv = native.factorize_i64(arr)
        exp_uniq, exp_inv = np.unique(arr, return_inverse=True)
        np.testing.assert_array_equal(uniq, exp_uniq)
        np.testing.assert_array_equal(inv, exp_inv)
        np.testing.assert_array_equal(uniq[inv], arr)

    def test_empty(self):
        uniq, inv = native.factorize_i64(np.array([], np.int64))
        assert uniq.size == 0 and inv.size == 0

    def test_uint64_above_int64_max_rejected(self):
        with pytest.raises(ValueError, match="wrap"):
            native.factorize_i64(np.array([2**63 + 5, 3], np.uint64))

    def test_unique_inverse_helper_matches(self):
        # The engine helper must agree with np.unique regardless of
        # whether the native path engaged.
        from pipelinedp_tpu_torch.torch_engine import _unique_inverse
        rng = np.random.default_rng(1)
        for arr in (rng.integers(0, 2**40, 50_000),
                    rng.integers(-5, 5, 1000).astype(np.int32),
                    np.array([2**63 + 5, 3, 2**63 + 5], np.uint64),
                    rng.random(1000)):  # float: always numpy path
            uniq, inv = _unique_inverse(np.asarray(arr))
            exp_u, exp_i = np.unique(arr, return_inverse=True)
            np.testing.assert_array_equal(uniq, exp_u)
            np.testing.assert_array_equal(inv, exp_i)
            assert inv.dtype == np.int32


# ---------------------------------------------------------------------------
# The port against the JAX package's library, bit for bit
# ---------------------------------------------------------------------------

import operator  # noqa: E402

import pipelinedp_tpu as jpdp  # noqa: E402
from pipelinedp_tpu import jax_engine as je  # noqa: E402
from pipelinedp_tpu import native as jnative  # noqa: E402
from pipelinedp_tpu.backends import JaxBackend  # noqa: E402
from pipelinedp_tpu.ops import noise as jnoise  # noqa: E402
from pipelinedp_tpu.sketch import SketchParams as JaxSketchParams  # noqa

import pipelinedp_tpu_torch as pdt  # noqa: E402
from pipelinedp_tpu_torch import convert  # noqa: E402
from pipelinedp_tpu_torch.ops import noise as tnoise  # noqa: E402

SAMPLERS = {
    "uniform": lambda m: m.uniform(3000),
    "snapping_laplace": lambda m: m.snapping_laplace(
        np.linspace(-40.0, 90.0, 3000), 1.7),
    "discrete_laplace": lambda m: m.discrete_laplace(np.arange(3000), 3.2),
    "discrete_gaussian": lambda m: m.discrete_gaussian(np.arange(3000),
                                                       5.5),
    "secure_gaussian": lambda m: m.secure_gaussian(
        np.linspace(-40.0, 90.0, 3000), 2.3),
}


@pytest.fixture
def jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library cannot build here")
    return jnative


@pytest.mark.parametrize("seed", [0, 7, 2**64 - 3])
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_same_seed_same_draws_as_jax_library(name, seed, jax_native):
    native.seed(seed)
    got = SAMPLERS[name](native)
    jax_native.seed(seed)
    want = SAMPLERS[name](jax_native)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


def test_libraries_keep_their_own_streams(jax_native):
    """Two copies of one library in one process: ``ctypes`` loads each
    ``RTLD_LOCAL``, so seeding or drawing from one leaves the other's
    ChaCha20 stream where it was."""
    assert native._lib()._name != jax_native._lib()._name
    for mine, other in ((native, jax_native), (jax_native, native)):
        mine.seed(5)
        whole = mine.uniform(64)
        mine.seed(5)
        first = mine.uniform(32)
        other.seed(99)
        other.uniform(17)
        other.seed_from_os()
        rest = mine.uniform(32)
        np.testing.assert_array_equal(np.concatenate([first, rest]), whole)


@pytest.mark.parametrize("gen", [
    lambda rng: rng.integers(-1000, 1000, 10_000),
    lambda rng: rng.integers(0, 50, 100_000),
    lambda rng: rng.integers(0, 2**62, 20_000),
    lambda rng: (rng.integers(0, 3000, 50_000) * 2**33 + 7),
], ids=["narrow", "duplicates", "wide_distinct", "spread"])
def test_factorize_matches_jax_and_np_unique(gen, jax_native):
    arr = gen(np.random.default_rng(2)).astype(np.int64)
    uniq, inv = native.factorize_i64(arr)
    juniq, jinv = jax_native.factorize_i64(arr)
    nuniq, ninv = np.unique(arr, return_inverse=True)
    for u, i in ((juniq, jinv), (nuniq, ninv.astype(np.int32))):
        assert uniq.dtype == u.dtype and uniq.tobytes() == u.tobytes()
        assert inv.dtype == i.dtype and inv.tobytes() == i.tobytes()


def test_encode_takes_the_factorizer(monkeypatch):
    """Wide integer keys reach ``factorize_i64`` through the encode, and
    the ids are ``np.unique``'s."""
    from pipelinedp_tpu_torch import torch_engine as te
    calls = []
    real = native.factorize_i64

    def counting(arr):
        calls.append(len(arr))
        return real(arr)

    monkeypatch.setattr(native, "factorize_i64", counting)
    rng = np.random.default_rng(3)
    pk = rng.integers(0, 400, 5000) * 2**33 + 7
    enc = te.encode(convert.dataset_from_arrays(
        rng.integers(0, 900, 5000) * 2**33 + 7, pk, rng.random(5000)),
        None, None)
    assert calls == [5000, 5000]
    uniq, inv = np.unique(pk, return_inverse=True)
    assert list(enc.pk_vocab) == uniq.tolist()


class _SamplerLog:
    """Records (sampler, length) of every native call of one package, so
    the port's order of draws can be held to the JAX package's."""

    NAMES = ("discrete_laplace", "discrete_gaussian", "snapping_laplace",
             "secure_gaussian")

    def __init__(self, monkeypatch, module):
        self.calls = []
        for name in self.NAMES:
            monkeypatch.setattr(module, name, self._wrap(name,
                                                         getattr(module,
                                                                 name)))

    def _wrap(self, name, fn):
        def logged(values, scale, **kw):
            self.calls.append((name, int(np.size(values))))
            return fn(values, scale, **kw)
        return logged

    def count(self, *names):
        return sum(1 for n, _ in self.calls if n in names)


def _secure_pair(monkeypatch, run_jax, run_torch, seed):
    """Runs both packages under secure host noise from one
    ``seed_host_rng`` seed; returns both results and both sampler logs."""
    jlog = _SamplerLog(monkeypatch, jnative)
    tlog = _SamplerLog(monkeypatch, native)
    jnoise.set_secure_host_noise(True)
    tnoise.set_secure_host_noise(True)
    try:
        jnoise.seed_host_rng(seed)
        want = run_jax()
        tnoise.seed_host_rng(seed)
        got = run_torch()
    finally:
        jnoise.set_secure_host_noise(False)
        tnoise.set_secure_host_noise(False)
    return want, got, jlog, tlog


def _bits(rows):
    return [(k, tuple(np.asarray(x, np.float64).tobytes() for x in v))
            for k, v in rows]


def _assert_same(got, want, tlog, jlog, integer=True, floating=True):
    """Same kept keys and released bits, the same native calls in the same
    order, and each of the integer and float samplers reached where
    asked."""
    assert len(want) > 0
    assert [v._fields for _, v in got] == [v._fields for _, v in want]
    assert _bits(got) == _bits(want)
    assert tlog.calls == jlog.calls
    assert (tlog.count("discrete_laplace", "discrete_gaussian") > 0) == (
        integer)
    assert (tlog.count("snapping_laplace", "secure_gaussian") > 0) == (
        floating)


JM = jpdp.Metrics
SCALAR5 = [JM.COUNT, JM.PRIVACY_ID_COUNT, JM.SUM, JM.MEAN, JM.VARIANCE]
FUSED_CASES = {
    "scalar5_private": (dict(metrics=SCALAR5), None),
    "count_sum_pid_public": (dict(metrics=[JM.COUNT, JM.SUM,
                                           JM.PRIVACY_ID_COUNT]),
                             list(range(40)) + [700, 701]),
    "per_partition_sum_public": (dict(
        metrics=[JM.SUM, JM.COUNT], min_value=None, max_value=None,
        min_sum_per_partition=-4.0, max_sum_per_partition=12.0),
        list(range(30)) + [800]),
    "vector_sum_private": (dict(
        metrics=[JM.VECTOR_SUM], min_value=None, max_value=None,
        vector_size=6, vector_max_norm=4.0), None),
}


def _fused_data(seed, n=5000, users=1500, parts=120, d=None):
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(1.2, n) % parts).astype(np.int64)
    values = (rng.random(n) * 10.0 if d is None else
              rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32))
    return pid, pk, values


@pytest.mark.parametrize("kind", ["LAPLACE", "GAUSSIAN"])
@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_secure_fused_release_matches_jax(case, kind, monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_VECTOR_ACCUMULATOR", "fx")
    kw, public = FUSED_CASES[case]
    base = dict(max_partitions_contributed=3,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0, noise_kind=jpdp.NoiseKind[kind],
                vector_norm_kind=(jpdp.NormKind.L2 if kind == "GAUSSIAN"
                                  else jpdp.NormKind.L1))
    params = jpdp.AggregateParams(**dict(base, **kw))
    pid, pk, values = _fused_data(len(case), d=params.vector_size)

    def run(pkg, backend, ds, p):
        acc = pkg.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        res = pkg.DPEngine(acc, backend).aggregate(
            ds, p, pkg.DataExtractors(), public_partitions=public)
        acc.compute_budgets()
        return list(res)

    want, got, jlog, tlog = _secure_pair(
        monkeypatch,
        lambda: run(jpdp, JaxBackend(), je.ArrayDataset(pid, pk, values),
                    params),
        lambda: run(pdt, pdt.TorchBackend("cpu"),
                    convert.dataset_from_arrays(pid, pk, values),
                    convert.params_from_reference(params)), seed=31)
    _assert_same(got, want, tlog, jlog,
                 integer=case != "vector_sum_private")


def test_secure_streamed_release_matches_jax(monkeypatch):
    monkeypatch.setenv("PIPELINEDP_TPU_INGEST_EXECUTOR", "0")
    monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", "700")
    params = jpdp.AggregateParams(
        metrics=[JM.COUNT, JM.SUM, JM.MEAN, JM.PRIVACY_ID_COUNT],
        max_partitions_contributed=3, max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0)
    pid, pk, values = _fused_data(9)
    timings = {}

    def run(pkg, backend, ds, p):
        acc = pkg.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        res = pkg.DPEngine(acc, backend).aggregate(ds, p,
                                                   pkg.DataExtractors())
        acc.compute_budgets()
        out = list(res)
        timings[pkg.__name__] = res.timings
        return out

    want, got, jlog, tlog = _secure_pair(
        monkeypatch,
        lambda: run(jpdp, JaxBackend(), je.ArrayDataset(pid, pk, values),
                    params),
        lambda: run(pdt, pdt.TorchBackend("cpu"),
                    convert.dataset_from_arrays(pid, pk, values),
                    convert.params_from_reference(params)), seed=8)
    assert timings["pipelinedp_tpu_torch"]["stream_batches"] > 5
    _assert_same(got, want, tlog, jlog)


def test_secure_sketch_first_matches_jax(monkeypatch):
    rng = np.random.default_rng(4)
    pid = rng.integers(0, 600, 8000)
    pk = np.char.add("key/", (rng.zipf(1.4, 8000) % 80).astype("U6"))
    values = rng.uniform(0.0, 10.0, 8000)
    sk = dict(eps=4.0, delta=1e-7, width=1024, depth=2, candidate_cap=64)

    def run(pkg, backend, sketch):
        params = pkg.AggregateParams(
            metrics=[pkg.Metrics.COUNT, pkg.Metrics.SUM],
            max_partitions_contributed=3, max_contributions_per_partition=2,
            min_value=0.0, max_value=10.0)
        acc = pkg.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        res = pkg.DPEngine(acc, backend).aggregate(
            pkg.ArrayDataset(privacy_ids=pid, partition_keys=pk,
                             values=values), params, pkg.DataExtractors(),
            sketch_first=sketch)
        acc.compute_budgets()
        return sorted(res)

    want, got, jlog, tlog = _secure_pair(
        monkeypatch, lambda: run(jpdp, JaxBackend(), JaxSketchParams(**sk)),
        lambda: run(pdt, pdt.TorchBackend("cpu"), pdt.SketchParams(**sk)),
        seed=12)
    _assert_same(got, want, tlog, jlog)


@pytest.mark.parametrize("kind", ["LAPLACE", "GAUSSIAN"])
def test_secure_host_path_matches_jax(kind, monkeypatch):
    rng = np.random.default_rng(6)
    rows = list(zip(rng.integers(0, 200, 700).tolist(),
                    rng.integers(0, 6, 700).tolist(),
                    (rng.random(700) * 10.0).tolist()))
    getters = dict(privacy_id_extractor=operator.itemgetter(0),
                   partition_extractor=operator.itemgetter(1),
                   value_extractor=operator.itemgetter(2))
    params = jpdp.AggregateParams(
        metrics=[JM.COUNT, JM.SUM, JM.MEAN, JM.PRIVACY_ID_COUNT],
        max_partitions_contributed=2, max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0, noise_kind=jpdp.NoiseKind[kind])

    def run(pkg, p):
        acc = pkg.NaiveBudgetAccountant(total_epsilon=2.0, total_delta=1e-6)
        res = pkg.DPEngine(acc, pkg.LocalBackend()).aggregate(
            rows, p, pkg.DataExtractors(**getters))
        acc.compute_budgets()
        return sorted(res)

    want, got, jlog, tlog = _secure_pair(
        monkeypatch, lambda: run(jpdp, params),
        lambda: run(pdt, convert.params_from_reference(params)), seed=2)
    _assert_same(got, want, tlog, jlog)


def test_multiproc_backend_releases_on_the_snapping_grid():
    """``MultiProcLocalBackend``'s spawned workers run the release stage
    with the parent's secure flag: every count is an integer and every
    sum lies on the snapping grid of its scale."""
    rows = [(u, u % 600, 0.75) for u in range(1800)]
    params = pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
        max_partitions_contributed=1, max_contributions_per_partition=1,
        min_value=0.0, max_value=3.0)
    backend = pdt.MultiProcLocalBackend(n_jobs=2, chunk_size=100)
    tnoise.set_secure_host_noise(True)
    try:
        acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        res = pdt.DPEngine(acc, backend).aggregate(
            rows, params, pdt.DataExtractors(
                privacy_id_extractor=operator.itemgetter(0),
                partition_extractor=operator.itemgetter(1),
                value_extractor=operator.itemgetter(2)),
            public_partitions=list(range(600)))
        acc.compute_budgets()
        out = dict(res)
        fanned_out = backend._pool_instance is not None
    finally:
        tnoise.set_secure_host_noise(False)
        backend.close()
    assert fanned_out and len(out) == 600
    counts = np.array([v.count for v in out.values()])
    sums = np.array([v.sum for v in out.values()])
    # SUM's half of eps = 1 at sensitivity 3: scale 6, Lambda = 8.
    np.testing.assert_array_equal(counts, np.round(counts))
    np.testing.assert_array_equal(sums / 8.0, np.round(sums / 8.0))
