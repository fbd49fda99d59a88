"""The port's threefry PRNG (``pipelinedp_tpu_torch/ops/prng.py``) against
JAX's own, on the CPU.

Keys, splits, ``fold_in``, bits, uniforms, Laplace and Gaussian draws,
and the counter-keyed draws of ``ops/counter_rng.py``, are bit-equal over
their whole range.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pipelinedp_tpu.ops import counter_rng as jax_counter_rng
from pipelinedp_tpu_torch.ops import counter_rng, prng

SEEDS = [0, 1, 7, 12345, 2**31 - 1]
LENGTHS = [1, 2, 3, 1001, 8192]


def _as_u32(x):
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


def _ulps(a, b):
    """ULP distance between two float32 arrays of one sign pattern."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_matches_jax_internal(seed):
    from jax._src import prng as jax_prng
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 2**32, 2, dtype=np.uint32)
    c = rng.integers(0, 2**32, 64, dtype=np.uint32)
    ref = np.asarray(jax_prng.threefry_2x32(jnp.asarray(k), jnp.asarray(c)))
    h0, h1 = prng.threefry2x32(int(k[0]), int(k[1]),
                               torch.from_numpy(c[:32].astype(np.int64)),
                               torch.from_numpy(c[32:].astype(np.int64)))
    np.testing.assert_array_equal(
        np.concatenate([h0.numpy(), h1.numpy()]), _as_u32(ref))


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_split(seed):
    kj = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    np.testing.assert_array_equal(kt.numpy(), _as_u32(kj))
    for n in (1, 2, 3, 5):
        np.testing.assert_array_equal(prng.split(kt, n).numpy(),
                                      _as_u32(jax.random.split(kj, n)))
    # Split of a split: the engine's bounding stream.
    np.testing.assert_array_equal(
        prng.split(prng.split(kt, 3)[0], 3).numpy(),
        _as_u32(jax.random.split(jax.random.split(kj, 3)[0], 3)))


@pytest.mark.parametrize("seed", SEEDS)
def test_bits(seed):
    kj = jax.random.PRNGKey(seed)
    kt = prng.PRNGKey(seed)
    assert int(prng.bits(kt, ())) == int(jax.random.bits(kj, (), jnp.uint32))
    for n in LENGTHS:
        np.testing.assert_array_equal(
            prng.bits(kt, (n,)).numpy(),
            _as_u32(jax.random.bits(kj, (n,), jnp.uint32)))
    np.testing.assert_array_equal(
        prng.bits(kt, (3, 5)).numpy(),
        _as_u32(jax.random.bits(kj, (3, 5), jnp.uint32)))


@pytest.mark.parametrize("n", LENGTHS)
def test_row_bits(n):
    for seed in SEEDS:
        kj = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(
            counter_rng.row_bits(prng.PRNGKey(seed), n).numpy(),
            _as_u32(jax_counter_rng.row_bits(kj, n)))


@pytest.mark.parametrize("n", LENGTHS)
def test_uniform_bit_equal(n):
    for seed in SEEDS:
        a = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (n,)))
        b = prng.uniform(prng.PRNGKey(seed), (n,)).numpy()
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("n", LENGTHS)
def test_laplace_bit_equal(n):
    for seed in SEEDS:
        a = np.asarray(jax.random.laplace(jax.random.PRNGKey(seed), (n,)))
        b = prng.laplace(prng.PRNGKey(seed), (n,)).numpy()
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_normal_bit_equal():
    """Bit-equal over the whole range, the tail branch of XLA's
    ``erf_inv`` (w = -log1p(-u^2) >= 5) included: the tail's ``sqrt`` is
    taken in float64 and rounded once, which is the correctly rounded
    float32 square root that XLA computes (torch's CPU float32 ``sqrt`` is
    not always)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    total = tail = 0
    for seed in SEEDS:
        for n in (1001, 65536):
            kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
            a = np.asarray(jax.random.normal(kj, (n,)))
            b = prng.normal(kt, (n,)).numpy()
            u = prng.uniform(kt, (n,), lo, 1.0)
            w = -prng.xla_log1p(u * -u).numpy()
            np.testing.assert_array_equal(_ulps(a, b), 0)
            total += n
            tail += int((w >= 5.0).sum())
    assert 0 < tail < total // 100  # the tail branch was exercised


def test_fold_in_matches_jax():
    for seed in SEEDS:
        for data in (0, 1, 7, 0x7EC, 0x7EE, 2**31, 2**32 - 1):
            np.testing.assert_array_equal(
                prng.fold_in(prng.PRNGKey(seed), data).numpy(),
                _as_u32(jax.random.fold_in(jax.random.PRNGKey(seed), data)))


@pytest.mark.parametrize("kind", ["laplace", "normal"])
def test_counter_draws_bit_equal(kind):
    """``counter_rng.laplace`` / ``normal`` over 2^18 random counters."""
    rng = np.random.default_rng(3)
    x0 = rng.integers(0, 2**32, 1 << 18, dtype=np.uint32)
    x1 = rng.integers(0, 2**32, 1 << 18, dtype=np.uint32)
    for seed in SEEDS[:3]:
        kj = jax.random.PRNGKey(seed)
        a = np.asarray(jax.jit(getattr(jax_counter_rng, kind))(
            kj, jnp.asarray(x0), jnp.asarray(x1)))
        b = getattr(counter_rng, kind)(
            prng.PRNGKey(seed), torch.from_numpy(x0.astype(np.int64)),
            torch.from_numpy(x1.astype(np.int64))).numpy()
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("kind", ["laplace", "normal"])
def test_counter_transform_bit_equal_on_every_grid_point(kind):
    """The draws depend on the bits only through their top 24, so feeding
    every one of the 2^24 grid points through both transforms covers the
    whole range: the tails, u = 0.5 +- 2^-25 and the top point, where the
    Gaussian is +inf in both packages."""
    bits = np.arange(1 << 24, dtype=np.uint32) << np.uint32(8)

    # The JAX package's transforms after its threefry, as written in
    # ``counter_rng.laplace`` / ``normal``.
    def jax_transform(bits):
        u = jax_counter_rng._uniform_open01(bits)
        if kind == "laplace":
            c = u - np.float32(0.5)
            return -jnp.sign(c) * jnp.log1p(-2.0 * jnp.abs(c))
        return np.float32(np.sqrt(2.0)) * jax.scipy.special.erfinv(
            u * np.float32(2.0) - np.float32(1.0))

    a = np.asarray(jax.jit(jax_transform)(jnp.asarray(bits)))
    b = getattr(counter_rng, f"{kind}_from_bits")(
        torch.from_numpy(bits.astype(np.int64))).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    if kind == "normal":
        assert np.isposinf(b[-1]) and np.isfinite(b[:-1]).all()


@pytest.mark.parametrize("lo,hi", [(1e-30, 1e-3), (1e-3, 0.6), (0.6, 2.0),
                                   (2.0, 1e6)])
def test_xla_log_bit_equal(lo, hi):
    x = np.random.default_rng(0).uniform(lo, hi, 50_000).astype(np.float32)
    a = np.asarray(jax.jit(jnp.log)(x))
    b = prng.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_xla_log_special_values_bit_equal():
    """Zeros, subnormals (treated as zero), negatives, NaN and infinities
    give jitted ``jnp.log``'s bits: -inf, the all-ones NaN, +inf."""
    x = np.float32([0.0, -0.0, 1e-40, -1e-40, 1e-38, -1.0, np.nan, -np.nan,
                    np.inf, -np.inf, 2.0, np.finfo(np.float32).tiny])
    a = np.asarray(jax.jit(jnp.log)(x))
    b = prng.xla_log(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("lo,hi", [(-0.999999, -0.42), (-0.42, 0.42),
                                   (0.42, 3.0)])
def test_xla_log1p_bit_equal(lo, hi):
    x = np.random.default_rng(1).uniform(lo, hi, 50_000).astype(np.float32)
    a = np.asarray(jax.jit(jnp.log1p)(x))
    b = prng.xla_log1p(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_selection_noise_add_is_one_fma(seed):
    """XLA fuses ``est + noise * scale`` into one FMA on the CPU; the
    port's ``fma32`` rounds the same way, so threshold decisions agree."""
    n = 1 << 16
    rng = np.random.default_rng(seed)
    est = rng.integers(0, 3_000_000, n).astype(np.float32)
    scale = np.float32(37.123457)

    @jax.jit
    def noisy(key, est, scale):
        return est + jax.random.laplace(key, (n,)) * scale

    a = np.asarray(noisy(jax.random.PRNGKey(seed), est, scale))
    lap = prng.laplace(prng.PRNGKey(seed), (n,))
    b = prng.fma32(lap, float(scale), torch.from_numpy(est)).numpy()
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
