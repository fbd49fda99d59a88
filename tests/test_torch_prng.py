"""The port's threefry PRNG (``pipelinedp_tpu_torch/ops/prng.py``) against
JAX's own, on the CPU.

Keys, splits, bits, uniforms and Laplace draws are bit-equal. Gaussian
draws are bit-equal except in the tail branch of XLA's ``erf_inv``
(``|u| > ~0.9973``, where its float32 ``sqrt`` is not correctly rounded):
there they may sit up to 2 ULP apart, and the test counts and bounds
those cases.
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


def test_normal_bit_equal_outside_the_tail_branch():
    """Bit-equal for ``|u|`` below the tail branch of XLA's ``erf_inv``;
    in the tail (w = -log1p(-u^2) >= 5) XLA's float32 sqrt is off by one
    ULP, which moves the draw by at most 2 ULP. The count of such cases
    is printed and bounded."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    total = tail = off = 0
    for seed in SEEDS:
        for n in (1001, 65536):
            kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
            a = np.asarray(jax.random.normal(kj, (n,)))
            b = prng.normal(kt, (n,)).numpy()
            u = prng.uniform(kt, (n,), lo, 1.0)
            w = -prng.xla_log1p(u * -u).numpy()
            in_tail = w >= 5.0
            d = _ulps(a, b)
            np.testing.assert_array_equal(d[~in_tail], 0)
            assert d[in_tail].max(initial=0) <= 2
            total += n
            tail += int(in_tail.sum())
            off += int((d > 0).sum())
    print(f"normal: {off} of {total} draws differ (all in the tail "
          f"branch, which held {tail} draws), by at most 2 ULP")
    assert off <= tail < total // 100


@pytest.mark.parametrize("lo,hi", [(1e-30, 1e-3), (1e-3, 0.6), (0.6, 2.0),
                                   (2.0, 1e6)])
def test_xla_log_bit_equal(lo, hi):
    x = np.random.default_rng(0).uniform(lo, hi, 50_000).astype(np.float32)
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
