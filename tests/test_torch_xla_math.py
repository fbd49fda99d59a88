"""XLA's float32 transcendentals in PyTorch (``pipelinedp_tpu_torch/ops/
xla_math.py``), held bit for bit against the jitted JAX functions on the
CPU over dense float32 grids: the regions where each algorithm's branches
meet, its clamps, +-inf, NaN and subnormals (XLA's CPU executables flush
subnormals to zero). Also: the same value gives the same bits at every
width and offset of a tensor, ``fma32`` is the correctly rounded fused
multiply-add, ``ndtri`` of constants is XLA's compile-time fold of it,
and ``interp`` is ``jnp.interp`` vectorised over the sweep's quantile
table.
"""

import fractions

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy import special as jspecial
from jax.scipy.stats import norm as jnorm

from pipelinedp_tpu.analysis import jax_sweep
from pipelinedp_tpu_torch.ops import xla_math as xm

_SPECIALS = np.float32([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, -1e-40,
                        1.2e-38, 1e-30, 88.7, 89.0, -87.9, -104.0, 3.74,
                        -3.75, 3.83, 1.0, -1.0, 2.0, -2.0, 0.70710677,
                        -0.70710677, 9.2, -13.2, 1e30, -1e30])


def _grid(lo, hi, n=100_001, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([np.linspace(lo, hi, n, dtype=np.float32),
                           rng.uniform(lo, hi, n).astype(np.float32),
                           _SPECIALS])


def _assert_bits(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    same = (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) &
                                                        np.isnan(b))
    assert same.all(), (np.count_nonzero(~same), a[~same][:5], b[~same][:5])


_CASES = {
    "exp": (jnp.exp, xm.exp, (-95.0, 95.0)),
    "exp_near_zero": (jnp.exp, xm.exp, (-2.0, 2.0)),
    "erf": (jax.lax.erf, xm.erf, (-5.0, 5.0)),
    "erfc": (jspecial.erfc, xm.erfc, (-12.0, 12.0)),
    "ndtr": (jspecial.ndtr, xm.ndtr, (-15.0, 15.0)),
    "norm_cdf": (jnorm.cdf, xm.ndtr, (-15.0, 15.0)),
    "norm_pdf": (jnorm.pdf, xm.norm_pdf, (-15.0, 15.0)),
    "log": (jnp.log, xm.xla_log, (1e-6, 1e4)),
}


@pytest.mark.parametrize("name", sorted(_CASES))
def test_bit_equal_to_jitted_jax(name):
    jf, tf, (lo, hi) = _CASES[name]
    x = _grid(lo, hi)
    if name == "log":
        # ``xla_log`` takes finite normal x > 0 (its callers' domain).
        x = x[np.isfinite(x) & (x >= np.finfo(np.float32).tiny)]
    _assert_bits(jax.jit(jf)(x), tf(torch.from_numpy(x)).numpy())


def test_ndtri_bit_equal_to_jitted_jax():
    x = np.concatenate([np.linspace(0, 1, 200_001, dtype=np.float32),
                        np.float32([1e-30, 1e-10, 1 - 6e-8, 1e-38, 5e-39,
                                    0.135335, 0.8646647, np.nan])])
    _assert_bits(jax.jit(jspecial.ndtri)(x),
                 xm.ndtri(torch.from_numpy(x)).numpy())


def test_ndtri_folded_is_xla_compile_time_value():
    """The sweep evaluates ``ndtri(1 - q)`` of four constants; XLA folds
    that at compile time, and ``folded=True`` gives the folded bits, on
    the sweep's constants and on the grid points of its quantile
    levels."""
    from jax._src.scipy.special import _ndtri
    inv_q = np.asarray([1.0 - q for q in jax_sweep.ERROR_QUANTILES],
                       np.float32)
    folded = np.asarray(jax.jit(lambda: _ndtri(inv_q))())
    _assert_bits(folded, xm.ndtri(torch.from_numpy(inv_q),
                                  folded=True).numpy())
    levels = np.float32([0.5, 0.75, 0.9, 0.95, 0.99, 0.995, 0.25, 0.1,
                         0.05, 0.01, 0.001])
    _assert_bits(jax.jit(lambda: _ndtri(levels))(),
                 xm.ndtri(torch.from_numpy(levels), folded=True).numpy())


def test_interp_matches_jnp_interp_on_quantile_table():
    log_rs, t_table = jax_sweep._laplace_gauss_table(
        tuple(1.0 - q for q in jax_sweep.ERROR_QUANTILES))
    rng = np.random.default_rng(1)
    logr = np.concatenate([rng.uniform(-9, 9, 5000),
                           np.linspace(-8, 8, 20_001), log_rs,
                           np.float32([-1e30, 1e30, np.log(1e-6)])])
    logr = logr.astype(np.float32).reshape(-1, 1)
    f = jax.jit(lambda lr: jax.vmap(
        lambda col: jnp.interp(lr, log_rs, col), in_axes=1,
        out_axes=-1)(t_table))
    got = xm.interp(torch.from_numpy(logr), torch.from_numpy(log_rs),
                    torch.from_numpy(t_table))
    _assert_bits(f(logr), got.numpy())


@pytest.mark.parametrize("name", ["exp", "erf", "erfc", "ndtr", "norm_pdf"])
def test_same_bits_at_every_width_and_offset(name):
    _, tf, (lo, hi) = _CASES[name]
    x = torch.from_numpy(_grid(lo, hi, n=4099, seed=3))
    full = tf(x).numpy()
    for start, width in ((0, 1), (1, 7), (3, 16), (5, 33), (17, 1000)):
        part = tf(x[start:start + width].clone()).numpy()
        _assert_bits(part, full[start:start + width])
    _assert_bits(tf(x[1::3]).numpy(), full[1::3])


def test_fma32_is_correctly_rounded():
    rng = np.random.default_rng(5)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (rng.standard_normal(3000) * 10.0 **
         rng.integers(-6, 6, 3000)).astype(np.float32)
    # Products cancelling c almost exactly, where a double rounding would
    # show.
    c[:1000] = -(a[:1000].astype(np.float64) *
                 b[:1000]).astype(np.float32)
    got = xm.fma32(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    for i in range(0, 3000, 7):
        exact = (fractions.Fraction(float(a[i])) * fractions.Fraction(
            float(b[i])) + fractions.Fraction(float(c[i])))
        lo = np.float32(float(exact))
        cands = [lo, np.nextafter(lo, np.float32(np.inf)),
                 np.nextafter(lo, np.float32(-np.inf))]
        best = min(cands, key=lambda v: (abs(fractions.Fraction(float(v)) -
                                             exact), int(np.float32(v).view(
                                                 np.uint32)) & 1))
        if abs(best) < np.finfo(np.float32).tiny:
            best = np.float32(0.0) * np.sign(best)
        assert got[i] == best, (i, a[i], b[i], c[i], got[i], best)


def test_ftz_flushes_subnormals_to_signed_zero():
    x = torch.tensor([1e-40, -1e-40, 1.2e-38, 0.0, -0.0, 1.0],
                     dtype=torch.float32)
    out = xm.ftz(x).numpy()
    np.testing.assert_array_equal(np.signbit(out),
                                  [False, True, False, False, True, False])
    assert out[0] == 0.0 and out[1] == 0.0 and out[2] == np.float32(1.2e-38)
