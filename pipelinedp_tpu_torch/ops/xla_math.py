"""XLA's float32 transcendentals, written op by op in PyTorch.

The utility-analysis sweep (``analysis/torch_sweep.py``) is held bit for
bit against the JAX package's ``analysis/jax_sweep.py`` on the CPU. Its
stage C evaluates ``exp``, ``erf``/``erfc`` (through ``norm.cdf``),
``norm.pdf``, ``log``, ``ndtri`` and ``jnp.interp`` in float32, and the
bits of every one of them are XLA's, not libm's: XLA's CPU code generator
emits its own polynomial ``exp`` (Cephes), an ``erf`` rational function
(Eigen's), and decomposes ``erfc`` into two rational functions of
``1/x^2`` times ``exp(-x^2)``. Its LLVM back end contracts every ``a * b
+ c`` whose product has no other use into one fused multiply-add. This
module rebuilds each of those algorithms from IEEE ``+ - * /``,
``floor``, comparisons and bit casts, with ``fma32`` wherever XLA's
machine code holds an FMA, so each value is the same on the CPU, on the
card, and at every position of a tensor. (``torch.exp`` and
``torch.erf`` are not usable here: on the CPU their vectorised body and
their scalar tail can round differently, so a value's bits would depend
on its position.)

Square roots are taken in float64 and rounded once: that is the
correctly rounded float32 square root (53 >= 2 * 24 + 2 bits), which
XLA's ``sqrt`` is.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pipelinedp_tpu_torch.ops.prng import xla_log

__all__ = ["erf", "erfc", "exp", "fma32", "interp", "ndtr", "ndtri",
           "norm_pdf", "sqrt", "xla_log"]


def _f32(v: float) -> float:
    return float(np.float32(v))


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as the FMA instruction
    gives it, for float32 tensors (or Python floats for ``b``, ``c``).

    The float64 product of two float32 values is exact, and the float64
    sum ``s`` of it and ``c`` carries an exact error term ``e`` (Knuth's
    two-sum). Rounding ``s`` to float32 could round twice; rounding to odd
    first (nudging an even ``s`` one float64 step towards ``e`` when ``e``
    is not zero) makes the float32 rounding of ``s`` the rounding of the
    exact value."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else _f32(b)
    c64 = c.double() if torch.is_tensor(c) else _f32(c)
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    nudge = even & (err != 0) & torch.isfinite(s)
    s = torch.where(nudge, torch.nextafter(s, torch.where(
        err > 0, torch.full_like(s, math.inf),
        torch.full_like(s, -math.inf))), s)
    return ftz(s.float())


def _horner_fma(x: torch.Tensor, coeffs) -> torch.Tensor:
    """``((c0 x + c1) x + c2) ...``, each step one FMA."""
    p = fma32(x, coeffs[0], coeffs[1])
    for c in coeffs[2:]:
        p = fma32(p, x, c)
    return p


_MIN_NORMAL = float(np.finfo(np.float32).tiny)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Subnormal values flushed to a zero of their sign. XLA's CPU
    executables run with flush-to-zero and denormals-are-zero set, so a
    float32 result below 2^-126 in magnitude is zero there."""
    return torch.where(torch.abs(x) < _MIN_NORMAL, x * 0.0, x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root."""
    return torch.sqrt(x.double()).float()


# XLA's CPU exp (Cephes' expf): clamp, n = floor(x log2(e) + 1/2), a
# two-step Cody-Waite reduction, a degree-5 polynomial, and the scale 2^n
# built from the exponent bits.
_EXP_LO = _f32(-87.8)
_EXP_HI = _f32(88.8)
_LOG2E = _f32(1.44269504088896341)
_EXP_C1 = _f32(0.693359375)
_EXP_C2 = _f32(-2.12194440e-4)
_EXP_P = tuple(_f32(v) for v in (
    1.9875691500E-4, 1.3981999507E-3, 8.3334519073E-3, 4.1665795894E-2,
    1.6666665459E-1, 0.5))


def exp(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``exp``."""
    x = torch.clamp(x, _EXP_LO, _EXP_HI)
    fx = torch.floor(fma32(x, _LOG2E, 0.5))
    fx = torch.clamp(fx, -127.0, 127.0)
    r = fma32(-fx, _EXP_C1, x)
    r = fma32(-fx, _EXP_C2, r)
    p = fma32(torch.full_like(r, _EXP_P[0]), r, _EXP_P[1])
    for c in _EXP_P[2:]:
        p = fma32(p, r, c)
    y = fma32(p, r * r, r) + 1.0
    scale = ((fx.to(torch.int32) + 127) << 23).view(torch.float32)
    return ftz(y * ftz(scale))


# XLA's float32 erf (Eigen's): x clamped to +-3.7439213, then
# x * P(x^2) / Q(x^2) with odd and even polynomials.
_ERF_CLAMP = _f32(3.7439212799072266)
_ERF_ALPHA = tuple(_f32(v) for v in (
    0.00022905065861350646, 0.0034082910107109506, 0.050955695062380861,
    0.18520832239976145, 1.128379143519084))
_ERF_BETA = tuple(_f32(v) for v in (
    -1.1791602954361697e-7, 0.000023547966471313185,
    0.0010179625278914885, 0.014070470171167667, 0.11098505178285362,
    0.49746925110067538, 1.0))


def erf(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``erf``."""
    x = torch.clamp(x, -_ERF_CLAMP, _ERF_CLAMP)
    x2 = x * x
    p = _horner_fma(x2, _ERF_ALPHA)
    q = _horner_fma(x2, _ERF_BETA)
    return ftz(ftz(x * p) / q)


# XLA's float32 erfc: 1 - x P(x^2) below |x| = 1; above it
# exp(-x^2) / |x| times a rational function of 1/x^2 (two coefficient
# sets split at |x| = 2), zero once -x^2 underflows exp.
_ERFC_SMALL = tuple(_f32(v) for v in (
    7.85386146e-05, -0.000801019371, 0.00518832775, -0.0268538129,
    0.112835854, -0.37612626, 1.12837911))
_ERFC_MID = tuple(_f32(v) for v in (
    0.0232682, -0.138703942, 0.368742466, -0.582473278, 0.621000469,
    -0.494451523, 0.340488, -0.274112701, 0.563825965))
_ERFC_BIG = tuple(_f32(v) for v in (
    -10.477664, 12.9772, -7.49551868, 2.92101908, -1.01526523,
    0.42184633, -0.282076746, 0.564189494))
_ERFC_UNDERFLOW = _f32(-88.7228394)


def _erfc_nonneg_tail(z: torch.Tensor, z2: torch.Tensor) -> torch.Tensor:
    """erfc past |x| = 1 for ``z = |x|``, ``z2 = x * x``: the pieces XLA
    computes as separate loops (``1/z2``, ``1/z``, ``exp(-z2)``) and the
    rational function over them."""
    q = 1.0 / z2
    ez = ftz(exp(-z2) * (1.0 / z))
    poly = torch.where(z < 2.0, _horner_fma(q, _ERFC_MID),
                       _horner_fma(q, _ERFC_BIG))
    tail = ftz(ez * poly)
    return torch.where(-z2 < _ERFC_UNDERFLOW, torch.zeros_like(tail), tail)


def erfc(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``erfc`` (``jax.scipy.special.erfc``)."""
    z = torch.abs(x)
    x2 = x * x
    small = fma32(-x, _horner_fma(x2, _ERFC_SMALL), 1.0)
    tail = _erfc_nonneg_tail(z, x2)
    tail = torch.where(x < 0, 2.0 - tail, tail)
    return torch.where(z < 1.0, small, tail)


_HALF_SQRT2 = _f32(0.5 * np.sqrt(np.float32(2.0)))


def ndtr(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.stats.norm.cdf`` / ``special.ndtr`` in float32:
    ``0.5 * y`` with ``y = 1 + erf(w)`` near 0, else ``2 - erfc(|w|)`` or
    ``erfc(|w|)``, for ``w = x / sqrt(2)``."""
    w = x * _HALF_SQRT2
    z = torch.abs(w)
    erfc_z = erfc(z)
    y = torch.where(z < _HALF_SQRT2, 1.0 + erf(w),
                    torch.where(w > 0, 2.0 - erfc_z, erfc_z))
    return ftz(y * 0.5)


_LOG_2PI = _f32(math.log(2 * math.pi))


def norm_pdf(x: torch.Tensor) -> torch.Tensor:
    """``jax.scipy.stats.norm.pdf``: ``exp((log(2 pi) + x^2) / -2)``,
    which XLA computes as one FMA and a halving."""
    return exp(fma32(x, x, _LOG_2PI) * -0.5)


# jax.scipy.special.ndtri's Cephes coefficients, highest power first.
_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
             -5.66762857469070293439E1, 1.39312609387279679503E1,
             -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
             8.63602421390890590575E1, -2.25462687854119370527E2,
             2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
             5.71628192246421288162E1, 4.40805073893200834700E1,
             1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2,
             -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
             4.13172038254672030440E1, 1.50425385692907503408E1,
             2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
             3.93881025292474443415E0, 1.33303460815807542389E0,
             2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6,
             6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
             1.37702099489081330271E0, 2.16236993594496635890E-1,
             1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval(coeffs, x: torch.Tensor, fused: bool) -> torch.Tensor:
    """``jnp.polyval``: ``y = y * x + c`` from ``y = 0``, one FMA a step
    when ``fused``, a rounded product and a rounded sum otherwise."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = fma32(y, x, _f32(c)) if fused else y * x + _f32(c)
    return y


def _log_correctly_rounded(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x.double()).float()


def ndtri(p: torch.Tensor, folded: bool = False) -> torch.Tensor:
    """``jax.scipy.special.ndtri`` (Cephes) in float32 as XLA computes it
    after its algebraic simplifier: ``log(sqrt(y))`` becomes
    ``0.5 * log(y)`` and ``(a / b) / z`` becomes ``a / (b * z)``.

    ``folded=False`` is a jitted ndtri of an array: the fused loop
    contracts the Horner steps and ``w + (w w^2) P/Q`` into FMAs.
    ``folded=True`` is ndtri of constants inside a jitted function, which
    XLA evaluates at compile time: one operation at a time, no FMA, each
    ``log`` correctly rounded. The sweep's error quantiles take the
    latter (``ndtri(1 - q)`` of four constants)."""
    log = _log_correctly_rounded if folded else xla_log
    if not folded:
        p = ftz(p)
    one = torch.ones_like(p)
    mcp = torch.where(p > _f32(-np.expm1(-2.0)), one - p, p)
    mcp = torch.where(mcp == 0.0, torch.full_like(p, 0.5), mcp)
    w = mcp - 0.5
    ww = w * w
    www = w * ww
    ratio = (_polyval(_NDTRI_P0, ww, not folded) /
             _polyval(_NDTRI_Q0, ww, not folded))
    x_big = www * ratio + w if folded else fma32(www, ratio, w)
    x_big = x_big * -_f32(np.sqrt(2.0 * np.pi))
    zz = log(mcp) * -2.0
    z = sqrt(zz)
    first = z - (log(zz) * 0.5) / z
    inv_z = 1.0 / z
    second_small = (_polyval(_NDTRI_P2, inv_z, not folded) /
                    (_polyval(_NDTRI_Q2, inv_z, not folded) * z))
    second_other = (_polyval(_NDTRI_P1, inv_z, not folded) /
                    (_polyval(_NDTRI_Q1, inv_z, not folded) * z))
    x = torch.where(mcp > _f32(np.exp(-2.0)), x_big,
                    torch.where(z >= 8.0, first - second_small,
                                first - second_other))
    x = torch.where(p > _f32(1.0 - np.exp(-2.0)), x, -x)
    inf = torch.full_like(p, math.inf)
    return torch.where(p == 0.0, -inf, torch.where(p == 1.0, inf, x))


def interp(x: torch.Tensor, xp: torch.Tensor,
           fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp(x, xp, col)`` (constant extrapolation) of every column
    ``col`` of ``fp`` [K, Q] over sorted ``xp`` [K], in float32: the result
    is ``x``'s shape plus a trailing Q axis. The interval is
    ``searchsorted(xp, x, side='right')`` clipped to ``[1, K - 1]``; the
    value is ``fp[i-1] + (delta / dx) * df``, one FMA."""
    K, Q = fp.shape
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, K - 1)
    x0 = xp[i - 1]
    dx = xp[i] - x0
    eps = _f32(np.spacing(np.finfo(np.float32).eps))
    dx0 = (torch.abs(dx) <= eps).unsqueeze(-1)
    t = ((x - x0) / torch.where(dx0[..., 0], torch.ones_like(dx),
                                dx)).unsqueeze(-1)
    cols = torch.arange(Q, device=fp.device)
    f0 = fp[(i - 1).unsqueeze(-1), cols]
    f1 = fp[i.unsqueeze(-1), cols]
    f = torch.where(dx0, f0, fma32(t, f1 - f0, f0))
    xq = x.unsqueeze(-1)
    f = torch.where(xq < xp[0], fp[0], f)
    return torch.where(xq > xp[-1], fp[-1], f)
