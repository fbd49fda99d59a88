"""JAX's threefry PRNG, reproduced bit for bit in PyTorch.

The fused path's keep decisions and contribution samples are functions
of JAX's random streams: the root ``jax.random.split`` into bounding,
selection and noise keys, the bounding salt ``jax.random.bits``, and the
selection draws ``jax.random.uniform`` / ``laplace`` / ``normal``. A port
that is held bit for bit against the JAX package must draw the same
numbers, so this module rebuilds those calls under JAX's default
``jax_threefry_partitionable=True`` semantics:

* a key is an int64 tensor ``[2]`` on the CPU holding the two uint32 key
  words, as ``jax.random.PRNGKey`` gives them (``[0, seed]``);
* ``split(key, n)`` is ``_threefry_split_foldlike``: one Threefry-2x32
  block per child over the counters ``(hi, lo)`` of a 64-bit iota;
* ``bits(key, shape)`` is ``_threefry_random_bits_partitionable``:
  ``bits1 ^ bits2`` of the same block over the same iota counters;
* ``fold_in(key, data)`` is ``threefry_fold_in``: one block over the
  counter ``(0, data)``;
* ``uniform`` / ``laplace`` / ``normal`` follow ``jax/_src/random.py``'s
  ``_uniform`` (mantissa fill of ``[1, 2)``, minus one, affine map, clamp
  at ``minval``), ``_laplace`` and ``_normal_real``.

Unsigned order: torch has no full uint32 arithmetic, so every word lives
in int64 and is masked with ``& 0xFFFFFFFF`` after each add and shift;
products never arise here. Values in ``[0, 2^32)`` keep their unsigned
order as int64.

Transcendentals: torch's ``log1p`` and ``erfinv`` are not XLA's. XLA's
float32 ``log1p`` sits up to one ULP from torch's in about 7% of the
Laplace draws, and XLA's ``erf_inv`` (Giles' single-precision polynomial)
up to 91 ULP from torch's ``erfinv``. So ``laplace`` and ``normal`` run
XLA's own float32 algorithms, op for op: the Cephes ``log`` and ``log1p``
of XLA's CPU emitter and the Giles ``erf_inv`` of its CHLO lowering. XLA's
CPU code generator contracts each ``a * b + c`` of those polynomials into
one fused multiply-add; ``fma32`` reproduces that single rounding through
an exact float64 product (a float32 product has at most 48 significant
bits). The one square root, in the tail of ``erf_inv``, is taken in
float64 and rounded once, so it is correctly rounded as XLA's is. Every op
is elementwise IEEE arithmetic, so the draws are the same on the CPU and
on the card.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
# Threefry-2x32 rotation schedule (Salmon et al., table 2), the one
# inside jax.random's own generator.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA

Word = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0: Word, k1: Word, x0: torch.Tensor,
                 x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Threefry-2x32 block (20 rounds) per element. Key words are
    Python ints or int64 tensors, counter lanes int64 tensors holding
    uint32 values; returns the two output lanes as int64 tensors in
    ``[0, 2^32)``."""
    k0 = k0 & MASK32
    k1 = k1 & MASK32
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0.to(torch.int64) + ks[0]) & MASK32
    x1 = (x1.to(torch.int64) + ks[1]) & MASK32
    for d in range(5):
        for r in _ROTATIONS[d % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(d + 1) % 3]) & MASK32
        x1 = (x1 + ks[(d + 2) % 3] + (d + 1)) & MASK32
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the key words ``[seed >> 32,
    seed & 0xFFFFFFFF]`` (``[0, seed]`` for a 32-bit seed)."""
    seed = int(seed)
    return torch.tensor([(seed >> 32) & MASK32, seed & MASK32],
                        dtype=torch.int64)


def key_words(key: torch.Tensor) -> Tuple[int, int]:
    """The two key words as Python ints (keys stay on the host; draws
    take the words as scalars, so a device draw needs no key transfer)."""
    k = key.tolist()
    return int(k[0]), int(k[1])


def _iota_2x32(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """``iota_2x32_shape``: the high and low words of a row-major 64-bit
    iota over ``shape``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK32


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (partitionable): ``[num, 2]``."""
    k0, k1 = key_words(key)
    hi, lo = _iota_2x32((num,), "cpu")
    b1, b2 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([b1, b2], dim=1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: one Threefry-2x32 block over the
    counter ``(0, data)`` (``threefry_seed`` of a uint32 datum), whose two
    output words are the new key. The partitionable flag does not touch
    it."""
    k0, k1 = key_words(key)
    y0, y1 = threefry2x32(k0, k1, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & MASK32]))
    return torch.cat([y0, y1])


def bits(key: torch.Tensor, shape: Sequence[int] = (),
         device="cpu") -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)``: int64 tensor of uint32
    values."""
    k0, k1 = key_words(key)
    hi, lo = _iota_2x32(tuple(shape), device)
    b1, b2 = threefry2x32(k0, k1, hi, lo)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device="cpu") -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    b = bits(key, shape, device)
    # The top 23 bits fill the mantissa of a float in [1, 2).
    fbits = ((b >> 9) | 0x3F800000).to(torch.int32)
    floats = fbits.view(torch.float32) - 1.0
    return torch.clamp_min(floats * float(span) + float(lo), float(lo))


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` with one rounding, as a contracted FMA gives
    it: the float64 product of two float32 values is exact."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else float(np.float32(b))
    c64 = c.double() if torch.is_tensor(c) else float(np.float32(c))
    return (a64 * b64 + c64).float()


def _f32(v: float) -> float:
    return float(np.float32(v))


# Cephes logf coefficients, as XLA's CPU emitter rounds them to float32.
_LOG_P = tuple(_f32(v) for v in (
    7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
    1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
    3.3333331174E-1))
_LOG_Q1 = _f32(-2.12194440e-4)
_LOG_Q2 = _f32(0.693359375)
_SQRTHF = _f32(0.707106781186547524)
_MIN_NORM = float(np.array(0x00800000, np.uint32).view(np.float32))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU float32 ``log`` (Cephes), with its special cases: zero
    and subnormal inputs (its executables treat subnormals as zero) give
    -inf, +inf gives +inf, and a negative or NaN input the NaN whose bits
    are all set (XLA ORs an all-ones mask into the result)."""
    raw = x
    x = torch.clamp_min(x, _MIN_NORM)
    xb = x.view(torch.int32)
    e = 1.0 + ((xb >> 23) - 0x7F).float()
    frac = ((xb & ~0x7F800000) | 0x3F000000).view(torch.float32)
    small = frac < _SQRTHF
    t = (frac - 1.0) + torch.where(small, frac, torch.zeros_like(frac))
    e = e - small.float()
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = fma32(t, p[0], p[1])
    y1 = fma32(t, p[3], p[4])
    y2 = fma32(t, p[6], p[7])
    y = fma32(y, t, p[2])
    y1 = fma32(y1, t, p[5])
    y2 = fma32(y2, t, p[8])
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, _LOG_Q1 * e)
    t = fma32(torch.full_like(t, -0.5), x2, t)
    t = t + y
    out = fma32(torch.full_like(t, _LOG_Q2), e, t)
    out = torch.where(raw == math.inf, raw, out)
    # Made on the tensor's device: a host tensor would cost a copy and a
    # stream synchronisation on every call.
    all_ones_nan = torch.full_like(out, -1, dtype=torch.int32).view(
        torch.float32)
    out = torch.where((raw < 0) | torch.isnan(raw), all_ones_nan, out)
    return torch.where(torch.abs(raw) < _MIN_NORM, -math.inf, out)


_LOG1P_NUM = tuple(_f32(v) for v in (
    4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
    6.5787325942061044846969E0, 2.9911919328553073277375E1,
    6.0949667980987787057556E1, 5.7112963590585538103336E1,
    2.0039553499201281259648E1))
_LOG1P_DEN = tuple(_f32(v) for v in (
    1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
    2.2176239823732856465394E2, 3.0909872225312059774938E2,
    2.1642788614495947685003E2, 6.0118660497603843919306E1))


def _horner(x: torch.Tensor, coeffs) -> torch.Tensor:
    p = torch.zeros_like(x)
    for c in coeffs:
        p = fma32(p, x, c)
    return p


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: a Cephes rational function below
    ``sqrt(2) - 1`` in magnitude, ``log(1 + x)`` above; for finite
    ``x > -1``."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN)
    small = x + fma32(torch.full_like(x, -0.5), x2, (x * x2) * r)
    large = xla_log(x + 1.0)
    return torch.where(torch.abs(x) < 0.41421356237309504880, small, large)


_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def xla_erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles' approximation), for ``|x| <= 1``.

    The tail branch's ``sqrt`` is taken in float64 and rounded to
    float32: that is the correctly rounded float32 square root (53 >= 2 *
    24 + 2 bits), which XLA's ``sqrt`` gives and torch's CPU float32
    ``sqrt`` does not always."""
    w = -xla_log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w.double()).float() - 3.0)
    lt5 = torch.tensor(_ERFINV_LT5, dtype=torch.float32, device=x.device)
    ge5 = torch.tensor(_ERFINV_GE5, dtype=torch.float32, device=x.device)
    p = torch.where(lt, lt5[0], ge5[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = fma32(p, w, torch.where(lt, lt5[i], ge5[i]))
    # XLA returns +-inf at |x| == 1, which the counter-keyed uniform
    # reaches on its top grid point.
    return torch.where(torch.abs(x) == 1.0, x * math.inf, p * x)


def laplace(key: torch.Tensor, shape: Sequence[int],
            device="cpu") -> torch.Tensor:
    """``jax.random.laplace(key, shape)`` (unit scale, float32)."""
    epsneg = float(np.finfo(np.float32).epsneg)
    u = uniform(key, shape, np.float32(-1.0 + epsneg), 1.0, device)
    return torch.sign(u) * xla_log1p(-torch.abs(u))


def normal(key: torch.Tensor, shape: Sequence[int],
           device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (float32)."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0, device)
    return _f32(np.sqrt(2)) * xla_erfinv(u)
