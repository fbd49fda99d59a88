"""Native host library: hardened noise for DP releases, and the integer
factorizer of the encode.

Port copy of ``pipelinedp_tpu/native/__init__.py``, over copies of its C++
sources (``secure_noise.cc``, ``encode.cc``). A textbook floating-point
Laplace leaks information through the noise sample's low-order bits
(Mironov, CCS 2012); the reference delegates its host noise to the C++
google/differential-privacy library, which hardens against this. This
library is the hardened twin:

* ``snapping_laplace(values, scale, bound)``: Mironov's snapping mechanism
  over a ChaCha20 CSPRNG;
* ``discrete_laplace(counts, scale)``: exact two-sided geometric noise for
  integer releases (no float noise bits at all);
* ``discrete_gaussian(counts, sigma)``: discrete-Gaussian noise
  (Canonne-Kamath-Steinke sampler) for integer releases; the support is
  exactly the integers, and the acceptance probabilities are realized to
  2^-53 (double-precision Bernoulli coins) rather than CKS's exact
  rationals, a deviation below any expressible (eps, delta);
* ``secure_gaussian(values, sigma, bound)``: granularity-snapped
  discrete-Gaussian release for real values;
* ``seed(n)`` / ``seed_from_os()``: deterministic seeding for tests, OS
  entropy otherwise;
* ``factorize_i64(arr)``: ``np.unique(arr, return_inverse=True)`` for
  integer keys through an open-addressing hash.

The same ``seed(n)`` gives the JAX package's draws bit for bit: the sources
are the same and the samplers consume the stream in the same order.

Each source is compiled with ``g++`` at first use, never at import, into
``pipelinedp_tpu_torch/build/`` under a file name that carries a hash of the
source and the flags, so an edited source rebuilds and another package's
library is never loaded. ``ctypes`` loads each library ``RTLD_LOCAL``, so
this library's CSPRNG state is its own even in a process that also loads the
JAX package's. A host without a compiler gets ``NativeUnavailableError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import warnings
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "secure_noise.cc")
_ENC_SRC = os.path.join(_DIR, "encode.cc")
#: The port's build directory, shared with the CUDA kernels
#: (``ops/kernels/_build.py``); ignored by git.
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LOAD_ERROR: Optional[str] = None
_ENC_LIB: Optional[ctypes.CDLL] = None
_ENC_ERROR: Optional[str] = None


class NativeUnavailableError(RuntimeError):
    """The native library could not be built or loaded on this host."""


def _build_shared_lib(src: str, name: str, flags=GXX_FLAGS,
                      libs=()) -> str:
    """The path of ``src`` compiled with ``g++ flags src libs``, built on
    first use. The file name carries a hash of the source, the flags and
    the libraries; the build goes to a per-process temporary name and is
    renamed into place, so concurrent builders race harmlessly."""
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(
            (*flags, *libs)).encode())
    out = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    from pipelinedp_tpu_torch.obs import costs
    cached = os.path.exists(out)
    with costs.build_span(name, cached):
        if not cached:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            proc = subprocess.run(["g++", *flags, src, *libs, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeUnavailableError(
                    f"g++ failed building {os.path.basename(src)}: "
                    f"{proc.stderr[-500:]}")
            os.replace(tmp, out)
    return out


def _lib() -> ctypes.CDLL:
    global _LIB, _LOAD_ERROR
    if _LIB is not None:
        return _LIB
    if _LOAD_ERROR is not None:
        raise NativeUnavailableError(_LOAD_ERROR)
    with _LOCK:
        if _LIB is not None:
            return _LIB
        try:
            lib = ctypes.CDLL(_build_shared_lib(_SRC, "_secure_noise"))
        except (OSError, NativeUnavailableError) as e:
            _LOAD_ERROR = str(e)
            raise NativeUnavailableError(_LOAD_ERROR) from e
        lib.sn_seed.argtypes = [ctypes.c_uint64]
        lib.sn_seed.restype = None
        lib.sn_seed_from_os.argtypes = []
        lib.sn_seed_from_os.restype = None
        lib.sn_snapping_laplace.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double]
        lib.sn_snapping_laplace.restype = ctypes.c_double
        lib.sn_uniform.argtypes = [ctypes.POINTER(ctypes.c_double),
                                   ctypes.c_int64]
        lib.sn_uniform.restype = None
        lib.sn_discrete_laplace.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_double]
        lib.sn_discrete_laplace.restype = None
        lib.sn_discrete_gaussian.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_double]
        lib.sn_discrete_gaussian.restype = ctypes.c_int32
        lib.sn_secure_gaussian.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64, ctypes.c_double, ctypes.c_double]
        lib.sn_secure_gaussian.restype = ctypes.c_double
        _LIB = lib
        return _LIB


def available() -> bool:
    """True when the native library can be (or was) built and loaded.
    May spawn a g++ build on first call; :func:`is_loaded` is the check
    without side effects."""
    try:
        _lib()
        return True
    except NativeUnavailableError:
        return False


def is_loaded() -> bool:
    """True iff the library is already loaded in this process. Never
    triggers a build."""
    return _LIB is not None


def seed(n: int) -> None:
    """Deterministic CSPRNG seeding, for tests and reproducible runs."""
    _lib().sn_seed(ctypes.c_uint64(n & (2**64 - 1)))


def seed_from_os() -> None:
    """Re-key from OS entropy (e.g. in a new pool worker)."""
    _lib().sn_seed_from_os()


def _f64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _default_bound(scale: float) -> float:
    """2^46 * max(Lambda, 1), Lambda the smallest power of two >= scale."""
    lam = 2.0**np.ceil(np.log2(scale))
    return float(max(lam, 1.0) * 2.0**46)


def _warn_if_clamped(name: str, flat: np.ndarray, bound: float) -> None:
    if flat.size and float(np.max(np.abs(flat))) > bound:
        warnings.warn(
            f"{name}: input magnitude exceeds the clamp bound "
            f"({bound:.3g}); the release is clamped. Pass an explicit "
            "bound sized to the query range.", UserWarning, stacklevel=3)


def snapping_laplace(values, scale: float,
                     bound: Optional[float] = None) -> np.ndarray:
    """Snapping-Laplace release of ``values`` with noise scale ``scale``.

    Returns values + Laplace(scale) noise, rounded to the snapping
    resolution Lambda (smallest power of two >= scale) and clamped to
    [-bound, bound]. The default bound is 2^46 * max(Lambda, 1): Mironov's
    analysis wants B/Lambda bounded (the clamp is part of the mechanism),
    and the max(..., 1) floor keeps small noise scales from shrinking the
    representable release range below realistic aggregates. Callers whose
    releases can legitimately exceed ~7e13 must pass an explicit bound;
    inputs that the clamp actually truncates raise a UserWarning.
    """
    if scale <= 0:
        raise ValueError("scale must be positive")
    vals = np.asarray(values, dtype=np.float64)
    # ascontiguousarray promotes 0-d to 1-d: keep the true shape.
    shape = vals.shape
    flat = np.ascontiguousarray(vals).ravel()
    out = np.empty_like(flat)
    if bound is None:
        bound = _default_bound(scale)
    _warn_if_clamped("snapping_laplace", flat, bound)
    _lib().sn_snapping_laplace(_f64_ptr(flat), _f64_ptr(out), flat.size,
                               float(scale), float(bound))
    return out.reshape(shape)


def discrete_laplace(counts, scale: float) -> np.ndarray:
    """Integer release: counts + two-sided-geometric noise of scale
    ``scale`` (decay exp(-1/scale)), with no floating-point noise bits."""
    if scale <= 0:
        raise ValueError("scale must be positive")
    vals = np.asarray(counts, dtype=np.int64)
    shape = vals.shape
    flat = np.ascontiguousarray(vals).ravel()
    out = np.empty_like(flat)
    _lib().sn_discrete_laplace(_i64_ptr(flat), _i64_ptr(out), flat.size,
                               float(scale))
    return out.reshape(shape)


def discrete_gaussian(counts, sigma: float) -> np.ndarray:
    """Integer release: counts + discrete-Gaussian noise of standard
    deviation about ``sigma`` (Canonne-Kamath-Steinke sampler). The
    release's support is exactly the integers; the sampler's acceptance
    coins are double-precision Bernoullis (see ``secure_noise.cc``).
    ``sigma`` must be in (0, 2^40)."""
    if not 0 < sigma < 2.0**40:
        raise ValueError("sigma must be in (0, 2^40)")
    vals = np.asarray(counts, dtype=np.int64)
    shape = vals.shape
    flat = np.ascontiguousarray(vals).ravel()
    out = np.empty_like(flat)
    rc = _lib().sn_discrete_gaussian(_i64_ptr(flat), _i64_ptr(out),
                                     flat.size, float(sigma))
    if rc != 0:
        raise ValueError(f"sn_discrete_gaussian rejected sigma={sigma}")
    return out.reshape(shape)


def secure_gaussian(values, sigma: float,
                    bound: Optional[float] = None) -> np.ndarray:
    """Hardened Gaussian release of ``values`` with noise std ``sigma``:
    the value is snapped to a power-of-two granularity g (sized so
    sigma/g is in (2^39, 2^40]) and g-scaled discrete-Gaussian noise is
    added, so the release's support is the g-grid: the Gaussian twin of
    :func:`snapping_laplace`, with the same default clamp bound policy."""
    if sigma <= 0:
        raise ValueError("sigma must be positive")
    vals = np.asarray(values, dtype=np.float64)
    shape = vals.shape
    flat = np.ascontiguousarray(vals).ravel()
    out = np.empty_like(flat)
    if bound is None:
        bound = _default_bound(sigma)
    _warn_if_clamped("secure_gaussian", flat, bound)
    g = _lib().sn_secure_gaussian(_f64_ptr(flat), _f64_ptr(out), flat.size,
                                  float(sigma), float(bound))
    if g <= 0:
        raise ValueError(f"sn_secure_gaussian rejected sigma={sigma}")
    return out.reshape(shape)


def uniform(n: int) -> np.ndarray:
    """Raw uniforms in (0, 1] from the CSPRNG, for statistical tests."""
    out = np.empty(n, dtype=np.float64)
    _lib().sn_uniform(_f64_ptr(out), n)
    return out


# ---------------------------------------------------------------------------
# Ingest: hash-based integer factorization (encode.cc)
# ---------------------------------------------------------------------------


def _enc_lib() -> ctypes.CDLL:
    global _ENC_LIB, _ENC_ERROR
    if _ENC_LIB is not None:
        return _ENC_LIB
    if _ENC_ERROR is not None:
        raise NativeUnavailableError(_ENC_ERROR)
    with _LOCK:
        if _ENC_LIB is not None:
            return _ENC_LIB
        try:
            lib = ctypes.CDLL(_build_shared_lib(_ENC_SRC, "_encode"))
        except (OSError, NativeUnavailableError) as e:
            _ENC_ERROR = str(e)
            raise NativeUnavailableError(_ENC_ERROR) from e
        lib.pdp_factorize_i64.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)]
        lib.pdp_factorize_i64.restype = ctypes.c_int64
        _ENC_LIB = lib
        return _ENC_LIB


def encode_available() -> bool:
    """True when the native factorizer can be (or was) built and loaded."""
    try:
        _enc_lib()
        return True
    except NativeUnavailableError:
        return False


def factorize_i64(arr: np.ndarray):
    """``np.unique(arr, return_inverse=True)`` for integer arrays, via a
    grow-as-needed open-addressing hash: O(N + U log U) instead of the full
    O(N log N) sort, the encode's hot path when the vocabulary is much
    smaller than the data. When an early sample finds mostly-distinct keys
    the C++ side bails (-2) and this falls back to np.unique, which wins
    that regime. Returns (sorted uniques int64, inverse int32),
    bit-identical to np.unique."""
    arr = np.asarray(arr)
    if (arr.dtype.kind == "u" and arr.size and
            int(arr.max()) > np.iinfo(np.int64).max):
        raise ValueError(
            "factorize_i64: uint64 values above int64 max would wrap; "
            "use np.unique for this input")
    flat = np.ascontiguousarray(arr, dtype=np.int64).ravel()
    n = flat.size
    inverse = np.empty(n, dtype=np.int32)
    uniq = np.empty(n, dtype=np.int64)
    if n == 0:
        return uniq[:0], inverse
    u = _enc_lib().pdp_factorize_i64(
        _i64_ptr(flat), n,
        inverse.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        _i64_ptr(uniq))
    if u == -2:  # mostly-distinct sample: the sort wins
        nu, ni = np.unique(flat, return_inverse=True)
        return nu, ni.astype(np.int32)
    if u < 0:
        raise NativeUnavailableError(
            "pdp_factorize_i64 failed (allocation or id overflow)")
    return uniq[:u].copy(), inverse
