"""Seeded, process-stable key hashing — the ONE blessed hash for keys.

Everything upstream of the counting sketch depends on one property the
builtin ``hash()`` cannot provide: the bucket of a key must be a pure
function of ``(key bytes, seed)`` — identical across processes, runs,
checkpoint resumes and the host/driver boundary. Python's builtin
string hash is salted per process (``PYTHONHASHSEED``), so a resumed
run (or a multi-process mesh) would scatter the same key into
different buckets and every sketch-derived artifact — selected
buckets, candidate tables, released key sets — would silently stop
replaying. Key hashing therefore routes through :func:`stable_hash64`,
never through raw ``hash()``.

Construction: FNV-1a 64-bit over the key's code units (UTF-32 code
points for ``str``, raw bytes for ``bytes``, the 64-bit value for
integers), seed folded into the offset basis, finished with the
splitmix64 avalanche (:func:`mix64`). The same arithmetic runs
vectorized over NumPy ``<U``/``S``/integer arrays and scalar over
Python objects, so a key hashes identically no matter which container
carried it — asserted in ``tests/test_torch_sketch.py``. Only TRAILING NUL
code units are treated as padding (NumPy pads fixed-width string
cells with NULs, and the hash must not depend on the array's
itemsize — note NumPy itself cannot represent a trailing NUL in
``U``/``S`` cells); embedded and leading NULs are key content and
hash, and the true length is mixed in at the end so prefixes stay
distinct.

Per-depth sketch rows derive their bucket ids by remixing the one
64-bit key hash with a depth salt (:func:`bucket_ids`) — one hash pass
per key, ``depth`` cheap remixes.

A copy of ``pipelinedp_tpu/sketch/hashing.py``: every hash and bucket id
is bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple, Union

import numpy as np

#: Deterministic default seed: sketch artifacts must replay across
#: runs unless the caller explicitly rotates the seed
#: (``SketchParams.hash_seed``).
DEFAULT_SEED = 0x5EEDC0DE

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_GOLDEN = 0x9E3779B97F4A7C15
_MASK64 = (1 << 64) - 1


def mix64(x: Union[int, np.ndarray]) -> np.ndarray:
    """splitmix64 finalizer (Steele et al.), vectorized: a full-period
    avalanche on uint64 — every output bit depends on every input bit,
    which is what lets one key hash feed ``depth`` independent-looking
    bucket rows."""
    with np.errstate(over="ignore"):
        x = np.asarray(x, dtype=np.uint64)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def _seed_basis(seed: int) -> np.uint64:
    return mix64(np.uint64((_FNV_OFFSET ^ (seed & _MASK64)) & _MASK64))


def _fnv_rows(mat: np.ndarray, seed: int) -> np.ndarray:
    """Vectorized FNV-1a over the code-unit columns of ``mat`` [N, L]
    (uint8 bytes or uint32 code points). Only TRAILING NUL columns are
    skipped per row — they are NumPy's fixed-width padding, and the
    hash must not depend on the array's itemsize. Embedded/leading
    NULs are key content and DO hash (``a\\0b`` != ``ab``); the true
    (padding-free) length is mixed in at the end."""
    n, width = mat.shape
    h = np.full(n, _seed_basis(seed), dtype=np.uint64)
    nonzero = mat != 0
    any_nz = nonzero.any(axis=1)
    # true length = 1 + index of the last nonzero unit (0 if none).
    true_len = np.where(any_nz,
                        width - np.argmax(nonzero[:, ::-1], axis=1),
                        0).astype(np.uint64)
    prime = np.uint64(_FNV_PRIME)
    with np.errstate(over="ignore"):
        for j in range(width):
            col = mat[:, j].astype(np.uint64)
            live = np.uint64(j) < true_len
            upd = (h ^ col) * prime
            h = np.where(live, upd, h)
        h = h ^ (true_len * np.uint64(_GOLDEN))
    return mix64(h)


def _fnv_scalar(units, seed: int) -> int:
    """Scalar twin of :func:`_fnv_rows` — byte-for-byte the same
    arithmetic, so a Python ``str`` hashes identically to the same
    string inside a NumPy ``<U`` array. Like the array form, trailing
    NULs are treated as padding (NumPy cannot represent them either),
    embedded/leading NULs hash as content."""
    true_len = 0
    for i, u in enumerate(units):
        if u != 0:
            true_len = i + 1
    h = int(_seed_basis(seed))
    for u in units[:true_len]:
        h = ((h ^ u) * _FNV_PRIME) & _MASK64
    h = h ^ ((true_len * _GOLDEN) & _MASK64)
    return int(mix64(np.uint64(h)))


def _hash_int_array(arr: np.ndarray, seed: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        x = arr.astype(np.int64).astype(np.uint64)
        return mix64(x ^ _seed_basis(seed))


def stable_hash_any(key: Any, seed: int = DEFAULT_SEED) -> int:
    """Seeded stable 64-bit hash of ONE key (str / bytes / int /
    anything with a stable ``repr``). The scalar entry point for
    non-vectorized callers;
    agrees with :func:`stable_hash64` element-wise. NOTE: hashes by
    VALUE BYTES (repr for arbitrary objects) — not by ``__eq__``; use
    it for replayable key→bucket maps, never where object-equality
    semantics must be honored (that is builtin ``hash()``'s job)."""
    if isinstance(key, (bool, np.bool_)):
        key = int(key)
    if isinstance(key, (int, np.integer)):
        with np.errstate(over="ignore"):
            x = np.uint64(int(key) & _MASK64)
            return int(mix64(x ^ _seed_basis(seed)))
    if isinstance(key, str):
        return _fnv_scalar([ord(c) for c in key], seed)
    if isinstance(key, (bytes, bytearray, np.bytes_)):
        return _fnv_scalar(list(bytes(key)), seed)
    return stable_hash_any(repr(key), seed)


def stable_hash64(keys, seed: int = DEFAULT_SEED) -> np.ndarray:
    """Seeded stable uint64 hashes for a key column.

    Accepts NumPy integer / ``<U`` / ``S`` arrays (vectorized) or any
    sequence of str/bytes/int/objects (scalar loop over *unique-ish*
    inputs — callers factorize first, so the loop runs over distinct
    keys, not rows). Same key, same seed → same hash, regardless of
    container.
    """
    arr = keys if isinstance(keys, np.ndarray) else np.asarray(keys)
    if arr.dtype.kind in "iub":
        return _hash_int_array(arr, seed)
    if arr.dtype.kind == "U":
        # UTF-32 code points, native byte order: [N, L] uint32 view.
        a = np.ascontiguousarray(arr)
        if a.size == 0:
            return np.zeros(0, np.uint64)
        L = a.dtype.itemsize // 4
        mat = a.view(np.uint32).reshape(len(a), L)
        if not a.dtype.isnative:  # pragma: no cover - exotic input
            mat = mat.byteswap()
        return _fnv_rows(mat, seed)
    if arr.dtype.kind == "S":
        a = np.ascontiguousarray(arr)
        if a.size == 0:
            return np.zeros(0, np.uint64)
        mat = a.view(np.uint8).reshape(len(a), a.dtype.itemsize)
        return _fnv_rows(mat, seed)
    return np.fromiter((stable_hash_any(k, seed) for k in arr),
                       dtype=np.uint64, count=len(arr))


def bucket_ids(hashes: np.ndarray, width: int, depth: int,
               seed: int = DEFAULT_SEED) -> np.ndarray:
    """[depth, N] int32 bucket rows from one uint64 hash column: row
    ``d`` remixes the key hash with a (seed, d) salt and reduces mod
    ``width``. Row 0 is the SELECTION row (candidates are keys whose
    row-0 bucket is selected); rows 1.. serve count-min estimates."""
    if width <= 0:
        raise ValueError("sketch width must be positive")
    h = np.asarray(hashes, dtype=np.uint64)
    out = np.empty((depth, len(h)), dtype=np.int32)
    with np.errstate(over="ignore"):
        for d in range(depth):
            salt = mix64(np.uint64(
                ((seed & _MASK64) ^ ((d + 1) * _GOLDEN)) & _MASK64))
            out[d] = (mix64(h ^ salt) % np.uint64(width)).astype(np.int32)
    return out


def build_candidate_table(uniq_keys: Sequence, selected_of_key: np.ndarray
                          ) -> Tuple[list, dict]:
    """The host-side key→candidate-id encoding table: the keys of
    ``uniq_keys`` (factorization order — ascending for NumPy-sortable
    dtypes) whose row-0 bucket was selected, paired with dense
    candidate ids in that order.

    NOT a DP release: the table is phase-2 *input* (it restricts which
    rows the exact dense pass sees); only phase 2's own private
    partition selection decides what is released.
    """
    sel = np.asarray(selected_of_key, dtype=bool)
    if isinstance(uniq_keys, np.ndarray):
        cand = uniq_keys[sel].tolist()
    else:
        cand = [k for k, s in zip(uniq_keys, sel) if s]
    return cand, {k: i for i, k in enumerate(cand)}
