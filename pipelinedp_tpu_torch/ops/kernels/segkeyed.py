"""The utility-analysis sweep's keyed float32 sums: a CUDA kernel and its
plain PyTorch version.

``segmented_sums(values, layout)`` (K5) reduces a float32 ``[n, W]``
stack per key into ``[P, W]``::

    out[p, w] = (((0 + values[r0, w]) + values[r1, w]) + ...) + values[rk, w]

over the rows ``r0 < r1 < ... < rk`` whose key is ``p``: float32 adds,
strictly in row order, from +0.0 (a key with no rows totals +0.0). That
is the order of the JAX package's ``jax.ops.segment_sum(cols, pk_safe,
num_segments=P)`` on the CPU (``analysis/jax_sweep.py``: the ``[n, Cc,
5]`` per-metric stack and the ``[n, Cc, 3]`` selection moments), whose
scatter adds the updates one after another in row order. The sums are
clipped, square-rooted and fed to the keep-probability window, so neither
an atomic ``index_add_`` (no fixed order) nor a tree reduction may stand
in for it.

The keys of a sweep are the same for every config chunk, so their row
order is computed once: ``key_layout(keys, P)`` sorts the rows by key
(stably, so each key keeps its rows in row order) and gives each key's
range of that order. Both launches of every chunk reuse it.

K5 is a port-only kernel: it replaces no Pallas body, only the XLA
scatter above. The CUDA source, its design and its bound are in
``csrc/segkeyed.cu``. Dispatch is by the device of the tensors and nothing
else: a CUDA tensor launches the kernel (or raises), a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

import numpy as np
import torch

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES: Dict[str, int] = {"segmented_sums": 0}

#: ``kThreads`` of ``csrc/segkeyed.cu``: the columns of one block, and
#: ``kDepth``: the rows whose loads a thread issues ahead of its adds. With
#: the warp's 32 columns, the seams of the kernel's fold.
BLOCK_COLS = 128
DEPTH_ROWS = 16

#: The layouts of ``seam_layout``.
SEAM_LAYOUTS = ("empty_keys", "one_row_keys", "depth", "warp_cols",
                "block_cols", "odd_width")


class KeyLayout(NamedTuple):
    """The row order of one set of keys: ``order`` int32 ``[n]``, the rows
    sorted by key with each key's rows in row order, and ``offsets`` int64
    ``[P + 1]``, key ``p``'s rows being ``order[offsets[p]:offsets[p+1]]``."""
    order: torch.Tensor
    offsets: torch.Tensor
    P: int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def key_layout(keys: torch.Tensor, P: int) -> KeyLayout:
    """The ``KeyLayout`` of int32 ``keys`` ``[n]`` in ``[0, P)``: one
    stable sort and one ``bincount``. Raises when a key lies outside
    ``[0, P)`` (this reads the count's length back, once per sweep)."""
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise TypeError(f"key_layout takes int32 keys [n], got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    if P < 1:
        raise ValueError(f"key_layout needs P >= 1, got {P}")
    order = torch.sort(keys, stable=True).indices.to(torch.int32)
    counts = torch.bincount(keys.long(), minlength=P)
    if counts.shape[0] != P:
        raise ValueError(f"key_layout: a key is >= P = {P}")
    offsets = torch.zeros(P + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return KeyLayout(order.contiguous(), offsets, int(P))


def segmented_sums_plain(values: torch.Tensor,
                         layout: KeyLayout) -> torch.Tensor:
    """The plain version: a float32 left fold per key, vectorised over
    keys, one step per position within a key. Keys are ranked by their
    row count, longest first, so the keys still open at step ``k`` are a
    prefix of that order."""
    n, W = values.shape
    P = layout.P
    device = values.device
    out = torch.zeros(P, W, dtype=torch.float32, device=device)
    if n == 0:
        return out
    offsets = layout.offsets.cpu().numpy()
    lens = np.diff(offsets)
    korder = np.argsort(-lens, kind="stable")
    lens_sorted = lens[korder]
    n_open = int(np.count_nonzero(lens_sorted))
    rows = values.index_select(0, layout.order.long())
    pos = torch.from_numpy(offsets[:-1][korder][:n_open].copy()).to(device)
    # open_at[k]: how many keys hold more than k rows.
    open_at = P - np.cumsum(np.bincount(lens, minlength=int(lens.max()) + 1))
    tot = torch.zeros(n_open, W, dtype=torch.float32, device=device)
    max_len = int(lens_sorted[0])
    for k in range(max_len):
        c = int(open_at[k])
        if c == 1:
            # One key left open: its remaining rows are contiguous in
            # ``rows``, so each step adds a one-row view, one at a time.
            first = int(pos[0])
            last = tot[0]
            for row in rows[first:first + max_len - k].unbind():
                last.add_(row)
            break
        tot[:c] += rows.index_select(0, pos[:c])
        pos[:c] += 1
    out[torch.from_numpy(korder[:n_open].copy()).to(device)] = tot
    return out


def _order_values(n: int, W: int, rng: np.random.Generator) -> np.ndarray:
    """Small values with a 1e8 and, three rows later, a -1e8 every seven
    rows of each column (shifted per column): a key's running total keeps
    returning near 0, and each small value added while it is near 1e8
    rounds away, so a total depends on where each add happens."""
    values = rng.choice(np.float32([1.0, 0.37, 2.5, -0.75]), (n, W))
    for w in range(W):
        big = np.arange(w % 7, n - 3, 7)
        values[big, w] = np.float32(1e8)
        values[big + 3, w] = np.float32(-1e8)
    return values


def seam_layout(name: str, order_sensitive: bool = False):
    """``(values [n, W] float32, keys [n] int32, P)`` as numpy arrays: keys
    and widths laid over the seams of the CUDA kernel, for holding it to
    the plain version. ``empty_keys``: most keys without rows;
    ``one_row_keys``: every key one row; ``depth``: key lengths one below,
    at and one above one and two load groups (``DEPTH_ROWS``);
    ``warp_cols``, ``block_cols``: widths one past a warp's and a block's
    columns; ``odd_width``: an odd width of config-stack shape (129
    configs times 5). The rows of all keys are interleaved at random.
    Values are standard normal times 10, or order-sensitive
    (``_order_values``)."""
    rng = np.random.default_rng(70 + SEAM_LAYOUTS.index(name))
    D = DEPTH_ROWS
    if name == "empty_keys":
        P, W = 64, 15
        lengths = [int(rng.integers(1, 40)) if p % 3 == 0 else 0
                   for p in range(P)]
    elif name == "one_row_keys":
        P, W = 300, 9
        lengths = [1] * P
    elif name == "depth":
        P, W = 12, 40
        lengths = [D - 1, D, D + 1, 2 * D - 1, 2 * D, 2 * D + 1, 1, 0,
                   3 * D, 5 * D + 3, 2, D // 2]
    elif name == "warp_cols":
        P, W = 20, 33
        lengths = list(rng.integers(0, 3 * D, P))
    elif name == "block_cols":
        P, W = 10, BLOCK_COLS + 1
        lengths = list(rng.integers(1, 3 * D, P))
    else:
        P, W = 16, 129 * 5
        lengths = list(rng.integers(0, 4 * D, P))
    keys = np.repeat(np.arange(P, dtype=np.int32), lengths)
    keys = keys[rng.permutation(len(keys))]
    n = len(keys)
    if order_sensitive:
        values = _order_values(n, W, rng)
    else:
        values = (rng.standard_normal((n, W)) * 10).astype(np.float32)
    return values.astype(np.float32), keys, P


def _check(values: torch.Tensor, layout: KeyLayout) -> None:
    if values.dtype != torch.float32:
        raise TypeError(f"segmented_sums takes float32 values, got "
                        f"{values.dtype}")
    if values.dim() != 2 or values.shape[0] != layout.order.shape[0]:
        raise ValueError(f"segmented_sums takes values [n, W] over the "
                         f"layout's n = {layout.order.shape[0]} rows, got "
                         f"{tuple(values.shape)}")
    if values.device != layout.order.device:
        raise ValueError("segmented_sums takes values on the layout's "
                         "device")
    if not values.is_contiguous():
        raise ValueError("segmented_sums takes contiguous values")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segmented_sums runs on cuda or cpu, not "
                         f"{values.device}")


_LAUNCH = []


def _launcher():
    """``segkeyed_launch`` of the built ``csrc/segkeyed.cu``, loaded once:
    the call per launch is then a ctypes call and nothing more."""
    if not _LAUNCH:
        from pipelinedp_tpu_torch.ops.kernels import _build
        lib = _build.load("segkeyed")
        lib.segkeyed_block_cols.restype = ctypes.c_int
        lib.segkeyed_depth_rows.restype = ctypes.c_int
        if (lib.segkeyed_block_cols() != BLOCK_COLS or
                lib.segkeyed_depth_rows() != DEPTH_ROWS):
            raise RuntimeError("csrc/segkeyed.cu's block or depth differs "
                               "from BLOCK_COLS or DEPTH_ROWS")
        fn = lib.segkeyed_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def segmented_sums(values: torch.Tensor, layout: KeyLayout) -> torch.Tensor:
    """Each key's row-ordered float32 column totals, ``[P, W]``: ``values``
    float32 ``[n, W]`` contiguous, on the device of ``layout``
    (``key_layout``)."""
    _check(values, layout)
    if values.device.type == "cpu":
        return segmented_sums_plain(values, layout)
    n, W = values.shape
    # One allocation; the kernel writes every element, on the caller's
    # stream.
    out = torch.empty(layout.P, W, dtype=torch.float32, device=values.device)
    with torch.cuda.device(values.device):
        err = _launcher()(values.data_ptr(), layout.order.data_ptr(),
                          layout.offsets.data_ptr(), out.data_ptr(), n, W,
                          layout.P, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segkeyed launch failed: CUDA error {err}")
    LAUNCHES["segmented_sums"] += 1
    return out
