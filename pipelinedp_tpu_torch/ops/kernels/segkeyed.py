"""The utility-analysis sweep's keyed float32 sums: a CUDA kernel and its
plain PyTorch version.

``segmented_sums(values, layout)`` (K5) reduces a float32 ``[n, W]``
stack per key into ``[P, W]``::

    out[p, w] = (((0 + values[r0, w]) + values[r1, w]) + ...) + values[rk, w]

over key ``p``'s rows ``r0 < r1 < ... < rk``: float32 adds, strictly in
row order, from +0.0 (a key with no rows totals +0.0). That is the order
of the JAX package's ``jax.ops.segment_sum(cols, pk_safe, num_segments=P)``
on the CPU (``analysis/jax_sweep.py``: the ``[n, Cc, 5]`` per-metric stack
and the ``[n, Cc, 3]`` selection moments), whose scatter adds the updates
one after another in row order. The sums are clipped, square-rooted and
fed to the keep-probability window, so neither an atomic ``index_add_``
(no fixed order) nor a tree reduction may stand in for it.

The keys of a sweep are the same for every config chunk, so the caller
puts its rows in key order once: ``key_layout(keys, P, keep)`` sorts the
kept rows by key (stably, so each key keeps its rows in row order), and
the caller gathers its per-row inputs through ``layout.order``. Every
stack it then builds has each key's rows as one contiguous range,
``offsets[p]:offsets[p + 1]``. Rows outside ``keep`` may be dropped only
where their every column is +-0.0: a fold from +0.0 never holds -0.0, and
adding +-0.0 to anything else leaves it unchanged, so the totals keep
their bits.

K5 is a port-only kernel: it replaces no Pallas body, only the XLA
scatter above. The CUDA source, its design and its bound are in
``csrc/segkeyed.cu``. Dispatch is by the device of the tensors and nothing
else: a CUDA tensor launches the kernel (or raises), a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch.ops.kernels import _build

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES: Dict[str, int] = {"segmented_sums": 0}

#: ``kLanes``, ``kRows``, ``kStages``, ``kBoxRows`` and ``kBoxStages`` of
#: ``csrc/segkeyed.cu``: the columns of a warp's unit, the rows and stages
#: of its 4-byte ring, and the rows of a TMA box and the boxes of its tiled
#: ring. With them, the seams of the kernel's fold.
WARP_LANES = 32
RING_ROWS = 16
RING_STAGES = 16
BOX_ROWS = 64
BOX_STAGES = 8

#: The layouts of ``seam_layout``.
SEAM_LAYOUTS = ("empty_keys", "one_row_keys", "ring_stages", "narrow_width",
                "moment_width", "warp_cols", "odd_width", "config_width")


class KeyLayout(NamedTuple):
    """The key order of one set of rows.

    ``order`` int64 ``[n]``: the kept rows sorted by key, each key's rows
    in row order. ``offsets`` int64 ``[P + 1]``: key ``p``'s rows are
    ``order[offsets[p]:offsets[p + 1]]``. ``walk`` int32 ``[P]``: the keys
    by row count, longest first (ties by key); the kernel hands out its
    units, a warp's 32 (key, column) pairs of the ``[P, W]`` totals, in
    that order (``work_units``)."""
    order: torch.Tensor
    offsets: torch.Tensor
    walk: torch.Tensor
    P: int


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


def key_layout(keys: torch.Tensor, P: int,
               keep: Optional[torch.Tensor] = None) -> KeyLayout:
    """The ``KeyLayout`` of int32 ``keys`` ``[n]`` in ``[0, P)`` over the
    rows where the bool ``keep`` ``[n]`` is set (every row when it is
    None): two stable sorts and one ``bincount``. Raises when a key lies
    outside ``[0, P)``. Reads two numbers back, once per sweep."""
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise TypeError(f"key_layout takes int32 keys [n], got {keys.dtype} "
                        f"{tuple(keys.shape)}")
    if P < 1:
        raise ValueError(f"key_layout needs P >= 1, got {P}")
    if keep is not None and (keep.dtype != torch.bool or
                             keep.shape != keys.shape or
                             keep.device != keys.device):
        raise TypeError("key_layout takes keep as bool [n] on the keys' "
                        "device")
    k = keys.long()
    if k.numel():
        lo, hi = torch.aminmax(k)
        if int(lo) < 0 or int(hi) >= P:
            raise ValueError(f"key_layout: a key lies outside [0, {P})")
    if keep is not None:
        k = torch.where(keep, k, P)  # dropped rows sort past every key
    counts = torch.bincount(k, minlength=P + 1)[:P]
    offsets = torch.zeros(P + 1, dtype=torch.int64, device=keys.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    n_kept = int(offsets[-1])
    order = torch.sort(k, stable=True).indices[:n_kept]
    walk = torch.sort(counts, descending=True, stable=True).indices
    return KeyLayout(order.contiguous(), offsets, walk.to(torch.int32),
                     int(P))


def takes_tiles(n: int, W: int, data_ptr: int) -> bool:
    """Whether the kernel folds an ``[n, W]`` stack at ``data_ptr`` in its
    tiled TMA ring (rows of 16-byte multiples and at least one unit's 32
    columns, a 16-byte aligned base, at least one box of rows), else in
    its 4-byte ring, as ``tiled()`` of ``csrc/segkeyed.cu`` decides."""
    return (W % 4 == 0 and W >= WARP_LANES and n >= BOX_ROWS and
            data_ptr % 16 == 0)


def work_units(layout: KeyLayout, W: int, tiled: bool) -> np.ndarray:
    """The kernel's units for a width-``W`` stack, in the order it hands
    them out: ``[n_units, 32, 2]`` (key, column) per lane, ``-1`` where a
    lane idles. Tiled (``takes_tiles``): unit ``u`` is the 32-column tile
    ``u % T`` of key ``walk[u // T]``, ``T = ceil(W / 32)``. Otherwise
    unit ``u`` takes lanes ``32 u .. 32 u + 31`` of the ``[P, W]`` totals
    with their keys in walk order, lane ``f`` being column ``f % W`` of
    key ``walk[f // W]``: a unit is 32 columns of one key or reaches into
    the next, and at W < 32 it holds several keys."""
    walk = layout.walk.cpu().numpy().astype(np.int64)
    lane = np.arange(WARP_LANES)
    if tiled:
        T = -(-W // WARP_LANES)
        u = np.arange(layout.P * T)
        col = (u % T)[:, None] * WARP_LANES + lane
        key = np.broadcast_to(walk[u // T][:, None], col.shape)
        idle = col >= W
    else:
        total = layout.P * W
        f = np.arange(-(-total // WARP_LANES) * WARP_LANES).reshape(
            -1, WARP_LANES)
        idle = f >= total
        key = walk[np.minimum(f // W, layout.P - 1)]
        col = f % W
    return np.stack([np.where(idle, -1, key), np.where(idle, -1, col)], -1)


def segmented_sums_plain(values: torch.Tensor,
                         layout: KeyLayout) -> torch.Tensor:
    """The plain version: a float32 left fold over each key's contiguous
    rows, vectorised over keys, one step per position within a key. Keys
    are taken in ``walk`` order, longest first, so the keys still open at
    step ``k`` are a prefix of it."""
    n, W = values.shape
    P = layout.P
    device = values.device
    out = torch.zeros(P, W, dtype=torch.float32, device=device)
    if n == 0:
        return out
    offsets = layout.offsets.cpu().numpy()
    lens = np.diff(offsets)
    korder = layout.walk.cpu().numpy().astype(np.int64)
    lens_sorted = lens[korder]
    n_open = int(np.count_nonzero(lens_sorted))
    pos = torch.from_numpy(offsets[:-1][korder][:n_open].copy()).to(device)
    # open_at[k]: how many keys hold more than k rows.
    open_at = P - np.cumsum(np.bincount(lens, minlength=int(lens.max()) + 1))
    tot = torch.zeros(n_open, W, dtype=torch.float32, device=device)
    max_len = int(lens_sorted[0])
    for k in range(max_len):
        c = int(open_at[k])
        if c == 1:
            # One key left open: its remaining rows are contiguous, so
            # each step adds a one-row view, one at a time.
            first = int(pos[0])
            last = tot[0]
            for row in values[first:first + max_len - k].unbind():
                last.add_(row)
            break
        tot[:c] += values.index_select(0, pos[:c])
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
    """``(values [n, W] float32, keys [n] int32, P)`` as numpy arrays in
    row order: keys and widths laid over the seams of the CUDA kernel,
    for holding it to the plain version. On a 16-byte aligned base,
    ``empty_keys``, ``ring_stages`` and ``config_width`` take the
    kernel's tiled TMA ring (``takes_tiles``), the others its 4-byte ring,
    as does every layout on a base one float in. ``empty_keys``: most keys
    without rows; ``one_row_keys``: every key one row, several keys to a
    warp's unit; ``ring_stages``: key lengths one below, at and one above
    one stage, the 4-byte ring's depth in flight and its whole ring, one
    and two boxes and the tiled ring's boxes (``RING_ROWS``,
    ``RING_STAGES``, ``BOX_ROWS``, ``BOX_STAGES``); ``narrow_width``,
    ``moment_width``: the walked megasweep's widths (one config times 5
    and 3), several keys to a unit; ``warp_cols``: one column past a
    warp's; ``odd_width``,
    ``config_width``: config-stack widths (129 and 132 configs times 5),
    units reaching over key boundaries. The rows of all keys are
    interleaved at random. Values are standard normal times 10, or
    order-sensitive (``_order_values``)."""
    rng = np.random.default_rng(70 + SEAM_LAYOUTS.index(name))
    R, S, B, BS = RING_ROWS, RING_STAGES, BOX_ROWS, BOX_STAGES
    if name == "empty_keys":
        P, W = 64, 36
        lengths = [int(rng.integers(1, 40)) if p % 3 == 0 else 0
                   for p in range(P)]
    elif name == "one_row_keys":
        P, W = 300, 12
        lengths = [1] * P
    elif name == "ring_stages":
        P, W = 22, 40
        lengths = [R - 1, R, R + 1, (S - 1) * R - 1, (S - 1) * R,
                   (S - 1) * R + 1, S * R - 1, S * R, S * R + 1, B - 1, B,
                   B + 1, 2 * B - 1, 2 * B, 2 * B + 1, B * BS - 1, B * BS,
                   B * BS + 1, 2 * B * BS + 3, 1, 0, R // 2]
    elif name == "narrow_width":
        P, W = 40, 5
        lengths = list(rng.integers(0, 2 * S * R, P))
    elif name == "moment_width":
        P, W = 50, 3
        lengths = list(rng.integers(0, 3 * R, P))
    elif name == "warp_cols":
        P, W = 20, WARP_LANES + 1
        lengths = list(rng.integers(0, 3 * R, P))
    elif name == "odd_width":
        P, W = 16, 129 * 5
        lengths = list(rng.integers(0, (S + 2) * R, P))
    else:
        P, W = 12, 132 * 5
        lengths = list(rng.integers(0, (S + 2) * R, P))
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
        raise ValueError(f"segmented_sums takes values [n, W] in the "
                         f"layout's order of n = {layout.order.shape[0]} "
                         f"rows, got {tuple(values.shape)}")
    if values.device != layout.offsets.device:
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
        lib = _build.load("segkeyed")
        if ((lib.segkeyed_ring_rows(), lib.segkeyed_ring_stages(),
             lib.segkeyed_box_rows(), lib.segkeyed_box_stages()) !=
                (RING_ROWS, RING_STAGES, BOX_ROWS, BOX_STAGES)):
            raise RuntimeError("csrc/segkeyed.cu's rings differ from "
                               "RING_ROWS, RING_STAGES, BOX_ROWS or "
                               "BOX_STAGES")
        fn = lib.segkeyed_launch
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_longlong,
                                               ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def segmented_sums(values: torch.Tensor, layout: KeyLayout) -> torch.Tensor:
    """Each key's row-ordered float32 column totals, ``[P, W]``: ``values``
    float32 ``[n, W]`` contiguous, its rows in the order of ``layout``
    (``key_layout``), on the layout's device."""
    _check(values, layout)
    with costs.kernel_launch("segmented_sums", (values, layout.offsets,
                                                layout.P),
                             lambda: work(values, layout)):
        if values.device.type == "cpu":
            return segmented_sums_plain(values, layout)
        return _segmented_sums(values, layout)


def work(values: torch.Tensor, layout: KeyLayout) -> costs.Work:
    """The least work of one K5 call on these inputs, the counts of its
    bound in the cost table and in ``chip_smoke.py``: each value read
    once, the offsets and the walk read once, each total written once,
    one float32 add per element, and a key's rows one chain of dependent
    adds per column, so the longest key is the longest chain."""
    n, W = values.shape
    P = layout.P
    lens = torch.diff(layout.offsets)
    return costs.Work(ops=n * W,
                      bytes=4 * n * W + 8 * (P + 1) + 4 * P + 4 * P * W,
                      chain=int(lens.max()) if P else 0)


def _segmented_sums(values: torch.Tensor,
                    layout: KeyLayout) -> torch.Tensor:
    n, W = values.shape
    # The kernel writes every element of ``out``; ``queue`` is its unit
    # counter, zeroed on the caller's stream before the launch.
    out = torch.empty(layout.P, W, dtype=torch.float32, device=values.device)
    queue = torch.empty(1, dtype=torch.int32, device=values.device)
    with torch.cuda.device(values.device):
        err = _launcher()(values.data_ptr(), layout.offsets.data_ptr(),
                          layout.walk.data_ptr(), out.data_ptr(),
                          queue.data_ptr(), n, W, layout.P,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segkeyed launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, "segmented_sums")
    return out
