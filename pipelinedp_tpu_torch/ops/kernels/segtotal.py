"""The per-partition-sum-bounds SUM's segment totals: a CUDA kernel and its
plain PyTorch version.

``segment_totals(values, new_seg)`` (K4) gives every row the float32 total
of its segment::

    out[i] = (((0 + values[s]) + values[s + 1]) + ...) + values[e - 1]

where ``[s, e)`` is the run of rows holding ``i`` that starts at a row with
``new_seg`` set (row 0 always starts one) and ends before the next. The
adds are float32, strictly left to right, starting from +0.0, so a run of
``-0.0`` totals +0.0. That is the order of the JAX package's
``jax.ops.segment_sum(masked, seg_ord, num_segments=n)`` on the CPU
(``jax_engine._partials``), whose scatter adds the updates one after
another in row order; the engine reads ``out`` where the reference reads
``seg_total[seg_ord]``. The released bits depend on that rounding, because
the total is clipped before it is quantized, so neither an atomic
``index_add_`` (no fixed order), nor ``cumsum`` differences, nor a
pairwise sum may stand in for it.

K4 is a port-only kernel: it replaces no Pallas body, only the XLA
scatter above. The CUDA source, its design and its bound are in
``csrc/segtotal.cu``. Dispatch is by the device of the tensors and nothing
else: a CUDA tensor launches the kernel (or raises), a CPU tensor takes the
plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch.ops.kernels import _build

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES: Dict[str, int] = {"segment_totals": 0}

#: ``kTile`` of ``csrc/segtotal.cu``: the rows of one block of its first
#: launch. At most one segment a tile goes to the second launch, so the
#: scratch holds one entry per tile.
TILE_ROWS = 2048

#: Rows a thread of the first launch holds (``kRows``), and so the rows
#: of one of its warps; and the rows after its tile a block of the first
#: launch reads (``kSpill``): a segment that runs past its tile's end and
#: ends within them is finished there, a longer one goes to the second
#: launch. With TILE_ROWS, the seams of the kernel's fold.
THREAD_ROWS = 8
WARP_ROWS = 32 * THREAD_ROWS
SPILL_ROWS = 64

#: The layouts of ``seam_layout``.
SEAM_LAYOUTS = ("thread", "warp", "tile", "tile_last_row", "two_tiles",
                "spill", "mid_length")


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


def segment_totals_plain(values: torch.Tensor,
                         new_seg: torch.Tensor) -> torch.Tensor:
    """The plain version: a float32 left fold per segment, vectorised over
    segments, one step per position within a segment. Segments are ranked
    by length, longest first, so the segments still open at step ``k``
    are a prefix of that order."""
    n = values.shape[0]
    device = values.device
    if n == 0:
        return torch.zeros(0, dtype=torch.float32, device=device)
    starts_mask = new_seg.clone()
    starts_mask[0] = True
    starts = torch.nonzero(starts_mask).squeeze(1)
    lens = torch.diff(starts, append=torch.tensor([n], device=device))
    order = torch.argsort(lens, descending=True, stable=True)
    pos = starts[order]
    lens_np = lens.cpu().numpy()
    # open_at[k]: how many segments are longer than k.
    open_at = len(lens_np) - np.cumsum(np.bincount(lens_np))
    tot = torch.zeros(len(lens_np), dtype=torch.float32, device=device)
    max_len = int(lens_np.max())
    for k in range(max_len):
        c = int(open_at[k])
        if c == 1:
            # One segment left open: its remaining rows are contiguous,
            # so each step adds a one-row view, still one row at a time.
            first = int(pos[0])
            last = tot[0]
            for row in values[first:first + max_len - k].unbind():
                last.add_(row)
            break
        tot[:c] += values.index_select(0, pos[:c])
        pos[:c] += 1
    by_segment = torch.empty_like(tot)
    by_segment[order] = tot
    seg_ord = torch.cumsum(starts_mask.to(torch.int64), 0) - 1
    return by_segment[seg_ord]


def _order_values(n: int, rng: np.random.Generator) -> np.ndarray:
    """Small values with a 1e8 and, three rows later, a -1e8 every seven
    rows: the running value keeps returning near 0, and each small value
    added while it is near 1e8 rounds away, so a total depends on where
    each add happens."""
    values = rng.choice(np.float32([1.0, 0.37, 2.5]), n)
    big = np.arange(int(rng.integers(0, 3)), n - 3, 7)
    values[big] = np.float32(1e8)
    values[big + 3] = np.float32(-1e8)
    return values


def seam_layout(name: str, order_sensitive: bool = False):
    """``(values, new_seg)`` as numpy arrays: segments laid over the seams
    of the CUDA kernel's tiled fold, for holding it to the plain version.
    ``thread``, ``warp``, ``tile``: lengths one below, at and one above
    that many rows; ``tile_last_row``: segments starting on a tile's last
    row (one ends there, one runs into the next tile); ``two_tiles``:
    segments spanning exactly two tiles, tile-aligned and not;
    ``mid_length``: 40 lengths drawn from 65-1024 rows. Values are
    standard normal times 10, or order-sensitive (``_order_values``)."""
    rng = np.random.default_rng(30 + SEAM_LAYOUTS.index(name))
    around = {"thread": THREAD_ROWS, "warp": WARP_ROWS, "tile": TILE_ROWS}
    if name in around:
        r = around[name]
        lengths = [r - 1, r, r + 1] * 4 + [1, r + 1, r - 1, r]
    elif name == "tile_last_row":
        lengths = [TILE_ROWS - 1, 1, TILE_ROWS - 1, TILE_ROWS + 1,
                   TILE_ROWS - 1, 5, 40]
    elif name == "two_tiles":
        lengths = [TILE_ROWS, 2 * TILE_ROWS, TILE_ROWS - 3, 2 * TILE_ROWS,
                   10]
    elif name == "spill":
        lengths, pos = [], 0
        for past in (SPILL_ROWS - 1, SPILL_ROWS, SPILL_ROWS + 1) * 2:
            fill = (pos // TILE_ROWS + 1) * TILE_ROWS - 10 - pos
            lengths += [fill, 10 + past]
            pos += fill + 10 + past
        lengths.append(7)
    else:
        lengths = list(rng.integers(65, 1025, 40))
    n = int(np.sum(lengths))
    if order_sensitive:
        values = _order_values(n, rng)
    else:
        values = (rng.standard_normal(n) * 10).astype(np.float32)
    new_seg = np.zeros(n, bool)
    new_seg[np.cumsum([0] + lengths[:-1])] = True
    return values, new_seg


def _check(values: torch.Tensor, new_seg: torch.Tensor) -> None:
    if values.dtype != torch.float32:
        raise TypeError(f"segment_totals takes float32 values, got "
                        f"{values.dtype}")
    if new_seg.dtype != torch.bool:
        raise TypeError(f"segment_totals takes bool new_seg, got "
                        f"{new_seg.dtype}")
    if values.dim() != 1 or new_seg.shape != values.shape:
        raise ValueError(f"segment_totals takes values and new_seg [N], got "
                         f"{tuple(values.shape)} and {tuple(new_seg.shape)}")
    if new_seg.device != values.device:
        raise ValueError("segment_totals takes tensors on one device")
    if not (values.is_contiguous() and new_seg.is_contiguous()):
        raise ValueError("segment_totals takes contiguous tensors")
    if values.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_totals runs on cuda or cpu, not "
                         f"{values.device}")


_LAUNCH = []


def _launcher():
    """``segtotal_launch`` of the built ``csrc/segtotal.cu``, loaded once:
    the call per launch is then a ctypes call and nothing more."""
    if not _LAUNCH:
        lib = _build.load("segtotal")
        lib.segtotal_tile_rows.restype = ctypes.c_int
        if lib.segtotal_tile_rows() != TILE_ROWS:
            raise RuntimeError("csrc/segtotal.cu's tile differs from "
                               "TILE_ROWS")
        fn = lib.segtotal_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def segment_totals(values: torch.Tensor,
                   new_seg: torch.Tensor) -> torch.Tensor:
    """Each row's float32 segment total, ``[N]``: ``values`` float32
    ``[N]``, ``new_seg`` bool ``[N]`` (set on the first row of each
    segment), both contiguous on one device."""
    _check(values, new_seg)
    with costs.kernel_launch("segment_totals", (values, new_seg),
                             lambda: work(values, new_seg)):
        if values.device.type == "cpu":
            return segment_totals_plain(values, new_seg)
        return _segment_totals(values, new_seg)


def work(values: torch.Tensor, new_seg: torch.Tensor) -> costs.Work:
    """The least work of one K4 call on these inputs, the counts of its
    bound in the cost table and in ``chip_smoke.py``: each value and flag
    read once, each total written once, one float32 add per row, and
    the adds of a segment one chain of dependent adds, so the longest
    segment is the longest chain."""
    n = values.shape[0]
    if n == 0:
        return costs.Work(ops=0, bytes=0)
    starts = new_seg.clone()
    starts[0] = True
    heads = torch.nonzero(starts).squeeze(1)
    lens = torch.diff(heads, append=heads.new_tensor([n]))
    return costs.Work(ops=n, bytes=9 * n, chain=int(lens.max()))


def _segment_totals(values: torch.Tensor,
                    new_seg: torch.Tensor) -> torch.Tensor:
    n = values.shape[0]
    # The kernel reads values in 16-byte and new_seg in 8-byte pieces; an
    # offset view is copied to fresh storage (the caching allocator aligns
    # every block) before the launch.
    if values.data_ptr() % 16:
        values = values.clone()
    if new_seg.data_ptr() % 8:
        new_seg = new_seg.clone()
    device = values.device
    tiles = (n + TILE_ROWS - 1) // TILE_ROWS
    # One allocation: the totals, then in whole int64 words the scratch:
    # each tile's first start, the starts of the segments the second
    # launch folds, and their count (an int32, which the launch zeroes).
    out_words = (n + 1) // 2
    buf = torch.empty(out_words + 2 * tiles + 1, dtype=torch.int64,
                      device=device)
    out = buf.view(torch.float32)[:n]
    with torch.cuda.device(device):
        err = _launcher()(values.data_ptr(), new_seg.data_ptr(),
                          out.data_ptr(), out.data_ptr() + 8 * out_words, n,
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segtotal launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, "segment_totals")
    return out
