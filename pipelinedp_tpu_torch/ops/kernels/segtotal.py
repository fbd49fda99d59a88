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

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES: Dict[str, int] = {"segment_totals": 0}

#: ``kShort`` of ``csrc/segtotal.cu``: the longest segment its first
#: launch folds; longer ones go to a list for a warp each.
SHORT_ROWS = 64


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def segment_totals(values: torch.Tensor,
                   new_seg: torch.Tensor) -> torch.Tensor:
    """Each row's float32 segment total, ``[N]``: ``values`` float32
    ``[N]``, ``new_seg`` bool ``[N]`` (set on the first row of each
    segment), both contiguous on one device."""
    _check(values, new_seg)
    if values.device.type == "cpu":
        return segment_totals_plain(values, new_seg)
    from pipelinedp_tpu_torch.ops.kernels import _build
    fn = _build.load("segtotal").segtotal_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n = values.shape[0]
    # The kernel's cp.async copies read 16-byte pieces of values and
    # 8-byte pieces of new_seg; an offset view is copied to fresh storage
    # (the caching allocator aligns every block) before the launch.
    if values.data_ptr() % 16:
        values = values.clone()
    if new_seg.data_ptr() % 8:
        new_seg = new_seg.clone()
    with torch.cuda.device(values.device):
        out = torch.empty(n, dtype=torch.float32, device=values.device)
        # The starts of segments longer than SHORT_ROWS, and their count.
        long_starts = torch.empty(n // SHORT_ROWS + 1, dtype=torch.int64,
                                  device=values.device)
        n_long = torch.zeros(1, dtype=torch.int32, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), new_seg.data_ptr(), out.data_ptr(),
                 long_starts.data_ptr(), n_long.data_ptr(), n, stream)
    if err != 0:
        raise RuntimeError(f"segtotal launch failed: CUDA error {err}")
    LAUNCHES["segment_totals"] += 1
    return out
