"""Device-resident counting sketch: the bucket binner, on the card.

A port of ``pipelinedp_tpu/sketch/device.py``. The sketch is a
``[depth, width]`` int32 count matrix over hashed bucket ids. Two
formulations, selected by ``SketchParams.backend``, give the same counts:

* ``"matmul"`` factors each bucket id into radix digits
  ``(hi, lo) = (b // 256, b % 256)`` and counts bin ``(hi, lo)`` as the
  contraction ``onehot(hi)^T @ onehot(lo)`` over a block of rows: two
  one-hot float32 factors and one ``torch.matmul``, the ``[width / 256,
  256]`` product reshaping to the width axis. Every product is 0 or 1 and
  every partial sum is at most the block's row count, below 2^24, so the
  float32 arithmetic (TF32 inputs of 0 and 1 included) is exact integer
  arithmetic.
* ``"xla"`` is the scatter twin: an ``index_add_`` of int32 ones.

Padding rows carry bucket id ``-1``: ``-1 // 256 == -1`` matches no
``hi`` one-hot column, and the scatter masks them explicitly.

The counts are exact integers, so any order of adds gives the same bits:
no hand kernel is due here (the JAX package's binner is XLA, not a Pallas
kernel). Chunked accumulation is exact too, so the streamed loop in
``sketch/engine.py`` can feed any batch sizing through the binner, and on
a mesh it bins each rank's slice of a chunk here and sums the ranks'
sketches (the JAX package's ``sharded_sketch_chunk_program``).
"""

from __future__ import annotations

import numpy as np
import torch

from pipelinedp_tpu_torch.obs import costs

#: Rows per padding unit: chunks pad to a multiple of it with -1 rows,
#: as the JAX package pads its one-hot row blocks.
ROW_BLOCK = 512

_LO = 256  # the radix low digit — see sketch.params.WIDTH_MULTIPLE

#: Bytes one one-hot factor of a matmul block may take. At width 2^16 a
#: block of 2^20 rows would need 1 GiB a factor; this keeps it at 64 MiB.
_FACTOR_BYTES = 64 << 20


def matmul_block_rows(width: int) -> int:
    """Rows per one-hot block of the matmul binner at ``width``: the
    largest ROW_BLOCK multiple whose widest float32 factor fits
    ``_FACTOR_BYTES``, and never past 2^24 rows, so every partial sum
    stays exact in float32."""
    widest = max(width // _LO, _LO)
    rows = _FACTOR_BYTES // (4 * widest)
    rows = max(ROW_BLOCK, rows // ROW_BLOCK * ROW_BLOCK)
    return min(rows, 1 << 24)


def counts_matmul(buckets: torch.Tensor, width: int) -> torch.Tensor:
    """[width] int32 bucket counts of one depth row via the radix one-hot
    contraction; ``buckets`` is [n] int32 padded with -1, ``width`` a
    multiple of 256."""
    w1 = width // _LO
    device = buckets.device
    iota_hi = torch.arange(w1, dtype=torch.int32, device=device)
    iota_lo = torch.arange(_LO, dtype=torch.int32, device=device)
    acc = torch.zeros(width, dtype=torch.int32, device=device)
    step = matmul_block_rows(width)
    for start in range(0, buckets.shape[0], step):
        blk = buckets[start:start + step]
        # Integer divmod first, then a 0/1 float32 factor: -1 (padding)
        # has hi == -1 and matches no iota column.
        hi = torch.div(blk, _LO, rounding_mode="floor")
        lo = torch.remainder(blk, _LO)
        oh_hi = (hi[:, None] == iota_hi[None, :]).to(torch.float32)
        oh_lo = (lo[:, None] == iota_lo[None, :]).to(torch.float32)
        part = torch.matmul(oh_hi.t(), oh_lo)  # [w1, 256], exact
        acc += part.to(torch.int32).reshape(width)
    return acc


def counts_scatter(buckets: torch.Tensor, width: int) -> torch.Tensor:
    """The scatter-add twin: int32 ones added at each bucket id, the
    padding masked."""
    ok = buckets >= 0
    idx = torch.where(ok, buckets, torch.zeros_like(buckets)).to(torch.int64)
    return torch.zeros(width, dtype=torch.int32,
                       device=buckets.device).index_add_(
                           0, idx, ok.to(torch.int32))


@costs.instrumented(phase="sketch")
def sketch_chunk(buckets: torch.Tensor, width: int,
                 backend: str) -> torch.Tensor:
    """[depth, width] int32 counts of one chunk; ``buckets`` is [depth, n]
    int32 with -1 padding, on the device that bins it."""
    fn = counts_matmul if backend == "matmul" else counts_scatter
    return torch.stack([fn(buckets[d], width)
                        for d in range(buckets.shape[0])])


def pad_chunk(buckets: np.ndarray, n_shards: int = 1) -> np.ndarray:
    """Pad a [depth, n] host chunk to a ROW_BLOCK multiple with -1 rows
    (matched by neither backend). With ``n_shards`` > 1 the padded length
    is a multiple of ``n_shards * ROW_BLOCK``, as the JAX package pads a
    chunk for its mesh."""
    depth, n = buckets.shape
    unit = ROW_BLOCK * max(1, int(n_shards))
    n_pad = max(-(-n // unit) * unit, unit)
    if n_pad == n:
        return buckets
    out = np.full((depth, n_pad), -1, dtype=np.int32)
    out[:, :n] = buckets
    return out


def accumulate_chunk(total: np.ndarray, device_counts) -> None:
    """Fold one chunk's counts into the host int64 accumulator (in
    place). Exact: integer sums associate, so any chunking lands on the
    same totals. The copy of a device tensor to the host waits for it."""
    if isinstance(device_counts, torch.Tensor):
        device_counts = device_counts.cpu().numpy()
    total += np.asarray(device_counts).astype(np.int64)
