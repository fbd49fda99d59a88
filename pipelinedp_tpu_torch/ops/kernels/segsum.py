"""The segment sums of ``_reduce_per_pk``: CUDA kernels and their plain
PyTorch version.

``segment_sum_lanes(cols, pk, P)`` (K1) reduces the ``[N, C]`` int32 stack
of count, marker and fixed-point value lanes per partition into ``[P, C]``
int32. It replaces the Pallas kernel
``pipelinedp_tpu/ops/kernels/segsum.py::segment_sum_lanes``; the CUDA
source, its design and its bound on the H100 are in
``csrc/segsum_lanes.cu``.

``segment_sum_wide(cols, pk, P)`` (K2) reduces VECTOR_SUM's lane-major
``[N, n_lanes * D]`` fixed-point coordinate lanes into ``[P, n_lanes * D]``
int32. It replaces ``pipelinedp_tpu/ops/kernels/segsum.py::
segment_sum_wide``; its source is ``csrc/segsum_wide.cu``. Its design
follows ``wide_tile(W, P)``, the rule that ``csrc/segsum_wide.cu`` states
and answers: a per-block shared-memory accumulator of ``tile`` columns
while one fits, else K1's kernels. The TPU kernel's D tile (the
``segsum_wide_d_block`` knob) is a VMEM hint with no counterpart here.

Both compute the same function, and rows whose key lies outside
``[0, P)`` are dropped. Dispatch is by the device of the tensors and
nothing else: a CUDA tensor launches a kernel (or raises), a CPU tensor
takes the plain version. There is no envelope and no fallback: both
kernels take any ``P >= 1``, any width ``>= 1`` and any 4-byte-aligned
view.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch.ops.kernels import _build

#: Calls of each wrapper that launched on the card since the last reset,
#: one per call whatever the kernels it launched: K1's call is its
#: sampling launch and its main one, and past the shared-memory limit
#: ``segment_sum_wide`` launches K1's two kernels. The CPU path never
#: counts.
LAUNCHES: Dict[str, int] = {"segment_sum_lanes": 0, "segment_sum_wide": 0}

#: ``kHot`` of ``csrc/segsum_lanes.cu``: the words of K1's hot-key
#: scratch.
HOT_WORDS = 64

_INT32_MAX = (1 << 31) - 1
#: The widest row the kernels take: their offsets within a tile of rows
#: are 32-bit.
MAX_COLS = 1 << 28


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


def wide_tile(W: int, P: int) -> int:
    """The column tile of K2's shared-memory design for ``[N, W]`` lanes
    over ``P`` partitions, or 0 where ``segment_sum_wide`` launches K1's
    kernels: ``segsum_wide_tile`` of ``csrc/segsum_wide.cu``, which holds
    the rule (this builds the library on first use)."""
    fn = _build.load("segsum_wide").segsum_wide_tile
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(int(W), int(P))


def hot_slots(C: int) -> int:
    """Hot-key slots of K1's shared-memory accumulator for ``C`` lanes:
    ``segsum_lanes_hot_slots`` of ``csrc/segsum_lanes.cu``, which holds
    the rule (this builds the library on first use)."""
    fn = _build.load("segsum_lanes").segsum_lanes_hot_slots
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(int(C))


def segment_sum_lanes_plain(cols: torch.Tensor, pk: torch.Tensor,
                            P: int) -> torch.Tensor:
    """The plain version of both kernels: an int64 ``index_add_`` cast
    back to int32; rows with ``pk`` outside ``[0, P)`` land in a spare
    row that is cut off."""
    idx = pk.long()
    idx = torch.where((idx >= 0) & (idx < P), idx, P)
    out = torch.zeros(P + 1, cols.shape[1], dtype=torch.int64,
                      device=cols.device)
    return out.index_add_(0, idx, cols.long())[:P].to(torch.int32)


segment_sum_wide_plain = segment_sum_lanes_plain


def _check(name: str, cols: torch.Tensor, pk: torch.Tensor, P: int) -> None:
    if cols.dtype != torch.int32 or pk.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 cols and pk, got "
                        f"{cols.dtype} and {pk.dtype}")
    if cols.dim() != 2 or pk.dim() != 1 or cols.shape[0] != pk.shape[0]:
        raise ValueError(f"{name} takes cols [N, C] and pk [N], "
                         f"got {tuple(cols.shape)} and {tuple(pk.shape)}")
    if not 1 <= cols.shape[1] <= MAX_COLS or not 1 <= int(P) <= _INT32_MAX:
        raise ValueError(f"{name} needs 1 <= C <= 2^28 and 1 <= P < 2^31, "
                         f"got C={cols.shape[1]}, P={P}")
    if cols.device != pk.device:
        raise ValueError(f"cols on {cols.device} but pk on {pk.device}")
    if not (cols.is_contiguous() and pk.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {cols.device}")


def _launch(name: str, source: str, symbol: str, cols: torch.Tensor,
            pk: torch.Tensor, P: int, hot_words: int = 0) -> torch.Tensor:
    """Launches ``symbol`` of ``csrc/<source>.cu`` on PyTorch's current
    stream and counts the call under ``name``; ``hot_words`` > 0 hands
    it a scratch of that many int32 words before the stream."""
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * (2 if hot_words else 1))
    fn.restype = ctypes.c_int
    n, C = cols.shape
    # The launch zeroes out and runs asynchronously on PyTorch's current
    # stream, so the caching allocator hands the inputs' and the scratch's
    # memory only to work queued after it, even when they are dropped
    # right away.
    with torch.cuda.device(cols.device):
        out = torch.empty(int(P), C, dtype=torch.int32, device=cols.device)
        args = [cols.data_ptr(), pk.data_ptr(), out.data_ptr(), n, C, int(P)]
        if hot_words:
            hot = torch.empty(hot_words, dtype=torch.int32,
                              device=cols.device)
            args.append(hot.data_ptr())
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{source} launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, name)
    return out


def work(cols: torch.Tensor, pk: torch.Tensor, P: int) -> costs.Work:
    """The least work of one K1 or K2 call on these inputs, the counts
    of its bound in the cost table and in ``chip_smoke.py``. Every
    element of ``cols`` must be read to know it is zero, but the answer
    needs ``pk`` only at rows with a nonzero lane: the 32-byte sectors of
    ``pk`` those rows touch, plus the sums written once. Operations: one
    int32 add per nonzero element."""
    n, C = cols.shape
    nonzero = cols != 0
    rows = nonzero.any(dim=1).nonzero().squeeze(1)
    sectors = int(torch.unique((pk.data_ptr() + 4 * rows) // 32).numel())
    return costs.Work(ops=int(nonzero.sum()),
                      bytes=4 * n * C + 32 * sectors + 4 * int(P) * C)


def segment_sum_lanes(cols: torch.Tensor, pk: torch.Tensor,
                      P: int) -> torch.Tensor:
    """``out[p, c] = sum_{r: pk[r] == p} cols[r, c]`` in int32: ``cols``
    int32 ``[N, C]`` contiguous, ``pk`` int32 ``[N]``; rows with ``pk``
    outside ``[0, P)`` are dropped."""
    _check("segment_sum_lanes", cols, pk, P)
    with costs.kernel_launch("segment_sum_lanes", (cols, pk, P),
                             lambda: work(cols, pk, P)):
        if cols.device.type == "cpu":
            return segment_sum_lanes_plain(cols, pk, P)
        return _launch("segment_sum_lanes", "segsum_lanes",
                       "segsum_lanes_launch", cols, pk, P, HOT_WORDS)


def segment_sum_wide(cols: torch.Tensor, pk: torch.Tensor,
                     P: int) -> torch.Tensor:
    """``out[p, j] = sum_{r: pk[r] == p} cols[r, j]`` in int32: ``cols``
    int32 ``[N, W]`` contiguous (the lane-major vector lanes), ``pk`` int32
    ``[N]``; rows with ``pk`` outside ``[0, P)`` are dropped. On the card
    the shared-memory kernel runs while ``wide_tile(W, P)`` > 0, K1's
    kernels otherwise; either counts one launch here."""
    _check("segment_sum_wide", cols, pk, P)
    with costs.kernel_launch("segment_sum_wide", (cols, pk, P),
                             lambda: work(cols, pk, P)):
        if cols.device.type == "cpu":
            return segment_sum_wide_plain(cols, pk, P)
        if wide_tile(cols.shape[1], int(P)):
            return _launch("segment_sum_wide", "segsum_wide",
                           "segsum_wide_launch", cols, pk, P)
        return _launch("segment_sum_wide", "segsum_lanes",
                       "segsum_lanes_launch", cols, pk, P, HOT_WORDS)
