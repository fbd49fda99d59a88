"""The segment sums of ``_reduce_per_pk``: CUDA kernels and their plain
PyTorch versions.

``segment_sum_lanes(cols, pk, P)`` (K1) reduces the ``[N, C]`` int32 stack
of count, marker and fixed-point value lanes per partition into ``[P, C]``
int32. It replaces the Pallas kernel
``pipelinedp_tpu/ops/kernels/segsum.py::segment_sum_lanes``; the CUDA
source, its design and its bound on the H100 are in
``csrc/segsum_lanes.cu``.

``segment_sum_wide(cols, pk, P)`` (K2) reduces VECTOR_SUM's lane-major
``[N, n_lanes * D]`` fixed-point coordinate lanes into ``[P, n_lanes * D]``
int32. It replaces ``pipelinedp_tpu/ops/kernels/segsum.py::
segment_sum_wide``; its source is ``csrc/segsum_wide.cu``. The TPU
kernel's D tile (the ``segsum_wide_d_block`` knob) is a VMEM hint with no
counterpart here: the CUDA kernel picks its own tiling.

Dispatch is by the device of the tensors and nothing else: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
There is no envelope and no fallback: both kernels take any ``P >= 1``
and any width ``>= 1``.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

#: Kernel launches per kernel since the last reset (the CPU path never
#: counts).
LAUNCHES: Dict[str, int] = {"segment_sum_lanes": 0, "segment_sum_wide": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def segment_sum_lanes_plain(cols: torch.Tensor, pk: torch.Tensor,
                            P: int) -> torch.Tensor:
    """The plain version: an int64 ``index_add_`` cast back to int32."""
    out = torch.zeros(P, cols.shape[1], dtype=torch.int64,
                      device=cols.device)
    return out.index_add_(0, pk.long(), cols.long()).to(torch.int32)


def segment_sum_wide_plain(cols: torch.Tensor, pk: torch.Tensor,
                           P: int) -> torch.Tensor:
    """The plain version: an int64 ``index_add_`` cast back to int32; rows
    with ``pk`` outside ``[0, P)`` land in a spare row that is cut off."""
    idx = pk.long()
    idx = torch.where((idx >= 0) & (idx < P), idx, P)
    out = torch.zeros(P + 1, cols.shape[1], dtype=torch.int64,
                      device=cols.device)
    return out.index_add_(0, idx, cols.long())[:P].to(torch.int32)


def _check(name: str, cols: torch.Tensor, pk: torch.Tensor, P: int) -> None:
    if cols.dtype != torch.int32 or pk.dtype != torch.int32:
        raise TypeError(f"{name} takes int32 cols and pk, got "
                        f"{cols.dtype} and {pk.dtype}")
    if cols.dim() != 2 or pk.dim() != 1 or cols.shape[0] != pk.shape[0]:
        raise ValueError(f"{name} takes cols [N, C] and pk [N], "
                         f"got {tuple(cols.shape)} and {tuple(pk.shape)}")
    if cols.shape[1] < 1 or int(P) < 1:
        raise ValueError(f"{name} needs C >= 1 and P >= 1, got "
                         f"C={cols.shape[1]}, P={P}")
    if cols.device != pk.device:
        raise ValueError(f"cols on {cols.device} but pk on {pk.device}")
    if not (cols.is_contiguous() and pk.is_contiguous()):
        raise ValueError(f"{name} takes contiguous tensors")
    if cols.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {cols.device}")


def _launch(name: str, source: str, symbol: str, cols: torch.Tensor,
            pk: torch.Tensor, P: int) -> torch.Tensor:
    """Launches ``symbol`` of ``csrc/<source>.cu`` on PyTorch's current
    stream and counts the launch under ``name``."""
    from pipelinedp_tpu_torch.ops.kernels import _build
    fn = getattr(_build.load(source), symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    n, C = cols.shape
    # The launch is asynchronous on PyTorch's current stream, so the
    # caching allocator hands the inputs' memory only to work queued after
    # the kernel, even when the caller drops them right away.
    with torch.cuda.device(cols.device):
        out = torch.zeros(int(P), C, dtype=torch.int32, device=cols.device)
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        err = fn(cols.data_ptr(), pk.data_ptr(), out.data_ptr(), n, C,
                 int(P), stream)
    if err != 0:
        raise RuntimeError(f"{source} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    return out


def segment_sum_lanes(cols: torch.Tensor, pk: torch.Tensor,
                      P: int) -> torch.Tensor:
    """``out[p, c] = sum_{r: pk[r] == p} cols[r, c]`` in int32: ``cols``
    int32 ``[N, C]`` contiguous, ``pk`` int32 ``[N]`` in ``[0, P)``."""
    _check("segment_sum_lanes", cols, pk, P)
    if cols.device.type == "cpu":
        return segment_sum_lanes_plain(cols, pk, P)
    return _launch("segment_sum_lanes", "segsum_lanes", "segsum_lanes_launch",
                   cols, pk, P)


def segment_sum_wide(cols: torch.Tensor, pk: torch.Tensor,
                     P: int) -> torch.Tensor:
    """``out[p, j] = sum_{r: pk[r] == p} cols[r, j]`` in int32: ``cols``
    int32 ``[N, W]`` contiguous (the lane-major vector lanes), ``pk`` int32
    ``[N]``; rows with ``pk`` outside ``[0, P)`` are dropped."""
    _check("segment_sum_wide", cols, pk, P)
    if cols.device.type == "cpu":
        return segment_sum_wide_plain(cols, pk, P)
    return _launch("segment_sum_wide", "segsum_wide", "segsum_wide_launch",
                   cols, pk, P)
