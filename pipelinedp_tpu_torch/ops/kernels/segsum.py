"""The lane segment sum of ``_reduce_per_pk``: a CUDA kernel and its plain
PyTorch version.

``segment_sum_lanes(cols, pk, P)`` reduces the ``[N, C]`` int32 stack of
count, marker and fixed-point value lanes per partition into ``[P, C]``
int32. It replaces the Pallas kernel
``pipelinedp_tpu/ops/kernels/segsum.py::segment_sum_lanes``; the CUDA
source, its design and its bound on the H100 are in
``csrc/segsum_lanes.cu``.

Dispatch is by the device of the tensors and nothing else: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes
``segment_sum_lanes_plain``. There is no envelope and no fallback: the
kernel takes any ``P`` and any ``C >= 1``.
"""

from __future__ import annotations

import ctypes

import torch

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


def segment_sum_lanes_plain(cols: torch.Tensor, pk: torch.Tensor,
                            P: int) -> torch.Tensor:
    """The plain version: an int64 ``index_add_`` cast back to int32."""
    out = torch.zeros(P, cols.shape[1], dtype=torch.int64,
                      device=cols.device)
    return out.index_add_(0, pk.long(), cols.long()).to(torch.int32)


def _check(cols: torch.Tensor, pk: torch.Tensor, P: int) -> None:
    if cols.dtype != torch.int32 or pk.dtype != torch.int32:
        raise TypeError(f"segment_sum_lanes takes int32 cols and pk, got "
                        f"{cols.dtype} and {pk.dtype}")
    if cols.dim() != 2 or pk.dim() != 1 or cols.shape[0] != pk.shape[0]:
        raise ValueError(f"segment_sum_lanes takes cols [N, C] and pk [N], "
                         f"got {tuple(cols.shape)} and {tuple(pk.shape)}")
    if cols.shape[1] < 1 or int(P) < 1:
        raise ValueError(f"segment_sum_lanes needs C >= 1 and P >= 1, got "
                         f"C={cols.shape[1]}, P={P}")
    if cols.device != pk.device:
        raise ValueError(f"cols on {cols.device} but pk on {pk.device}")
    if not (cols.is_contiguous() and pk.is_contiguous()):
        raise ValueError("segment_sum_lanes takes contiguous tensors")


def segment_sum_lanes(cols: torch.Tensor, pk: torch.Tensor,
                      P: int) -> torch.Tensor:
    """``out[p, c] = sum_{r: pk[r] == p} cols[r, c]`` in int32: ``cols``
    int32 ``[N, C]`` contiguous, ``pk`` int32 ``[N]`` in ``[0, P)``."""
    _check(cols, pk, P)
    if cols.device.type == "cpu":
        return segment_sum_lanes_plain(cols, pk, P)
    if cols.device.type != "cuda":
        raise ValueError(f"segment_sum_lanes runs on cuda or cpu, not "
                         f"{cols.device}")
    from pipelinedp_tpu_torch.ops.kernels import _build
    fn = _build.load("segsum_lanes").segsum_lanes_launch
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
        raise RuntimeError(f"segsum_lanes launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
