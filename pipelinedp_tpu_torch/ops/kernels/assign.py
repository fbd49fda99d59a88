"""The stream's batch assignment: a CUDA kernel and its plain version.

A streamed table is cut into batches, and on a mesh each batch into one
cell per rank, by hashes of the privacy ids, so that every unit's rows
land in one cell (``streaming._batch_assignment``). ``group_by_cell``
(K7) gives, from the int32 ids ``pid``,

- ``order``, int32 ``[N]``: the row indices grouped by cell, cells
  ascending and rows in input order within a cell;
- ``counts``, int64 ``[n_batches * n_dev]``: the rows of each cell,

where row i's cell is ``batch * n_dev + fmix32(uint32(pid)) % n_dev``
(the shard hash of ``parallel/sharded.py``, with ``n_dev > 1``) and
``batch = (uint64(fmix32(uint32(pid) ^ seed)) * n_batches) >> 32``. A
stable grouping is unique, so K7 gives the host path's numpy bit for bit.

The plain version is that host path itself (``ingest/assign.py``'s
``cell_of_rows`` and ``group_rows_by_cell``) on a CPU tensor's array, so
the hash lives once in numpy and once in CUDA. K7 is a port-only kernel:
the JAX package assigns on the host, in numpy. The CUDA source, its
design and its bound are in ``csrc/assign.cu``. Dispatch is by the
device of the ids and nothing else: a CUDA tensor launches the kernel
(or raises), a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch.ingest import assign as host_assign
from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch.ops.kernels import _build

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES: Dict[str, int] = {"group_by_cell": 0}

#: ``kMaxCells`` of ``csrc/assign.cu``: the largest cell space K7 takes
#: (its warps' counters in shared memory). The stream keeps the host path
#: above it.
MAX_CELLS = 4096

#: The most rows K7 takes: its slots and table entries are int32. The
#: stream keeps the host path above it.
MAX_ROWS = (1 << 31) - 1

#: The rows a warp counts and scatters at the stream's few cells; a larger
#: cell space takes longer segments, so that the count table holds at
#: most about ``TABLE_ENTRIES`` entries.
SEGMENT_ROWS = 2048
TABLE_ENTRIES = 1 << 22


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


def _check(pid: torch.Tensor, n_batches: int, n_dev: int) -> int:
    if pid.dtype != torch.int32 or pid.dim() != 1:
        raise TypeError(f"group_by_cell takes int32 ids [N], got "
                        f"{pid.dtype} {tuple(pid.shape)}")
    if pid.device.type not in ("cpu", "cuda"):
        raise ValueError(f"group_by_cell runs on cuda or cpu, not "
                         f"{pid.device}")
    n_batches, n_dev = int(n_batches), int(n_dev)
    if n_batches < 1 or n_dev < 1 or n_batches * n_dev > MAX_CELLS:
        raise ValueError(
            f"group_by_cell takes 1 to {MAX_CELLS} cells, got "
            f"{n_batches} batches x {n_dev} ranks")
    return n_batches * n_dev


def group_by_cell_plain(pid: torch.Tensor, n_batches: int, n_dev: int,
                        seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``group_by_cell`` for a CPU tensor: the
    stream's host path in numpy, its cells and their stable grouping."""
    n_cells = _check(pid, n_batches, n_dev)
    order, counts = host_assign.group_rows_by_cell(
        host_assign.cell_of_rows(pid.numpy(), n_batches, n_dev, seed),
        n_cells)
    return (torch.from_numpy(order.astype(np.int32)),
            torch.from_numpy(counts.astype(np.int64, copy=False)))


def segment_rows(n: int, n_cells: int) -> int:
    """The rows of one warp's segment: ``SEGMENT_ROWS``, or more, in
    multiples of 128 (a warp's four rounds), where the table of
    ``n_cells`` counts a segment would pass ``TABLE_ENTRIES``."""
    need = -(-n * n_cells // TABLE_ENTRIES)
    return max(SEGMENT_ROWS, -(-need // 128) * 128)


def work(pid: torch.Tensor, n_cells: int) -> costs.Work:
    """The least work of one K7 call, the counts of its bound in the cost
    table and in ``chip_smoke.py``: each id read once and each row's
    index written once (8 bytes a row), the counts written once, one hash
    a row."""
    n = pid.shape[0]
    return costs.Work(ops=n, bytes=8 * n + 8 * n_cells)


_LAUNCH = []


def _launcher():
    """``assign_launch`` of the built ``csrc/assign.cu``, loaded once."""
    if not _LAUNCH:
        lib = _build.load("assign")
        lib.assign_max_cells.restype = ctypes.c_int
        if lib.assign_max_cells() != MAX_CELLS:
            raise RuntimeError("csrc/assign.cu's cell limit differs from "
                               "MAX_CELLS")
        fn = lib.assign_launch
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] +
                       [ctypes.c_uint] * 3 + [ctypes.c_longlong] +
                       [ctypes.c_void_p] * 4)
        fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def load() -> None:
    """Builds (or loads) K7 now, so that no later call pays for it."""
    _launcher()


def group_by_cell(pid: torch.Tensor, n_batches: int, n_dev: int,
                  seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(order, counts)`` on the device of ``pid``: the row indices
    grouped by cell, stably (int32 ``[N]``), and the rows of each cell
    (int64 ``[n_batches * n_dev]``). ``pid``: int32 ``[N]``, on a card
    at most ``MAX_ROWS``."""
    n_cells = _check(pid, n_batches, n_dev)
    with costs.kernel_launch("group_by_cell", (pid,),
                             lambda: work(pid, n_cells)):
        if pid.device.type == "cpu":
            return group_by_cell_plain(pid, n_batches, n_dev, seed)
        n = pid.shape[0]
        if n > MAX_ROWS:
            raise ValueError(f"K7 takes at most {MAX_ROWS} rows, got {n}")
        pid = pid.contiguous()
        seg = segment_rows(n, n_cells)
        table = torch.empty(n_cells * (-(-n // seg)), dtype=torch.int32,
                            device=pid.device)
        order = torch.empty(n, dtype=torch.int32, device=pid.device)
        counts = torch.empty(n_cells, dtype=torch.int64, device=pid.device)
        with torch.cuda.device(pid.device):
            err = _launcher()(pid.data_ptr(), n, int(n_batches), int(n_dev),
                              int(seed) & 0xFFFFFFFF, seg, table.data_ptr(),
                              order.data_ptr(), counts.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"assign launch failed: CUDA error {err}")
        _build.count_launch(LAUNCHES, "group_by_cell")
        return order, counts
