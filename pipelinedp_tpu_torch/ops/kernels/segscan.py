"""The run scans of the bounding and the sweep: a CUDA kernel and its plain
PyTorch version.

Over rows sorted so that equal keys are contiguous, ``new_run`` marks the
first row of each run and ``new_group`` the first row of each group
(every group start is a run start; row 0 starts both). ``run_scan`` (K6,
the generic epilogue) gives every row

- ``run_start``: the index of its run's first row, the last marked row at
  or before it (``rank_in_run = idx - run_start``);
- ``run_ord``, given ``new_group``: the ordinal of its run within its
  group, the run starts since the group's start, less one.

``bound_linf_l0`` (K6, the bounding epilogue) gives the Linf/L0 sample of
``torch_engine._bound_sorted`` from the same scan, with ``new_seg`` as the
runs and ``new_pid`` as the groups: ``keep_row = (rank_in_run < linf_cap)
& (run_ord < l0)`` and ``seg_marker = new_seg & (run_ord < l0)``.

The plain versions are the JAX package's ``jax.lax.cummax`` arithmetic of
``pipelinedp_tpu/ops/segment.py`` (``run_starts``,
``run_ordinal_in_group``): a running maximum of the marked indices, and
cumulative-sum differences. Every result is exact integer work, the same
bits on either path.

K6 is a port-only kernel: it replaces no Pallas body, only ``cummax``,
which PyTorch's CUDA scan runs over a 1-D tensor in one block. The CUDA
source, its design and its bound are in ``csrc/segscan.cu``. Dispatch is by
the device of the flags and nothing else: a CUDA tensor launches the
kernel (or raises), a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch.ops.kernels import _build

#: Kernel launches since the last reset, one key per epilogue (the CPU
#: path never counts).
LAUNCHES: Dict[str, int] = {"run_scan": 0, "bound_linf_l0": 0}

#: ``kTile`` of ``csrc/segscan.cu``: the rows of one block, and so the
#: seams the carries cross; ``kRows``, the rows of one thread, and so 32
#: of them the rows of one warp.
TILE_ROWS = 4096
THREAD_ROWS = 16
WARP_ROWS = 32 * THREAD_ROWS

#: The layouts of ``seam_layout``.
SEAM_LAYOUTS = ("thread", "warp", "run_across_tile", "run_across_tiles",
                "group_across_tiles", "tile_last_row", "every_row",
                "only_row0")


def reset_launches() -> None:
    _build.reset_counts(LAUNCHES)


def run_scan_plain(new_run: torch.Tensor,
                   new_group: Optional[torch.Tensor] = None,
                   starts: bool = True
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain version of ``run_scan``: ``torch.cummax`` over the marked
    indices, and over the run ordinals at the group starts."""
    run_start = run_ord = None
    if starts:
        idx = torch.arange(new_run.shape[0], device=new_run.device)
        run_start = torch.cummax(torch.where(new_run, idx, 0), dim=0).values
    if new_group is not None:
        ordinal = torch.cumsum(new_run.to(torch.int64), dim=0) - 1
        group_first_run = torch.cummax(torch.where(new_group, ordinal, 0),
                                       dim=0).values
        run_ord = ordinal - group_first_run
    return run_start, run_ord


def bound_linf_l0_plain(new_seg: torch.Tensor, new_pid: torch.Tensor,
                        linf_cap: int, l0: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of ``bound_linf_l0``: ``jax_engine._partials``'
    Linf/L0 arithmetic over ``run_scan_plain``."""
    run_start, run_ord = run_scan_plain(new_seg, new_pid)
    idx = torch.arange(new_seg.shape[0], device=new_seg.device)
    keep_l0 = run_ord < l0
    return (idx - run_start < linf_cap) & keep_l0, new_seg & keep_l0


def seam_layout(name: str) -> Tuple[np.ndarray, np.ndarray]:
    """``(new_run, new_group)`` as numpy bool arrays: runs and groups laid
    over the seams of the CUDA kernel's carries, for holding it to the
    plain version. ``thread``, ``warp``: run lengths one below, at and one
    above that many rows; ``run_across_tile``: runs that cross one tile's
    end; ``run_across_tiles``: a run over several whole tiles;
    ``group_across_tiles``: one group of short runs over several tiles;
    ``tile_last_row``: runs that end on a tile's last row, and one that
    starts there; ``every_row``: every row a run, in random groups;
    ``only_row0``: one run and one group over several tiles."""
    # lint: disable=rng-purity(fixed-seed seam-layout test data, never a DP draw)
    rng = np.random.default_rng(60 + SEAM_LAYOUTS.index(name))
    t = TILE_ROWS
    around = {"thread": THREAD_ROWS, "warp": WARP_ROWS}
    if name in around:
        r = around[name]
        lengths = [r - 1, r, r + 1] * 12 + [1, r + 1, r - 1, r]
    elif name == "run_across_tile":
        lengths = [t - 5, 10, t - 10, 3, 2 * t + 7, 40]
    elif name == "run_across_tiles":
        lengths = [100, 5 * t + 17, 3, 2 * t, 9]
    elif name == "group_across_tiles":
        lengths = list(rng.integers(1, 9, 3 * t // 4))
    elif name == "tile_last_row":
        lengths = [t - 1, 1, t - 1, t + 1, t - 1, 5, 40]
    elif name == "every_row":
        lengths = [1] * (2 * t + 33)
    else:
        lengths = [3 * t + 11]
    n = int(np.sum(lengths))
    new_run = np.zeros(n, bool)
    new_run[np.cumsum([0] + lengths[:-1])] = True
    if name == "group_across_tiles":
        # Group starts only near the table's two ends, so one group spans
        # every tile between.
        starts = np.flatnonzero(new_run)
        new_group = np.zeros(n, bool)
        new_group[starts[[0, 3, 5, len(starts) - 4]]] = True
    elif name == "only_row0":
        new_group = new_run.copy()
    else:
        new_group = new_run & (rng.random(n) < 0.4)
    new_group[0] = True
    return new_run, new_group


def _check(new_run: torch.Tensor, new_group: Optional[torch.Tensor],
           name: str) -> None:
    for flags in (new_run,) if new_group is None else (new_run, new_group):
        if flags.dtype != torch.bool:
            raise TypeError(f"{name} takes bool flags, got {flags.dtype}")
        if flags.dim() != 1 or flags.shape != new_run.shape:
            raise ValueError(f"{name} takes flags [N] of one length, got "
                             f"{tuple(flags.shape)}")
        if flags.device != new_run.device:
            raise ValueError(f"{name} takes flags on one device")
    if new_run.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not "
                         f"{new_run.device}")


def work(new_run: torch.Tensor, new_group: Optional[torch.Tensor],
         out_bytes_per_row: int) -> costs.Work:
    """The least work of one K6 call, the counts of its bound in the cost
    table and in ``chip_smoke.py``: each flag read once and each output
    written once, one carry step a row."""
    n = new_run.shape[0]
    flags = 1 if new_group is None else 2
    return costs.Work(ops=n, bytes=(flags + out_bytes_per_row) * n)


_LAUNCH = []


def _launcher():
    """``segscan_launch`` of the built ``csrc/segscan.cu``, loaded once."""
    if not _LAUNCH:
        lib = _build.load("segscan")
        lib.segscan_tile_rows.restype = ctypes.c_int
        if lib.segscan_tile_rows() != TILE_ROWS:
            raise RuntimeError("csrc/segscan.cu's tile differs from "
                               "TILE_ROWS")
        fn = lib.segscan_launch
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] +
                       [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2 +
                       [ctypes.c_void_p] * 2)
        fn.restype = ctypes.c_int
        _LAUNCH.append(fn)
    return _LAUNCH[0]


def _aligned(flags: torch.Tensor) -> torch.Tensor:
    """The flags as the kernel reads them: contiguous, 16-byte aligned (an
    offset view is copied to fresh storage, which the caching allocator
    aligns)."""
    flags = flags.contiguous()
    return flags.clone() if flags.data_ptr() % 16 else flags


def _launch(name: str, new_run, new_group, outs, linf_cap=0, l0=0):
    """One K6 launch of epilogue ``name`` into ``outs`` (out_start,
    out_ord, keep, marker; None to leave one out)."""
    n = new_run.shape[0]
    if n == 0:
        return
    tiles = (n + TILE_ROWS - 1) // TILE_ROWS
    scratch = torch.empty(2 * tiles if tiles > 1 else 0, dtype=torch.int64,
                          device=new_run.device)
    ptrs = [0 if t is None else t.data_ptr() for t in outs]
    with torch.cuda.device(new_run.device):
        err = _launcher()(new_run.data_ptr(),
                          0 if new_group is None else new_group.data_ptr(),
                          n, *ptrs, linf_cap, l0, scratch.data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"segscan launch failed: CUDA error {err}")
    _build.count_launch(LAUNCHES, name)


def run_scan(new_run: torch.Tensor, new_group: Optional[torch.Tensor] = None,
             starts: bool = True
             ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(run_start, run_ord)``, int64 ``[N]`` each: ``run_start`` unless
    ``starts`` is False, ``run_ord`` given ``new_group`` (else None).
    ``new_run``, ``new_group``: bool ``[N]`` on one device."""
    _check(new_run, new_group, "run_scan")
    out_bytes = 8 * (int(starts) + int(new_group is not None))
    with costs.kernel_launch("run_scan", (new_run, new_group),
                             lambda: work(new_run, new_group, out_bytes)):
        if new_run.device.type == "cpu":
            return run_scan_plain(new_run, new_group, starts)
        n = new_run.shape[0]
        run_start = run_ord = None
        if starts:
            run_start = torch.empty(n, dtype=torch.int64,
                                    device=new_run.device)
        if new_group is not None:
            run_ord = torch.empty(n, dtype=torch.int64,
                                  device=new_run.device)
        _launch("run_scan", _aligned(new_run),
                None if new_group is None else _aligned(new_group),
                (run_start, run_ord, None, None))
        return run_start, run_ord


def bound_linf_l0(new_seg: torch.Tensor, new_pid: torch.Tensor,
                  linf_cap: int, l0: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(keep_row, seg_marker)``, bool ``[N]`` each: the rows among the
    first ``linf_cap`` of their (pid, pk) segment whose segment is among
    the first ``l0`` of its pid, and the first row of each such segment.
    ``new_seg``, ``new_pid``: bool ``[N]`` on one device."""
    _check(new_seg, new_pid, "bound_linf_l0")
    with costs.kernel_launch("bound_linf_l0", (new_seg, new_pid),
                             lambda: work(new_seg, new_pid, 2)):
        if new_seg.device.type == "cpu":
            return bound_linf_l0_plain(new_seg, new_pid, linf_cap, l0)
        n = new_seg.shape[0]
        keep_row = torch.empty(n, dtype=torch.bool, device=new_seg.device)
        seg_marker = torch.empty_like(keep_row)
        # A rank lies in [0, n) and an ordinal in [-1, n), so caps clamped
        # to [-1, n + 1] compare alike and fit the kernel's int64.
        _launch("bound_linf_l0", _aligned(new_seg), _aligned(new_pid),
                (None, None, keep_row, seg_marker),
                max(min(int(linf_cap), n + 1), -1),
                max(min(int(l0), n + 1), -1))
        return keep_row, seg_marker
