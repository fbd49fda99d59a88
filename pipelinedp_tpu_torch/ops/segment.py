"""Row-space segment primitives of the fused aggregation, in PyTorch.

Port of ``pipelinedp_tpu/ops/segment.py``. After the one sort by
(pid, hashed pk, tie-break) every run of equal keys is contiguous, so the
per-segment quantities come from cumulative ops over the runs:
``run_starts`` is a running maximum of the marked indices, ranks are index
differences and group ordinals are cumulative-sum differences.

Unsigned order: ``fmix32`` works on int64 tensors holding uint32 values
and masks with ``& 0xFFFFFFFF`` after every shift and multiply, where
uint32 arithmetic would wrap. The product of two 32-bit words needs 64
bits, so each multiply splits the constant into 16-bit halves to stay
inside int64 without overflow.
"""

from __future__ import annotations

import torch

# Sentinel for padding rows: sorts after all real ids.
PAD_ID = 2**31 - 1

_MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2^32`` for uint32 values held in int64: the 16-bit
    halves of ``c`` keep each partial product below 2^48."""
    lo = (x * (c & 0xFFFF)) & _MASK32
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer: an elementwise bijection on uint32 (held in
    int64) with full avalanche."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def run_starts(new_run: torch.Tensor) -> torch.Tensor:
    """Per-row index of the first row of its run. ``new_run`` is a bool
    [N] marking run boundaries over sorted rows; row 0 must be marked."""
    idx = torch.arange(new_run.shape[0], device=new_run.device)
    return torch.cummax(torch.where(new_run, idx, 0), dim=0).values


def rank_in_run(new_run: torch.Tensor) -> torch.Tensor:
    """0-based rank of each row inside its contiguous run."""
    idx = torch.arange(new_run.shape[0], device=new_run.device)
    return idx - run_starts(new_run)


def run_ordinal_in_group(new_run: torch.Tensor,
                         new_group: torch.Tensor) -> torch.Tensor:
    """Per row: the 0-based ordinal of the row's run within its group.
    Every group boundary is also a run boundary. With the run order inside
    each group randomised by a hashed sort key, ``ordinal < k`` is a
    uniform without-replacement sample of k runs per group (the L0
    bound)."""
    run_ord = torch.cumsum(new_run.to(torch.int64), dim=0) - 1
    group_first_run = torch.cummax(torch.where(new_group, run_ord, 0),
                                   dim=0).values
    return run_ord - group_first_run
