"""The stream's batch and rank assignment: grouping rows by (batch, rank)
cell, and regrouping a saved cell table onto a smaller mesh. A port of
``pipelinedp_tpu/ingest/assign.py``.

A row's cell is ``batch_of_row * n_dev + rank_of_row``, both from the
privacy-id hash, and the stream stages each cell's rows as one slice of
the row order. A cell id is small, so the grouping is a counting sort:
numpy's stable ``argsort`` of a 1- or 2-byte key is one radix pass (the
bincount-and-scatter), two passes of 16-bit digits for wider cell spaces.
The order is the stable ``argsort`` of the cell ids, so batch contents,
and every released value, do not depend on how it is computed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def regroup_cells(counts: np.ndarray, n_dev_new: int) -> np.ndarray:
    """Regroups a saved ``[n_batches, n_dev_old]`` table of rows per cell
    onto a smaller mesh whose size divides the old one: new rank ``d``
    takes the ``g = n_dev_old // n_dev_new`` contiguous old cells
    ``[d*g, (d+1)*g)`` of each batch, so the stream's consecutive slices
    of the original row order keep every old cell's rows, and so every
    privacy unit's rows, inside one new cell. The elastic resume reuses
    the row order as it was; only the cell boundaries coarsen.

    (The grouping is contiguous, not the ``fmix32(pid) % n_dev_new`` of a
    fresh run at the new shape. Where the caps do not bind that changes no
    released value: the ranks' partials add, so which survivor a row lands
    on never reaches the release.)"""
    counts = np.asarray(counts)
    n_batches, n_dev_old = counts.shape
    if n_dev_old % n_dev_new:
        raise ValueError(
            f"cannot regroup {n_dev_old} shard cells onto {n_dev_new} "
            "devices: the new mesh size must divide the old one")
    g = n_dev_old // n_dev_new
    return counts.reshape(n_batches, n_dev_new, g).sum(axis=2)


def group_rows_by_cell(cell_of_row: np.ndarray,
                       n_cells: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(order, counts)``: the row indices grouped by cell, cells
    ascending and rows in their original order within a cell (the stable
    ``argsort`` of ``cell_of_row``), and the rows per cell."""
    cell_of_row = np.asarray(cell_of_row)
    counts = np.bincount(cell_of_row, minlength=n_cells)
    if n_cells <= 1:
        return np.arange(cell_of_row.shape[0], dtype=np.int64), counts
    if n_cells <= (1 << 16):
        return np.argsort(cell_of_row.astype(np.uint16), kind="stable"), counts
    if n_cells > (1 << 32):
        raise NotImplementedError(
            f"{n_cells} batches: beyond the two-digit radix assignment")
    lo = (cell_of_row & 0xFFFF).astype(np.uint16)
    hi = (cell_of_row >> 16).astype(np.uint16)
    order = np.argsort(lo, kind="stable")
    return order[np.argsort(hi[order], kind="stable")], counts
