"""The least work of one launch of K1, K3 and K5, counted from the
launch's inputs: frozen copies of ``work`` in the port's
``ops/kernels/segsum.py``, ``hist.py`` and ``segkeyed.py``. Each input
byte the answer needs is read once and each output byte written once."""

from __future__ import annotations

from typing import NamedTuple

import torch


class Work(NamedTuple):
    """Adds, bytes moved, and the longest chain of dependent adds."""
    ops: int
    bytes: int
    chain: int = 0


def k1_work(cols: torch.Tensor, pk: torch.Tensor, P: int) -> Work:
    """K1, ``segment_sum_lanes(cols [N, C] int32, pk [N] int32, P)``:
    every element of ``cols`` is read to know it is zero; ``pk`` only in
    the 32-byte sectors the rows with a nonzero lane touch; the [P, C]
    sums written once. One int32 add per nonzero element."""
    n, C = cols.shape
    nonzero = cols != 0
    rows = nonzero.any(dim=1).nonzero().squeeze(1)
    sectors = int(torch.unique((pk.data_ptr() + 4 * rows) // 32).numel())
    return Work(ops=int(nonzero.sum()),
                bytes=4 * n * C + 32 * sectors + 4 * int(P) * C)


def k3_work(qpk: torch.Tensor, leaf: torch.Tensor, kept: torch.Tensor,
            sub_starts: torch.Tensor, p_offsets: torch.Tensor, Pb: int,
            span: int) -> Work:
    """K3, ``subtree_counts_multi``: every kept flag read, ``qpk`` and
    ``leaf`` in the 32-byte sectors of the kept rows, the starts and
    offsets once, the counts written once. One int32 add per in-range
    (row, tile, quantile)."""
    T, _, Qc = sub_starts.shape
    adds = 0
    for t in range(T):
        rel_pk = qpk - p_offsets[t]
        in_blk = kept & (rel_pk >= 0) & (rel_pk < Pb)
        pk_b = torch.clamp(rel_pk, 0, Pb - 1).long()
        for q in range(Qc):
            rel = leaf - sub_starts[t, :, q][pk_b]
            adds += int((in_blk & (rel >= 0) & (rel < span)).sum())
    sectors = int(torch.unique(kept.nonzero().squeeze(1) // 8).numel())
    return Work(ops=adds,
                bytes=qpk.shape[0] + 2 * 32 * sectors +
                4 * sub_starts.numel() + 4 * T +
                4 * T * int(Pb) * Qc * int(span))


def k5_work(values: torch.Tensor, offsets: torch.Tensor) -> Work:
    """K5, ``segmented_sums(values [n, W] float32, layout)`` over
    ``P = len(offsets) - 1`` keys: each value read once, the int64
    offsets and the int32 walk once, each [P, W] total written once; one
    add per element; a key's rows are one chain of dependent adds per
    column, so the longest key is the longest chain."""
    n, W = values.shape
    P = offsets.shape[0] - 1
    lens = torch.diff(offsets)
    return Work(ops=n * W,
                bytes=4 * n * W + 8 * (P + 1) + 4 * P + 4 * P * W,
                chain=int(lens.max()) if P else 0)
