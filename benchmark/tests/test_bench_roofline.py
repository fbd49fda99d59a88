"""The frozen yardstick against counts worked by hand."""

import torch

from benchmark.roofline import H100_SXM, Work, bound_s, k1_work, k3_work, \
    k5_work


def test_k1_counts_each_element_the_touched_pk_sectors_and_the_sums():
    cols = torch.zeros(20, 3, dtype=torch.int32)
    cols[0, 0] = 1   # pk sector 0 (rows 0-7)
    cols[9, 2] = 5   # sector 1 (rows 8-15)
    cols[9, 1] = 2
    cols[10, 0] = 7  # sector 1 again
    pk = torch.zeros(64, dtype=torch.int32)[:20]  # 32-byte aligned start
    assert pk.data_ptr() % 32 == 0
    w = k1_work(cols, pk, 4)
    assert w.ops == 4
    # cols 20 * 3 * 4 bytes, two 32-byte pk sectors, [4, 3] int32 sums.
    assert w.bytes == 240 + 64 + 48


def test_k3_counts_in_range_adds_kept_sectors_and_the_histogram():
    qpk = torch.tensor([0, 0, 1, 1, 0, 1, 0, 0, 1], dtype=torch.int32)
    leaf = torch.tensor([0, 1, 2, 5, 3, 0, 1, 2, 4], dtype=torch.int32)
    kept = torch.tensor([1, 1, 1, 0, 0, 0, 0, 0, 1], dtype=torch.bool)
    # One tile of both partitions, one quantile, subtree starts 0 and 2.
    sub_starts = torch.tensor([[[0], [2]]], dtype=torch.int32)
    p_offsets = torch.tensor([0], dtype=torch.int32)
    w = k3_work(qpk, leaf, kept, sub_starts, p_offsets, Pb=2, span=2)
    # Kept rows 0 (pk 0, leaf 0), 1 (pk 0, leaf 1), 2 (pk 1, leaf 2) fall
    # in their subtree [start, start + 2); row 8 (pk 1, leaf 4) does not.
    assert w.ops == 3
    # 9 flag bytes; rows 0-2 in sector 0 and row 8 in sector 1, for qpk
    # and leaf; 2 starts, 1 offset, [1, 2, 1, 2] counts, 4 bytes each.
    assert w.bytes == 9 + 2 * 32 * 2 + 4 * 2 + 4 + 4 * 4


def test_k5_counts_values_offsets_walk_totals_and_longest_key():
    values = torch.ones(10, 4)
    offsets = torch.tensor([0, 3, 3, 10], dtype=torch.int64)
    w = k5_work(values, offsets)
    assert w.ops == 40
    assert w.bytes == 160 + 8 * 4 + 4 * 3 + 4 * 3 * 4
    assert w.chain == 7


def test_bound_is_the_larger_of_bytes_adds_and_chain():
    assert bound_s(Work(ops=0, bytes=3_350_000)) == 1e-6
    assert bound_s(Work(ops=67_000_000, bytes=0)) == 1e-6
    chain = bound_s(Work(ops=0, bytes=0, chain=495))
    assert abs(chain - 495 * 4 / 1.98e9) < 1e-18
    assert H100_SXM["hbm_bytes_per_s"] == 3.35e12
