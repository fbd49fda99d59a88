"""The ordered segment totals of the per-partition-sum-bounds SUM
(``pipelinedp_tpu_torch/ops/kernels/segtotal.py``, kernel K4).

On the CPU: the plain version against the JAX package's
``jax.ops.segment_sum(masked, seg_ord, num_segments=n)`` read back per row
(``seg_total[seg_ord]``, as ``jax_engine._partials`` reads it), bit for
bit, on random inputs and on inputs whose float32 sum depends on the order
of the adds; the order claim itself (XLA's CPU scatter folds each segment
left to right); a run of ``-0.0``; every row its own segment; the
wrapper's dispatch and checks; segment layouts at the seams of the CUDA
kernel's tiled fold (lengths around a thread's, a warp's and a tile's
rows, a segment on a tile's last row, one spanning two tiles, mid-length
segments), with values whose totals depend on the order. On the card
(``cuda`` marker): the CUDA kernel against the plain version, bit for bit,
with short and long segments and on those layouts.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pipelinedp_tpu_torch.ops.kernels import segtotal


def _jax_totals(values, new_seg):
    """``seg_total[seg_ord]`` of ``jax_engine._partials``."""
    new_seg = new_seg.copy()
    new_seg[0] = True
    seg_ord = jnp.cumsum(jnp.asarray(new_seg).astype(jnp.int32)) - 1
    seg_total = jax.ops.segment_sum(jnp.asarray(values), seg_ord,
                                    num_segments=len(values))
    return np.asarray(seg_total[seg_ord])


def _fold(values, new_seg):
    """A float32 left fold per segment in plain Python: the order claim."""
    out = np.empty_like(values)
    start = 0
    for i in range(1, len(values) + 1):
        if i == len(values) or new_seg[i]:
            s = np.float32(0.0)
            with np.errstate(over="ignore"):
                for v in values[start:i]:
                    s = np.float32(s + v)
            out[start:i] = s
            start = i
    return out


def _plain(values, new_seg):
    return segtotal.segment_totals_plain(
        torch.from_numpy(values), torch.from_numpy(new_seg)).numpy()


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _random_case(seed, n, mean_len, spread=10.0):
    rng = np.random.default_rng(seed)
    values = (rng.standard_normal(n) * spread).astype(np.float32)
    values[rng.random(n) < 0.3] = 0.0  # rows outside the kept set
    new_seg = rng.random(n) < 1.0 / mean_len
    return values, new_seg


@pytest.mark.parametrize("seed,n,mean_len", [(0, 1, 1), (1, 17, 3),
                                              (2, 5000, 2), (3, 20_000, 9),
                                              (4, 3000, 150)])
def test_plain_matches_jax_segment_sum(seed, n, mean_len):
    values, new_seg = _random_case(seed, n, mean_len)
    got = _plain(values, new_seg)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_totals(values,
                                                                new_seg)))


def _order_sensitive():
    """Segments whose float32 sum depends on the order of the adds:
    cancellations around 1e8, a total that reaches 2^24 and then stops
    taking ones, and runs of equal values whose total passes 2^24, where
    every add rounds."""
    segs = [
        np.array([1e8, 1, -1e8, 1] * 3, np.float32),
        np.array([1, 1e8, 1, -1e8], np.float32),
        np.array([2.0**24] + [1.0] * 50 + [-(2.0**24)], np.float32),
        np.full(20_000, 1000.7, np.float32),
        np.full(3001, 0.1, np.float32),
        np.full(700, 33554.43, np.float32),
        np.array([3.4e38, 3.4e38, -3.4e38], np.float32),
    ]
    values = np.concatenate(segs)
    new_seg = np.zeros(len(values), bool)
    np.put(new_seg, np.cumsum([0] + [len(s) for s in segs[:-1]]), True)
    return values, new_seg


def test_order_claim_xla_cpu_folds_in_row_order():
    """The ported contract: on inputs where order matters, XLA's CPU
    ``segment_sum`` equals the sequential fold, and a pairwise sum would
    not."""
    values, new_seg = _order_sensitive()
    ref = _jax_totals(values, new_seg)
    np.testing.assert_array_equal(_bits(ref), _bits(_fold(values, new_seg)))
    assert ref[0] == 1.0  # ((1e8 + 1) - 1e8) + 1, ...: not 2.0
    assert ref[12] == 0.0  # 1 + 1e8 drops the 1, then -1e8
    assert ref[16] == 0.0  # 2^24 + 1 + ... stays 2^24
    pairwise = np.float32(np.float32(1e8 + 1) + np.float32(-1e8 + 1))
    assert pairwise != ref[0]
    run = np.full(20_000, 1000.7, np.float32)
    assert np.float32(run.sum()) != ref[len(values) - 3 - 700 - 3001 - 20_000]
    assert np.isinf(ref[-1])  # 3.4e38 + 3.4e38 overflows first


def test_plain_matches_jax_on_order_sensitive_inputs():
    values, new_seg = _order_sensitive()
    np.testing.assert_array_equal(_bits(_plain(values, new_seg)),
                                  _bits(_jax_totals(values, new_seg)))


def test_negative_zero_does_not_leak():
    """Rows outside the kept set are +0.0, but a kept -0.0 may appear;
    the fold starts from +0.0, as XLA's scatter does, so a segment of
    -0.0 totals +0.0."""
    values = np.array([-0.0, -0.0, 1.5, -0.0, -0.0, -0.0], np.float32)
    new_seg = np.array([1, 0, 1, 1, 0, 0], bool)
    got = _plain(values, new_seg)
    want = _jax_totals(values, new_seg)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert not np.signbit(got).any()


def test_every_row_its_own_segment():
    """Bounds-already-enforced mode: each row is a segment, and its total
    is the row plus +0.0."""
    rng = np.random.default_rng(5)
    values = rng.standard_normal(4000).astype(np.float32)
    values[::7] = -0.0
    new_seg = np.ones(4000, bool)
    got = _plain(values, new_seg)
    np.testing.assert_array_equal(_bits(got), _bits(values + np.float32(0)))
    np.testing.assert_array_equal(_bits(got),
                                  _bits(_jax_totals(values, new_seg)))


def test_row_zero_starts_a_segment():
    values = np.array([1.0, 2.0, 4.0], np.float32)
    got = _plain(values, np.array([False, False, True]))
    np.testing.assert_array_equal(got, [3.0, 3.0, 4.0])


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    values, new_seg = _random_case(6, 999, 4)
    before = dict(segtotal.LAUNCHES)
    got = segtotal.segment_totals(torch.from_numpy(values),
                                  torch.from_numpy(new_seg))
    np.testing.assert_array_equal(got.numpy(), _plain(values, new_seg))
    assert segtotal.LAUNCHES == before
    assert segtotal.segment_totals(torch.zeros(0),
                                   torch.zeros(0, dtype=torch.bool)).shape \
        == (0,)


@pytest.mark.parametrize("bad", ["float64", "int_flags", "shape",
                                 "strided"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    values = torch.zeros(10)
    flags = torch.zeros(10, dtype=torch.bool)
    if bad == "float64":
        values = values.double()
    elif bad == "int_flags":
        flags = flags.int()
    elif bad == "shape":
        flags = flags[:5]
    else:
        values = torch.zeros(20)[::2]
    with pytest.raises((TypeError, ValueError)):
        segtotal.segment_totals(values, flags)


LAYOUTS = segtotal.SEAM_LAYOUTS


@pytest.mark.parametrize("order_sensitive", [False, True],
                         ids=["normal", "order_sensitive"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_matches_jax_at_the_kernel_seams(layout, order_sensitive):
    values, new_seg = segtotal.seam_layout(layout, order_sensitive)
    got = _plain(values, new_seg)
    np.testing.assert_array_equal(_bits(got), _bits(_jax_totals(values,
                                                                new_seg)))
    if order_sensitive:
        # The values do make the order matter: folded right to left, some
        # segment's total differs.
        backwards = _fold(values[::-1], np.roll(new_seg, -1)[::-1])[::-1]
        assert (_bits(backwards) != _bits(got)).any()


def _cuda_case(case):
    if case.startswith("seams_"):
        name, _, kind = case[len("seams_"):].partition("/")
        return segtotal.seam_layout(name, kind == "order_sensitive")
    if case == "random_short":
        return _random_case(7, 100_000, 2)
    if case == "random_mixed":
        return _random_case(8, 100_000, 90)
    if case == "order_sensitive":
        return _order_sensitive()
    if case == "own_segment":
        values = np.random.default_rng(9).standard_normal(5000).astype(
            np.float32)
        return values, np.ones(5000, bool)
    if case == "hot_segment":
        values, new_seg = _random_case(10, 1 << 17, 3)
        new_seg[1000:1000 + (1 << 16)] = False
        return values, new_seg
    if case == "long_segments":
        rng = np.random.default_rng(11)
        values = (rng.standard_normal(300_001) * 100).astype(np.float32)
        starts = np.cumsum(rng.integers(60, 3000, 400))
        new_seg = np.zeros(len(values), bool)
        new_seg[starts[starts < len(values)]] = True
        return values, new_seg
    # A segment that runs past every chunk boundary to the table's end.
    values, new_seg = _random_case(12, 70_003, 4)
    new_seg[50_001:] = False
    return values, new_seg


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random_short", "random_mixed",
                                  "order_sensitive", "own_segment",
                                  "hot_segment", "long_segments",
                                  "long_to_the_end"] + [
                                      f"seams_{name}/{kind}"
                                      for name in LAYOUTS
                                      for kind in ("normal",
                                                   "order_sensitive")])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset_view"])
def test_cuda_kernel_matches_plain(case, offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    values, new_seg = _cuda_case(case)
    values, new_seg = values[offset:], new_seg[offset:].copy()
    want = _plain(np.ascontiguousarray(values), new_seg)
    v = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32),
                                         values])).cuda()[offset:]
    f = torch.from_numpy(np.concatenate([np.zeros(offset, bool),
                                         new_seg])).cuda()[offset:]
    got = segtotal.segment_totals(v, f)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(_bits(got.cpu().numpy()), _bits(want))
