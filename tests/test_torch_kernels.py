"""The port's lane segment sum (``pipelinedp_tpu_torch/ops/kernels``).

On the CPU: ``segment_sum_lanes_plain`` against the JAX package's Pallas
kernel (interpret mode, inside its envelope) and against
``jax.ops.segment_sum``, bit-equal, at the shapes of
``tests/test_kernels.py`` and at the flagship's P = 65536; keys outside
``[0, P)`` dropped; the wrapper's dispatch, its argument checks and the
views it takes; the plain result unchanged by the ways the kernels split
the work (column tiles, row chunks, a hot-key set). On the card (``cuda``
marker): the CUDA kernels against the plain version, bit-equal, at the
test shapes and at the edges of their designs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pipelinedp_tpu.ops import kernels as jax_kernels
from pipelinedp_tpu_torch.ops.kernels import segsum

CASES = [(8, 2, 1000), (64, 11, 5000), (1024, 14, 20_000), (8192, 4, 3000),
         (65536, 6, 50_000)]


def _random_case(P, C, n):
    rng = np.random.default_rng(P * C)
    pk = rng.integers(0, P, n).astype(np.int32)
    cols = rng.integers(0, 4096, (n, C)).astype(np.int32)
    return cols, pk


@pytest.mark.parametrize("P,C,n", CASES)
def test_plain_matches_jax_segment_sum(P, C, n):
    cols, pk = _random_case(P, C, n)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(cols), jnp.asarray(pk),
                                         num_segments=P))
    got = segsum.segment_sum_lanes_plain(torch.from_numpy(cols),
                                         torch.from_numpy(pk), P)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P, C)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("P,C,n", CASES[:4])
def test_plain_matches_pallas_kernel(P, C, n):
    cols, pk = _random_case(P, C, n)
    rb = jax_kernels.segsum_envelope(P, C)
    ref = np.asarray(jax_kernels.segment_sum_lanes(
        jnp.asarray(cols), jnp.asarray(pk), P, rb,
        jax_kernels.use_interpret()))
    got = segsum.segment_sum_lanes_plain(torch.from_numpy(cols),
                                         torch.from_numpy(pk), P)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bits", [12, 11, 4])
def test_max_lane_values(bits):
    """Every row carries the lane plan's maximum into ONE partition: the
    total exceeds 2^24, past float32 exactness."""
    n, P = 8192, 16
    lane_max = (1 << bits) - 1
    cols = np.full((n, 3), lane_max, np.int32)
    pk = np.zeros(n, np.int32)
    got = segsum.segment_sum_lanes_plain(torch.from_numpy(cols),
                                         torch.from_numpy(pk), P).numpy()
    assert int(got[0, 0]) == n * lane_max
    rb = jax_kernels.segsum_envelope(P, 3)
    ref = np.asarray(jax_kernels.segment_sum_lanes(
        jnp.asarray(cols), jnp.asarray(pk), P, rb,
        jax_kernels.use_interpret()))
    np.testing.assert_array_equal(got, ref)


def test_wrapper_on_cpu_takes_plain_and_counts_nothing():
    cols, pk = _random_case(64, 5, 777)
    before = dict(segsum.LAUNCHES)
    got = segsum.segment_sum_lanes(torch.from_numpy(cols),
                                   torch.from_numpy(pk), 64)
    assert segsum.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(), segsum.segment_sum_lanes_plain(
            torch.from_numpy(cols), torch.from_numpy(pk), 64).numpy())


BAD_ARGUMENTS = ["dtype_cols", "dtype_pk", "rank", "rows", "no_cols",
                 "strided", "no_partitions", "partitions_past_int32",
                 "columns_past_2_28", "pk_rank", "pk_strided",
                 "meta_device"]


def _bad_arguments(bad):
    cols = torch.zeros(10, 3, dtype=torch.int32)
    pk = torch.zeros(10, dtype=torch.int32)
    P = {"no_partitions": 0, "partitions_past_int32": 1 << 31}.get(bad, 8)
    if bad == "dtype_cols":
        cols = cols.to(torch.int64)
    elif bad == "dtype_pk":
        pk = pk.to(torch.int64)
    elif bad == "rank":
        cols = cols[:, 0]
    elif bad == "rows":
        pk = pk[:9]
    elif bad == "no_cols":
        cols = cols[:, :0]
    elif bad == "strided":
        cols = torch.zeros(3, 10, dtype=torch.int32).t()
    elif bad == "columns_past_2_28":
        cols = torch.zeros(10, 1, dtype=torch.int32).expand(
            10, segsum.MAX_COLS + 1)
    elif bad == "pk_rank":
        pk = pk[:, None]
    elif bad == "pk_strided":
        pk = torch.zeros(20, dtype=torch.int32)[::2]
    elif bad == "meta_device":
        cols, pk = cols.to("meta"), pk.to("meta")
    return cols, pk, P


@pytest.mark.parametrize("bad", BAD_ARGUMENTS)
def test_wrapper_rejects_bad_arguments(bad):
    cols, pk, P = _bad_arguments(bad)
    with pytest.raises((TypeError, ValueError)):
        segsum.segment_sum_lanes(cols, pk, P)


@pytest.mark.cuda
@pytest.mark.parametrize("P,C,n", CASES)
def test_cuda_kernel_matches_plain(P, C, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cols, pk = _random_case(P, C, n)
    c = torch.from_numpy(cols).cuda()
    p = torch.from_numpy(pk).cuda()
    before = segsum.LAUNCHES["segment_sum_lanes"]
    got = segsum.segment_sum_lanes(c, p, P)
    torch.cuda.synchronize()
    assert segsum.LAUNCHES["segment_sum_lanes"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), segsum.segment_sum_lanes_plain(c, p, P).cpu()
        .numpy())


# ---------------------------------------------------------------------------
# K2: segment_sum_wide, VECTOR_SUM's lane-major coordinate lanes
# ---------------------------------------------------------------------------

# (P, W, n): W = n_lanes * D, mostly not a multiple of the Pallas D tile
# (128, 256 or 512) nor of the CUDA kernel's column tile.
WIDE_CASES = [(1, 7, 500), (8, 192, 3000), (64, 3 * 33, 2000),
              (2048, 512, 2500), (8192, 130, 1000), (65536, 24, 20_000)]


def _wide_case(P, W, n, lane_bits=12):
    rng = np.random.default_rng(P + W)
    pk = rng.integers(0, P, n).astype(np.int32)
    cols = rng.integers(0, 1 << lane_bits, (n, W)).astype(np.int32)
    return cols, pk


@pytest.mark.parametrize("P,W,n", WIDE_CASES)
def test_wide_plain_matches_jax_segment_sum(P, W, n):
    cols, pk = _wide_case(P, W, n)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(cols), jnp.asarray(pk),
                                         num_segments=P))
    got = segsum.segment_sum_wide_plain(torch.from_numpy(cols),
                                        torch.from_numpy(pk), P)
    assert got.dtype == torch.int32 and tuple(got.shape) == (P, W)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("P,W,n", WIDE_CASES[:5])
def test_wide_plain_matches_pallas_kernel(P, W, n):
    """The JAX package's Pallas K2 in interpret mode, at the tiles its
    envelope picks."""
    cols, pk = _wide_case(P, W, n)
    rb, db = jax_kernels.segsum_wide_envelope(P, W)
    ref = np.asarray(jax_kernels.segment_sum_wide(
        jnp.asarray(cols), jnp.asarray(pk), P, rb, db,
        jax_kernels.use_interpret()))
    got = segsum.segment_sum_wide_plain(torch.from_numpy(cols),
                                        torch.from_numpy(pk), P)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("bits", [12, 10, 4])
def test_wide_max_lane_values(bits):
    """Every row carries the lane maximum into one partition: the totals
    pass 2^24, beyond float32 exactness."""
    n, P, W = 8192, 16, 40
    lane_max = (1 << bits) - 1
    cols = np.full((n, W), lane_max, np.int32)
    pk = np.zeros(n, np.int32)
    got = segsum.segment_sum_wide_plain(torch.from_numpy(cols),
                                        torch.from_numpy(pk), P).numpy()
    assert (got[0] == n * lane_max).all() and not got[1:].any()
    rb, db = jax_kernels.segsum_wide_envelope(P, W)
    ref = np.asarray(jax_kernels.segment_sum_wide(
        jnp.asarray(cols), jnp.asarray(pk), P, rb, db,
        jax_kernels.use_interpret()))
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("kernel,width", [
    ("segment_sum_lanes", 1), ("segment_sum_lanes", 3),
    ("segment_sum_lanes", 14), ("segment_sum_wide", 7),
    ("segment_sum_wide", 130), ("segment_sum_wide", 192)])
def test_plain_drops_keys_outside_the_range(kernel, width):
    """Keys -1 and P (and far outside) are dropped, as the kernels and
    ``jax.ops.segment_sum`` drop them; the wrapper on the CPU agrees."""
    cols, pk = _wide_case(8, width, 300)
    pk[::7] = -1
    pk[3::11] = 8
    pk[5::13] = -(1 << 30)
    pk[6::17] = 1 << 30
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(cols), jnp.asarray(pk),
                                         num_segments=8))
    c, p = torch.from_numpy(cols), torch.from_numpy(pk)
    got = getattr(segsum, kernel + "_plain")(c, p, 8)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(getattr(segsum, kernel)(c, p, 8).numpy(),
                                  ref)


def _zipf_case(P, W, n, seed):
    """A stack with every element nonzero over zipf(1.3) keys: about a
    quarter of the rows on one key."""
    rng = np.random.default_rng(seed)
    pk = ((rng.zipf(1.3, n) - 1) % P).astype(np.int32)
    cols = rng.integers(1, 1 << 10, (n, W)).astype(np.int32)
    return cols, pk


@pytest.mark.parametrize("split", ["column_tiles", "row_chunks",
                                   "hot_keys_from_sample"])
@pytest.mark.parametrize("P,W", [(2048, 192), (65536, 6), (64, 2048)])
def test_plain_invariant_to_the_kernels_split(split, P, W):
    """The kernels sum the stack in pieces: column tiles (16 columns, K2's
    tile at the bench's P = 2048), chunks of rows flushed one after another,
    and hot keys (any set, here the keys seen most in a strided sample)
    apart from the rest. The plain result of the whole equals the
    pieces', whatever the split."""
    cols, pk = _zipf_case(P, W, 6000, P + W)
    c, p = torch.from_numpy(cols), torch.from_numpy(pk)
    whole = segsum.segment_sum_wide_plain(c, p, P)
    if split == "column_tiles":
        t = 16
        parts = torch.cat([segsum.segment_sum_wide_plain(
            c[:, j:j + t].contiguous(), p, P) for j in range(0, W, t)], 1)
    elif split == "row_chunks":
        parts = sum(segsum.segment_sum_wide_plain(c[i:i + 997], p[i:i + 997],
                                                  P)
                    for i in range(0, c.shape[0], 997))
    else:
        sample = p[::c.shape[0] // 64]
        keys, hits = torch.unique(sample, return_counts=True)
        hot = keys[hits >= 2][:segsum.HOT_WORDS]
        is_hot = torch.isin(p, hot)
        parts = (segsum.segment_sum_wide_plain(c, torch.where(is_hot, p, -1),
                                               P)
                 + segsum.segment_sum_wide_plain(
                     c, torch.where(is_hot, -1, p), P))
        assert 1 <= hot.numel() <= segsum.HOT_WORDS
    assert torch.equal(parts, whole)


@pytest.mark.parametrize("P,W", [(8, 1), (999, 6), (2048, 192)])
@pytest.mark.parametrize("kernel", ["segment_sum_lanes", "segment_sum_wide"])
def test_wrapper_takes_a_view_off_16_byte_alignment(kernel, P, W):
    """A contiguous view 4 bytes into its storage, as the kernels read
    with 4-byte loads up to the first 16-byte boundary: the wrapper takes
    it and sums it as ``jax.ops.segment_sum`` does."""
    n = 1001
    rng = np.random.default_rng(P * W)
    flat = rng.integers(1, 1 << 10, n * W + 1).astype(np.int32)
    pk = rng.integers(0, P, n).astype(np.int32)
    view = torch.from_numpy(flat)[1:].view(n, W)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    ref = np.asarray(jax.ops.segment_sum(
        jnp.asarray(flat[1:].reshape(n, W)), jnp.asarray(pk), num_segments=P))
    got = getattr(segsum, kernel)(view, torch.from_numpy(pk), P)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_wide_wrapper_on_cpu_takes_plain_and_counts_nothing():
    cols, pk = _wide_case(64, 70, 777)
    before = dict(segsum.LAUNCHES)
    got = segsum.segment_sum_wide(torch.from_numpy(cols),
                                  torch.from_numpy(pk), 64)
    assert segsum.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(), segsum.segment_sum_wide_plain(
            torch.from_numpy(cols), torch.from_numpy(pk), 64).numpy())


@pytest.mark.parametrize("bad", BAD_ARGUMENTS)
def test_wide_wrapper_rejects_bad_arguments(bad):
    cols, pk, P = _bad_arguments(bad)
    with pytest.raises((TypeError, ValueError)):
        segsum.segment_sum_wide(cols, pk, P)


@pytest.mark.cuda
@pytest.mark.parametrize("P,W,n", WIDE_CASES)
def test_cuda_wide_kernel_matches_plain(P, W, n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    cols, pk = _wide_case(P, W, n)
    c = torch.from_numpy(cols).cuda()
    p = torch.from_numpy(pk).cuda()
    before = segsum.LAUNCHES["segment_sum_wide"]
    got = segsum.segment_sum_wide(c, p, P)
    torch.cuda.synchronize()
    assert segsum.LAUNCHES["segment_sum_wide"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(), segsum.segment_sum_wide_plain(c, p, P).cpu()
        .numpy())


#: The P past which K2 takes K1's kernels: a [P, 4] int32 tile passes the
#: shared-memory budget (200 KB) of ``csrc/segsum_wide.cu``.
SMEM_LIMIT_P = 12800


def _edge_case(kind):
    """(kernel, cols, pk, P) for the edges of the kernels' designs; cols
    may be a view whose data_ptr is not 16-byte aligned."""
    lanes, wide = "segment_sum_lanes", "segment_sum_wide"
    lim = SMEM_LIMIT_P
    cases = {
        # A quarter of the rows on one key, every element nonzero.
        "lanes_hot_key": (lanes, 65536, 6, 300_000, "zipf"),
        "wide_hot_key": (wide, 2048, 192, 100_000, "zipf"),
        "wide_hot_key_past_smem": (wide, 65536, 192, 50_000, "zipf"),
        "lanes_c1": (lanes, 1 << 20, 1, 100_003, "zipf"),
        "lanes_c14": (lanes, 4096, 14, 50_001, "zipf"),
        "lanes_c17_general": (lanes, 300, 17, 20_001, "zipf"),
        "lanes_nc_not_multiple_of_4": (lanes, 999, 3, 10_001, "uniform"),
        "lanes_unaligned_view": (lanes, 999, 6, 10_001, "unaligned"),
        "lanes_all_hot_slots_c128": (lanes, 100, 128, 3000, "zipf"),
        "lanes_fewer_hot_slots_c129": (lanes, 100, 129, 3000, "zipf"),
        "lanes_no_hot_slots_c8193": (lanes, 5, 8193, 40, "zipf"),
        "wide_w_not_multiple_of_4": (wide, 2048, 190, 20_000, "zipf"),
        "wide_unaligned_view": (wide, 2048, 192, 20_000, "unaligned"),
        "wide_p_at_smem_limit": (wide, lim, 192, 30_000, "zipf"),
        "wide_p_past_smem_limit": (wide, lim + 1, 192, 30_000, "zipf"),
        "wide_p_at_tile_16": (wide, 3200, 96, 30_000, "uniform"),
        "wide_p_past_tile_16": (wide, 3201, 96, 30_000, "uniform"),
        "wide_keys_outside": (wide, 64, 24, 5000, "outside"),
        "lanes_keys_outside": (lanes, 64, 5, 5000, "outside"),
    }
    kernel, P, W, n, keys = cases[kind]
    rng = np.random.default_rng(len(kind))
    if keys == "uniform":
        pk = rng.integers(0, P, n)
    else:
        pk = (rng.zipf(1.3, n) - 1) % P
    if keys == "outside":
        pk[::5] = -1
        pk[1::7] = P
    flat = torch.from_numpy(rng.integers(1, 1 << 10, n * W + 1).astype(
        np.int32)).cuda()
    cols = (flat[1:] if keys == "unaligned" else flat[:-1]).view(n, W)
    assert cols.is_contiguous()
    return kernel, cols, torch.from_numpy(pk.astype(np.int32)).cuda(), P


EDGE_CASES = ["lanes_hot_key", "wide_hot_key", "wide_hot_key_past_smem",
              "lanes_c1", "lanes_c14", "lanes_c17_general",
              "lanes_nc_not_multiple_of_4", "lanes_unaligned_view",
              "lanes_all_hot_slots_c128", "lanes_fewer_hot_slots_c129",
              "lanes_no_hot_slots_c8193", "wide_w_not_multiple_of_4",
              "wide_unaligned_view", "wide_p_at_smem_limit",
              "wide_p_past_smem_limit", "wide_p_at_tile_16",
              "wide_p_past_tile_16", "wide_keys_outside",
              "lanes_keys_outside"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EDGE_CASES)
def test_cuda_kernels_at_design_edges(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    kernel, cols, pk, P = _edge_case(kind)
    if kind.endswith("unaligned_view"):
        assert cols.data_ptr() % 16 != 0
    if kind == "wide_p_at_smem_limit":
        assert segsum.wide_tile(cols.shape[1], P) == 4
    if kind in ("wide_p_past_smem_limit", "wide_hot_key_past_smem"):
        assert segsum.wide_tile(cols.shape[1], P) == 0
    before = segsum.LAUNCHES[kernel]
    got = getattr(segsum, kernel)(cols, pk, P)
    torch.cuda.synchronize()
    assert segsum.LAUNCHES[kernel] == before + 1
    want = segsum.segment_sum_lanes_plain(cols, pk, P)
    assert int(want.abs().sum()) > 0
    assert torch.equal(got, want), kind
