"""The port's lane segment sum (``pipelinedp_tpu_torch/ops/kernels``).

On the CPU: ``segment_sum_lanes_plain`` against the JAX package's Pallas
kernel (interpret mode, inside its envelope) and against
``jax.ops.segment_sum``, bit-equal, at the shapes of
``tests/test_kernels.py`` and at the flagship's P = 65536; the wrapper's
dispatch and argument checks. On the card (``cuda`` marker): the CUDA
kernel against the plain version, bit-equal.
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


@pytest.mark.parametrize("bad", ["dtype_cols", "dtype_pk", "rank", "rows",
                                 "no_cols", "strided"])
def test_wrapper_rejects_bad_arguments(bad):
    cols = torch.zeros(10, 3, dtype=torch.int32)
    pk = torch.zeros(10, dtype=torch.int32)
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
    else:
        cols = torch.zeros(3, 10, dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        segsum.segment_sum_lanes(cols, pk, 8)


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


def test_wide_plain_drops_keys_outside_the_range():
    cols, pk = _wide_case(8, 5, 300)
    pk[::7] = -1
    pk[3::11] = 8
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(cols), jnp.asarray(pk),
                                         num_segments=8))
    got = segsum.segment_sum_wide_plain(torch.from_numpy(cols),
                                        torch.from_numpy(pk), 8)
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


@pytest.mark.parametrize("bad", ["dtype_cols", "dtype_pk", "rank", "rows",
                                 "no_cols", "strided"])
def test_wide_wrapper_rejects_bad_arguments(bad):
    cols = torch.zeros(10, 3, dtype=torch.int32)
    pk = torch.zeros(10, dtype=torch.int32)
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
    else:
        cols = torch.zeros(3, 10, dtype=torch.int32).t()
    with pytest.raises((TypeError, ValueError)):
        segsum.segment_sum_wide(cols, pk, 8)


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
