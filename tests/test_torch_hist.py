"""The port's subtree-leaf histogram K3 (``ops/kernels/hist.py``).

On the CPU: ``subtree_counts_multi_plain`` against the JAX package's
Pallas ``hist_bin_multi`` (interpret mode, at the row block of its
envelope) and against ``jax_engine._subtree_counts_multi``, bit-equal,
over several (T, Pb, Qc, span) with unaligned starts, nonzero partition
offsets, rows outside every block and rows not kept, and on the CUDA
count pass's edges (row counts around its 16-row steps, no row kept, a
clipped hot bin); the wrapper's dispatch, accumulation, views at any
element and argument checks. On the card (``cuda`` marker): the CUDA
kernel against the plain version, bit-equal, also on the edges as views
past a 16-byte boundary, fresh and added into.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pipelinedp_tpu import jax_engine as je
from pipelinedp_tpu.ops import kernels as jax_kernels
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.ops.kernels import hist

# (T, Pb, Qc, span): the Pallas parity shapes of tests/test_kernels.py,
# a span of 256 (the walk's), a lone partition, and wide packs.
CASES = [(1, 8, 1, 16), (3, 8, 2, 16), (5, 16, 4, 16), (1, 4, 3, 256),
         (2, 1, 5, 256), (4, 32, 3, 64)]


def _case(T, Pb, Qc, span, seed=0, n=9000, kept_share=0.8):
    """Rows over partitions [-3, T * Pb + 40): past both ends of every
    tile's block; tiles start at scattered offsets; starts unaligned."""
    rng = np.random.default_rng(seed + T * 100 + Pb * 10 + Qc + span)
    offsets = np.sort(rng.choice(T * Pb + 30, T, replace=False)).astype(
        np.int32)
    qpk = rng.integers(-3, T * Pb + 40, n).astype(np.int32)
    leaf = rng.integers(0, 4 * span, n).astype(np.int32)
    kept = rng.random(n) < kept_share
    starts = rng.integers(0, 3 * span, (T, Pb, Qc)).astype(np.int32)
    return qpk, leaf, kept, starts, offsets


# The CUDA count pass's edges (``csrc/hist_bin.cu`` takes rows in 16-row
# steps): row counts around a step, no row kept, and a clipped hot bin.
EDGES = ["n=1", "n=15", "n=17", "n=16k+3", "none kept", "hot bin"]


def _hot_bin_case(T, Pb, Qc, span, seed=0, n=4003, kept_share=0.6,
                  hot_share=0.9):
    """Most rows in one partition at the top leaf of a 2^16-leaf tree
    (values clipped at ``max_value``), inside that partition's subtree
    for every quantile; span-aligned starts elsewhere."""
    rng = np.random.default_rng(seed + 18)
    n_leaves = 1 << 16
    hot = Pb // 3
    offsets = (np.arange(T) * Pb).astype(np.int32)
    qpk = rng.integers(0, T * Pb, n).astype(np.int32)
    leaf = rng.integers(0, n_leaves, n).astype(np.int32)
    is_hot = rng.random(n) < hot_share
    qpk[is_hot] = hot
    leaf[is_hot] = n_leaves - 1
    kept = rng.random(n) < kept_share
    starts = (span * rng.integers(0, n_leaves // span, (T, Pb, Qc))).astype(
        np.int32)
    starts[:, hot, :] = n_leaves - span
    return qpk, leaf, kept, starts, offsets


def _edge(name, seed=0):
    """((T, Pb, Qc, span), inputs) of one of ``EDGES``."""
    if name == "hot bin":
        shape = (2, 16, 3, 256)
        return shape, _hot_bin_case(*shape, seed=seed)
    shape = (2, 8, 3, 16)
    if name == "none kept":
        return shape, _case(*shape, seed=seed, n=4003, kept_share=0.0)
    n = {"n=1": 1, "n=15": 15, "n=17": 17, "n=16k+3": 16 * 257 + 3}[name]
    return shape, _case(*shape, seed=seed, n=n)


def _plain(qpk, leaf, kept, starts, offsets, Pb, span):
    return hist.subtree_counts_multi_plain(
        *(torch.from_numpy(x) for x in (qpk, leaf, kept, starts, offsets)),
        Pb, span).numpy()


@pytest.mark.parametrize("T,Pb,Qc,span", CASES)
def test_plain_matches_jax_subtree_counts_multi(T, Pb, Qc, span):
    qpk, leaf, kept, starts, offsets = _case(T, Pb, Qc, span)
    want = np.asarray(je._subtree_counts_multi(
        *(jnp.asarray(x) for x in (qpk, leaf, kept, starts, offsets)),
        Pb, span))
    got = _plain(qpk, leaf, kept, starts, offsets, Pb, span)
    assert got.dtype == np.int32 and got.shape == (T, Pb, Qc, span)
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) > 50  # not vacuous


@pytest.mark.parametrize("T,Pb,Qc,span", CASES[:4])
def test_plain_matches_pallas_kernel(T, Pb, Qc, span):
    """The Pallas kernel in interpret mode."""
    qpk, leaf, kept, starts, offsets = _case(T, Pb, Qc, span, seed=1)
    rb = jax_kernels.hist_envelope(T, Pb, Qc, span)
    assert rb is not None
    want = np.asarray(jax_kernels.hist_bin_multi(
        *(jnp.asarray(x) for x in (qpk, leaf, kept, starts, offsets)),
        Pb, span, rb, jax_kernels.use_interpret()))
    got = _plain(qpk, leaf, kept, starts, offsets, Pb, span)
    np.testing.assert_array_equal(got, want)
    assert int(got.sum()) > 50


@pytest.mark.parametrize("name", EDGES)
def test_plain_matches_jax_on_edges(name):
    (T, Pb, Qc, span), args = _edge(name)
    qpk, leaf, kept, starts, offsets = args
    want = np.asarray(je._subtree_counts_multi(
        *(jnp.asarray(x) for x in args), Pb, span))
    got = _plain(*args, Pb, span)
    assert got.dtype == np.int32 and got.shape == (T, Pb, Qc, span)
    np.testing.assert_array_equal(got, want)
    if name == "none kept":
        assert not got.any()
    if name == "hot bin":
        # Every kept hot row lands on the top leaf of each quantile.
        hot = (qpk == Pb // 3) & (leaf == (1 << 16) - 1) & kept
        assert (got[0, Pb // 3, :, span - 1] == int(hot.sum())).all()
        assert int(hot.sum()) > 2000


@pytest.mark.parametrize("name", EDGES)
def test_plain_matches_pallas_kernel_on_edges(name):
    """The Pallas kernel in interpret mode, at its envelope's row block."""
    (T, Pb, Qc, span), args = _edge(name, seed=1)
    rb = jax_kernels.hist_envelope(T, Pb, Qc, span)
    assert rb is not None
    want = np.asarray(jax_kernels.hist_bin_multi(
        *(jnp.asarray(x) for x in args), Pb, span, rb,
        jax_kernels.use_interpret()))
    np.testing.assert_array_equal(_plain(*args, Pb, span), want)


def _views(tensors, k, unit):
    """Contiguous copies of ``tensors`` as views past a 16-byte boundary:
    ``unit="bytes"`` puts every data_ptr ``4 k`` bytes past it (kept
    flags and int32 words then sit at different phases), ``"rows"``
    starts every tensor ``k`` elements in."""
    views = []
    for x in tensors:
        skip = (4 * k) // x.element_size() if unit == "bytes" else k
        buf = torch.zeros(x.numel() + 16, dtype=x.dtype, device=x.device)
        view = buf[skip:skip + x.numel()].view(x.shape)
        view.copy_(x)
        views.append(view)
    return views


@pytest.mark.parametrize("unit", ["bytes", "rows"])
def test_wrapper_takes_views_at_any_element(unit):
    """A contiguous view may start at any element: the wrapper takes it as
    it is (on the CPU the plain version; on the card the kernel reads it
    in place)."""
    (T, Pb, Qc, span), args = _edge("n=16k+3", seed=2)
    want = _plain(*args, Pb, span)
    for k in (1, 2, 3):
        views = _views([torch.from_numpy(x) for x in args], k, unit)
        assert views[0].data_ptr() % 16 != 0
        got = hist.subtree_counts_multi(*views, Pb, span)
        np.testing.assert_array_equal(got.numpy(), want)


def test_dense_every_row_in_range():
    """Every kept row lands in a bin of every tile's quantile column: the
    total is the kept count times T * Qc."""
    T, Pb, Qc, span, n = 3, 8, 2, 16, 4000
    rng = np.random.default_rng(7)
    qpk = rng.integers(0, Pb, n).astype(np.int32)
    leaf = rng.integers(0, span, n).astype(np.int32)
    kept = rng.random(n) < 0.5
    starts = np.zeros((T, Pb, Qc), np.int32)
    starts[1:] = -5  # leaves 0..15 sit at offsets 5..20: 11 in range
    got = _plain(qpk, leaf, kept, starts, np.zeros(T, np.int32), Pb, span)
    assert int(got[0].sum()) == int(kept.sum()) * Qc
    want = np.asarray(je._subtree_counts_multi(
        *(jnp.asarray(x) for x in (qpk, leaf, kept, starts,
                                   np.zeros(T, np.int32))), Pb, span))
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_takes_plain_adds_into_out_and_counts_nothing():
    qpk, leaf, kept, starts, offsets = (
        torch.from_numpy(x) for x in _case(3, 8, 2, 16, seed=4))
    before = dict(hist.LAUNCHES)
    got = hist.subtree_counts_multi(qpk, leaf, kept, starts, offsets, 8, 16)
    want = hist.subtree_counts_multi_plain(qpk, leaf, kept, starts, offsets,
                                           8, 16)
    assert torch.equal(got, want)
    out = torch.full_like(want, 3)
    assert hist.subtree_counts_multi(qpk, leaf, kept, starts, offsets, 8, 16,
                                     out=out) is out
    assert torch.equal(out, want + 3)
    # ``te._subtree_counts_multi`` hands the wrapper contiguous int32
    # arguments.
    assert torch.equal(te._subtree_counts_multi(
        qpk, leaf, kept, starts.to(torch.int64), offsets, 8, 16), want)
    assert hist.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype_qpk", "dtype_kept", "rank_starts",
                                 "block", "offsets", "rows", "span",
                                 "out_shape", "strided"])
def test_wrapper_rejects_bad_arguments(bad):
    n, T, Pb, Qc, span = 10, 2, 4, 3, 16
    qpk = torch.zeros(n, dtype=torch.int32)
    leaf = torch.zeros(n, dtype=torch.int32)
    kept = torch.ones(n, dtype=torch.bool)
    starts = torch.zeros(T, Pb, Qc, dtype=torch.int32)
    offsets = torch.zeros(T, dtype=torch.int32)
    out = None
    if bad == "dtype_qpk":
        qpk = qpk.to(torch.int64)
    elif bad == "dtype_kept":
        kept = kept.to(torch.int32)
    elif bad == "rank_starts":
        starts = starts[0]
    elif bad == "block":
        Pb = 5
    elif bad == "offsets":
        offsets = offsets[:1]
    elif bad == "rows":
        leaf = leaf[:9]
    elif bad == "span":
        span = 0
    elif bad == "out_shape":
        out = torch.zeros(T, Pb, Qc, span + 1, dtype=torch.int32)
    else:
        qpk = torch.zeros(2 * n, dtype=torch.int32)[::2]
    with pytest.raises((TypeError, ValueError)):
        hist.subtree_counts_multi(qpk, leaf, kept, starts, offsets, Pb, span,
                                  out=out)


@pytest.mark.cuda
@pytest.mark.parametrize("T,Pb,Qc,span", CASES)
def test_cuda_kernel_matches_plain(T, Pb, Qc, span):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    args = [torch.from_numpy(x).cuda() for x in _case(T, Pb, Qc, span)]
    before = hist.LAUNCHES["subtree_counts_multi"]
    got = hist.subtree_counts_multi(*args, Pb, span)
    torch.cuda.synchronize()
    assert hist.LAUNCHES["subtree_counts_multi"] == before + 1
    want = hist.subtree_counts_multi_plain(*args, Pb, span)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("unit,k", [("bytes", 0), ("bytes", 1),
                                    ("bytes", 2), ("bytes", 3),
                                    ("rows", 1), ("rows", 2), ("rows", 3)])
@pytest.mark.parametrize("name", EDGES)
def test_cuda_kernel_on_edges_views_and_out(name, unit, k):
    """The count pass's edges as views 0, 4, 8 and 12 bytes past a
    16-byte boundary, fresh (the zero pass) and added into (``out=``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    (T, Pb, Qc, span), args = _edge(name)
    args = [torch.from_numpy(x).cuda() for x in args]
    want = hist.subtree_counts_multi_plain(*args, Pb, span)
    views = _views(args, k, unit)
    got = hist.subtree_counts_multi(*views, Pb, span)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    acc = want + 7
    assert hist.subtree_counts_multi(*views, Pb, span, out=acc) is acc
    np.testing.assert_array_equal(acc.cpu().numpy(),
                                  (2 * want + 7).cpu().numpy())
