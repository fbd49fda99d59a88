"""The ordered keyed float32 sums of the utility-analysis sweep
(``pipelinedp_tpu_torch/ops/kernels/segkeyed.py``, kernel K5).

On the CPU: first the contract on XLA itself: ``jax.ops.segment_sum`` of a
``[n, Cc, k]`` update folds every column of every key in row order from
+0.0 (the sequential fold in plain Python equals it on values whose sums
depend on the order, and another order would not); then the plain version,
fed the rows in ``key_layout``'s order, against ``jax.ops.segment_sum``
over the rows in row order, bit for bit, at the sweep's own call shapes
(``[n, Cc, 5]`` and ``[n, Cc, 3]`` over skewed keys) and on
``segkeyed.seam_layout``'s layouts; the zero-row argument (a fold over the
marker rows alone equals the fold over every row when the others are
+-0.0); a key without rows and a run of ``-0.0`` total +0.0;
``key_layout`` with and without ``keep`` and its work units; the
wrapper's checks; and a sweep with an ``inf``, a ``nan`` and a huge SUM
bound, where the layout keeps every row, against ``jax_sweep`` bit for
bit. On the card (``cuda`` marker): the CUDA kernel against the plain
version, bit for bit, on the same layouts, compacted, and as a view one
element in (an unaligned base).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pipelinedp_tpu as pdp
from pipelinedp_tpu import analysis as jan
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pt
from pipelinedp_tpu_torch import analysis as tan
from pipelinedp_tpu_torch.ops.kernels import segkeyed


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _jax_sums(values, keys, P, k):
    """``jax.ops.segment_sum`` of ``values`` [n, W] seen as [n, W/k, k],
    as the sweep calls it, flattened back to [P, W]."""
    n, W = values.shape
    upd = jnp.asarray(values.reshape(n, W // k, k))
    out = jax.ops.segment_sum(upd, jnp.asarray(keys), num_segments=P)
    return np.asarray(out).reshape(P, W)


def _fold(values, keys, P):
    """A float32 left fold per key and column in plain Python."""
    out = np.zeros((P, values.shape[1]), np.float32)
    with np.errstate(over="ignore"):
        for r in range(values.shape[0]):
            out[keys[r]] = (out[keys[r]] + values[r]).astype(np.float32)
    return out


def _ordered(values, keys, P, keep=None):
    """(layout, the rows of ``values`` in its order) as torch tensors."""
    layout = segkeyed.key_layout(
        torch.from_numpy(keys), P,
        None if keep is None else torch.from_numpy(keep))
    return layout, torch.from_numpy(values).index_select(0, layout.order)


def _plain(values, keys, P, keep=None):
    layout, ordered = _ordered(values, keys, P, keep)
    return segkeyed.segmented_sums_plain(ordered, layout).numpy()


def _width_split(W):
    return 5 if W % 5 == 0 else 3


def test_order_claim_xla_cpu_folds_columns_in_row_order():
    """The ported contract: XLA's CPU scatter adds a [n, Cc, k] update
    row after row into every (key, column) from +0.0, so the sequential
    fold equals it; the same rows in reverse order would not."""
    values, keys, P = segkeyed.seam_layout("odd_width", order_sensitive=True)
    ref = _jax_sums(values, keys, P, 5)
    np.testing.assert_array_equal(_bits(ref), _bits(_fold(values, keys, P)))
    rev = _fold(values[::-1].copy(), keys[::-1].copy(), P)
    assert np.count_nonzero(_bits(rev) != _bits(ref)) > 100


@pytest.mark.parametrize("order_sensitive", [False, True])
@pytest.mark.parametrize("name", segkeyed.SEAM_LAYOUTS)
def test_plain_matches_jax_on_seam_layouts(name, order_sensitive):
    values, keys, P = segkeyed.seam_layout(name, order_sensitive)
    ref = _jax_sums(values, keys, P, _width_split(values.shape[1]))
    np.testing.assert_array_equal(_bits(_plain(values, keys, P)),
                                  _bits(ref))


@pytest.mark.parametrize("k", [5, 3])
def test_plain_matches_jax_at_sweep_shapes(k):
    """The sweep's stacks: [n, Cc, 5] per metric and [n, Cc, 3] moments,
    keyed by zipf-skewed partitions over a power-of-two P with empty
    keys."""
    rng = np.random.default_rng(7 + k)
    n, Cc, P = 3000, 6, 64
    keys = (rng.zipf(1.3, n) % 40).astype(np.int32)
    values = (rng.standard_normal((n, Cc * k)) *
              rng.choice([1e-3, 1.0, 1e4], (n, 1))).astype(np.float32)
    ref = _jax_sums(values, keys, P, k)
    np.testing.assert_array_equal(_bits(_plain(values, keys, P)),
                                  _bits(ref))


def _zero_row_case(k):
    """A sweep-shaped stack whose rows outside ``marker`` are +-0.0:
    order-sensitive values on the marker rows over zipf-skewed keys, one
    key without a marker row, and key 0 whose total cancels exactly to 0
    (1.0, then -1.0) with -0.0 and +0.0 rows before, between and after."""
    rng = np.random.default_rng(90 + k)
    n, Cc, P = 2400, 4, 32
    keys = (rng.zipf(1.3, n) % 24 + 1).astype(np.int32)
    keys[keys == 7] = 8  # key 7: rows outside marker only, added below
    marker = rng.random(n) < 0.45
    values = segkeyed._order_values(n, Cc * k, rng)
    signs = rng.choice(np.float32([0.0, -0.0]), (n, Cc * k))
    values = np.where(marker[:, None], values, signs).astype(np.float32)
    cancel = np.float32([[-0.0], [1.0], [-0.0], [0.0], [-1.0], [-0.0],
                         [0.0], [-0.0]]) * np.ones((1, Cc * k), np.float32)
    cancel_marker = np.array([0, 1, 0, 0, 1, 0, 0, 0], bool)
    empty = np.full((3, Cc * k), -0.0, np.float32)
    at = np.sort(rng.choice(n, 8 + 3, replace=False))
    values = np.insert(values, at, np.concatenate([cancel, empty]), axis=0)
    keys = np.insert(keys, at, np.int32([0] * 8 + [7] * 3))
    marker = np.insert(marker, at, np.concatenate([cancel_marker,
                                                   np.zeros(3, bool)]))
    return values, keys, marker, P


@pytest.mark.parametrize("k", [5, 3])
def test_zero_rows_dropped_keep_every_bit(k):
    """The fold over the marker rows alone (``key_layout(keep=marker)``)
    equals ``jax.ops.segment_sum`` over every row, bit for bit: rows
    outside the marker are +-0.0, a fold from +0.0 never holds -0.0, and
    key 0's exact cancellation stays +0.0 through the zero rows after it."""
    values, keys, marker, P = _zero_row_case(k)
    ref = _jax_sums(values, keys, P, k)
    got = _plain(values, keys, P, keep=marker)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    assert _bits(ref[0]).tolist() == [0] * values.shape[1]  # +0.0
    assert _bits(ref[7]).tolist() == [0] * values.shape[1]
    assert np.count_nonzero(~marker) > values.shape[0] // 3


def test_empty_key_and_negative_zeros_total_plus_zero():
    keys = np.array([1, 1, 3], np.int32)
    values = np.array([[-0.0, 2.0], [-0.0, -2.0], [-0.0, 1.0]], np.float32)
    out = _plain(values, keys, 4)
    ref = _jax_sums(values, keys, 4, 2)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert not np.signbit(out).any()  # +0.0 start: -0.0 rows give +0.0


def test_key_layout_is_a_stable_order():
    keys = torch.tensor([2, 0, 2, 1, 0, 2], dtype=torch.int32)
    layout = segkeyed.key_layout(keys, 4)
    assert layout.order.tolist() == [1, 4, 3, 0, 2, 5]
    assert layout.offsets.tolist() == [0, 2, 3, 6, 6]
    assert layout.walk.tolist() == [2, 0, 1, 3]
    assert layout.walk.dtype == torch.int32
    assert layout.P == 4
    with pytest.raises(ValueError):
        segkeyed.key_layout(keys, 2)
    with pytest.raises(ValueError):
        segkeyed.key_layout(-keys, 4)
    with pytest.raises(TypeError):
        segkeyed.key_layout(keys.long(), 4)


def test_key_layout_keep_is_stable_and_compact():
    """``keep`` drops rows; the kept ones stay in row order within each
    key, the offsets count kept rows only, and the walk orders keys by
    kept rows, longest first, ties by key."""
    rng = np.random.default_rng(5)
    n, P = 5000, 64
    keys = (rng.zipf(1.4, n) % 50).astype(np.int32)
    keep = rng.random(n) < 0.6
    layout = segkeyed.key_layout(torch.from_numpy(keys), P,
                                 torch.from_numpy(keep))
    order = layout.order.numpy()
    assert order.dtype == np.int64
    kept_rows = np.flatnonzero(keep)
    want = kept_rows[np.argsort(keys[kept_rows], kind="stable")]
    np.testing.assert_array_equal(order, want)
    lens = np.bincount(keys[keep], minlength=P)
    np.testing.assert_array_equal(np.diff(layout.offsets.numpy()), lens)
    np.testing.assert_array_equal(layout.walk.numpy(),
                                  np.argsort(-lens, kind="stable"))
    with pytest.raises(TypeError):
        segkeyed.key_layout(torch.from_numpy(keys), P,
                            torch.from_numpy(keep.astype(np.int32)))
    none_kept = segkeyed.key_layout(torch.from_numpy(keys), P,
                                    torch.zeros(n, dtype=torch.bool))
    assert none_kept.order.numel() == 0
    out = segkeyed.segmented_sums(torch.zeros(0, 7), none_kept)
    assert out.shape == (P, 7) and not out.bool().any()


@pytest.mark.parametrize("W,tiled", [(1, False), (3, False), (5, False),
                                     (31, False), (32, False), (33, False),
                                     (645, False), (660, False), (32, True),
                                     (36, True), (396, True), (660, True)])
def test_work_units_walk_longest_first_and_cover_once(W, tiled):
    """Each (key, column) of the [P, W] totals is in exactly one unit,
    and the units come longest first: a unit's longest key never exceeds
    the one before's. A tiled unit holds one key's 32-column tile."""
    rng = np.random.default_rng(W)
    P = 48
    keys = (rng.zipf(1.3, 4000) % 40).astype(np.int32)
    layout = segkeyed.key_layout(torch.from_numpy(keys), P)
    units = segkeyed.work_units(layout, W, tiled)
    n_units = P * -(-W // 32) if tiled else -(-P * W // 32)
    assert units.shape == (n_units, 32, 2)
    pairs = units.reshape(-1, 2)
    live = pairs[pairs[:, 0] >= 0]
    assert len(live) == P * W
    assert len({tuple(p) for p in live.tolist()}) == P * W
    assert (pairs[pairs[:, 0] < 0] == -1).all()
    lens = np.diff(layout.offsets.numpy())
    longest = np.where(units[..., 0] >= 0,
                       lens[np.maximum(units[..., 0], 0)], -1).max(1)
    assert (np.diff(longest) <= 0).all()
    if tiled:
        for u in units:
            assert len(set(u[u[:, 0] >= 0, 0].tolist())) == 1
            assert u[0, 1] % 32 == 0
    elif W < 32:  # several keys to a unit: only the last unit idles
        assert (units[:-1, :, 0] >= 0).all()
        assert len(set(units[0, :, 0].tolist())) == -(-32 // W)


def test_takes_tiles_rule():
    B = segkeyed.BOX_ROWS
    assert segkeyed.takes_tiles(B, 660, 1 << 20)
    assert segkeyed.takes_tiles(B, 32, 16)
    assert not segkeyed.takes_tiles(B - 1, 660, 1 << 20)  # under one box
    assert not segkeyed.takes_tiles(B, 645, 1 << 20)  # 4-byte rows
    assert not segkeyed.takes_tiles(B, 28, 1 << 20)  # under 32 columns
    assert not segkeyed.takes_tiles(B, 660, (1 << 20) + 4)  # unaligned


def test_wrapper_checks_and_cpu_dispatch():
    keys = torch.tensor([0, 1, 1], dtype=torch.int32)
    layout = segkeyed.key_layout(keys, 2)
    segkeyed.reset_launches()
    out = segkeyed.segmented_sums(torch.ones(3, 4), layout)
    assert out.tolist() == [[1.0] * 4, [2.0] * 4]
    assert segkeyed.LAUNCHES["segmented_sums"] == 0  # the plain version
    with pytest.raises(TypeError):
        segkeyed.segmented_sums(torch.ones(3, 4, dtype=torch.float64),
                                layout)
    with pytest.raises(ValueError):
        segkeyed.segmented_sums(torch.ones(4, 4), layout)
    with pytest.raises(ValueError):
        segkeyed.segmented_sums(torch.ones(4, 3).t(), layout)


def _sweep(amod, pmod, backend, cols, sum_bounds):
    opts = amod.UtilityAnalysisOptions(
        epsilon=1.0, delta=1e-6,
        aggregate_params=pmod.AggregateParams(
            metrics=[pmod.Metrics.SUM, pmod.Metrics.COUNT],
            max_partitions_contributed=2, max_contributions_per_partition=2,
            min_sum_per_partition=sum_bounds[0],
            max_sum_per_partition=sum_bounds[1]),
        multi_param_configuration=amod.MultiParameterConfiguration(
            max_partitions_contributed=[1, 3],
            max_contributions_per_partition=[1, 2]))
    out = amod.perform_utility_analysis(pmod.ArrayDataset(*cols), backend,
                                        opts, pmod.DataExtractors())
    return list(out)[0]


def _float_bits(x):
    """A result's float fields, each by its float64 bits, every NaN as one
    NaN: which NaN's payload an operation passes on follows the order of
    its operands in the machine code (and the card's NaNs carry none), so
    payloads are no part of either package's result."""
    out = []
    for m in x:
        for f in ("sum_metrics", "count_metrics",
                  "partition_selection_metrics"):
            for v in vars(getattr(m, f)).values():
                if isinstance(v, (float, list)):
                    out.append(np.asarray(v, np.float64).view(np.uint64))
    bits = np.concatenate([np.atleast_1d(v) for v in out])
    return np.where(np.isnan(bits.view(np.float64)),
                    np.float64(np.nan).view(np.uint64), bits)


@pytest.mark.parametrize("case", ["inf", "nan", "huge_bound"])
def test_sweep_keeps_every_row_past_the_zero_row_limit(case, monkeypatch):
    """A SUM value that is infinite or NaN (on rows whose pairs have more
    than one row), or a SUM bound whose square overflows, makes a product
    on the rows outside the marker NaN, which the JAX package's fold
    carries: the layout then keeps every row, and the sweep equals
    ``jax_sweep`` bit for bit (NaN for NaN)."""
    rng = np.random.default_rng(12)
    n = 1500
    pid = rng.integers(0, 60, n)
    pk = rng.integers(0, 6, n)
    values = rng.uniform(0, 5, n)
    # Bounds of 2e19 clip every value to 2e19, whose square overflows.
    bounds = (2e19, 3e19) if case == "huge_bound" else (0.0, 8.0)
    if case != "huge_bound":
        # A (user, partition) pair of several rows: its total is non-finite
        # on each of them.
        pair = (pid == pid[0]) & (pk == pk[0])
        assert pair.sum() > 1
        values[np.flatnonzero(pair)[-1]] = np.inf if case == "inf" else np.nan
    cols = (pid, pk, values)
    keeps = []
    real = segkeyed.key_layout

    def spy(keys, P, keep=None):
        keeps.append(keep)
        return real(keys, P, keep)
    monkeypatch.setattr(segkeyed, "key_layout", spy)
    port = _sweep(tan, pt, pt.TorchBackend(device="cpu"), cols, bounds)
    assert keeps == [None]
    ref = _sweep(jan, pdp, JaxBackend(), cols, bounds)
    np.testing.assert_array_equal(_float_bits(port), _float_bits(ref))
    assert not np.isfinite(_float_bits(port).view(np.float64)).all()


def test_finite_sweep_folds_marker_rows_only(monkeypatch):
    keeps = []
    real = segkeyed.key_layout

    def spy(keys, P, keep=None):
        keeps.append(keep)
        return real(keys, P, keep)
    monkeypatch.setattr(segkeyed, "key_layout", spy)
    rng = np.random.default_rng(13)
    cols = (rng.integers(0, 60, 1500), rng.integers(0, 6, 1500),
            rng.uniform(0, 5, 1500))
    _sweep(tan, pt, pt.TorchBackend(device="cpu"), cols, (0.0, 8.0))
    assert len(keeps) == 1 and keeps[0] is not None
    assert 0 < int(keeps[0].sum()) < 1500


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("K5 is a CUDA kernel; this host has no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("order_sensitive", [False, True])
@pytest.mark.parametrize("name", segkeyed.SEAM_LAYOUTS)
def test_cuda_kernel_matches_plain(name, order_sensitive):
    _cuda_or_skip()
    values, keys, P = segkeyed.seam_layout(name, order_sensitive)
    layout, ordered = _ordered(values, keys, P)
    dev = segkeyed.KeyLayout(layout.order.cuda(), layout.offsets.cuda(),
                             layout.walk.cuda(), P)
    got = segkeyed.segmented_sums(ordered.cuda(), dev)
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(_plain(values, keys, P)))
    # The same rows one float into a buffer: an unaligned base.
    buf = torch.empty(ordered.numel() + 1, device="cuda")
    view = buf[1:].view(ordered.shape)
    view.copy_(ordered.cuda())
    got = segkeyed.segmented_sums(view, dev)
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(_plain(values, keys, P)))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [5, 3])
def test_cuda_kernel_zero_rows_dropped(k):
    _cuda_or_skip()
    values, keys, marker, P = _zero_row_case(k)
    layout = segkeyed.key_layout(torch.from_numpy(keys).cuda(), P,
                                 torch.from_numpy(marker).cuda())
    ordered = torch.from_numpy(values).cuda().index_select(0, layout.order)
    got = segkeyed.segmented_sums(ordered, layout)
    np.testing.assert_array_equal(_bits(got.cpu().numpy()),
                                  _bits(_jax_sums(values, keys, P, k)))
