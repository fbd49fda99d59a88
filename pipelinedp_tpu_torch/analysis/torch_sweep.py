"""The utility-analysis sweep on a CUDA device: the port of
``pipelinedp_tpu/analysis/jax_sweep.py``, held to it bit for bit on the
CPU.

The reference's multi-configuration analysis with a configuration axis:

    stage A (once):   sort rows by (pid, pk) -> per-(pid, pk) user stats
                      (count, sum) and per-pid partition fan-out, in row
                      space (one sort, K4 for the ordered segment sums).
    stage B (per      broadcast user stats against [Cc] config vectors:
    config chunk):    clip errors, L0 drop moments, per-user keep
                      probabilities -> per-(partition, config) error
                      model through K5, the ordered keyed float32 sum.
    stage C (fused    P(partition kept) from Poisson-binomial moments
    with B):          (refined-normal window, Gauss-Hermite quadrature,
                      point), error quantiles (closed-form Gaussian /
                      interpolated Laplace+Gaussian table), then the
                      cross-partition fixed halving trees.
    host:             normalize and pack AggregateMetrics.

Every float32 operation is the JAX package's, in its order: XLA's CPU
transcendentals come from ``ops/xla_math.py``, each ``a * b + c`` that
XLA's code generator contracts into one FMA goes through ``fma32``, the
reductions over partitions and over the window are the same fixed halving
trees, and the keyed sums add in row order. So walked (one config per
chunk) and batched sweeps are bit-identical, the CPU and the card agree
bit for bit, and on the CPU the port equals ``jax_sweep``.

Per-partition rows past ``_PP_BYTE_CAP`` run the host analysis graph on
the sweep's backend, as the JAX package's do. The chunk width is the
``sweep_config_batch`` knob, else the static widest-in-budget width, which
a fitted plan's measured sweep peak rescales (``_plan_chunk``). Not ported
here: the TPU lane alignment of the JAX package (``_lane_align``) and its
compile cache.

On a mesh (``parallel.make_mesh``) every rank runs stage A on all rows
(K4), then each chunk's configuration axis splits over the ranks: the
rank at position ``d`` runs the chunk's ``d``-th slice of ``chunk / n``
configs (K5 on its slice) and one all-gather per output field gives every
rank the whole chunk, the JAX package's multi-process branch. Each
configuration's outputs are a pure function of (data, config), so the
mesh equals one device bit for bit.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import dp_computations, obs
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams,
                                                   MechanismType, Metrics,
                                                   NoiseKind,
                                                   PartitionSelectionStrategy)
from pipelinedp_tpu_torch.analysis import data_structures
from pipelinedp_tpu_torch.analysis import metrics as am
from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch.plan import knobs
from pipelinedp_tpu_torch.ops import partition_selection as ps_ops
from pipelinedp_tpu_torch.ops import segment as seg_ops
from pipelinedp_tpu_torch.ops import xla_math as xm
from pipelinedp_tpu_torch.ops.kernels import segkeyed, segsum, segtotal
from pipelinedp_tpu_torch.torch_engine import _pad_pow2, encode, put_on_device

# Error quantile levels, as the reference's utility analysis fixes them.
ERROR_QUANTILES = (0.1, 0.5, 0.9, 0.99)
# Integer window half-width of the refined-normal keep-probability sum.
_WINDOW = 64
# Gauss-Hermite order for the large-sigma / thresholding quadrature.
_GH_ORDER = 32
# Truncated-geometric tables are clamped to this many entries per config.
_MAX_TABLE = 1 << 16
# Upper bound on configurations per chunk (tests shrink it to exercise the
# chunk loop).
_CHUNK_CAP = 512
# Row-broadcast budget per chunk: n_pad * chunk <= this.
_CHUNK_ROW_BUDGET = 1 << 26
# Byte budget of the per-partition [P, C] blocks; past it the sweep runs
# the host analysis graph instead (the same rows, at Python speed).
_PP_BYTE_CAP = 256 << 20
#: The ``sweep_config_batch`` knob's seam and variable: > 0 pins the chunk
#: width (1 is the walked mode), 0 sizes it.
_SWEEP_CONFIG_BATCH = 0
_CONFIG_BATCH_ENV = knobs.BY_NAME["sweep_config_batch"].env_var
#: Device byte budget the model-fitted chunk sizing targets: the float32
#: byte equivalent of the static element budgets (2^28 elements x 4).
_SWEEP_HBM_BUDGET = 1 << 30
# While every SUM value outside the marker rows and every SUM bound lies
# within this magnitude, K5's stacks are +-0.0 on those rows (see
# ``_k5_rows``).
_ZERO_ROW_LIMIT = 2.0**62

_MIXED = "mixed"  # static sentinel: per-config mechanisms in this chunk


def _f32(v: float) -> float:
    return float(np.float32(v))


def _pad_rows(n: int) -> int:
    """The JAX package's row padding (the next multiple of 8192). The port
    pads no rows, but the chunk width's row budget is taken over this
    count, so both packages chunk alike."""
    return max(8192, -(-n // 8192) * 8192)


def sweep_is_supported(options: data_structures.UtilityAnalysisOptions,
                       data_extractors, return_per_partition: bool) -> bool:
    """The JAX package's gates of the fused path; what fails them runs the
    host analysis graph, in both packages."""
    params = options.aggregate_params
    if (params.max_partitions_contributed is None or
            params.max_contributions_per_partition is None):
        return False
    multi = options.multi_param_configuration
    if Metrics.SUM in params.metrics:
        has_base = (params.min_sum_per_partition is not None and
                    params.max_sum_per_partition is not None)
        has_multi = (multi is not None and
                     multi.min_sum_per_partition is not None)
        if not (has_base or has_multi):
            return False
    return True


# ---------------------------------------------------------------------------
# Host-side per-config parameter vectors
# ---------------------------------------------------------------------------


def _config_vectors(
        options) -> Tuple[Dict[str, np.ndarray], List[AggregateParams]]:
    """[C] vectors of the swept parameters."""
    all_params = list(data_structures.get_aggregate_params(options))
    return {
        "l0": np.asarray([p.max_partitions_contributed for p in all_params],
                         np.float32),
        "linf": np.asarray(
            [p.max_contributions_per_partition or 0 for p in all_params],
            np.float32),
        "min_sum": np.asarray(
            [p.min_sum_per_partition
             if p.min_sum_per_partition is not None else 0.0
             for p in all_params], np.float32),
        "max_sum": np.asarray(
            [p.max_sum_per_partition
             if p.max_sum_per_partition is not None else 0.0
             for p in all_params], np.float32),
    }, all_params


def _noise_stds(metric, all_params, budgets) -> np.ndarray:
    """Per-config noise std of the released metric, [C]: the reference's
    analysis combiners predict every metric's noise through
    ``compute_dp_count_noise_std`` with linf = the config's
    ``max_contributions_per_partition`` (a parity quirk both packages
    keep)."""
    spec = budgets[metric]
    out = []
    for p in all_params:
        params = dp_computations.ScalarNoiseParams(
            eps=spec.eps, delta=spec.delta,
            min_value=0.0,
            max_value=float(p.max_contributions_per_partition),
            min_sum_per_partition=None, max_sum_per_partition=None,
            max_partitions_contributed=p.max_partitions_contributed,
            max_contributions_per_partition=(
                p.max_contributions_per_partition),
            noise_kind=p.noise_kind)
        out.append(dp_computations.compute_dp_count_noise_std(params))
    return np.asarray(out, np.float32)


def _selection_tables(all_params, eps, delta) -> Tuple[np.ndarray, ...]:
    """Per-config keep-probability inputs: a [C, T] truncated-geometric
    table (row-padded with its last value; all ones for thresholding
    configs), threshold[C] and scale[C] (dummies for table configs)."""
    tables, thr, scale = [], [], []
    for p in all_params:
        strat = p.partition_selection_strategy
        s = ps_ops.create_partition_selection_strategy(
            strat, eps, delta, p.max_partitions_contributed)
        if strat == PartitionSelectionStrategy.TRUNCATED_GEOMETRIC:
            tables.append(s.keep_table[:_MAX_TABLE])
            thr.append(0.0)
            scale.append(1.0)
        else:
            tables.append(np.ones(1, np.float32))
            thr.append(s.threshold)
            scale.append(s.noise_scale if strat ==
                         PartitionSelectionStrategy.LAPLACE_THRESHOLDING
                         else s.noise_stddev)
    T = max(len(t) for t in tables)
    out = np.ones((len(tables), T), np.float32)
    for i, t in enumerate(tables):
        out[i, :len(t)] = t
        out[i, len(t):] = t[-1] if len(t) else 1.0
    return out, np.asarray(thr, np.float32), np.asarray(scale, np.float32)


@functools.lru_cache(maxsize=4)
def _laplace_gauss_table(quantiles: Tuple[float, ...],
                         n_r: int = 48) -> Tuple[np.ndarray, np.ndarray]:
    """Quantiles t(r, q) of Lap(1) + r N(0,1) over a log grid of the noise
    ratio r: a fixed-seed Monte-Carlo table, the same in both packages."""
    rng = np.random.default_rng(0x5eed)
    lap = rng.laplace(size=400_000)
    gau = rng.normal(size=400_000)
    rs = np.geomspace(1e-3, 1e3, n_r)
    table = np.stack([
        np.quantile(lap + r * gau, quantiles) for r in rs
    ])  # [n_r, nq]
    return np.log(rs).astype(np.float32), table.astype(np.float32)


# ---------------------------------------------------------------------------
# Stage A: per-(pid, pk) user stats, one sort, row space
# ---------------------------------------------------------------------------


def _last_of_run(new_run: torch.Tensor) -> torch.Tensor:
    """``roll(new_run, -1)`` with the last row set: marks each run's last
    row."""
    last = torch.roll(new_run, -1)
    last[-1] = True
    return last


def _run_ends(new_run: torch.Tensor) -> torch.Tensor:
    """Per row, the index of the last row of its run."""
    n = new_run.shape[0]
    return n - 1 - torch.flip(
        seg_ops.run_starts(torch.flip(_last_of_run(new_run), (0,))), (0,))


def _sort_pid_pk(pid: torch.Tensor, pk: torch.Tensor) -> torch.Tensor:
    """``jnp.lexsort((pk, pid))``: rows by pid, then pk, ties by position
    (one stable sort of the packed int64 key; both ids are >= 0)."""
    return torch.sort((pid.long() << 32) | pk.long(), stable=True).indices


@costs.instrumented(phase="sweep")
def _preagg_kernel(pid, pk, values):
    """Dense per-row arrays where ``marker`` rows carry one (pid, pk)
    user-contribution record: (pk, count, sum, n_partitions of the pid).
    ``values`` float32 [n] (zeros when SUM is not analyzed). The
    per-segment sum is K4's ordered segment total."""
    n = pid.shape[0]
    if n == 0:
        empty = torch.zeros(0, dtype=torch.float32, device=pid.device)
        return (torch.zeros(0, dtype=torch.bool, device=pid.device),
                pk.contiguous(), empty, empty, empty)
    idx = torch.arange(n, device=pid.device)
    sort_idx = _sort_pid_pk(pid, pk)
    spid = pid[sort_idx]
    spk = pk[sort_idx]
    svalues = values[sort_idx].contiguous()

    new_pid = (idx == 0) | (spid != torch.roll(spid, 1))
    new_seg = new_pid | (spk != torch.roll(spk, 1))
    marker = new_seg

    seg_start = seg_ops.run_starts(new_seg)
    seg_end = _run_ends(new_seg)
    count_u = (seg_end - seg_start + 1).to(torch.float32)
    sum_u = segtotal.segment_totals(svalues, new_seg.contiguous())

    seg_in_pid = seg_ops.run_ordinal_in_group(new_seg, new_pid)
    npart_u = (seg_in_pid[_run_ends(new_pid)] + 1).to(torch.float32)
    return marker, spk.contiguous(), count_u, sum_u, npart_u


# ---------------------------------------------------------------------------
# Stage B+C: per-config error model + cross-partition reduction
# ---------------------------------------------------------------------------


def _fold_partitions(a: torch.Tensor) -> torch.Tensor:
    """Sum over the leading (partition) axis with the JAX package's fixed
    halving tree: each stage adds the upper half onto the lower half, an
    odd stage carries its last row, so the rounding is a function of P
    alone, never of the config-axis width."""
    while a.shape[0] > 1:
        n = a.shape[0]
        half = n // 2
        front = a[:half] + a[half:2 * half]
        a = front if n % 2 == 0 else torch.cat([front, a[2 * half:]], 0)
    return a[0]


def _fold_last(a: torch.Tensor) -> torch.Tensor:
    """``_fold_partitions`` over the trailing axis."""
    while a.shape[-1] > 1:
        n = a.shape[-1]
        half = n // 2
        front = a[..., :half] + a[..., half:2 * half]
        a = (front if n % 2 == 0 else
             torch.cat([front, a[..., 2 * half:]], -1))
    return a[..., 0]


def _table_lookup(table, ii):
    """table: [Cc, T]; ii: int64 [P, Cc, K] -> [P, Cc, K]."""
    Cc = table.shape[0]
    cfg = torch.arange(Cc, device=table.device).view(1, Cc, 1)
    return table[cfg, ii]


_SQRT2 = _f32(math.sqrt(2.0))
_SIXTH = _f32(np.float32(1.0) / np.float32(6.0))
_INV_SQRT2 = _f32(np.float32(1.0) / np.float32(math.sqrt(2.0)))
_GH_NODES, _GH_WEIGHTS = np.polynomial.hermite.hermgauss(_GH_ORDER)


def _keep_probability(strategy, mu, var, m3, table, thr, scale, is_tg,
                      is_lap):
    """E[keep(N)] for N ~ Poisson-binomial with the given moments, over
    [P, Cc]: a refined-normal pmf with skewness over an integer window
    while sigma * 8 <= 64, Gauss-Hermite quadrature past it, the point
    value at sigma < 1e-9. ``strategy`` may be ``_MIXED``: each config
    then picks its keep curve through the ``is_tg`` / ``is_lap`` masks."""
    device = mu.device
    sigma = xm.sqrt(torch.clamp_min(var, 0.0))
    s = torch.clamp_min(sigma, 1e-30)
    skew = torch.where(sigma > 0, m3 / ((s * s) * s),
                       torch.zeros_like(m3))
    T = table.shape[-1]

    def tg_at(i):  # i: [P, Cc, K] float counts
        ii = torch.clamp(torch.round(i), 0, T - 1).long()
        return _table_lookup(table, ii)

    def lap_at(i):
        z = (i - thr[None, :, None]) / scale[None, :, None]
        return torch.where(z < 0, xm.ftz(0.5 * xm.exp(z)),
                           1.0 - 0.5 * xm.exp(-z))

    def gauss_at(i):
        z = (i - thr[None, :, None]) / scale[None, :, None]
        return xm.ndtr(z)

    if strategy == PartitionSelectionStrategy.TRUNCATED_GEOMETRIC:
        keep_at = tg_at
    elif strategy == PartitionSelectionStrategy.LAPLACE_THRESHOLDING:
        keep_at = lap_at
    elif strategy == _MIXED:
        def keep_at(i):
            return torch.where(
                is_tg[None, :, None], tg_at(i),
                torch.where(is_lap[None, :, None], lap_at(i), gauss_at(i)))
    else:
        keep_at = gauss_at

    # --- windowed refined normal (small sigma) ---
    rmu = torch.round(mu)[..., None]
    offsets = torch.arange(-_WINDOW, _WINDOW + 1, device=device,
                           dtype=torch.float32)
    centers = rmu + offsets  # [P, Cc, W]
    edge_offsets = torch.arange(-_WINDOW - 1, _WINDOW + 1, device=device,
                                dtype=torch.float32)
    z = ((rmu + edge_offsets) + 0.5 - mu[..., None]) / s[..., None]
    # refined cdf: ndtr(z) + skew (1 - z^2) pdf(z) / 6, clipped to [0, 1];
    # XLA contracts 1 - z z, and the add of the correction (whose division
    # by 6 it turns into a multiply by the float32 1/6) into one FMA each.
    corr = (skew[..., None] * xm.fma32(-z, z, 1.0)) * xm.norm_pdf(z)
    cdf_edges = torch.clamp(xm.fma32(corr, _SIXTH, xm.ndtr(z)), 0.0, 1.0)
    cdf_hi = cdf_edges[..., 1:]
    cdf_lo = cdf_edges[..., :-1]
    pmf = cdf_hi - cdf_lo
    pmf[..., 0] = cdf_hi[..., 0]
    pmf[..., -1] = 1.0 - cdf_lo[..., -1]
    pmf = torch.where(centers >= 0, pmf, torch.zeros_like(pmf))
    keep_c = keep_at(torch.clamp_min(centers, 0.0))
    # The fold of the 2 * WINDOW + 1 products carries the last one to its
    # final add, where XLA contracts that product into the add.
    win = xm.fma32(pmf[..., -1], keep_c[..., -1],
                   _fold_last(pmf[..., :-1] * keep_c[..., :-1]))

    # --- Gauss-Hermite (large sigma) ---
    nodes = torch.tensor(_GH_NODES, dtype=torch.float32, device=device)
    weights = torch.tensor(_GH_WEIGHTS / math.sqrt(math.pi),
                           dtype=torch.float32, device=device)
    xs = xm.fma32((sigma * _SQRT2)[..., None], nodes, mu[..., None])
    gh = _fold_last(weights * keep_at(torch.clamp_min(xs, 0.0)))

    point = keep_at(torch.clamp_min(rmu, 0.0))[..., 0]
    small = sigma * 8.0 <= _WINDOW
    return torch.clamp(torch.where(sigma < 1e-9, point,
                                   torch.where(small, win, gh)), 0.0, 1.0)


def _error_quantiles(noise_kind, exp_l0, var_l0, noise_std, noise_sq,
                     log_rs, t_table, ndtri_q, ppf_q, is_gauss=None):
    """Per-(partition, config, q) error quantiles of bounding + noise
    ([P, Cc, Q]). ``noise_kind=None`` is a mixed sweep: both closed forms,
    picked per config by the ``is_gauss`` [Cc] mask."""

    def gaussian_spread():
        return xm.sqrt(var_l0 + noise_sq)[..., None], ndtri_q

    def laplace_spread():
        b = noise_std * _INV_SQRT2
        r = xm.sqrt(torch.clamp_min(var_l0, 0.0)) / torch.clamp_min(b, 1e-30)
        logr = xm.xla_log(torch.clamp_min(r, 1e-6))
        t = xm.interp(logr, log_rs, t_table)  # [..., Q]
        # Beyond the grid the Gaussian term dominates: t ~ r ppf(q).
        t = torch.where((r > 900.0)[..., None], r[..., None] * ppf_q, t)
        return b[..., None], t

    e = exp_l0[..., None]
    if noise_kind is not None:
        scale, t = (gaussian_spread() if noise_kind == NoiseKind.GAUSSIAN
                    else laplace_spread())
        return xm.fma32(scale, t, e)  # exp_l0 + scale t, one FMA
    # Mixed noise kinds: XLA selects between the two products before the
    # add, so neither add is contracted.
    g_scale, g_t = gaussian_spread()
    l_scale, l_t = laplace_spread()
    return e + torch.where(is_gauss[None, :, None], g_scale * g_t,
                           l_scale * l_t)


def _metric_chunk(metric_name, x_u, marker, layout, p_u, bounds_lo,
                  bounds_hi, noise_std, noise_sq_row, noise_kind,
                  p_keep_pk, mask_pk, pseudo_mask_pk, consts,
                  is_gauss=None, per_partition=False):
    """Stage B+C for one metric over one config chunk: the [Cc] aggregate
    accumulator fields (and with ``per_partition`` the unreduced [P, Cc]
    blocks). The [n, Cc, 5] stack goes through K5 in the layout's key
    order."""
    Cc = bounds_lo.shape[0]
    n = x_u.shape[0]
    x = x_u[:, None]  # [n, 1]
    lo = bounds_lo[None, :]
    hi = bounds_hi[None, :]
    markerf = marker.to(torch.float32)[:, None]
    contribution = torch.minimum(torch.maximum(x, lo), hi)
    err = (contribution - x) * markerf
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    err_min = torch.where(x < lo, err, zero)
    err_max = torch.where(x > hi, err, zero)
    one_minus_p = 1.0 - p_u
    exp_l0_u = (-contribution * one_minus_p) * markerf
    var_l0_u = (((contribution * contribution) * p_u) * one_minus_p) * markerf
    x_m = torch.where(marker[:, None], x, zero).expand(n, Cc)

    cols = torch.stack([x_m, err_min, err_max, exp_l0_u, var_l0_u], dim=-1)
    per_pk = segkeyed.segmented_sums(cols.reshape(n, Cc * 5), layout)
    per_pk = per_pk.view(-1, Cc, 5)
    psum = per_pk[..., 0]
    e_min = per_pk[..., 1]
    e_max = per_pk[..., 2]
    exp_l0 = per_pk[..., 3]
    var_l0 = per_pk[..., 4]

    if pseudo_mask_pk is not None:
        # Empty public partitions: one (0, 0, 0) pseudo-user with clip
        # error clip(0, lo, hi) and keep probability 0.
        zc = torch.minimum(torch.maximum(zero, lo), hi)
        pm = pseudo_mask_pk[:, None]
        e_min = e_min + torch.where(0.0 < lo, zc, zero) * pm
        e_max = e_max + torch.where(0.0 > hi, zc, zero) * pm
        exp_l0 = exp_l0 + (-zc) * pm

    noise = noise_std[None, :]
    noise_sq = noise_sq_row[None, :]
    p_keep = p_keep_pk
    m = mask_pk[:, None]

    err_l0_expected = p_keep * exp_l0
    err_linf_min = p_keep * e_min
    err_linf_max = p_keep * e_max
    err_l0_var = p_keep * var_l0
    err_var = p_keep * (var_l0 + noise_sq)
    qs = _error_quantiles(noise_kind, exp_l0, var_l0,
                          noise.expand_as(exp_l0), noise_sq.expand_as(exp_l0),
                          consts["log_rs"], consts["t_table"],
                          consts["ndtri_q"], consts["ppf_q"], is_gauss)
    err_quant = p_keep[..., None] * (qs + (e_min + e_max)[..., None])
    # XLA contracts the first product into the add.
    err_w_dropped = xm.fma32(p_keep, (exp_l0 + e_min) + e_max,
                             (1 - p_keep) * -psum)

    abs_sum = torch.abs(psum)
    nz = abs_sum > 0
    one = torch.ones((), dtype=torch.float32, device=x.device)
    safe = torch.where(nz, abs_sum, one)
    safe_sq = torch.where(nz, psum * psum, one)

    def rel(a):
        return torch.where(nz, a / safe, zero)

    def relv(a):
        return torch.where(nz, a / safe_sq, zero)

    if metric_name == "sum":
        dropped_l0 = torch.zeros_like(exp_l0)
        dropped_linf = torch.zeros_like(e_max)
        dropped_sel = torch.zeros_like(psum)
    else:
        dropped_l0 = -exp_l0
        dropped_linf = -e_max
        dropped_sel = (1 - p_keep) * ((psum + exp_l0) + e_max)

    def S(a):  # sum over (masked) partitions -> [Cc]
        return _fold_partitions(a * m)

    def Sq(a):  # [P, Cc, Q] -> [Cc, Q]
        return _fold_partitions(a * m[..., None])

    pp = {}
    if per_partition:
        pp = {"pp_sum": psum, "pp_err_min": e_min, "pp_err_max": e_max,
              "pp_exp_l0": exp_l0, "pp_var_l0": var_l0}

    return {
        **pp,
        "num_partitions": _fold_partitions(m)[0] * torch.ones(
            Cc, device=x.device),
        "kept_partitions_expected": S(p_keep),
        "total_aggregate": S(psum),
        "data_dropped_l0": S(dropped_l0),
        "data_dropped_linf": S(dropped_linf),
        "data_dropped_partition_selection": S(dropped_sel),
        "error_l0_expected": S(err_l0_expected),
        "error_linf_min_expected": S(err_linf_min),
        "error_linf_max_expected": S(err_linf_max),
        "error_l0_variance": S(err_l0_var),
        "error_variance": S(err_var),
        "error_quantiles": Sq(err_quant),
        "rel_error_l0_expected": S(rel(err_l0_expected)),
        "rel_error_linf_min_expected": S(rel(err_linf_min)),
        "rel_error_linf_max_expected": S(rel(err_linf_max)),
        "rel_error_l0_variance": S(relv(err_l0_var)),
        "rel_error_variance": S(relv(err_var)),
        "rel_error_quantiles": Sq(
            torch.where(nz[..., None], err_quant / safe[..., None], zero)),
        "error_expected_w_dropped_partitions": S(err_w_dropped),
        "rel_error_expected_w_dropped_partitions": S(rel(err_w_dropped)),
    }


@costs.instrumented(phase="sweep")
def _sweep_chunk_body(metric_names, strategy, noise_kind, P, public,
                      chunk, start, marker, layout, count_u, sum_u,
                      npart_u, users_pk, cfg, consts, per_partition=False):
    """Stages B+C for one chunk of configurations: the chunk's ``chunk``
    configs at ``start`` of the (padded) config vectors in ``cfg``, all on
    the device."""
    sl = slice(start, start + chunk)
    l0, linf = cfg["l0"][sl], cfg["linf"][sl]
    min_sum, max_sum = cfg["min_sum"][sl], cfg["max_sum"][sl]
    noise_std_rows = cfg["noise_rows"][:, sl]
    table = cfg["table"][sl]
    thr, scale = cfg["thr"][sl], cfg["scale"][sl]
    is_tg, is_lap, is_gauss = (cfg["is_tg"][sl], cfg["is_lap"][sl],
                               cfg["is_gauss"][sl])
    markerf = marker.to(torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=marker.device)
    p_u = torch.where(npart_u[:, None] > 0,
                      torch.clamp_max(l0[None, :] /
                                      torch.clamp_min(npart_u, 1.0)[:, None],
                                      1.0),
                      zero) * markerf[:, None]  # [n, Cc]

    # users_pk carries -1 on padding partitions beyond the real vocab, so
    # "== 0" identifies genuinely empty (public) partitions only.
    mask_pk = (users_pk > 0) | (public & (users_pk == 0))
    pseudo_mask = ((users_pk == 0).to(torch.float32) if public else None)
    Cc = l0.shape[0]

    if strategy is None:
        p_keep_pk = torch.ones((P, Cc), device=marker.device)
        sel_stats = None
    else:
        one_minus_p = 1.0 - p_u
        var_u = p_u * one_minus_p
        mom = torch.stack([p_u, var_u, var_u * (1.0 - 2.0 * p_u)], dim=-1)
        n = p_u.shape[0]
        mom_pk = segkeyed.segmented_sums(mom.reshape(n, Cc * 3), layout)
        mom_pk = mom_pk.view(P, Cc, 3)
        p_keep_pk = _keep_probability(strategy, mom_pk[..., 0],
                                      mom_pk[..., 1], mom_pk[..., 2],
                                      table, thr, scale, is_tg, is_lap)
        p_keep_pk = torch.where(mask_pk[:, None], p_keep_pk, zero)
        mf = mask_pk.to(torch.float32)[:, None]
        sel_stats = {
            "num_partitions": (_fold_partitions(mf)[0] *
                               torch.ones(Cc, device=marker.device)),
            "keep_sum": _fold_partitions(p_keep_pk * mf),
            "keep_var": _fold_partitions(p_keep_pk * (1 - p_keep_pk) * mf),
        }

    out = {}
    for idx, name in enumerate(metric_names):
        if name == "sum":
            x_u = sum_u
            lo_b, hi_b = min_sum, max_sum
        elif name == "count":
            x_u = count_u
            lo_b, hi_b = torch.zeros_like(linf), linf
        else:  # privacy_id_count
            x_u = torch.clamp_max(count_u, 1.0)
            lo_b, hi_b = torch.zeros_like(linf), torch.ones_like(linf)
        # Rows [M:] of noise_std_rows carry the host-computed squares.
        out[name] = _metric_chunk(
            name, x_u, marker, layout, p_u, lo_b, hi_b,
            noise_std_rows[idx], noise_std_rows[len(metric_names) + idx],
            noise_kind, p_keep_pk, mask_pk.to(torch.float32), pseudo_mask,
            consts, is_gauss, per_partition=per_partition)
    if per_partition:
        out["_pp_keep"] = p_keep_pk
    return out, sel_stats


def _sharded_chunk(mesh, metric_names, strategy, noise_kind, P, public,
                   chunk, start, marker, layout, count_u, sum_u, npart_u,
                   users_pk, cfg, consts, per_partition):
    """One chunk over the mesh (``jax_sweep._sweep_chunk_sharded``): this
    rank runs its slice of ``chunk / n`` configs, and the outputs are
    gathered along the configuration axis (dim 1 of the [P, Cc]
    per-partition blocks), so every rank holds the whole chunk. Returns
    (out, sel, per-partition blocks or None)."""
    from pipelinedp_tpu_torch.parallel import sharded as psh
    local = chunk // mesh.size
    out, sel = _sweep_chunk_body(
        metric_names, strategy, noise_kind, P, public, local,
        start + mesh.index * local, marker, layout, count_u, sum_u, npart_u,
        users_pk, cfg, consts, per_partition=per_partition)
    pp = _split_pp(out, metric_names) if per_partition else None

    def gather(tree, dim, site):
        return {k: (gather(v, dim, f"{site}.{k}") if isinstance(v, dict)
                    else psh.gather_blocks(v, mesh, dim, f"{site}.{k}"))
                for k, v in sorted(tree.items())}

    out = gather(out, 0, "sweep.out")
    sel = gather(sel, 0, "sweep.sel") if sel is not None else None
    pp = gather(pp, 1, "sweep.pp") if pp is not None else None
    return out, sel, pp


#: The [P, Cc] per-partition blocks _metric_chunk emits (plus the
#: metric-independent "_pp_keep").
_PP_FIELDS = ("pp_sum", "pp_err_min", "pp_err_max", "pp_exp_l0",
              "pp_var_l0")


def _split_pp(out, metric_names):
    """Pops the per-partition blocks out of a chunk's output dict into the
    flat-keyed dict (``_pp_keep`` / ``<metric>.<field>``)."""
    pp = {"_pp_keep": out.pop("_pp_keep")}
    for nm in metric_names:
        for f in _PP_FIELDS:
            pp[f"{nm}.{f}"] = out[nm].pop(f)
    return pp


# ---------------------------------------------------------------------------
# Dataset histograms on the device (tuning input)
# ---------------------------------------------------------------------------

# Bin-id space of the 3-leading-digit binning: values <= 1000 are their
# own bin; each later decade d contributes 900 bins for n // 10^(d+1) in
# [100, 1000). 7 decades cover int32.
_HIST_DECADES = 7
_HIST_BINS = 1001 + _HIST_DECADES * 900


def _bin_ids(v: torch.Tensor) -> torch.Tensor:
    """Exact integer 3-leading-digit binning (host twin
    ``histograms._to_bin_lower``): dense bin ids of the same shape. The
    ``>=`` folds v == 10^k into decade k-2's first bin, whose lower edge
    (10^k) is the host's."""
    v = v.long()
    thresholds = torch.tensor([10**(3 + j) for j in range(_HIST_DECADES)],
                              dtype=torch.int64, device=v.device)
    e = torch.sum(v[..., None] >= thresholds, dim=-1)
    rb = torch.tensor([10**j for j in range(_HIST_DECADES + 1)],
                      dtype=torch.int64, device=v.device)[e]
    lead = v // rb  # in [100, 1000) for e >= 1
    return torch.where(e == 0, v, 1001 + (e - 1) * 900 + lead - 100)


def _bin_lower_of_id(ids: np.ndarray) -> np.ndarray:
    """Host inverse of _bin_ids: dense bin id -> bin lower edge."""
    ids = np.asarray(ids, np.int64)
    d = np.maximum((ids - 1001) // 900, 0)
    m = (ids - 1001) % 900 + 100
    return np.where(ids <= 1000, ids, m * 10**(d + 1))


def _bin_stats(v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(count, sum, max) per dense bin over masked int32 values,
    ``[BINS, 3]`` int32. Count and sum are K1's exact int32 keyed sums
    (every histogram's total is bounded by the row count); the max is a
    ``scatter_reduce``."""
    ids = torch.where(mask, _bin_ids(v),
                      torch.full_like(v, _HIST_BINS, dtype=torch.int64))
    ids = ids.to(torch.int32).contiguous()
    cols = torch.stack([mask.to(torch.int32),
                        torch.where(mask, v, torch.zeros_like(v))], dim=1)
    cnt_tot = segsum.segment_sum_lanes(cols.to(torch.int32).contiguous(), ids,
                                       _HIST_BINS + 1)
    mx = torch.full((_HIST_BINS + 1,), -1, dtype=torch.int32,
                    device=v.device)
    mx.scatter_reduce_(0, ids.long(),
                       torch.where(mask, v, torch.full_like(v, -1)).to(
                           torch.int32), "amax")
    return torch.cat([cnt_tot, mx[:, None]], dim=1)[:_HIST_BINS]


@costs.instrumented(phase="sweep")
def _histogram_kernel(P, pid, pk):
    """All four tuning histograms (host graph twin:
    ``histograms.compute_dataset_histograms``), ``[4, BINS, 3]``."""
    n = pid.shape[0]
    idx = torch.arange(n, device=pid.device)
    sort_idx = _sort_pid_pk(pid, pk)
    spid = pid[sort_idx]
    spk = pk[sort_idx]
    new_pid = (idx == 0) | (spid != torch.roll(spid, 1))
    new_seg = new_pid | (spk != torch.roll(spk, 1))
    marker = new_seg
    pk_safe = spk.contiguous()

    seg_start = seg_ops.run_starts(new_seg)
    count_u = (_run_ends(new_seg) - seg_start + 1).to(torch.int32)
    seg_in_pid = seg_ops.run_ordinal_in_group(new_seg, new_pid)
    npart_u = (seg_in_pid[_run_ends(new_pid)] + 1).to(torch.int32)

    per_pk = segsum.segment_sum_lanes(
        torch.stack([torch.ones_like(spk), marker.to(torch.int32)],
                    dim=1).contiguous(), pk_safe, P)
    rows_pk, pids_pk = per_pk[:, 0], per_pk[:, 1]
    pk_mask = pids_pk > 0
    return torch.stack([
        _bin_stats(npart_u, new_pid),      # L0
        _bin_stats(count_u, marker),       # Linf
        _bin_stats(rows_pk, pk_mask),      # count / partition
        _bin_stats(pids_pk, pk_mask),      # pids / partition
    ])


def fused_dataset_histograms(col, data_extractors, device):
    """Device twin of ``compute_dataset_histograms``: one sort and four
    binned reductions; only the per-bin stats come back to the host."""
    from pipelinedp_tpu_torch.analysis import histograms as hs

    encoded = encode(col, data_extractors)
    if encoded.n_rows == 0:
        empty = [hs.Histogram(t, []) for t in (
            hs.HistogramType.L0_CONTRIBUTIONS,
            hs.HistogramType.LINF_CONTRIBUTIONS,
            hs.HistogramType.COUNT_PER_PARTITION,
            hs.HistogramType.COUNT_PRIVACY_ID_PER_PARTITION)]
        return [hs.DatasetHistograms(*empty)]
    P = _pad_pow2(len(encoded.pk_vocab))
    pid, pk, _ = put_on_device(encoded, device, with_values=False)
    stats = _histogram_kernel(P, pid, pk).cpu().numpy()

    def to_histogram(name, table):
        nz = np.flatnonzero(table[:, 0] > 0)
        lowers = _bin_lower_of_id(nz)
        bins = [
            hs.FrequencyBin(lower=int(lo), count=int(table[i, 0]),
                            sum=int(table[i, 1]), max=int(table[i, 2]))
            for lo, i in zip(lowers, nz)
        ]
        return hs.Histogram(name, bins)

    return [hs.DatasetHistograms(
        to_histogram(hs.HistogramType.L0_CONTRIBUTIONS, stats[0]),
        to_histogram(hs.HistogramType.LINF_CONTRIBUTIONS, stats[1]),
        to_histogram(hs.HistogramType.COUNT_PER_PARTITION, stats[2]),
        to_histogram(hs.HistogramType.COUNT_PRIVACY_ID_PER_PARTITION,
                     stats[3]),
    )]


# ---------------------------------------------------------------------------
# The lazy sweep result and its execution
# ---------------------------------------------------------------------------

_METRIC_ORDER = [(Metrics.SUM, "sum", am.AggregateMetricType.SUM),
                 (Metrics.COUNT, "count", am.AggregateMetricType.COUNT),
                 (Metrics.PRIVACY_ID_COUNT, "privacy_id_count",
                  am.AggregateMetricType.PRIVACY_ID_COUNT)]


def _k5_rows(marker: torch.Tensor, sum_u: torch.Tensor,
             vectors: Dict[str, np.ndarray]) -> Optional[torch.Tensor]:
    """The rows K5 must fold: ``marker``, or None for every row.

    On a row outside ``marker`` every column of both K5 stacks is +-0.0
    (``_metric_chunk`` and ``_sweep_chunk_body`` multiply them by the
    marker, or select 0), as long as each product stays finite: ``(c -
    x) * 0`` and ``((c * c) * p) * ...`` with ``x`` the row's value and
    ``c`` its clip to a config's bounds. A fold from +0.0 never holds
    -0.0 and adding +-0.0 changes nothing else, so dropping those rows
    keeps every total's bits. Counts are small integers; SUM's values and
    bounds within ``_ZERO_ROW_LIMIT`` keep ``c - x`` and ``c * c`` finite.
    A NaN, an infinity or a larger value turns a product into NaN, which
    the JAX package's fold carries: then K5 folds every row. One check a
    sweep."""
    bounds = np.concatenate([vectors["min_sum"], vectors["max_sum"]])
    if not np.all(np.abs(bounds) <= _ZERO_ROW_LIMIT):
        return None
    if not bool((marker | (torch.abs(sum_u) <= _ZERO_ROW_LIMIT)).all()):
        return None
    return marker


def _plan_chunk(static_chunk: int, rows: int, partitions: int,
                device: torch.device) -> Tuple[int, str]:
    """(chunk, source) for ``sweep_config_batch=0``: when the current plan
    carries a fitted sweep-phase peak-memory sample for this shape bucket
    (``plan/model.py``, measured at the static width), the chunk is
    ``static * budget / peak``; otherwise the static width exactly
    (source "static": a cold start or a poisoned history predicts None).
    The bucket varies on (rows, partitions) only."""
    from pipelinedp_tpu_torch.plan import planner
    model = planner.current_cost_model()
    if model is None:
        return static_chunk, "static"
    dk = (torch.cuda.get_device_name(device) if device.type == "cuda"
          else "cpu")
    peak = model.predict_hbm_peak(dk, "sweep", rows, partitions, 0)
    if not peak or peak <= 0:
        return static_chunk, "static"
    scaled = int(static_chunk * (_SWEEP_HBM_BUDGET / float(peak)))
    return int(np.clip(scaled, 1, _CHUNK_CAP)), "model"


def _chunk_width(C: int, n_pad: int, P_pad: int,
                 device: torch.device) -> int:
    """Configs per chunk: the ``sweep_config_batch`` knob
    (``PIPELINEDP_TPU_SWEEP_CONFIG_BATCH``) when above 0 (1 is the walked
    mode), else the widest chunk whose [n, Cc] broadcast and
    [P, Cc, 2 WINDOW + 1] window fit the JAX package's static budgets,
    capped at ``_CHUNK_CAP`` and rescaled by a fitted plan's measured
    peak (``_plan_chunk``). Every width gives the same bits per config."""
    pinned = int(knobs.value("sweep_config_batch"))
    if pinned > 0:
        return int(np.clip(pinned, 1, _CHUNK_CAP))
    chunk = int(np.clip(
        min(_CHUNK_ROW_BUDGET // max(n_pad, 1),
            (1 << 28) // max(P_pad * (2 * _WINDOW + 1), 1),
            _pad_pow2(C, minimum=1)),
        1, _CHUNK_CAP))
    chunk, source = _plan_chunk(chunk, n_pad, P_pad, device)
    obs.event("sweep.chunk_planned", chunk=int(chunk), source=source,
              rows=int(n_pad), partitions=int(P_pad))
    return chunk


class _PerPartitionRows:
    """Lazy view of the per-partition utility rows; forces the parent
    sweep on first iteration ((pk, flat per-config tuple) rows)."""

    def __init__(self, parent: "LazySweepResult"):
        self._parent = parent

    def __iter__(self):
        for _ in self._parent:  # force execution
            pass
        yield from self._parent._pp_rows


class LazySweepResult:
    """1-element iterable (List[AggregateMetrics]) running the sweep on
    first iteration, after ``compute_budgets()``."""

    def __init__(self, col, options, data_extractors, public_partitions,
                 budgets, selection_budget, device, backend,
                 return_per_partition=False, checkpoint=None, mesh=None):
        self._col = col
        self._mesh = mesh
        self._options = options
        self._extractors = data_extractors
        self._public = public_partitions
        self._budgets = budgets
        self._selection_budget = selection_budget
        self._device = (mesh.device if mesh is not None
                        else torch.device(device))
        self._return_per_partition = return_per_partition
        self._backend = backend  # host-graph fallback past _PP_BYTE_CAP
        self._checkpoint = checkpoint  # budget-safe chunk-prefix resume
        #: chunk index the last _execute resumed from.
        self._resumed_from_chunk: Optional[int] = None
        #: configs per chunk and chunks of the last _execute.
        self.chunk: Optional[int] = None
        self.n_chunks: Optional[int] = None
        self._cache = None
        self._pp_rows: Optional[list] = None

    def per_partition_rows(self) -> "_PerPartitionRows":
        return _PerPartitionRows(self)

    def __iter__(self):
        if self._cache is None:
            self._cache = [self._execute()]
        yield from self._cache

    def _host_fallback(self):
        """Per-partition sweeps past the fetch budget run the host
        analysis graph on the backend instead (the same rows, at Python
        speed), as the JAX package's do."""
        from pipelinedp_tpu_torch.analysis import utility_analysis as ua
        res, pp = ua._host_analysis(
            self._col, self._backend, self._options, self._extractors,
            self._public, return_per_partition=True)
        self._pp_rows = list(pp)
        return list(res)[0]

    def _encode(self):
        options = self._options
        if options.pre_aggregated_data:
            # Each row IS one (pid, pk) user record carrying (count, sum,
            # n_partitions): stage A is skipped.
            from pipelinedp_tpu_torch.dp_engine import DataExtractors
            ex = self._extractors
            wrap = DataExtractors(
                privacy_id_extractor=None,
                partition_extractor=ex.partition_extractor,
                value_extractor=lambda row: tuple(
                    ex.preaggregate_extractor(row)))
            return encode(self._col, wrap, self._public, require_pid=False,
                          vector_size=3)
        return encode(self._col, self._extractors, self._public)

    def _stage_a(self, encoded, P, P_pad):
        """(marker, pk_safe, count_u, sum_u, npart_u, users_in) on the
        device, partition sampling applied."""
        options = self._options
        device = self._device
        if options.pre_aggregated_data:
            _, pk, values = put_on_device(encoded, device)
            marker = torch.ones(encoded.n_rows, dtype=torch.bool,
                                device=device)
            pk_safe = pk.contiguous()
            count_u = values[:, 0].contiguous()
            sum_u = values[:, 1].contiguous()
            npart_u = values[:, 2].contiguous()
        else:
            with_values = Metrics.SUM in options.aggregate_params.metrics
            pid, pk, values = put_on_device(encoded, device,
                                            with_values=with_values)
            if values is None:
                values = torch.zeros(encoded.n_rows, dtype=torch.float32,
                                     device=device)
            marker, pk_safe, count_u, sum_u, npart_u = _preagg_kernel(
                pid, pk, values)
        if (options.partitions_sampling_prob < 1 and
                not options.pre_aggregated_data):
            # The host bounder's deterministic sampler (SHA1 of the
            # original key): sampled-out partitions' user records drop
            # after stage A, so npart_u keeps the pre-sampling spread.
            from pipelinedp_tpu_torch.sampling_utils import ValueSampler
            sampler = ValueSampler(options.partitions_sampling_prob)
            sampled_np = np.zeros(P_pad, bool)
            for i, k in enumerate(encoded.pk_vocab):
                if isinstance(k, np.generic):
                    k = k.item()
                sampled_np[i] = sampler.keep(k)
            marker = marker & torch.from_numpy(sampled_np).to(device)[
                pk_safe.long()]
        users_pk = (segsum.segment_sum_lanes(
            marker.to(torch.int32)[:, None].contiguous(), pk_safe,
            P_pad)[:, 0] if encoded.n_rows else
            torch.zeros(P_pad, dtype=torch.int32, device=device))
        # Partitions beyond the real vocab must not count as public.
        real_pk = torch.arange(P_pad, device=device) < P
        users_in = torch.where(real_pk, users_pk,
                               torch.full_like(users_pk, -1))
        return marker, pk_safe, count_u, sum_u, npart_u, users_in

    def _execute(self) -> List[am.AggregateMetrics]:
        from pipelinedp_tpu_torch.resilience import checkpoint as ckpt_mod
        from pipelinedp_tpu_torch.resilience import faults

        options = self._options
        params = options.aggregate_params
        public = self._public is not None
        device = self._device
        vectors, all_params = _config_vectors(options)
        C = len(all_params)
        encoded = self._encode()
        n_pad = _pad_rows(encoded.n_rows)
        P = len(encoded.pk_vocab)
        P_pad = _pad_pow2(max(P, 1))

        per_partition = self._return_per_partition
        metric_names = tuple(nm for m, nm, _ in _METRIC_ORDER
                             if m in params.metrics)
        if per_partition:
            pp_bytes = (P_pad * (C + _CHUNK_CAP) *
                        (5 * len(metric_names) + 1) * 4)
            if pp_bytes > _PP_BYTE_CAP:
                return self._host_fallback()

        marker, pk_safe, count_u, sum_u, npart_u, users_in = self._stage_a(
            encoded, P, P_pad)
        # One key order for the whole sweep: the per-row inputs of every
        # chunk's K5 stacks go into it once, so each key's rows are one
        # contiguous range (users_in and the chunk width keep stage A's
        # rows).
        layout = segkeyed.key_layout(pk_safe, P_pad,
                                     keep=_k5_rows(marker, sum_u, vectors))
        marker, count_u, sum_u, npart_u = (
            a.index_select(0, layout.order)
            for a in (marker, count_u, sum_u, npart_u))

        noise_rows = np.stack([
            _noise_stds(m, all_params, self._budgets)
            for m, nm, _ in _METRIC_ORDER if m in params.metrics
        ]) if metric_names else np.zeros((0, C), np.float32)

        tg = PartitionSelectionStrategy.TRUNCATED_GEOMETRIC
        lap_t = PartitionSelectionStrategy.LAPLACE_THRESHOLDING
        if public:
            strategy = None
            table = np.ones((C, 2), np.float32)
            thr = np.zeros(C, np.float32)
            scale = np.ones(C, np.float32)
            is_tg = is_lap = np.zeros(C, bool)
        else:
            strategies = [p.partition_selection_strategy
                          for p in all_params]
            strategy = (strategies[0] if len(set(strategies)) == 1 else
                        _MIXED)
            table, thr, scale = _selection_tables(
                all_params, self._selection_budget.eps,
                self._selection_budget.delta)
            is_tg = np.asarray([s == tg for s in strategies], bool)
            is_lap = np.asarray([s == lap_t for s in strategies], bool)
        kinds = [p.noise_kind for p in all_params]
        noise_kind = kinds[0] if len(set(kinds)) == 1 else None
        is_gauss = np.asarray([k == NoiseKind.GAUSSIAN for k in kinds],
                              bool)

        chunk = _chunk_width(C, n_pad, P_pad, device)
        mesh = self._mesh
        n_dev = mesh.size if mesh is not None else 1
        if n_dev > 1:
            # Every rank takes an equal slice of each chunk's configs.
            chunk = max(chunk // n_dev, 1) * n_dev
        C_pad = -(-C // chunk) * chunk

        def cpad(a, axis=0):
            a = np.asarray(a)
            reps = C_pad - a.shape[axis]
            if reps:
                tail = np.repeat(np.take(a, [-1], axis=axis), reps, axis)
                a = np.concatenate([a, tail], axis)
            return a

        # Rows [M:] of noise_rows are the host-computed squares the chunk
        # adds to var_l0 (as data, like the JAX package ships them).
        host_cfg = {
            "l0": cpad(vectors["l0"]), "linf": cpad(vectors["linf"]),
            "min_sum": cpad(vectors["min_sum"]),
            "max_sum": cpad(vectors["max_sum"]),
            "noise_rows": (cpad(np.concatenate([noise_rows,
                                                noise_rows * noise_rows]),
                                axis=1) if len(noise_rows) else
                           np.zeros((0, C_pad), np.float32)),
            "table": cpad(table), "thr": cpad(thr), "scale": cpad(scale),
            "is_tg": cpad(is_tg), "is_lap": cpad(is_lap),
            "is_gauss": cpad(is_gauss),
        }
        cfg = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
               for k, v in host_cfg.items()}
        consts = _sweep_constants(device)

        # Budget-safe chunk-prefix resume: each chunk's per-config outputs
        # are a pure function of (data, config), so the completed-chunk
        # prefix saved after every chunk lets a killed sweep resume there.
        # Per-partition sweeps do not checkpoint.
        ckpt_store = (ckpt_mod.as_store(self._checkpoint)
                      if not per_partition else None)
        if ckpt_store is not None:
            # A sibling file: a stream owns the path itself.
            ckpt_store = ckpt_mod.CheckpointStore(ckpt_store.path + ".sweep")
        ckpt_every = knobs.checkpoint_every()
        acc_flat = None
        done_chunks = 0
        ckpt_fp = None
        if ckpt_store is not None:
            ckpt_fp = ckpt_mod.sweep_fingerprint(
                repr((metric_names, str(strategy), str(noise_kind),
                      public, options.epsilon, options.delta,
                      options.partitions_sampling_prob,
                      bool(options.pre_aggregated_data))),
                C, chunk, P_pad, data=ckpt_mod.data_digest(encoded),
                arrays=list(host_cfg.values()), n_dev=n_dev)
            saved = ckpt_store.load_for(ckpt_fp)
            if saved is not None:
                done_chunks = saved.next_batch
                acc_flat = dict(saved.arrays)
        self._resumed_from_chunk = done_chunks
        # On a mesh every rank reads the store; position 0 writes it.
        ckpt_writer = mesh is None or mesh.index == 0

        def flatten_host(out, sel):
            flat = {}
            for nm in metric_names:
                for f, v in out[nm].items():
                    flat[f"o:{nm}:{f}"] = v.cpu().numpy()
            if sel is not None:
                for f, v in sel.items():
                    flat[f"s:{f}"] = v.cpu().numpy()
            return flat

        chunk_outs = []
        pp_chunks = []
        self.chunk = chunk
        self.n_chunks = -(-C // chunk)
        t_sweep0 = time.monotonic()
        live_configs = 0  # configs run by this call (not the resumed ones)
        for ci, start in enumerate(range(0, C, chunk)):
            if ckpt_store is not None and ci < done_chunks:
                continue  # restored from the checkpoint prefix
            faults.check_chunk(ci)
            faults.check_sweep_config_chunk(ci)
            # The heartbeat's sweep section: configs done against the
            # plan and configs/s, so a stalled chunk can be named.
            el = time.monotonic() - t_sweep0
            obs.monitor.update_sweep({
                "configs_done": min(ci * chunk, C),
                "configs_planned": C,
                "chunk": ci,
                "chunks_planned": self.n_chunks,
                "config_batch": chunk,
                "configs_per_s": (round(live_configs / el, 1) if el > 0
                                  else 0.0),
                "resumed_from_chunk": done_chunks,
            })
            with obs.span("sweep.chunk", cat="sweep", chunk=ci,
                          start=int(start)):
                if n_dev > 1:
                    out, sel, pp = _sharded_chunk(
                        mesh, metric_names, strategy, noise_kind, P_pad,
                        public, chunk, start, marker, layout, count_u,
                        sum_u, npart_u, users_in, cfg, consts,
                        per_partition)
                else:
                    out, sel = _sweep_chunk_body(
                        metric_names, strategy, noise_kind, P_pad, public,
                        chunk, start, marker, layout, count_u, sum_u,
                        npart_u, users_in, cfg, consts,
                        per_partition=per_partition)
                    pp = (_split_pp(out, metric_names) if per_partition
                          else None)
            if per_partition:
                pp_chunks.append(pp)
            if ckpt_store is not None:
                flat = flatten_host(out, sel)
                acc_flat = (flat if acc_flat is None else
                            {k: np.concatenate([acc_flat[k], flat[k]])
                             for k in flat})
                if (ci + 1) % ckpt_every == 0 and ckpt_writer:
                    ckpt_store.save(ckpt_mod.StreamCheckpoint(
                        ckpt_fp, ci + 1, acc_flat))
            else:
                chunk_outs.append((out, sel))
            live_configs += chunk

        # The grid completed: clear the heartbeat's sweep section (a
        # killed sweep leaves its last snapshot for the stall watchdog).
        obs.monitor.update_sweep(None)

        if ckpt_store is not None:
            out_cat = {nm: {} for nm in metric_names}
            sel_cat = {}
            for k, v in acc_flat.items():
                if k.startswith("o:"):
                    _, nm, f = k.split(":", 2)
                    out_cat[nm][f] = v[:C]
                else:
                    sel_cat[k[2:]] = v[:C]
            sel_cat = sel_cat or None
        else:
            out_cat, sel_cat = _concat_fetch(chunk_outs, metric_names, C)
        fields = {nm: out_cat[nm] for nm in metric_names}

        if per_partition:
            keys = sorted(pp_chunks[0])
            blocks = {k: torch.cat([c[k] for c in pp_chunks], dim=1)
                      [:P, :C].cpu().numpy() for k in keys}
            users_np = users_in.cpu().numpy()[:P]
            mask_np = (users_np > 0) | (public & (users_np == 0))
            self._pp_rows = self._assemble_pp(
                all_params, metric_names, blocks, mask_np, noise_rows,
                encoded.pk_vocab)

        result = self._pack(all_params, fields, sel_cat, noise_rows,
                            metric_names)
        if ckpt_store is not None and ckpt_writer:
            # A finished run must not be resumable.
            ckpt_store.clear()
        return result

    def _assemble_pp(self, all_params, metric_names, blocks, mask_np,
                     noise_rows, vocab):
        """[P, C] blocks -> host rows in the host graph's per-partition
        format: (pk, flat tuple of per-config entries: [p_keep] + one
        SumMetrics per analyzed metric, configs sequential)."""
        private = self._public is None
        rows = []
        C = len(all_params)
        keep = blocks["_pp_keep"]
        for p in np.flatnonzero(mask_np).tolist():
            entries = []
            for c in range(C):
                if private:
                    entries.append(float(keep[p, c]))
                for row_i, nm in enumerate(metric_names):
                    entries.append(am.SumMetrics(
                        sum=float(blocks[f"{nm}.pp_sum"][p, c]),
                        per_partition_error_min=float(
                            blocks[f"{nm}.pp_err_min"][p, c]),
                        per_partition_error_max=float(
                            blocks[f"{nm}.pp_err_max"][p, c]),
                        expected_cross_partition_error=float(
                            blocks[f"{nm}.pp_exp_l0"][p, c]),
                        std_cross_partition_error=math.sqrt(max(
                            float(blocks[f"{nm}.pp_var_l0"][p, c]), 0.0)),
                        std_noise=float(noise_rows[row_i][c]),
                        noise_kind=all_params[c].noise_kind))
            rows.append((vocab[p], tuple(entries)))
        return rows

    def _pack(self, all_params, fields, sel_fields, noise_rows,
              metric_names) -> List[am.AggregateMetrics]:
        """Host normalization, the vectorized twin of the reference's
        ``SumAggregateErrorMetricsCombiner.compute_metrics``."""
        results = []
        type_of = {nm: t for _, nm, t in _METRIC_ORDER}
        for i, p in enumerate(all_params):
            packed = am.AggregateMetrics(input_aggregate_params=p)
            if sel_fields is not None:
                packed.partition_selection_metrics = (
                    am.PartitionSelectionMetrics(
                        num_partitions=float(
                            sel_fields["num_partitions"][i]),
                        dropped_partitions_expected=float(
                            sel_fields["num_partitions"][i] -
                            sel_fields["keep_sum"][i]),
                        dropped_partitions_variance=float(
                            sel_fields["keep_var"][i])))
            for row, nm in enumerate(metric_names):
                f = fields[nm]
                kept = max(float(f["kept_partitions_expected"][i]), 1e-30)
                nparts = max(float(f["num_partitions"][i]), 1.0)
                total = max(1.0, float(f["total_aggregate"][i]))

                def g(k):
                    return float(f[k][i])

                def gq(k):
                    return [float(x) for x in f[k][i]]

                el0 = g("error_l0_expected") / kept
                emin = g("error_linf_min_expected") / kept
                emax = g("error_linf_max_expected") / kept
                rel0 = g("rel_error_l0_expected") / kept
                remin = g("rel_error_linf_min_expected") / kept
                remax = g("rel_error_linf_max_expected") / kept
                m = am.AggregateErrorMetrics(
                    metric_type=type_of[nm],
                    ratio_data_dropped_l0=g("data_dropped_l0") / total,
                    ratio_data_dropped_linf=g("data_dropped_linf") / total,
                    ratio_data_dropped_partition_selection=(
                        g("data_dropped_partition_selection") / total),
                    error_l0_expected=el0,
                    error_linf_expected=emin + emax,
                    error_linf_min_expected=emin,
                    error_linf_max_expected=emax,
                    error_expected=el0 + emin + emax,
                    error_l0_variance=g("error_l0_variance") / kept,
                    error_variance=g("error_variance") / kept,
                    error_quantiles=[q / kept for q in
                                     gq("error_quantiles")],
                    rel_error_l0_expected=rel0,
                    rel_error_linf_expected=remin + remax,
                    rel_error_linf_min_expected=remin,
                    rel_error_linf_max_expected=remax,
                    rel_error_expected=rel0 + remin + remax,
                    rel_error_l0_variance=g("rel_error_l0_variance") / kept,
                    rel_error_variance=g("rel_error_variance") / kept,
                    rel_error_quantiles=[
                        q / kept for q in gq("rel_error_quantiles")],
                    error_expected_w_dropped_partitions=(
                        g("error_expected_w_dropped_partitions") / nparts),
                    rel_error_expected_w_dropped_partitions=(
                        g("rel_error_expected_w_dropped_partitions") /
                        nparts),
                    noise_std=float(noise_rows[row][i]))
                if nm == "sum":
                    packed.sum_metrics = m
                elif nm == "count":
                    packed.count_metrics = m
                else:
                    packed.privacy_id_count_metrics = m
            results.append(packed)
        return results


def _sweep_constants(device) -> Dict[str, torch.Tensor]:
    """The stage-C constants on ``device``: the Laplace+Gaussian quantile
    table, ``ndtri(1 - q)`` and ``scipy``'s ``norm.ppf(1 - q)`` of the
    error quantiles, each as the JAX package rounds it."""
    import scipy.stats

    inv_q = np.asarray([1.0 - q for q in ERROR_QUANTILES], np.float32)
    log_rs, t_table = _laplace_gauss_table(
        tuple(1.0 - q for q in ERROR_QUANTILES))
    return {
        "log_rs": torch.from_numpy(log_rs).to(device),
        "t_table": torch.from_numpy(t_table).to(device),
        "ndtri_q": xm.ndtri(torch.from_numpy(inv_q), folded=True).to(device),
        "ppf_q": torch.from_numpy(
            scipy.stats.norm.ppf(inv_q).astype(np.float32)).to(device),
    }


def _concat_fetch(chunk_outs, metric_names, C):
    """The chunks' [Cc] (and [Cc, Q]) fields concatenated over the config
    axis and cut to the C real configs, fetched to the host in one
    transfer."""
    keys = [(nm, f) for nm in metric_names for f in chunk_outs[0][0][nm]]
    sel_keys = (list(chunk_outs[0][1]) if chunk_outs[0][1] is not None
                else [])
    leaves = [torch.cat([o[nm][f] for o, _ in chunk_outs])[:C]
              for nm, f in keys]
    leaves += [torch.cat([s[f] for _, s in chunk_outs])[:C]
               for f in sel_keys]
    flat = torch.cat([t.reshape(-1) for t in leaves]).cpu().numpy()
    split, off = [], 0
    for t in leaves:
        size = t.numel()
        split.append(flat[off:off + size].reshape(tuple(t.shape)))
        off += size
    out_cat = {nm: {} for nm in metric_names}
    for (nm, f), v in zip(keys, split):
        out_cat[nm][f] = v
    sel_cat = ({f: v for f, v in zip(sel_keys, split[len(keys):])}
               if sel_keys else None)
    return out_cat, sel_cat


def build_fused_sweep(col, options, data_extractors, public_partitions,
                      budget_accountant, backend, device="cuda",
                      mesh=None, return_per_partition=False,
                      checkpoint=None) -> LazySweepResult:
    """Requests the budgets the host analysis engine would and returns the
    lazy sweep on ``device``. With ``return_per_partition``, past
    ``_PP_BYTE_CAP`` the rows come from the host analysis graph on
    ``backend``. ``checkpoint`` (a path or ``resilience.checkpoint.CheckpointStore``)
    enables budget-safe chunk-prefix resume through a ``<path>.sweep``
    sibling file; the save cadence follows ``PIPELINEDP_TPU_CKPT_EVERY``.
    ``mesh`` splits each chunk's configurations over the mesh's ranks."""
    if mesh is not None:
        from pipelinedp_tpu_torch.parallel import sharded
        sharded.require_mesh(mesh)
    params = options.aggregate_params
    mechanism_type = data_structures.analysis_mechanism_type(options)
    selection_budget = None
    if public_partitions is None:
        selection_budget = budget_accountant.request_budget(
            MechanismType.GENERIC, weight=params.budget_weight)
    budgets = {}
    for metric in params.metrics:
        budgets[metric] = budget_accountant.request_budget(
            mechanism_type, weight=params.budget_weight)
    return LazySweepResult(col, options, data_extractors,
                           public_partitions, budgets, selection_budget,
                           device, backend,
                           return_per_partition=return_per_partition,
                           checkpoint=checkpoint, mesh=mesh)
