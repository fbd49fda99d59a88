"""Batched ingest for tables of more rows than one device batch: the port
of the serial, single-device core of ``pipelinedp_tpu/streaming.py``.

The per-partition accumulator columns are additive, so a large table
streams through the same ``torch_engine._partials`` in batches grouped by
privacy unit:

* every privacy unit's rows land in exactly one batch (rows are grouped
  by ``fmix32(pid ^ seed)``), so bounding per batch equals bounding over
  the whole table; batch ``b`` bounds under ``fold_in(k_bound, b)``;
* each batch's int32 columns are fetched and folded on the host: counts
  in int64, fixed-point value lanes into exact float64 step totals (the
  lane plan comes from the largest batch; the division by the scale
  happens once, at the end), so the released bits do not depend on the
  batch boundaries;
* partition selection runs once on the device over the combined
  privacy-id counts, with the same draw as a single batch;
* PERCENTILE walks in two passes. Pass A adds each batch's [P, 256] mid
  histogram (K1) on the device and the top two levels walk on the sum.
  Pass B streams the same batches again, once per sweep of the planner
  (``plan_pass_b_sweeps``), and bins their rows into every packed
  [T, Pb, Qc, 256] subtree tile with ``_subtree_counts_multi`` (kernel
  K3 on the card), adding into the sweep's accumulator; the bottom two
  levels then walk per tile and one running maximum over the quantile
  list ends the walk.

Node noise is a pure function of the global (partition, node id), so with
non-binding caps a streamed run releases the same values and kept set as
a single batch; the JAX package's streamed run releases the same values
as the port's for the same seed, bit for bit.

Not ported here (each raises ``NotImplementedError`` naming ROADMAP step
7): the overlapped ingest executor (the serial loop below is the JAX
package's bit-parity reference path), the pass-B device prefix cache (pass
B re-ships every batch each sweep, the ``"reship"`` source, bit-identical
to the other two), checkpoint and resume, the mesh and its elastic
reshards, streamed VECTOR_SUM and streamed ``select_partitions``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.ops import prng
from pipelinedp_tpu_torch.ops import quantile_tree

#: Rows per batch, and the engine's trigger to stream, when
#: ``PIPELINEDP_TPU_STREAM_CHUNK`` is unset (the JAX package's
#: ``stream_chunk_rows`` knob). Batch membership decides which rows a
#: unit's bounding sees, so it changes released values.
_CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"
_STREAM_CHUNK_ROWS = 1 << 26

#: The int32 guards: privacy units per partition at selection time, and
#: kept rows per partition in the streamed tree histograms. Seams, so
#: tests can pin each cliff.
_SELECT_UNITS_CAP = int(np.iinfo(np.int32).max)
_TREE_ROWS_CAP = int(np.iinfo(np.int32).max)


def stream_chunk_rows() -> int:
    raw = os.environ.get(_CHUNK_ENV)
    return int(raw) if raw else int(_STREAM_CHUNK_ROWS)


def chunk_target_rows(config) -> int:
    """Rows per batch: the chunk knob, capped at int32 capacity and, for
    configurations with fixed-point value lanes, at the lanes' per-batch
    capacity."""
    chunk = min(stream_chunk_rows(), (1 << 31) - 1)
    if te._fixedpoint_layout(config) or te._vector_fx(config):
        chunk = min(chunk, te._fx_max_rows())
    return chunk


def should_stream(config, n_rows: int) -> bool:
    """The engine streams when one batch cannot hold the table."""
    return n_rows > chunk_target_rows(config)


def _rank1_names(config, fx_bits: int):
    """The rank-1 int32 columns ``_reduce_per_pk`` produces, in the order
    the fetch packs them."""
    names = ["count"]
    n_lanes = -(-te._FX_PAYLOAD_BITS // fx_bits)
    for spec in te._fixedpoint_layout(config):
        names += [f"{spec.name}_fx{k}" for k in range(n_lanes)]
    return sorted(names)


def _fmix32(x: np.ndarray) -> np.ndarray:
    """The murmur3 finalizer on a uint32 numpy array (wrapping products)."""
    x = x ^ (x >> np.uint32(16))
    x = x * np.uint32(0x85EBCA6B)
    x = x ^ (x >> np.uint32(13))
    x = x * np.uint32(0xC2B2AE35)
    return x ^ (x >> np.uint32(16))


def group_rows_by_cell(cell_of_row: np.ndarray,
                       n_cells: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(order, counts)``: the row indices grouped by cell, cells
    ascending and rows in their original order within a cell (the stable
    ``argsort`` of ``cell_of_row``), and the rows per cell. A port of
    ``pipelinedp_tpu/ingest/assign.py``: numpy's stable argsort of a
    uint16 key is one counting-sort pass, two for wider cell spaces."""
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


def _batch_assignment(config, encoded, n_batches: int, seed: int):
    """Row order and per-batch row counts such that each privacy unit's
    rows are contiguous in one batch (``streaming._batch_assignment`` of
    the JAX package on one device; the row order inside a batch is part
    of the contract, since the tie-break bits are keyed by row position).
    Without privacy ids every row is its own unit and batches are plain
    contiguous slices. Returns ``(order or None, counts [n_batches])``."""
    n = encoded.n_rows
    if config.bounds_already_enforced:
        base, rem = divmod(n, n_batches)
        counts = np.full(n_batches, base, np.int64)
        counts[:rem] += 1
        return None, counts
    # Hash before bucketing (id families sharing low bits would pile into
    # one batch), salted by the run seed.
    h = _fmix32(encoded.pid.astype(np.uint32) ^
                np.uint32(seed & 0xFFFFFFFF))
    batch_of_row = ((h.astype(np.uint64) * np.uint64(n_batches)) >>
                    np.uint64(32)).astype(np.int64)
    return group_rows_by_cell(batch_of_row, n_batches)


@dataclasses.dataclass(frozen=True)
class PassBPlan:
    """How pass B covers the (quantile x partition) grid: ``tiles`` are
    ``(q0, qc, p0)`` units of ``q_chunk`` quantiles by ``p_blk``
    partitions in walk order (quantile groups outer, partition blocks
    inner; the last of each may be smaller), and ``sweeps`` packs
    consecutive same-shape tiles whose joint [T, Pb, Qc, span] histogram
    fits the byte cap into one traversal of the batch stream."""
    q_chunk: int
    p_blk: int
    tiles_per_sweep: int
    tiles: Tuple[Tuple[int, int, int], ...]
    sweeps: Tuple[Tuple[Tuple[int, int, int], ...], ...]

    @property
    def n_tiles(self) -> int:
        return len(self.tiles)

    @property
    def n_sweeps(self) -> int:
        return len(self.sweeps)

    @property
    def chunked(self) -> bool:
        return len(self.tiles) > 1


def plan_pass_b_sweeps(P_pad, Q, span, cap, q_chunk=0) -> PassBPlan:
    """Sizes pass B's sweeps before anything streams (the JAX package's
    planner, whole). The budget is ``cap`` bytes of int32 [.., span]
    blocks. Among the (q_chunk, p_blk) tilings whose tiles fit, it picks
    the fewest sweeps, then the fewest tiles, then the largest partition
    blocks, then the widest quantile groups. A positive ``q_chunk`` pins
    the quantile-group width (an infeasible pin falls back to the
    search). Only a cap below one [1, 1, span] block raises."""
    unit = span * 4
    if unit > cap:
        raise NotImplementedError(
            f"streamed percentiles need one [1, 1, {span}] subtree block "
            f"({unit} bytes) within the subhist byte cap — the cap is below "
            "a single partition's block")
    budget = cap // unit
    if P_pad * Q <= budget and not (0 < q_chunk < Q):
        tile = ((0, Q, 0),)
        return PassBPlan(Q, P_pad, 1, tile, (tile,))
    # Partition blocks: the full axis and the powers of two that divide
    # it, so every block of a tiling has one size.
    pbs = sorted({P_pad} | {1 << k for k in range(P_pad.bit_length())
                            if P_pad % (1 << k) == 0}, reverse=True)
    best = None
    qcs = ([min(int(q_chunk), Q)] if q_chunk and q_chunk > 0
           else range(1, Q + 1))
    for qc in qcs:
        for pb in pbs:
            if qc * pb > budget:
                continue
            t_full = budget // (qc * pb)
            n_pb = P_pad // pb
            n_fullq, rq = divmod(Q, qc)
            n_tiles = (n_fullq + (1 if rq else 0)) * n_pb
            sweeps = -(-(n_fullq * n_pb) // t_full)
            if rq:
                sweeps += -(-n_pb // (budget // (rq * pb)))
            key = (sweeps, n_tiles, -pb, -qc)
            if best is None or key < best[0]:
                best = (key, qc, pb, t_full)
    if best is None and q_chunk:
        return plan_pass_b_sweeps(P_pad, Q, span, cap)
    _, qc, pb, t_full = best
    tiles = tuple((q0, min(qc, Q - q0), p0)
                  for q0 in range(0, Q, qc)
                  for p0 in range(0, P_pad, pb))
    sweeps = []
    i = 0
    while i < len(tiles):
        qn, pn = tiles[i][1], min(pb, P_pad - tiles[i][2])
        t_cap = max(1, budget // (qn * pn))
        j = i
        while (j < len(tiles) and j - i < t_cap and tiles[j][1] == qn
               and min(pb, P_pad - tiles[j][2]) == pn):
            j += 1
        sweeps.append(tiles[i:j])
        i = j
    return PassBPlan(qc, pb, t_full, tiles, tuple(sweeps))


def stream_partials_and_select(config, encoded, scales, keep_table,
                               sel_threshold, sel_scale, sel_min_count,
                               sel_rows_per_uid, rng_seed: Optional[int],
                               device) -> Tuple[np.ndarray, Dict, Dict]:
    """The streamed aggregation, serial, on ``device``. Returns
    ``(keep bool [P_pad], part64, stats)``: ``part64`` holds the combined
    int64 counts and float64 value columns ready for
    ``torch_engine._host_release``; with percentiles
    ``stats["percentile_values"]`` holds the walked [P_pad, Q] float32
    values."""
    if "VECTOR_SUM" in config.metrics:
        raise NotImplementedError(
            "streamed VECTOR_SUM is not ported yet (ROADMAP step 7)")
    device = torch.device(device)
    P_pad = te._pad_pow2(len(encoded.pk_vocab))
    n = encoded.n_rows
    chunk = chunk_target_rows(config)
    n_batches = max(1, -(-n // chunk))
    seed = te._run_seed(rng_seed)
    # The key topology of a single batch: one bounding stream (folded per
    # batch), one selection stream, one noise stream.
    k_bound, k_sel, k_noise = prng.split(prng.PRNGKey(seed), 3)
    _, _, n_mid, span = quantile_tree.tree_constants()
    if config.percentiles:
        plan = plan_pass_b_sweeps(P_pad, len(config.percentiles), span,
                                  te._subhist_byte_cap())

    order, batch_rows = _batch_assignment(config, encoded, n_batches, seed)
    max_rows = int(batch_rows.max())
    layout = te._fixedpoint_layout(config)
    # The lane plan is a per-batch bound: it depends on the largest batch,
    # which exceeds the chunk only where one unit owns that many rows.
    try:
        fx_bits = te._fx_plan(max_rows)[0] if layout else 12
    except NotImplementedError:
        raise NotImplementedError(
            f"the largest streaming batch holds {max_rows} rows — beyond "
            "the 2^27-row per-batch lane capacity. A batch this far over "
            f"the {chunk}-row chunk target means a single privacy unit "
            "owns that many rows; its rows cannot be split across batches "
            "(contribution bounding must see them together)")
    names = _rank1_names(config, fx_bits)

    def batches():
        """The deterministic batch sequence on ``device``: (b, pid, pk,
        values or None); pass A and every pass-B sweep read it alike."""
        offset = 0
        for b in range(n_batches):
            cnt = int(batch_rows[b])
            rows = (slice(offset, offset + cnt) if order is None
                    else order[offset:offset + cnt])
            offset += cnt
            if cnt == 0:
                continue
            pid = torch.from_numpy(np.ascontiguousarray(
                encoded.pid[rows])).to(device)
            pk = torch.from_numpy(np.ascontiguousarray(
                encoded.pk[rows])).to(device)
            values = (torch.from_numpy(np.ascontiguousarray(
                encoded.values[rows])).to(device)
                if config.needs_values else None)
            yield b, pid, pk, values

    # Pass A: fetch and fold each batch's columns. The lanes fold into
    # exact float64 step totals per batch; only counts live in ``acc``.
    acc = {"count": np.zeros(P_pad, np.int64),
           "privacy_id_count_raw": np.zeros(P_pad, np.int64)}
    val_acc = {spec.name: np.zeros(P_pad, np.float64) for spec in layout}
    mid_acc = None
    for b, pid, pk, values in batches():
        part, nseg, qrows = te._partials(config, P_pad, pid, pk, values,
                                         prng.fold_in(k_bound, b), fx_bits)
        host = torch.stack([part[k] for k in names] + [nseg]).cpu().numpy()
        batch64 = {name: host[i].astype(np.int64)
                   for i, name in enumerate(names)}
        batch64["privacy_id_count_raw"] = host[-1].astype(np.int64)
        te._fold_fx_steps(config, batch64, fx_bits)
        acc["count"] += batch64["count"]
        acc["privacy_id_count_raw"] += batch64["privacy_id_count_raw"]
        for spec in layout:
            val_acc[spec.name] += batch64[spec.name]
        if config.percentiles:
            mid = te._mid_histogram(P_pad, qrows)
            mid_acc = mid if mid_acc is None else mid_acc.add_(mid)

    part64: Dict[str, np.ndarray] = dict(acc)
    # One division by the scale over the combined step totals: the same
    # bits as a single batch's release, for any batching.
    for spec in layout:
        part64[spec.name] = val_acc[spec.name] / spec.scale

    if config.selection is None:
        keep = np.ones(P_pad, bool)
    else:
        nseg = acc["privacy_id_count_raw"]
        if nseg.max(initial=0) >= _SELECT_UNITS_CAP:
            raise NotImplementedError(
                "more than 2^31 privacy units in one partition")
        # Selection never reads the walk: strip the percentiles.
        sel_config = dataclasses.replace(config, percentiles=())
        keep_t, _ = te._selection_and_metrics(
            sel_config, P_pad, {}, torch.from_numpy(
                nseg.astype(np.int32)).to(device), keep_table, sel_threshold,
            sel_scale, sel_min_count, sel_rows_per_uid, k_sel)
        keep = keep_t.cpu().numpy()
    stats = {"n_batches": n_batches}
    if not config.percentiles:
        return keep, part64, stats

    # Pass B. The histograms accumulate in device int32, so a partition
    # with 2^31 kept rows would wrap a bucket: guard on the host counts.
    if int(acc["count"].max(initial=0)) >= _TREE_ROWS_CAP:
        raise NotImplementedError(
            "streamed percentiles: a partition holds >= 2^31 kept rows — "
            "beyond the int32 tree-histogram capacity")
    k_tree = prng.fold_in(k_noise, 0x7ee)
    scale = float(np.asarray(scales, np.float32)[-1])
    lo, hi, target, leaf_lo, done = te._walk_top(
        config, P_pad, mid_acc.reshape(P_pad, n_mid), k_tree, scale)
    del mid_acc
    Q = len(config.percentiles)
    vals = torch.empty(P_pad, Q, dtype=torch.float32, device=device)
    for sweep in plan.sweeps:
        qn, p0_s = sweep[0][1], sweep[0][2]
        Pb = min(plan.p_blk, P_pad - p0_s)
        starts = torch.stack([leaf_lo[p0:p0 + Pb, q0:q0 + qn]
                              for q0, _, p0 in sweep]).contiguous()
        p_offs = torch.tensor([p0 for _, _, p0 in sweep], dtype=torch.int32,
                              device=device)
        sub = torch.zeros(len(sweep), Pb, qn, span, dtype=torch.int32,
                          device=device)
        for b, pid, pk, values in batches():
            qpk, leaf, kept = te._bounded_qrows(
                config, pid, pk, values, prng.fold_in(k_bound, b))
            te._subtree_counts_multi(qpk, leaf, kept, starts, p_offs, Pb,
                                     span, out=sub)
        for ti, (q0, _, p0) in enumerate(sweep):
            psl, qsl = slice(p0, p0 + Pb), slice(q0, q0 + qn)
            vals[psl, qsl] = te._walk_bottom(
                config, Pb, sub[ti], starts[ti], lo[psl, qsl], hi[psl, qsl],
                target[psl, qsl], leaf_lo[psl, qsl], done[psl, qsl], k_tree,
                scale, p0)
        del sub
    # The monotone step runs once over the full quantile list.
    quantiles = np.asarray([p / 100.0 for p in config.percentiles],
                           np.float32)
    stats["percentile_values"] = te._monotone_in_q(
        vals, quantiles).cpu().numpy()
    stats.update(pass_b_source="reship", pass_b_sweeps=plan.n_sweeps,
                 pass_b_tiles=plan.n_tiles)
    return keep, part64, stats
