"""Batched ingest for tables of more rows than one device batch: the port
of the single-device stream of ``pipelinedp_tpu/streaming.py``.

The per-partition accumulator columns are additive, so a large table
streams through the same ``torch_engine._partials`` in batches grouped by
privacy unit:

* every privacy unit's rows land in exactly one batch (rows are grouped
  by ``fmix32(pid ^ seed)``), so bounding per batch equals bounding over
  the whole table; batch ``b`` bounds under ``fold_in(k_bound, b)``;
* each batch's int32 columns are fetched and folded on the host: counts
  in int64, fixed-point value lanes (the per-value ``nsum``/``nsumsq`` or
  the per-partition-bounds ``sum``) into exact float64 step totals (the
  lane plan comes from the largest batch; the division by the scale
  happens once, at the end), so the released bits do not depend on the
  batch boundaries; VECTOR_SUM folds its [P, n_lanes * D] lane sums (K2)
  the same way under ``fx``, and its float32 sums in float64 under ``f32``;
* partition selection runs once on the device over the combined
  privacy-id counts, with the same draw as a single batch; a streamed
  ``select_partitions`` keeps only that keep vector;
* PERCENTILE walks in two passes. Pass A adds each batch's [P, 256] mid
  histogram (K1) on the device and the top two levels walk on the sum.
  Pass B streams the same batches again, once per sweep of the planner
  (``plan_pass_b_sweeps``), and bins their rows into every packed
  [T, Pb, Qc, 256] subtree tile with ``_subtree_counts_multi`` (kernel
  K3 on the card), adding into the sweep's accumulator; the bottom two
  levels then walk per tile and one running maximum over the quantile
  list ends the walk. Pass B reads the batches that pass A kept on the
  device (the pass-B cache, ``PIPELINEDP_TPU_STREAM_CACHE``) and
  re-ships the rest.

Pass A runs serially or through the overlapped ingest executor
(``ingest/executor.py``, on by default): a stager thread gathers batch
b+1's rows into pinned host buffers and ships them on a side CUDA stream
while the card computes batch b, and a fold thread fetches and folds the
batches in order. A checkpoint store saves the folded prefix so that a
killed run resumes (``resilience/checkpoint.py``); ``resilience/faults.py``
injects the kills that test it. Serial or overlapped, cached or
re-shipped, resumed or not, the released bits are the same.

Node noise is a pure function of the global (partition, node id), so with
non-binding caps a streamed run releases the same values and kept set as
a single batch; the JAX package's streamed run releases the same values
as the port's for the same seed, bit for bit.

On a mesh (``parallel.make_mesh``) the stream takes the JAX package's
multi-process path: every batch is split into one cell per rank by the
unsalted ``fmix32(pid) % n`` of ``parallel/sharded.py``, each rank bounds
its own cell under ``fold_in(fold_in(k_bound, b), position)`` and reduces
it, and one replicating all-reduce per output gives every rank the whole
batch's columns, so every rank folds, selects, walks and releases alike.
The batch target is the chunk knob times the mesh size. The ingest
executor's threads are off on a mesh (``ingest.forced_serial``): every
rank must enqueue its collectives in the same order. The elastic
reshards of a mesh that loses a rank wait for ROADMAP step 5b.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import ingest, obs
from pipelinedp_tpu_torch import plan as plan_mod
from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.ops import prng
from pipelinedp_tpu_torch.ops import quantile_tree
from pipelinedp_tpu_torch.parallel import sharded as psh
from pipelinedp_tpu_torch.resilience import checkpoint as ckpt_mod
from pipelinedp_tpu_torch.resilience import faults

#: The int32 guards: privacy units per partition at selection time, and
#: kept rows per partition in the streamed tree histograms (the
#: ``select_units_cap`` and ``tree_rows_cap`` knobs' seams, so tests can
#: pin each cliff).
_SELECT_UNITS_CAP = int(np.iinfo(np.int32).max)
_TREE_ROWS_CAP = int(np.iinfo(np.int32).max)

#: Pass-B quantiles-per-tile pin (the ``q_chunk`` knob's seam): 0 lets
#: ``plan_pass_b_sweeps`` search.
_Q_CHUNK = 0


def stream_chunk_rows() -> int:
    """Rows per batch, and the engine's trigger to stream: the
    ``stream_chunk_rows`` knob (``PIPELINEDP_TPU_STREAM_CHUNK``). Batch
    membership decides which rows a unit's bounding sees, so it changes
    released values and a plan never moves it."""
    return int(plan_mod.knob_value("stream_chunk_rows"))


def stream_cache_bytes() -> int:
    """Device bytes the pass-B cache may keep: the ``stream_cache_bytes``
    knob (``PIPELINEDP_TPU_STREAM_CACHE``, 4 GiB by default; 0 disables).
    The three pass-B sources are bit-identical, so it trades device
    memory for host-to-device traffic only."""
    return int(plan_mod.knob_value("stream_cache_bytes"))


def chunk_target_rows(config, n_dev: int = 1) -> int:
    """Rows per batch, over the whole mesh: the chunk knob times the mesh
    size (every rank still sees about one chunk), capped at int32
    capacity and, for configurations with fixed-point value lanes, at the
    lanes' per-batch capacity, which the ranks' lane sums share."""
    chunk = min(stream_chunk_rows() * n_dev, (1 << 31) - 1)
    if te._fixedpoint_layout(config) or te._vector_fx(config):
        chunk = min(chunk, te._fx_max_rows())
    return chunk


def should_stream(config, n_rows: int, mesh=None) -> bool:
    """The engine streams when one batch cannot hold the table."""
    n_dev = mesh.size if mesh is not None else 1
    return n_rows > chunk_target_rows(config, n_dev)


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


def _batch_assignment(config, encoded, n_batches: int, seed: int,
                      n_dev: int = 1):
    """Row order and per-(batch, rank) row counts such that each privacy
    unit's rows are contiguous in one rank's cell of one batch
    (``streaming._batch_assignment`` of the JAX package; the row order
    inside a cell is part of the contract, since the tie-break bits are
    keyed by row position). The rank is the unsalted shard hash of
    ``parallel/sharded.py``, independent of the batch hash. Without
    privacy ids every row is its own unit and cells are plain contiguous
    slices. Returns ``(order or None, counts [n_batches, n_dev])``."""
    n = encoded.n_rows
    cells = n_batches * n_dev
    if config.bounds_already_enforced:
        base, rem = divmod(n, cells)
        counts = np.full(cells, base, np.int64)
        counts[:rem] += 1
        return None, counts.reshape(n_batches, n_dev)
    # Hash before bucketing (id families sharing low bits would pile into
    # one batch), salted by the run seed.
    h = _fmix32(encoded.pid.astype(np.uint32) ^
                np.uint32(seed & 0xFFFFFFFF))
    cell_of_row = ((h.astype(np.uint64) * np.uint64(n_batches)) >>
                   np.uint64(32)).astype(np.int64)
    if n_dev > 1:
        cell_of_row = (cell_of_row * n_dev +
                       psh.shard_of_rows(encoded.pid, n_dev))
    order, counts = group_rows_by_cell(cell_of_row, cells)
    return order, counts.reshape(n_batches, n_dev)


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
        # An infeasible pin falls back to the search, visibly.
        obs.event("plan.q_chunk_infeasible", q_chunk=int(q_chunk),
                  P_pad=int(P_pad), Q=int(Q), cap=int(cap))
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


class _Staging:
    """Host buffers and the copy to the device for one stream.

    A batch's rows are gathered into a host buffer set and shipped. On the
    card the sets are pinned, and the copy runs ``non_blocking`` on a side
    stream; a CUDA event recorded after it orders the copy before the
    compute stream reads the batch. On the CPU the "device" tensors are
    the host buffers themselves. A ``StagingRing`` keeps a set from being
    written again until the batch staged from it has had its outputs
    fetched; without a ring (a CPU run that feeds the pass-B cache, which
    keeps what it ships) every batch gets fresh buffers.

    ``counts`` is the [n_batches, n_dev] cell table of ``_batch_assignment``
    and ``cell`` this rank's column: the rank stages its own cell of each
    batch, and an empty cell of a non-empty batch still yields (a rank
    joins every batch's collectives)."""

    def __init__(self, config, encoded, order, counts, device, tracer,
                 cell: int = 0):
        self.config = config
        self.encoded = encoded
        self.order = order
        self.totals = counts.sum(axis=1)
        # The first row of this rank's cell of each batch in ``order``.
        self.starts = (np.cumsum(self.totals) - self.totals +
                       counts[:, :cell].sum(axis=1))
        self.batch_rows = counts[:, cell]
        self.device = device
        self.on_card = device.type == "cuda"
        self.max_rows = (int(self.batch_rows.max()) if len(self.batch_rows)
                         else 0)
        self.copy_stream = (torch.cuda.Stream(device) if self.on_card
                            else None)
        self._sets: Dict[int, Tuple] = {}
        self.tracer = tracer
        self.reship_bytes = 0     # pass-B host->device bytes

    @property
    def stage_s(self) -> float:
        """Seconds staging both passes' batches: the ``ingest.stage``
        spans' total."""
        return self.tracer.total("ingest.stage")

    def _alloc(self):
        vshape = ((self.max_rows, self.config.vector_size)
                  if self.config.vector_size else (self.max_rows,))

        def empty(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=self.on_card)

        return (empty(self.max_rows, torch.int32),
                empty(self.max_rows, torch.int32),
                empty(vshape, torch.float32) if self.config.needs_values
                else None)

    def batches(self, start_at=0, cancelled=None, ring=None,
                track_reship=False):
        """Ships the deterministic batch sequence from ``start_at`` on:
        yields ``(b, pid, pk, values or None, ready event or None)``. Pass
        A and every pass-B re-ship iterate it alike, on the caller's thread
        or on the executor's stager thread (``cancelled`` is the stager's
        teardown event)."""
        enc = self.encoded
        staged = 0
        for b in range(start_at, len(self.batch_rows)):
            if self.totals[b] == 0:
                continue
            cnt = int(self.batch_rows[b])
            offset = int(self.starts[b])
            rows = (slice(offset, offset + cnt) if self.order is None
                    else self.order[offset:offset + cnt])
            if ring is not None:
                # Blocks until the set staged two batches ago has had its
                # outputs fetched; aborts promptly on teardown.
                ring.acquire(cancelled)
            with self.tracer.span("ingest.stage", cat="ingest", batch=b):
                if ring is None:
                    bufs = self._alloc()
                else:
                    slot = staged % ring.n_slots
                    if slot not in self._sets:
                        self._sets[slot] = self._alloc()
                    bufs = self._sets[slot]
                staged += 1
                host = [buf[:cnt] for buf in bufs if buf is not None]
                sources = [enc.pid, enc.pk] + (
                    [enc.values] if self.config.needs_values else [])
                for dst, src in zip(host, sources):
                    if self.order is None:
                        dst.numpy()[...] = src[rows]
                    else:
                        np.take(src, rows, axis=0, out=dst.numpy(),
                                mode="clip")
                ready = None
                if self.on_card:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(self.copy_stream):
                        dev = [h.to(self.device, non_blocking=True)
                               for h in host]
                        ready = torch.cuda.Event()
                        ready.record(self.copy_stream)
                else:
                    dev = host
                obs.inc("ingest.batches_staged")
                if track_reship:
                    # The host-to-device bytes this sweep pays past the cached
                    # prefix: what the pass-B cache exists to shrink.
                    nb = sum(int(h.nbytes) for h in host)
                    self.reship_bytes += nb
                    obs.inc("stream.pass_b_reshipped_bytes", nb)
                else:
                    # Heartbeat progress toward pass A's plan; pass-B
                    # re-ships are counted by the sweep counters instead.
                    obs.inc("progress.batches_staged")
                    obs.inc("progress.rows_staged", cnt)
            values = dev[2] if self.config.needs_values else None
            yield b, dev[0], dev[1], values, ready

    def ready_on_compute(self, item):
        """Orders the compute stream after the batch's copy, and marks the
        copied tensors as used by it (they were allocated on the side
        stream)."""
        *tensors, ready = item[1:]
        if ready is None:
            return
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(ready)
        for t in tensors:
            if t is not None:
                t.record_stream(compute)


def _start_fetch(tensors, device):
    """Starts copying ``tensors`` to the host: on the card into pinned
    buffers, non_blocking on the compute stream, and returns ``(host
    tensors, event)``; the fold waits on the event. On the CPU the
    tensors are already on the host and the event is None."""
    if device.type != "cuda":
        return tensors, None
    host = [None if t is None else
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(
                t, non_blocking=True) for t in tensors]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(device))
    return host, done


def _wait_compute(device) -> None:
    """Waits for the work queued so far on the compute stream (not for the
    side stream's copies)."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


def stream_partials_and_select(config, encoded, scales, keep_table,
                               sel_threshold, sel_scale, sel_min_count,
                               sel_rows_per_uid, rng_seed: Optional[int],
                               device, checkpoint=None,
                               executor: Optional[bool] = None,
                               cache_bytes: Optional[int] = None,
                               mesh=None) -> Tuple[np.ndarray, Dict, Dict]:
    """The streamed aggregation on ``device``. Returns ``(keep bool
    [P_pad], part64, stats)``: ``part64`` holds the combined int64 counts
    and float64 value columns (and VECTOR_SUM's [P_pad, D] float64
    coordinates) ready for ``torch_engine._host_release``; with
    percentiles ``stats["percentile_values"]`` holds the walked [P_pad, Q]
    float32 values.

    ``executor`` selects the overlapped ingest (``ingest/executor.py``):
    None follows ``PIPELINEDP_TPU_INGEST_EXECUTOR`` (on unless 0). The
    overlapped and serial runs release the same bits: the fold worker
    keeps the float64 left fold and the checkpoint-after-fold order of the
    serial loop.

    ``cache_bytes`` is the pass-B device cache's budget
    (``PIPELINEDP_TPU_STREAM_CACHE`` when None, 4 GiB by default; 0
    disables): pass A keeps each shipped batch's device tensors while they
    fit; on overflow the cache freezes and pass B re-reads the cached
    prefix and re-ships only the suffix (``"hybrid"``); with no cache it
    re-ships every batch (``"reship"``). The three sources are
    bit-identical.

    ``checkpoint`` (a ``resilience.checkpoint.CheckpointStore`` or a path)
    saves ``(next_batch, accumulators)`` every ``PIPELINEDP_TPU_CKPT_EVERY``
    folds (default 1), so that a killed run resumes bit for bit: the same
    keys replay, the folded prefix is restored, and success clears the
    store. It needs a fixed ``rng_seed``; a checkpoint of another run
    raises ``CheckpointMismatch``. On a mesh every rank reads the store and
    the rank at position 0 writes it.

    ``mesh`` runs the stream sharded over the mesh's ranks, on the mesh's
    device (see the module docstring); every rank returns the same
    result."""
    device = mesh.device if mesh is not None else torch.device(device)
    n_dev = mesh.size if mesh is not None else 1
    # The run's span tracer: phase totals always accumulate (the stats
    # below are views over them); full spans reach the ledger under
    # PIPELINEDP_TPU_TRACE.
    tr = obs.run_tracer()
    obs.monitor.maybe_start()
    # The execution planner: the full knob vector for this request's
    # shape (env > seam > plan file > default), recorded as one
    # plan.applied event per knob. A plan moves only dp-safe knobs.
    knob_plan = plan_mod.resolve(
        shape={"rows": int(encoded.n_rows),
               "partitions": len(encoded.pk_vocab),
               "quantiles": len(config.percentiles or ())})
    use_executor = (bool(knob_plan.values["ingest_executor"])
                    if executor is None else bool(executor))
    if mesh is not None:
        # Every rank must enqueue the same collectives in the same order;
        # the executor's stager and fold threads would interleave the
        # transfers with them differently on each rank.
        if use_executor:
            obs.event("ingest.forced_serial",
                      reason="multi-process mesh: threaded enqueue "
                             "wedges the collective rendezvous")
            obs.inc("ingest.forced_serial")
        use_executor = False
    P_pad = te._pad_pow2(len(encoded.pk_vocab))
    # Owner blocks tile the partition axis (a no-op on a power-of-two
    # mesh).
    P_pad = -(-P_pad // n_dev) * n_dev
    n = encoded.n_rows
    chunk = chunk_target_rows(config, n_dev)
    n_batches = max(1, -(-n // chunk))
    seed = te._run_seed(rng_seed)
    # The key topology of a single batch: one bounding stream (folded per
    # batch), one selection stream, one noise stream.
    k_bound, k_sel, k_noise = prng.split(prng.PRNGKey(seed), 3)
    _, _, n_mid, span = quantile_tree.tree_constants()
    if config.percentiles:
        subhist_cap = int(knob_plan.values["subhist_byte_cap"])
        try:
            plan = plan_pass_b_sweeps(
                P_pad, len(config.percentiles), span, subhist_cap,
                q_chunk=int(knob_plan.values["q_chunk"]))
        except NotImplementedError:
            obs.inc("walk.path_streamed_refusal")
            obs.event("walk.fallback", path="streamed_refusal",
                      span_bytes=span * 4, cap=subhist_cap)
            raise
        if plan.chunked:
            obs.inc("walk.path_partition_block_chunked")
            obs.event("walk.fallback", path="partition_block_chunked",
                      p_blk=int(plan.p_blk), q_chunk=int(plan.q_chunk),
                      P_pad=int(P_pad), tiles=plan.n_tiles,
                      tiles_per_sweep=plan.tiles_per_sweep,
                      sweeps=plan.n_sweeps)
    ckpt_store = ckpt_mod.as_store(checkpoint)
    if ckpt_store is not None and rng_seed is None:
        raise ValueError(
            "checkpointing requires a fixed rng_seed: resume must replay "
            "the identical noise keys (the privacy budget is consumed at "
            "noise draw, not at job success)")

    order, counts = _batch_assignment(config, encoded, n_batches, seed,
                                      n_dev)
    batch_rows = counts.sum(axis=1)
    # The lane plan bounds a batch's GLOBAL rows: the ranks' lanes add.
    max_rows = int(batch_rows.max())
    layout = te._fixedpoint_layout(config)
    vec_fx = te._vector_fx(config)
    # The lane plan is a per-batch bound: it depends on the largest batch,
    # which exceeds the chunk only where one unit owns that many rows.
    try:
        fx_bits = te._fx_plan(max_rows)[0] if layout or vec_fx else 12
    except NotImplementedError:
        raise NotImplementedError(
            f"the largest streaming batch holds {max_rows} rows — beyond "
            "the 2^27-row per-batch lane capacity. A batch this far over "
            f"the {chunk}-row chunk target means a single privacy unit "
            "owns that many rows; its rows cannot be split across batches "
            "(contribution bounding must see them together)")
    names = _rank1_names(config, fx_bits)

    # The lanes fold into exact float64 step totals per batch; only the
    # integer counts live in ``acc``.
    acc = {"count": np.zeros(P_pad, np.int64),
           "privacy_id_count_raw": np.zeros(P_pad, np.int64)}
    val_acc = {spec.name: np.zeros(P_pad, np.float64) for spec in layout}
    vec_acc = None
    mid_acc = None

    # Resume: restore the folded prefix and skip it. The fold is a left
    # fold, so the prefix sum and the rest give the uninterrupted run's
    # float64 operations exactly.
    start_batch = 0
    ckpt_fp = None
    if ckpt_store is not None:
        with tr.span("ckpt.restore", cat="checkpoint"):
            ckpt_fp = ckpt_mod.run_fingerprint(
                config, n, n_batches, seed, P_pad, fx_bits,
                data=ckpt_mod.data_digest(encoded), n_dev=n_dev)
            saved = ckpt_store.load_for(ckpt_fp)
        if saved is not None:
            start_batch = saved.next_batch
            for name in acc:
                acc[name] = saved.arrays[f"acc:{name}"]
            for name in val_acc:
                val_acc[name] = saved.arrays[f"val:{name}"]
            vec_acc = saved.arrays.get("vec")
            if "mid" in saved.arrays:
                mid_acc = torch.from_numpy(saved.arrays["mid"]).to(device)

    # The pass-B device cache. A resumed run never caches: the skipped
    # prefix is absent, so a partial cache would drop those rows from
    # pass B.
    cache_cap = (int(knob_plan.values["stream_cache_bytes"])
                 if cache_bytes is None else int(cache_bytes))
    cache: Optional[list] = ([] if config.percentiles and start_batch == 0
                             and cache_cap > 0 else None)
    cache_used = 0
    cache_frozen = False
    cache_upto = 0  # the first batch past the cached prefix
    staging = _Staging(config, encoded, order, counts, device, tr,
                       cell=mesh.index if mesh is not None else 0)
    ckpt_writer = mesh is None or mesh.index == 0
    # On the CPU a cached batch's tensors are the staging buffers, so a
    # run that feeds the cache stages into fresh buffers; on the card the
    # cache keeps device copies and the ring's pinned sets rotate.
    ring = (None if cache is not None and device.type == "cpu"
            else ingest.StagingRing(2))
    n_saves = 0
    ckpt_every = plan_mod.knobs.checkpoint_every()
    obs.inc("ingest.streamed_runs")
    # Only the rows this run stages: a resume skips the folded prefix.
    obs.inc("ingest.rows_ingested", int(batch_rows[start_batch:].sum()))
    obs.inc("progress.batches_planned",
            int((batch_rows[start_batch:] > 0).sum()))
    if config.percentiles:
        obs.inc("progress.sweeps_planned", plan.n_sweeps)
    obs.inc("ingest.executor_overlapped" if use_executor
            else "ingest.executor_serial")

    def fold_host(host, vec):
        """Folds one batch's fetched [C+1, P] block (and VECTOR_SUM's
        [P, W] block) into the host accumulators."""
        nonlocal vec_acc
        batch64 = {name: host[i].astype(np.int64)
                   for i, name in enumerate(names)}
        batch64["privacy_id_count_raw"] = host[-1].astype(np.int64)
        te._fold_fx_steps(config, batch64, fx_bits)
        acc["count"] += batch64["count"]
        acc["privacy_id_count_raw"] += batch64["privacy_id_count_raw"]
        for spec in layout:
            val_acc[spec.name] += batch64[spec.name]
        if vec is not None:
            # The batch's lane sums become exact float64 step totals with
            # the batch's count (offset removal is linear); under f32 the
            # batch's float32 sums add in float64 in batch order.
            v64 = (te._fold_vector_fx_steps(config, vec, batch64["count"],
                                            fx_bits) if vec_fx
                   else vec.astype(np.float64))
            vec_acc = v64 if vec_acc is None else vec_acc + v64

    def save_ckpt(next_batch):
        nonlocal n_saves
        if not ckpt_writer:
            return
        with tr.span("ckpt.save", cat="checkpoint", next_batch=next_batch):
            arrays = {f"acc:{k}": v for k, v in acc.items()}
            arrays.update({f"val:{k}": v for k, v in val_acc.items()})
            if vec_acc is not None:
                arrays["vec"] = vec_acc
            if mid_acc is not None:
                arrays["mid"] = mid_acc.cpu().numpy()
            ckpt_store.save(ckpt_mod.StreamCheckpoint(ckpt_fp, next_batch,
                                                      arrays))
        n_saves += 1

    def fold_item(item):
        """Waits for one launched batch's outputs and folds them, in batch
        order: on the caller's thread (serial, one batch behind the
        launch) or on the executor's fold worker. The mid histogram adds
        at fold time, so a checkpoint after batch j holds no later
        batch's histogram."""
        nonlocal mid_acc
        b, host, vec, done, mid = item
        with tr.span("ingest.fetch", cat="ingest", batch=b):
            if done is not None:
                done.synchronize()
            if ring is not None:
                ring.retire()
        with tr.span("ingest.fold", cat="ingest", batch=b):
            fold_host(host.numpy(), None if vec is None else vec.numpy())
            if mid is not None:
                mid_acc = mid if mid_acc is None else mid_acc.add_(mid)
        if ckpt_store is not None and (b + 1) % ckpt_every == 0:
            save_ckpt(b + 1)

    def launch(item):
        """Fault check and the batch's device work (asynchronous on the
        card), always on the dispatch thread, so an injected
        ``ChunkFailure`` severs the run at one batch in both modes."""
        nonlocal cache_used, cache_frozen, cache_upto
        b, pid, pk, values, _ = item
        faults.check_chunk(b)
        staging.ready_on_compute(item)
        with obs.device_annotation("pdp.stream_partials"):
            part, nseg, mid = _batch_partials(
                config, P_pad, pid, pk, values, _cell_key(k_bound, b, mesh),
                fx_bits)
        packed = torch.stack([part[k] for k in names] + [nseg])
        vec = part.get("vector_sum")
        if mesh is not None:
            # One replicating exchange per output: every rank folds the
            # whole batch.
            packed = psh.combine_shards(packed, mesh, 1, True,
                                        "stream.packed")
            if vec is not None:
                vec = psh.combine_shards(vec, mesh, 0, True, "stream.vector")
            if mid is not None:
                mid = psh.combine_shards(mid, mesh, 0, True, "stream.mid")
        (host, vec), done = _start_fetch([packed, vec], device)
        if cache is not None and not cache_frozen:
            nbytes = sum(int(t.nbytes) for t in (pid, pk, values)
                         if t is not None)
            if cache_used + nbytes <= cache_cap:
                cache_used += nbytes
                cache.append((b, pid, pk, values, None))
                cache_upto = b + 1
            else:
                # Overflow freezes the cache: the resident prefix keeps
                # serving pass B and only the suffix re-ships.
                cache_frozen = True
                obs.inc("stream.cache_overflow")
                obs.event("stream.cache_overflow",
                          cache_bytes=int(cache_used + nbytes),
                          cap=int(cache_cap), prefix_batches=len(cache))
        return b, host, vec, done, mid

    with tr.span("ingest.pass_a", cat="ingest", n_batches=n_batches,
                 executor="overlapped" if use_executor
                 else "serial") as pass_a:
        if use_executor:
            # Overlapped pass A: the stager prepares batch b+1 while the
            # device computes batch b and the fold worker drains finished
            # batches. Any failure cancels both workers and joins them before
            # it propagates, so the checkpoint on disk is a clean prefix.
            folder = ingest.OrderedFoldWorker(fold_item, depth=2)
            try:
                with ingest.BackgroundStager(
                        lambda cancelled: staging.batches(
                            start_batch, cancelled, ring),
                        depth=1, name="stager-a") as stager:
                    for item in stager.items(poll=folder.raise_if_failed):
                        folder.submit(launch(item))
                folder.finish()
            except BaseException:
                folder.cancel()
                raise
        else:
            # Serial pass A: fold one batch late, so batch b's copy and work
            # are in flight while batch b-1's fetch waits.
            pending = None
            try:
                for item in staging.batches(start_batch, ring=ring):
                    out = launch(item)
                    if pending is not None:
                        fold_item(pending)
                    pending = out
            except faults.FaultInjected:
                # Let the previous batch's work finish before propagating;
                # its result is not folded, so the checkpoint stays a clean
                # prefix.
                if pending is not None and pending[3] is not None:
                    pending[3].synchronize()
                raise
            if pending is not None:
                fold_item(pending)
    # The stats below are views over the run tracer's spans: staging,
    # waiting for batch outputs and folding, against pass A's wall.
    t_loop = pass_a.duration
    t_stage = tr.total("ingest.stage")
    t_fetch = tr.total("ingest.fetch")
    t_fold = tr.total("ingest.fold")
    busy_a = t_stage + t_fetch + t_fold

    part64: Dict[str, np.ndarray] = dict(acc)
    # One division by the scale over the combined step totals: the same
    # bits as a single batch's release, for any batching.
    for spec in layout:
        part64[spec.name] = val_acc[spec.name] / spec.scale
    if vec_acc is not None:
        part64["vector_sum"] = (vec_acc / te._vector_fx_scale(config)
                                if vec_fx else vec_acc)

    if config.selection is None:
        keep = np.ones(P_pad, bool)
    else:
        nseg = acc["privacy_id_count_raw"]
        if nseg.max(initial=0) >= int(
                knob_plan.values["select_units_cap"]):
            raise NotImplementedError(
                "more than 2^31 privacy units in one partition")
        # Selection never reads the walk: strip the percentiles.
        sel_config = dataclasses.replace(config, percentiles=())
        with tr.span("ingest.select", cat="ingest"), \
                obs.device_annotation("pdp.partition_select"):
            keep = _select(sel_config, P_pad, torch.from_numpy(
                nseg.astype(np.int32)).to(device), keep_table,
                sel_threshold, sel_scale, sel_min_count, sel_rows_per_uid,
                k_sel)
        te._record_selection_audit(config.selection, int((nseg > 0).sum()),
                                   int(keep.sum()), "streamed")
    stats = {"n_batches": n_batches, "chunk_rows": chunk, "fx_bits": fx_bits,
             "max_batch_rows": max_rows, "mesh_devices": n_dev,
             "t_stage": t_stage,
             "t_device": t_fetch, "t_fold": t_fold, "t_total": t_loop,
             "overlap_frac": (max(0.0, 1.0 - t_loop / busy_a)
                              if busy_a > 0 else 0.0),
             "executor": "overlapped" if use_executor else "serial",
             "fold_wait_s": t_fetch + t_fold}
    if ckpt_store is not None:
        stats["resumed_from_batch"] = start_batch
        stats["checkpoint_saves"] = n_saves
    if config.percentiles:
        stats.update(_pass_b(config, plan, P_pad, acc, mid_acc, scales,
                             k_bound, k_noise, cache, cache_frozen,
                             cache_upto, staging, use_executor, device,
                             tr, int(knob_plan.values["tree_rows_cap"]),
                             mesh))
    stats["stage_s"] = staging.stage_s
    plan_mod.note_observed("pass_a", t_loop)
    if config.percentiles:
        plan_mod.note_observed("pass_b", tr.total("ingest.pass_b_sweep"))
        plan_mod.note_observed("walk", tr.total("walk.top") +
                               tr.total("walk.bottom"))
    if ckpt_store is not None and ckpt_writer:
        # The run released its outputs: a later run on this path must not
        # resume a finished one.
        ckpt_store.clear()
    return keep, part64, stats


def _pass_b(config, plan, P_pad, acc, mid_acc, scales, k_bound, k_noise,
            cache, cache_frozen, cache_upto, staging, use_executor,
            device, tr, tree_rows_cap, mesh=None) -> Dict:
    """The percentile walk's second pass: the top levels walk on the
    summed mid histogram, then each sweep of the plan streams the batches
    (the cached prefix from the device, the rest re-shipped) into its
    packed [T, Pb, Qc, span] subtree histograms (K3 on the card), and the
    bottom levels walk per tile. On a mesh each rank bins its own cells
    and one replicating all-reduce per sweep sums the ranks' histograms
    (integer sums: any grouping gives the same counts)."""
    _, _, n_mid, span = quantile_tree.tree_constants()
    # The histograms accumulate in device int32, so a partition with 2^31
    # kept rows would wrap a bucket: guard on the host counts.
    if int(acc["count"].max(initial=0)) >= tree_rows_cap:
        raise NotImplementedError(
            "streamed percentiles: a partition holds >= 2^31 kept rows — "
            "beyond the int32 tree-histogram capacity")
    k_tree = prng.fold_in(k_noise, 0x7ee)
    scale = float(np.asarray(scales, np.float32)[-1])
    with tr.span("walk.top", cat="walk"), \
            obs.device_annotation("pdp.walk_top"):
        lo, hi, target, leaf_lo, done = _walk_top(
            config, P_pad, mid_acc.reshape(P_pad, n_mid), k_tree, scale)
    del mid_acc
    prefix = cache or []
    complete = cache is not None and not cache_frozen
    Q = len(config.percentiles)
    vals = torch.empty(P_pad, Q, dtype=torch.float32, device=device)

    def run_sweep(consume):
        """One traversal of the batch stream: the cached prefix, then, past
        it, the re-shipped batches through a ring of buffer sets (on the
        executor's stager when it is on)."""
        if prefix:
            obs.inc("stream.pass_b_cache_hit_batches", len(prefix))
        for item in prefix:
            consume(item, None)
        if complete:
            return
        obs.inc("stream.pass_b_reship_rounds")
        ring_b = ingest.StagingRing(2)
        if use_executor:
            with ingest.BackgroundStager(
                    lambda cancelled: staging.batches(
                        cache_upto, cancelled, ring_b,
                        track_reship=True),
                    depth=1, name="stager-b") as stager_b:
                for item in stager_b.items():
                    consume(item, ring_b)
        else:
            for item in staging.batches(cache_upto, ring=ring_b,
                                        track_reship=True):
                consume(item, ring_b)

    for sweep in plan.sweeps:
        q0_s, qn, p0_s = sweep[0]
        Pb = min(plan.p_blk, P_pad - p0_s)
        with tr.span("ingest.pass_b_sweep", cat="ingest", tiles=len(sweep),
                     q0=q0_s, p0=p0_s):
            vals = _pass_b_sweep(config, sweep, Pb, qn, span, leaf_lo, lo,
                                 hi, target, done, k_bound, k_tree, scale,
                                 staging, run_sweep, device, vals, tr, mesh)
        obs.inc("stream.pass_b_stream_sweeps")
        obs.inc("stream.pass_b_tiles", len(sweep))
    # The monotone step runs once over the full quantile list.
    quantiles = np.asarray([p / 100.0 for p in config.percentiles],
                           np.float32)
    values = te._monotone_in_q(vals, quantiles).cpu().numpy()
    return {"percentile_values": values,
            "pass_b_source": ("device_cache" if complete
                              else "hybrid" if prefix else "reship"),
            "pass_b_sweeps": plan.n_sweeps, "pass_b_tiles": plan.n_tiles,
            "pass_b_tiles_per_sweep": plan.tiles_per_sweep,
            "pass_b_cached_batches": len(prefix),
            "pass_b_reshipped_bytes": staging.reship_bytes,
            "pass_b_sweep_s": tr.total("ingest.pass_b_sweep")}


def _pass_b_sweep(config, sweep, Pb, qn, span, leaf_lo, lo, hi, target,
                  done, k_bound, k_tree, scale, staging, run_sweep, device,
                  vals, tr, mesh=None):
    """One sweep of the plan: streams the batches into the sweep's packed
    [T, Pb, Qc, span] subtree histograms, then walks the bottom levels
    per tile into ``vals``."""
    starts = torch.stack([leaf_lo[p0:p0 + Pb, q0:q0 + qn]
                          for q0, _, p0 in sweep]).contiguous()
    p_offs = torch.tensor([p0 for _, _, p0 in sweep], dtype=torch.int32,
                          device=device)
    sub = torch.zeros(len(sweep), Pb, qn, span, dtype=torch.int32,
                      device=device)

    def consume(item, ring_b):
        b, pid, pk, values, _ = item
        faults.check_pass_b_chunk(b)
        staging.ready_on_compute(item)
        with obs.device_annotation("pdp.stream_pass_b"):
            _sweep_batch(config, pid, pk, values, _cell_key(k_bound, b, mesh),
                         starts, p_offs, Pb, span, sub)
        if ring_b is not None:
            # The batch's buffers are free once its work has run.
            _wait_compute(device)
            ring_b.retire()

    run_sweep(consume)
    if mesh is not None:
        sub = psh.combine_shards(sub, mesh, 0, True, "stream.subtree")
    for ti, (q0, _, p0) in enumerate(sweep):
        psl, qsl = slice(p0, p0 + Pb), slice(q0, q0 + qn)
        with tr.span("walk.bottom", cat="walk", p0=p0, q0=q0), \
                obs.device_annotation("pdp.walk_bottom"):
            vals[psl, qsl] = _walk_bottom(
                config, Pb, sub[ti], starts[ti], lo[psl, qsl],
                hi[psl, qsl], target[psl, qsl], leaf_lo[psl, qsl],
                done[psl, qsl], k_tree, scale, p0)
    return vals


def _cell_key(k_bound, b: int, mesh):
    """The bounding key of batch ``b``; on a mesh folded once more with
    the rank's position, as the JAX package's sharded kernels fold it."""
    kb = prng.fold_in(k_bound, b)
    return kb if mesh is None else prng.fold_in(kb, mesh.index)


@costs.instrumented(phase="pass_a")
def _batch_partials(config, P_pad, pid, pk, values, key, fx_bits):
    """One batch's pass-A device work: its partials and, with
    percentiles, its [P, 256] mid histogram."""
    part, nseg, qrows = te._partials(config, P_pad, pid, pk, values, key,
                                     fx_bits)
    mid = te._mid_histogram(P_pad, qrows) if config.percentiles else None
    return part, nseg, mid


@costs.instrumented(phase="select")
def _select(config, P_pad, nseg, keep_table, threshold, scale, min_count,
            rows_per_uid, key) -> np.ndarray:
    """The streamed partition selection over the combined counts."""
    keep, _ = te._selection_and_metrics(config, P_pad, {}, nseg, keep_table,
                                        threshold, scale, min_count,
                                        rows_per_uid, key)
    return keep.cpu().numpy()


@costs.instrumented(phase="pass_b")
def _sweep_batch(config, pid, pk, values, key, starts, p_offs, Pb, span,
                 sub) -> None:
    """One batch of a pass-B sweep, added into the sweep's histograms."""
    qpk, leaf, kept = te._bounded_qrows(config, pid, pk, values, key)
    te._subtree_counts_multi(qpk, leaf, kept, starts, p_offs, Pb, span,
                             out=sub)


_walk_top = costs.instrumented(te._walk_top, phase="walk")
_walk_bottom = costs.instrumented(te._walk_bottom, phase="walk")
