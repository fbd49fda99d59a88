"""Shape-bucketed request fusion: one device path serves a whole batch of
tenant requests.

The port of ``pipelinedp_tpu/serve/fusion.py``. A resident service at
heavy traffic dies by a thousand dispatches: served solo, every request
runs its own device path, so the warm path is bounded by per-request
launches and device occupancy, not by arithmetic. This module batches
*real* DP requests:

* a **micro-batching layer between admission and the workers**: every
  admitted, fusable request lands in a shape bucket keyed by its
  tenant-independent params signature plus its ``(rows, partitions)``
  edges (the JAX package's buckets); a bucket flushes as ONE batch when
  it reaches ``serve_fuse_batch`` requests or its bounded wait window
  (``serve_fuse_window_ms``) expires — latency is bounded, batching is
  opportunistic;
* **one device path per batch**: the batch executor hands the members'
  preparations to ``torch_engine.fused_aggregate_batch``, which
  concatenates their rows, unpadded, and reduces them with ONE launch of
  K1 (``segment_sum_lanes``) for the whole batch. The JAX package pads
  every member to the bucket edge and masks the padding
  (``pad_request_to_bucket``); the port has no pad mask and no
  counterpart of that function, because it pads nothing;
* **bit-identity per request** (PARITY row 35): per-request root keys,
  per-request row tie-breaks and run boundaries that break at every
  request make request b's slice of the batch bit-identical — released
  values AND kept sets — to the same request served solo;
* **bookkeeping exactly as solo**: every request keeps its own
  two-phase budget reserve/commit, accountant audit record and books
  entry; the fusion layer only changes WHEN device work happens, never
  whose budget pays for it.

Bucket boundaries and the window are dp-safe ``plan/`` knobs
(``serve_fusion`` / ``serve_fuse_window_ms`` / ``serve_fuse_batch`` /
``serve_fuse_rows_floor``), and live bucket occupancy is pushed into the
heartbeat's serve section so a stalled window self-diagnoses.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, List, Optional, Tuple

from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.dp_engine import DataExtractors
from pipelinedp_tpu_torch.obs import trace_context

#: Smallest legal row-bucket edge: the JAX package's solo path never pads
#: below 8192 rows (``torch_engine._pad_rows`` is its rule), and the port
#: buckets as it does.
_ROWS_FLOOR_MIN = 8192

#: Seconds between queue-put retries / flush-loop beats while the
#: service drains (same beat as the serve workers).
_POLL_S = 0.02


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """One fusion bucket: the tenant-independent params signature (which
    fixes the FusedConfig, metrics, extractor shape and public-partition
    mode) plus the data shape's edges. Every member of a bucket runs in
    one batched device path."""
    signature: str
    rows: int        # row edge: every member has at most this many rows
    partitions: int  # the solo path's _pad_pow2(P) — shared exactly
    fx_bits: int     # lane plan at the bucket's row edge
    # Vector shape, EXPLICIT: the params signature covers these too, but
    # the batch's [N, D] value plane and its accumulator layout are
    # incompatible across any difference here — a D=64 and a D=256
    # request (or 'fx' vs 'f32' lanes) in one batch would be a shape
    # error at best and silently mixed noise calibration at worst.
    vector_size: int = 0          # 0 = scalar request
    vector_norm_kind: str = ""    # "" = scalar request
    vector_accumulator: str = ""  # "" = scalar request

    @property
    def label(self) -> str:
        return f"{self.signature[:8]}@r{self.rows}p{self.partitions}"


def bucket_for(config, encoded, rows_floor: int) -> Optional[BucketKey]:
    """The shape half of a request's bucket key, or None when the
    request cannot fuse (empty vocabulary, streamed scale). The
    partition edge is EXACTLY the solo path's ``_pad_pow2(P)`` — the
    selection draw is shaped by it, so fused and solo must agree. The
    row edge is the JAX package's: the next 8192-row multiple of the
    request's rows (``_pad_rows``), floored at ``serve_fuse_rows_floor``.
    The port pads no rows, so the edge decides only which requests batch
    together and the lane plan (``fused_fx_bits``, a capacity choice):
    any edge is bit-identical, and the knob is dp-safe."""
    from pipelinedp_tpu_torch import streaming

    P = len(encoded.pk_vocab)
    if P == 0:
        return None
    if streaming.should_stream(config, encoded.n_rows):
        return None
    rows = max(te._pad_rows(int(encoded.n_rows)),
               max(int(rows_floor), _ROWS_FLOOR_MIN))
    return BucketKey(
        signature="", rows=rows, partitions=te._pad_pow2(P),
        fx_bits=te.fused_fx_bits(config, rows),
        vector_size=int(config.vector_size or 0),
        vector_norm_kind=(config.vector_norm_kind.value
                          if config.vector_size and
                          config.vector_norm_kind else ""),
        vector_accumulator=(config.vector_accumulator
                            if config.vector_size else ""))


class FusedBatch:
    """One flushed bucket's worth of admitted requests, riding the
    service queue as a unit: a worker executes the whole batch through
    one device path and finishes every member's pending individually."""

    __slots__ = ("key", "entries")

    def __init__(self, key: BucketKey, entries: List[Any]):
        self.key = key
        self.entries = entries


class _Bucket:
    __slots__ = ("key", "entries", "deadline")

    def __init__(self, key: BucketKey, deadline: float):
        self.key = key
        self.entries: List[Any] = []
        self.deadline = deadline


@dataclasses.dataclass
class _Admitted:
    """What ``offer`` learned about a fusable request, stashed on the
    pending so the executor never re-derives it."""
    signature: str
    config: Any
    encoded: Any
    bucket: BucketKey


class Fuser:
    """The micro-batching layer: ``offer()`` runs on the submitting
    caller's thread (the host-side encode is per-request work and
    parallelizes across callers), buckets live under one lock, and a
    single ``pdp-serve-fuse`` thread flushes expired windows. Batches
    enter the service's own bounded queue, so worker-pool sizing and
    graceful drain stay exactly the solo story."""

    def __init__(self, service, clock, window_ms: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 rows_floor: Optional[int] = None):
        from pipelinedp_tpu_torch import plan as plan_mod
        from pipelinedp_tpu_torch.ingest.executor import _CaptureThread

        self._service = service
        self._clock = clock
        self.window_s = max(0.0, float(
            plan_mod.knob_value("serve_fuse_window_ms")
            if window_ms is None else window_ms) / 1000.0)
        self.max_batch = max(1, int(
            plan_mod.knob_value("serve_fuse_batch")
            if max_batch is None else max_batch))
        # Tile-rounded, as in the JAX package, so a floor like 10000
        # buckets requests the way it does there.
        self.rows_floor = te._pad_rows(max(_ROWS_FLOOR_MIN, int(
            plan_mod.knob_value("serve_fuse_rows_floor")
            if rows_floor is None else rows_floor)))
        self._lock = threading.Lock()
        self._buckets: Dict[BucketKey, _Bucket] = {}
        self._queued = 0
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = _CaptureThread(self._loop, "pdp-serve-fuse")
        self._thread.start()

    # --- admission side (caller thread) ---

    def offer(self, pending) -> bool:
        """Route one admitted pending into its shape bucket. Returns
        False when the request cannot fuse (non-fusable params, shapes
        that would stream, encode failure, fuser congestion or a
        closing service) — the caller then queues it solo, so fusion
        can only ever ADD a path, never lose a request."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.serve.service import params_signature

        request = pending.request
        try:
            if not te.params_are_fusable(request.params):
                return False
            config = te.FusedConfig.from_params(
                request.params, request.public_partitions is not None)
            extractors = (request.data_extractors
                          if request.data_extractors is not None
                          else DataExtractors())
            encoded = te.encode(
                request.dataset, extractors, request.public_partitions,
                require_pid=not config.bounds_already_enforced,
                vector_size=config.vector_size)
            shape = bucket_for(config, encoded, self.rows_floor)
        except Exception:
            # A request the encode rejects fails identically on the
            # solo path, where the existing error-refusal story owns it.
            return False
        if shape is None:
            return False
        signature = params_signature(request)
        key = dataclasses.replace(shape, signature=signature)
        pending.fusion = _Admitted(signature=signature, config=config,
                                   encoded=encoded, bucket=key)
        ready: Optional[FusedBatch] = None
        with self._lock:
            if self._stop.is_set():
                return False
            if self._queued >= self._service.max_queue:
                # Bounded like the service queue: a congested fuser
                # sheds to the solo path instead of growing without
                # bound (which may then refuse queue_full — the same
                # backpressure story, one layer earlier).
                obs.inc("serve.fusion_shed")
                return False
            bucket = self._buckets.get(key)
            if bucket is None:
                bucket = _Bucket(key, self._clock.monotonic() +
                                 self.window_s)
                self._buckets[key] = bucket
            bucket.entries.append(pending)
            self._queued += 1
            if len(bucket.entries) >= self.max_batch:
                self._buckets.pop(key, None)
                self._queued -= len(bucket.entries)
                ready = FusedBatch(key, bucket.entries)
        # Past the locked insertion the pending is COMMITTED to the
        # fusion path (returning False now would double-route it), so
        # nothing below may take the offer down: a failure while
        # emitting a ready batch finishes its members as error
        # refusals (exactly once — finish() is checked), and a failure
        # before that leaves the pending safely in its bucket for the
        # window thread to flush.
        try:
            obs.inc("serve.fusion_offered")
            self._push_state()
            if ready is not None:
                self._emit(ready)
            else:
                self._wake.set()  # re-arm the flush loop's deadline
        except Exception as e:
            obs.event("serve.fusion_offer_error", error=repr(e))
            if ready is not None:
                for p in ready.entries:
                    if not p.done.is_set():
                        self._service._release_lease(p.lease)
                        p.finish("refusal", self._service._refuse(
                            p.lease.request_id, p.lease.tenant,
                            "error",
                            f"fusion emit failed: "
                            f"{type(e).__name__}: {e}"))
        return True

    # --- the window flush thread ---

    def _loop(self) -> None:
        # Beat at a quarter of the window (bounded [1ms, 20ms]) so a
        # deadline is overshot by at most ~window/4; offer() wakes the
        # loop early when a new bucket opens.
        beat = min(max(self.window_s / 4, 0.001), _POLL_S)
        while True:
            self._wake.wait(beat)
            self._wake.clear()
            if self._stop.is_set():
                return
            self._flush_due()

    def _flush_due(self, everything: bool = False) -> None:
        now = self._clock.monotonic()
        ready: List[FusedBatch] = []
        with self._lock:
            for key in list(self._buckets):
                bucket = self._buckets[key]
                if everything or now >= bucket.deadline:
                    self._buckets.pop(key, None)
                    self._queued -= len(bucket.entries)
                    ready.append(FusedBatch(key, bucket.entries))
        if ready:
            self._push_state()
        for batch in ready:
            self._emit(batch)

    def _emit(self, batch: FusedBatch) -> None:
        """Hand a flushed batch to the worker pool through the
        service's own bounded queue. During a close the workers drain
        the queue before exiting, so a put only fails once the pool is
        gone — those stragglers are refused exactly like the close()
        sweep refuses queued singles."""
        from pipelinedp_tpu_torch import obs
        svc = self._service
        while True:
            try:
                svc._q.put(batch, timeout=_POLL_S)
                obs.inc("serve.fused_batches_queued")
                return
            except queue.Full:
                if svc._stop.is_set() and not svc._workers:
                    break
        for pending in batch.entries:
            svc._refuse_unworked(
                pending, "service closed before the fused batch "
                "reached a worker")

    # --- lifecycle / introspection ---

    def close(self) -> None:
        """Stop accepting offers, then flush every open window into
        the queue (the closing service still drains it) and join the
        flush thread. Stop-then-flush, in that order: an offer racing
        close either lands before the final flush (and is served) or
        sees the stop flag and falls back to the solo queue — no
        pending can strand in a bucket."""
        self._stop.set()
        self._wake.set()
        self._flush_due(everything=True)
        while self._thread.is_alive():
            self._thread.join(timeout=_POLL_S)
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        obs_monitor.update_fusion(None)

    def snapshot(self) -> Dict[str, Any]:
        """Live bucket occupancy for the heartbeat's serve section."""
        now = self._clock.monotonic()
        with self._lock:
            buckets = {
                b.key.label: {
                    "queued": len(b.entries),
                    "rows": b.key.rows,
                    "partitions": b.key.partitions,
                    "window_remaining_s": round(
                        max(0.0, b.deadline - now), 4),
                } for b in self._buckets.values()}
        return {"window_ms": round(self.window_s * 1000, 3),
                "max_batch": self.max_batch,
                "queued": sum(b["queued"] for b in buckets.values()),
                "buckets": buckets}

    def _push_state(self) -> None:
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        obs_monitor.update_fusion(self.snapshot())

    # --- the batch executor (worker thread) ---

    def execute(self, batch: FusedBatch) -> None:
        """Serve one flushed batch: per-request graph build + budget
        finalization under each warm entry's lock (exactly the solo
        admission-to-accountant sequence), then ONE batched device path per
        stackable group, then each request's own release, commit, books
        and response. Every pending is finished exactly once on every
        path — the kill/failure semantics are the solo worker's."""
        from pipelinedp_tpu_torch import obs

        ready = []
        for pending in batch.entries:
            # Explicit per-member context handoff: one fused batch
            # carries MANY requests' traces, so each member's phase-1
            # work is stamped under its own admission-time context.
            with trace_context.restore(pending.ctx):
                ctx = self._begin(pending)
            if ctx is not None:
                ready.append(ctx)
        if not ready:
            return
        groups: Dict[Tuple, List] = {}
        for ctx in ready:
            groups.setdefault(ctx.prep.stack_signature(),
                              []).append(ctx)
        if len(groups) > 1:
            obs.event("serve.fused_batch_split", bucket=batch.key.label,
                      groups=len(groups))
        for group in groups.values():
            self._run_group(batch.key, group)

    def _begin(self, pending):
        """Phase 1 for one request: the solo worker's front half —
        fault seam, warm entry, fresh accountant, graph build, budget
        finalization — stopping short of device dispatch. Returns an
        execution context, or None when the pending was already
        finished (injected kill, clean failure, or a visible fallback
        to solo execution)."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import audit as obs_audit
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        from pipelinedp_tpu_torch.budget_accounting import (
            NaiveBudgetAccountant)
        from pipelinedp_tpu_torch.resilience import faults

        svc = self._service
        request, lease = pending.request, pending.lease
        rid, tenant = lease.request_id, lease.tenant
        admitted: _Admitted = pending.fusion
        signature = admitted.signature
        obs_monitor.update_request(rid, phase="fused_batch",
                                   signature=signature,
                                   bucket=admitted.bucket.label)
        try:
            # The injected hard-kill seam, per request even mid-batch:
            # a FaultInjected models the process dying between the
            # durable reserve and any commit/release.
            faults.check_serve_request(pending.seq)
            entry, warm = svc._warm_entry(request, signature)
            obs.inc("serve.warm_hits" if warm else "serve.cold_builds")
            with entry.lock:
                try:
                    if hasattr(entry.backend, "rng_seed"):
                        entry.backend.rng_seed = request.rng_seed
                    accountant = NaiveBudgetAccountant(
                        total_epsilon=lease.epsilon,
                        total_delta=lease.delta)
                    accountant.bind_books(tenant, rid)
                    entry.engine.rebind_budget_accountant(accountant)
                    extractors = (request.data_extractors
                                  if request.data_extractors is not None
                                  else DataExtractors())
                    with obs_audit.books_context(tenant, rid):
                        with svc._tr.span("serve.request", cat="serve",
                                          tenant=tenant, warm=warm,
                                          fused=True) as sp:
                            result = entry.engine.aggregate(
                                request.dataset, request.params,
                                extractors,
                                public_partitions=(
                                    request.public_partitions))
                            accountant.compute_budgets()
                            prep = None
                            if isinstance(result, te.LazyFusedResult):
                                prep = result.prepare_fused(
                                    encoded=admitted.encoded)
                            if prep is None:
                                # Visible fallback: this request runs
                                # solo (its own device path) but keeps the
                                # exact solo semantics — never silent.
                                # The offer-time encode rides along so
                                # the rows are never encoded twice.
                                obs.inc("serve.fusion_fallbacks")
                                obs.event("serve.fusion_fallback",
                                          request_id=rid, tenant=tenant,
                                          bucket=admitted.bucket.label)
                                if isinstance(result,
                                              te.LazyFusedResult):
                                    result._encoded_hint = (
                                        admitted.encoded)
                                results = list(result)
                except BaseException:
                    entry.engine.clear_budget_accountant()
                    raise
        except faults.FaultInjected as e:
            # Hard kill: the reserve stays spent (noise may have been
            # drawn); the warm slot is dropped; the submitter sees the
            # crash. Other batch members are untouched — each pending
            # resolves exactly once.
            svc._drop_entry(request, signature)
            obs.inc("serve.requests_killed")
            obs.event("serve.request_killed", request_id=rid,
                      tenant=tenant, error=repr(e))
            obs_monitor.unregister_request(rid)
            pending.finish("raise", e)
            return None
        except Exception as e:
            svc._drop_entry(request, signature)
            svc._release_lease(lease)
            obs_monitor.unregister_request(rid)
            pending.finish("refusal", svc._refuse(
                rid, tenant, "error", f"{type(e).__name__}: {e}"))
            return None
        if prep is None:
            svc._commit_and_respond(pending, accountant, results, warm,
                                    signature, sp.duration, fused=False)
            return None
        return _ExecCtx(pending=pending, entry=entry, warm=warm,
                        accountant=accountant, lazy=result, prep=prep,
                        build_s=sp.duration)

    def _run_group(self, key: BucketKey, group: List["_ExecCtx"]
                   ) -> None:
        """One batched device path for a group of prepared requests
        (the solo path for a group of one — the same bits), then each
        member's release/commit/respond. A dispatch that raises — a
        kernel that fails to build or launch among them — refuses every
        member with an ``"error"`` refusal and refunds its reserve."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch import plan as plan_mod
        from pipelinedp_tpu_torch.obs import audit as obs_audit
        from pipelinedp_tpu_torch.resilience import faults

        svc = self._service
        config = group[0].prep.lazy._config
        try:
            if len(group) == 1:
                # A window that expired with one request gains nothing
                # from a batch of one; the solo path is bit-identical.
                # The offer-time encode rides along as a hint so the
                # solo run never re-encodes the rows.
                ctx = group[0]
                ctx.lazy._encoded_hint = ctx.prep.encoded
                with trace_context.restore(ctx.pending.ctx):
                    with obs_audit.books_context(
                            ctx.pending.lease.tenant,
                            ctx.pending.lease.request_id):
                        results_by_ctx = {id(ctx): list(ctx.lazy)}
            else:
                # The planner resolution for this fused batch: one
                # resolve at the bucket shape (plan.applied events and
                # the walk's mid-request cap reads bucket here).
                plan_mod.resolve(
                    shape={"rows": int(key.rows),
                           "partitions": int(key.partitions),
                           "quantiles": len(config.percentiles or ())},
                    mesh=None)
                keep_h, raw_h, device_s = self._dispatch(key, config,
                                                         group)
                results_by_ctx = {}
                for i, ctx in enumerate(group):
                    lease = ctx.pending.lease
                    with trace_context.restore(ctx.pending.ctx):
                        with obs_audit.books_context(lease.tenant,
                                                     lease.request_id):
                            out = ctx.lazy.finish_from_fused(
                                ctx.prep, keep_h[i],
                                {k: v[i] for k, v in raw_h.items()},
                                key.fx_bits)
                    ctx.lazy.timings["device_s"] = device_s / len(group)
                    results_by_ctx[id(ctx)] = out
                obs.inc("serve.fused_batches")
                obs.inc("serve.fused_requests", len(group))
                obs.event("serve.fused_batch", bucket=key.label,
                          size=len(group),
                          device_s=round(device_s, 6))
        except faults.FaultInjected as e:
            # A kill during the shared dispatch takes the whole batch
            # down the hard-kill path: every reserve stays spent, every
            # submitter sees the crash — once each.
            for ctx in group:
                svc._drop_entry(ctx.pending.request,
                                ctx.pending.fusion.signature)
                obs.inc("serve.requests_killed")
                self._unregister(ctx)
                ctx.pending.finish("raise", e)
            return
        except Exception as e:
            # Clean failure before any member's DP release existed:
            # refund every non-replayed reserve and refuse each request
            # — the solo clean-failure semantics, batch-wide.
            for ctx in group:
                svc._drop_entry(ctx.pending.request,
                                ctx.pending.fusion.signature)
                svc._release_lease(ctx.pending.lease)
                self._unregister(ctx)
                ctx.pending.finish("refusal", svc._refuse(
                    ctx.pending.lease.request_id,
                    ctx.pending.lease.tenant, "error",
                    f"{type(e).__name__}: {e}"))
            return
        for ctx in group:
            svc._commit_and_respond(
                ctx.pending, ctx.accountant, results_by_ctx[id(ctx)],
                ctx.warm, ctx.pending.fusion.signature,
                ctx.build_s + (ctx.lazy.timings or {}).get("device_s",
                                                           0.0),
                fused=len(group) > 1)

    def _dispatch(self, key: BucketKey, config, group):
        """Run the ONE batched device path on the service's device and
        fetch it once (``torch_engine.fused_aggregate_batch``)."""
        svc = self._service
        # The batch span carries per-member child links: a comma-joined
        # list of the members' trace ids (scalar, so the activity ring
        # keeps it) — each member's own chain stays separable while the
        # shared dispatch names everyone it served.
        members = ",".join(
            (ctx.pending.ctx.trace_id
             if ctx.pending.ctx is not None else "-")
            for ctx in group)
        with svc._tr.span("serve.fused_dispatch", cat="serve",
                          bucket=key.label, size=len(group),
                          members=members) as sp:
            keep_h, raw_h = te.fused_aggregate_batch(
                config, key.partitions, [ctx.prep for ctx in group],
                key.fx_bits, svc.device)
        return keep_h, raw_h, sp.duration

    @staticmethod
    def _unregister(ctx) -> None:
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        obs_monitor.unregister_request(ctx.pending.lease.request_id)


@dataclasses.dataclass
class _ExecCtx:
    """One batch member past phase 1: everything phase 2 needs."""
    pending: Any
    entry: Any
    warm: bool
    accountant: Any
    lazy: Any
    prep: Any
    build_s: float
