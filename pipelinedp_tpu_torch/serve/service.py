"""Resident multi-tenant DP aggregation service.

``Service`` turns the one-process-one-job library into a system: it
stays resident, accepts a stream of aggregation requests for many
tenants, and routes them through long-lived warm state —

* **admission control** on the caller's thread, BEFORE any compute:
  malformed requests, per-tenant in-flight caps, queue-full
  backpressure and budget overdraws all come back as structured
  :class:`Refusal` values (never exceptions), and the budget debit is
  durably reserved in the tenant's ledger before the request is even
  queued;
* a **bounded queue** drained by a small pool of ingest-discipline
  worker threads (``pdp-serve-*`` ``_CaptureThread``\\ s, poll-with-
  timeout waits, graceful drain on ``close()`` — the zero-orphan
  lifecycle the streaming executor established);
* a **warm registry** of resident ``DPEngine`` + backend instances
  keyed by (tenant, params-signature): a repeat request rebinds a
  fresh per-request accountant into the resident engine
  (``DPEngine.rebind_budget_accountant``) and reuses the process's
  built kernels — no rebuild — while every request still gets its own
  two-phase accountant, audit record and books entry.

The transport is deliberately in-process (``submit(request)`` →
response/refusal): the service is a thin package over the existing
engine, batch mode is untouched, and serve-on/off is DP-bit-identical
(PARITY row 34) because the serve path runs exactly the batch path's
code with exactly the batch path's inputs.

The port of ``pipelinedp_tpu/serve/service.py``. Its resident backends
are ``TorchBackend`` instances on the service's ``device``: ``"cuda"``
unless the caller passes ``device="cpu"``, as the tests do. The port
compiles no programs, so "warm" means a resident engine and backend,
whose kernels an earlier request built and loaded.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import queue
import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

import torch

from pipelinedp_tpu_torch.aggregate_params import AggregateParams, Metrics
from pipelinedp_tpu_torch.budget_accounting import (Budget,
                                                    NaiveBudgetAccountant)
from pipelinedp_tpu_torch.dp_engine import DataExtractors, DPEngine
from pipelinedp_tpu_torch.obs import trace_context
from pipelinedp_tpu_torch.serve.budget_ledger import (BudgetLease,
                                                      DuplicateRequest,
                                                      LedgerError,
                                                      Overdraw,
                                                      TenantBudgetLedger,
                                                      UnknownTenant,
                                                      tenant_slug)

#: Admission-control env knobs (constructor args win; see the README
#: knob table). Queue depth bounds memory under backpressure; the
#: per-tenant in-flight cap keeps one tenant from monopolizing the
#: worker pool; the rows/rate quotas refuse oversized or too-frequent
#: requests BEFORE any budget reserve or compute (refusal kind
#: ``quota`` — ROADMAP serve item (b)).
QUEUE_ENV = "PIPELINEDP_TPU_SERVE_QUEUE"
INFLIGHT_ENV = "PIPELINEDP_TPU_SERVE_INFLIGHT"
WORKERS_ENV = "PIPELINEDP_TPU_SERVE_WORKERS"
ROWS_ENV = "PIPELINEDP_TPU_SERVE_ROWS"
RATE_ENV = "PIPELINEDP_TPU_SERVE_REQS_PER_S"

DEFAULT_QUEUE_DEPTH = 16
DEFAULT_INFLIGHT_PER_TENANT = 4
DEFAULT_WORKERS = 2
#: 0 = unlimited (the default: quotas are opt-in caps).
DEFAULT_MAX_ROWS = 0
DEFAULT_REQS_PER_S = 0
#: Seconds of admission history the per-tenant rate quota windows over.
_RATE_WINDOW_S = 1.0

#: Seconds between cancel polls while a worker blocks on the queue
#: (same beat as the ingest executor).
_POLL_S = 0.02


@dataclasses.dataclass
class ServeRequest:
    """One aggregation request against a tenant's budget.

    ``epsilon``/``delta`` are the request's DEMAND on the tenant's
    durable ledger — they become the per-request accountant's totals,
    so the ledger's debit and the accountant's distribution agree
    exactly. ``rng_seed`` fixes the noise stream (tests, replayable
    pipelines); None draws fresh noise per request.

    ``kind="tune"`` asks the utility-analysis megasweep which (bounds,
    budget split, selection strategy) would minimize expected error at
    the given (epsilon, delta) — BEFORE spending them. A tune request
    is admitted, quota'd, books-stamped and refused exactly like an
    aggregate, but debits ZERO (ε, δ) from the tenant's ledger:
    utility analysis releases error ESTIMATES of hypothetical
    mechanisms, never private data (the reference's analysis engine
    makes the same argument). ``tune_parameters`` optionally carries a
    ``parameter_tuning.ParametersToTune``; None tunes the bounds the
    single analyzed metric supports."""
    tenant: str
    params: AggregateParams
    dataset: Any
    epsilon: float
    delta: float = 0.0
    data_extractors: Optional[DataExtractors] = None
    public_partitions: Any = None
    rng_seed: Optional[int] = None
    request_id: Optional[str] = None
    kind: str = "aggregate"
    tune_parameters: Any = None


@dataclasses.dataclass
class ServeResponse:
    """A served request: the released metrics plus the books."""
    request_id: str
    tenant: str
    results: List[Tuple[Any, Any]]
    remaining: Budget
    warm: bool
    signature: str
    wall_s: float
    audit: Dict[str, Any]
    #: The request's causal trace id (obs.trace_context) — the handle
    #: for ``/trace/<id>`` and ``store --summarize --trace-id``.
    trace_id: Optional[str] = None

    @property
    def ok(self) -> bool:
        return True


#: The closed set of refusal reasons — admission control speaks a
#: vocabulary, not free text (``detail`` carries the prose).
REFUSAL_REASONS = ("overdraw", "malformed", "duplicate", "quota",
                   "queue_full", "tenant_busy", "shutdown", "degraded",
                   "error")


@dataclasses.dataclass
class Refusal:
    """A refused request: structured, never an exception. ``reason``
    is one of :data:`REFUSAL_REASONS`; ``remaining`` is attached where
    it informs the caller (overdraw)."""
    request_id: str
    tenant: str
    reason: str
    detail: str
    remaining: Optional[Budget] = None

    @property
    def ok(self) -> bool:
        return False


def params_signature(request: ServeRequest) -> str:
    """The warm-registry key half that names WHAT program a request
    needs: the full aggregation params, the public-partition mode and
    the extractor shape. Deliberately NOT the rng seed — the seed is
    per-request noise state, set on the resident backend under the
    entry lock, so requests that differ only in their noise stream
    still share one warm engine. Two requests with equal signatures
    (and tenant) may share a resident engine, whatever their shapes:
    the port's device path compiles nothing per shape."""
    ext = request.data_extractors
    basis = "|".join((
        repr(request.params),
        repr(sorted(map(repr, request.public_partitions))
             if request.public_partitions is not None else None),
        repr((ext is not None and ext.privacy_id_extractor is not None,
              ext is not None and ext.partition_extractor is not None,
              ext is not None and ext.value_extractor is not None)),
        # The request kind: a tune and an aggregate at the same params
        # run DIFFERENT programs (the megasweep vs the engine), so
        # they must never share a warm slot.
        request.kind,
    ))
    return hashlib.sha256(basis.encode("utf-8")).hexdigest()[:16]


class _WarmEntry:
    """One resident (tenant, signature) slot: engine + backend + a
    lock serializing same-key requests (an engine holds per-request
    accountant state while it runs)."""

    def __init__(self, engine: DPEngine, backend: Any):
        self.engine = engine
        self.backend = backend
        self.lock = threading.Lock()
        self.hits = 0


class _Pending:
    """A submitted request waiting for its worker: the caller blocks
    on ``done``; ``outcome`` is ("response", r) / ("refusal", r) /
    ("raise", exc) — the last one models a request the injected kill
    took down, re-raised on the submitting thread."""

    def __init__(self, request: ServeRequest, lease: BudgetLease,
                 seq: int):
        self.request = request
        self.lease = lease
        self.seq = seq
        #: The submitting caller's trace context, captured HERE because
        #: contextvars do not flow into threads: the worker / fuser /
        #: release tail each re-bind it explicitly
        #: (``trace_context.restore``), which is what keeps one
        #: request's spans a single causal chain across the handoffs.
        self.ctx = trace_context.current()
        self.done = threading.Event()
        self.outcome: Optional[Tuple[str, Any]] = None
        #: Set by the fusion layer at offer time (serve/fusion.py):
        #: the request's signature, encoded columns and shape bucket,
        #: so the batch executor never re-derives them.
        self.fusion: Optional[Any] = None
        #: Set by the worker that picks this request up: frees the
        #: in-flight slot and live id. Run by ``finish`` BEFORE the
        #: submitter is unblocked — a caller whose submit() returned
        #: must be able to resubmit the id (or fill the slot)
        #: immediately, not race the worker's cleanup.
        self.teardown: Optional[Any] = None

    def finish(self, kind: str, value: Any) -> None:
        teardown, self.teardown = self.teardown, None
        if teardown is not None:
            teardown()
        self.outcome = (kind, value)
        self.done.set()


class Service:
    """The resident service. Construct once, ``register_tenant`` (or
    pass ``tenants=``), then ``submit`` from any thread; ``close()``
    (or the context manager) drains the queue and joins every worker.
    ``device`` is where the default backends (and the fused batches)
    run: ``"cuda"`` (the default) or ``"cpu"``.

    Directory layout under ``ledger_dir``::

        budgets/budget-<tenant-slug>.json   durable budget ledgers
        books/<tenant-slug>/run_ledger.jsonl   per-tenant request books
    """

    def __init__(self, ledger_dir: str,
                 tenants: Optional[Dict[str, Tuple[float, float]]] = None,
                 *,
                 max_queue: Optional[int] = None,
                 max_inflight_per_tenant: Optional[int] = None,
                 workers: Optional[int] = None,
                 max_rows_per_request: Optional[int] = None,
                 max_reqs_per_s: Optional[int] = None,
                 fusion: Optional[bool] = None,
                 fuse_window_ms: Optional[int] = None,
                 fuse_max_batch: Optional[int] = None,
                 fuse_rows_floor: Optional[int] = None,
                 backend_factory=None,
                 clock=None,
                 device="cuda"):
        from pipelinedp_tpu_torch import obs
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Service(device='cuda') needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "serve on the CPU")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"Service runs on cuda or cpu, not {device}")
        self.device = device
        self.ledger_dir = str(ledger_dir)
        self.budgets = TenantBudgetLedger(
            os.path.join(self.ledger_dir, "budgets"))
        self.max_queue = int(
            os.environ.get(QUEUE_ENV, DEFAULT_QUEUE_DEPTH)
            if max_queue is None else max_queue)
        self.max_inflight_per_tenant = int(
            os.environ.get(INFLIGHT_ENV, DEFAULT_INFLIGHT_PER_TENANT)
            if max_inflight_per_tenant is None
            else max_inflight_per_tenant)
        n_workers = int(os.environ.get(WORKERS_ENV, DEFAULT_WORKERS)
                        if workers is None else workers)
        # Service-wide quota defaults (0 = unlimited); register_tenant
        # may tighten them per tenant.
        self.max_rows_per_request = int(
            os.environ.get(ROWS_ENV, DEFAULT_MAX_ROWS)
            if max_rows_per_request is None else max_rows_per_request)
        self.max_reqs_per_s = int(
            os.environ.get(RATE_ENV, DEFAULT_REQS_PER_S)
            if max_reqs_per_s is None else max_reqs_per_s)
        self._quotas: Dict[str, Dict[str, int]] = {}
        self._admit_times: Dict[str, Any] = {}
        self._backend_factory = backend_factory or self._default_backend
        if clock is None:
            from pipelinedp_tpu_torch.resilience.clock import SystemClock
            clock = SystemClock()
        self._clock = clock
        #: Service birth on the injectable clock — the denominator of
        #: the per-tenant budget burn-rate gauges.
        self._t0 = self._clock.monotonic()
        self._tr = obs.run_tracer(clock=clock)
        self._q: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._admit = threading.Lock()
        self._inflight: Dict[str, int] = {}
        #: (tenant, request id) pairs currently live in THIS process
        #: (admitted, not yet finished), guarded by ``_admit``. A
        #: duplicate id is refused while its original is in flight —
        #: the ledger's reserved-dedup lease is for restart replay
        #: only, and without this guard a client retry racing its own
        #: original would release two noisy views on one charge. Keyed
        #: per tenant, like the ledger's debits: tenants never collide
        #: on each other's ids.
        self._live: set = set()
        self._registry: Dict[Tuple[str, str], _WarmEntry] = {}
        self._registry_lock = threading.Lock()
        self._books_lock = threading.Lock()
        self._books_stores: Dict[str, Any] = {}
        self._env: Optional[Dict[str, Any]] = None
        self._seq = 0
        self._closed = threading.Event()
        self._stop = threading.Event()
        from pipelinedp_tpu_torch.ingest.executor import _CaptureThread
        self._workers = [
            _CaptureThread(self._worker_loop, f"pdp-serve-{i}")
            for i in range(max(1, n_workers))]
        for t in self._workers:
            t.start()
        # Shape-bucketed request fusion (serve/fusion.py): the dp-safe
        # ``serve_fusion`` knob arms it (constructor arg wins); off by
        # default, and on/off is DP-bit-identical per request (PARITY
        # row 35) — the knob is purely a throughput/latency trade.
        if fusion is None:
            from pipelinedp_tpu_torch import plan as plan_mod
            fusion = bool(plan_mod.knob_value("serve_fusion"))
        self._fuser = None
        if fusion:
            from pipelinedp_tpu_torch.serve import fusion as fusion_mod
            self._fuser = fusion_mod.Fuser(
                self, clock=self._clock, window_ms=fuse_window_ms,
                max_batch=fuse_max_batch, rows_floor=fuse_rows_floor)
        # Degraded mode: a process whose runtime is wedged (the health
        # probe degraded it to CPU, a mesh lost its last participant)
        # refuses EVERY submit with a structured "degraded" refusal
        # BEFORE any budget reserve — never a silent wrong-shape run,
        # never a spent charge for work that can't be trusted. Armed
        # here from resilience.health.DEGRADED_ENV, or at runtime via
        # set_degraded()/clear_degraded().
        self._degraded: Optional[str] = None
        from pipelinedp_tpu_torch.resilience.health import DEGRADED_ENV
        if os.environ.get(DEGRADED_ENV):
            self.set_degraded(
                f"{DEGRADED_ENV} is set: the runtime came up degraded "
                "(health probe fell back); refusing before reserve")
        for tenant, (eps, delta) in (tenants or {}).items():
            self.register_tenant(tenant, eps, delta)
        # The read-only introspection endpoint (obs/http.py): off
        # unless PIPELINEDP_TPU_METRICS_PORT is set; a bind failure is
        # an event, never a startup failure. Bound into THIS lifecycle:
        # close() stops it, so the service leaves zero orphan threads.
        from pipelinedp_tpu_torch.obs import http as obs_http
        self._http = obs_http.maybe_start()
        self._push_tenant_state()
        self._push_occupancy()
        obs.event("serve.started", workers=len(self._workers),
                  max_queue=self.max_queue,
                  max_inflight_per_tenant=self.max_inflight_per_tenant,
                  fusion=bool(self._fuser is not None),
                  metrics_port=(self._http.port
                                if self._http is not None else None),
                  ledger_dir=self.ledger_dir)

    # --- lifecycle ---

    def _default_backend(self, request: ServeRequest):
        from pipelinedp_tpu_torch.backends import TorchBackend
        return TorchBackend(self.device, rng_seed=request.rng_seed)

    def register_tenant(self, tenant: str, total_epsilon: float,
                        total_delta: float,
                        max_rows_per_request: Optional[int] = None,
                        max_reqs_per_s: Optional[int] = None) -> Budget:
        """Open (or re-open) a tenant's durable budget ledger; returns
        the remaining budget — which a restart replays from disk.
        ``max_rows_per_request`` / ``max_reqs_per_s`` tighten the
        service-wide quotas for THIS tenant (0 = unlimited; None keeps
        the service default): oversized or too-frequent requests are
        refused as ``quota`` before any budget reserve or compute."""
        quotas = {}
        if max_rows_per_request is not None:
            quotas["rows"] = int(max_rows_per_request)
        if max_reqs_per_s is not None:
            quotas["reqs_per_s"] = int(max_reqs_per_s)
        if quotas:
            self._quotas[tenant] = quotas
        remaining = self.budgets.open_tenant(tenant, total_epsilon,
                                             total_delta)
        self._push_tenant_state()
        return remaining

    def _tenant_quota(self, tenant: str, kind: str, default: int) -> int:
        return int(self._quotas.get(tenant, {}).get(kind, default))

    # --- degraded mode ---

    def set_degraded(self, detail: str) -> None:
        """Flip the service into degraded mode: every subsequent
        ``submit`` is refused with reason ``"degraded"`` before any
        budget reserve. The state is pushed into the heartbeat's
        ``serve.health`` section so an operator sees WHY traffic is
        bouncing, not just that it is."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        self._degraded = str(detail)
        obs.inc("serve.degraded_entered")
        obs.event("serve.degraded", detail=self._degraded)
        obs_monitor.update_serve_health(
            {"state": "degraded", "detail": self._degraded})

    def clear_degraded(self) -> None:
        """Leave degraded mode; submissions are admitted again."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        if self._degraded is None:
            return
        self._degraded = None
        obs.event("serve.degraded_cleared")
        obs_monitor.update_serve_health({"state": "ok"})

    def close(self) -> None:
        """Graceful drain: refuse new submissions, serve everything
        already queued, then stop and join every worker (zero orphan
        ``pdp-serve-*`` threads — the executor discipline). Taking the
        admission lock to flip ``_closed`` closes the race with an
        in-flight ``submit()``: an admitter that already passed the
        closed check finishes its enqueue before we proceed, and the
        post-join sweep below refunds + refuses anything the departed
        workers left behind — no submitter ever blocks forever."""
        from pipelinedp_tpu_torch import obs
        with self._admit:
            self._closed.set()
        # Flush every open fusion window BEFORE stopping the workers:
        # the flushed batches enter the queue and drain normally, so a
        # graceful close serves everything already admitted.
        if self._fuser is not None:
            self._fuser.close()
        self._stop.set()
        for t in self._workers:
            while t.is_alive():
                t.join(timeout=_POLL_S)
        self._workers = []
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            pendings = (item.entries if hasattr(item, "entries")
                        else [item])
            for pending in pendings:
                self._refuse_unworked(
                    pending, "service closed before a worker picked "
                    "this request up")
        if self._http is not None:
            self._http.stop()
            self._http = None
        obs.event("serve.closed")

    def _refuse_unworked(self, pending: "_Pending",
                         detail: str) -> None:
        """Refuse a pending no worker will ever serve (the close()
        sweep, a fused batch stranded by a closing queue): refund the
        reserve unless replayed, free the live id, finish the
        submitter exactly once."""
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        tenant, rid = pending.lease.tenant, pending.lease.request_id
        self._release_lease(pending.lease)
        with self._admit:
            self._live.discard((tenant, rid))
        obs_monitor.unregister_request(rid)
        pending.finish("refusal", self._refuse(
            rid, tenant, "shutdown",
            detail + "; " + ("the replayed reserve stays spent (the "
                             "pre-restart attempt may have drawn noise)"
                             if pending.lease.replayed else
                             "the reserve was refunded")))

    def __enter__(self) -> "Service":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    # --- admission control (caller thread; never any compute) ---

    def _validate(self, request: ServeRequest) -> Optional[str]:
        # submit() has already refused a non-ServeRequest before any
        # attribute of it was touched.
        if not request.tenant or not isinstance(request.tenant, str):
            return "tenant must be a non-empty string"
        if not isinstance(request.params, AggregateParams):
            return ("params must be an AggregateParams, got "
                    f"{type(request.params).__name__}")
        try:
            if request.dataset is None or len(request.dataset) == 0:
                return "dataset must be non-empty"
        except TypeError:
            return "dataset must be sized (rows or ArrayDataset)"
        if not (isinstance(request.epsilon, (int, float))
                and request.epsilon > 0):
            return f"epsilon must be positive, got {request.epsilon!r}"
        if not (isinstance(request.delta, (int, float))
                and request.delta >= 0):
            return f"delta must be >= 0, got {request.delta!r}"
        if request.kind not in ("aggregate", "tune"):
            return ("kind must be 'aggregate' or 'tune', got "
                    f"{request.kind!r}")
        if request.kind == "tune":
            metrics_list = list(request.params.metrics or [])
            if len(metrics_list) != 1:
                return ("tune requests analyze exactly one metric, got "
                        f"{[str(m) for m in metrics_list]!r}")
        return None

    def submit(self, request: ServeRequest):
        """Admit, queue and serve one request; blocks until its
        response (or refusal) is ready. Thread-safe — concurrent
        callers model concurrent tenants. The call sequence is the
        contract: a request REFUSED here has spent nothing and run
        nothing (the overdraw check happens before any compute), and
        a request admitted here has its (eps, delta) durably reserved
        before the queue ever sees it. A request id whose original is
        still in flight is refused as 'duplicate' — admitting the
        retry would let one durable debit release two noisy views."""
        if not isinstance(request, ServeRequest):
            # Refuse before touching any attribute — a non-ServeRequest
            # has no request_id/tenant to read.
            return self._refuse(
                f"req-{uuid.uuid4().hex[:12]}", "<unknown>", "malformed",
                f"expected ServeRequest, got {type(request).__name__}")
        # Normalized to str up front: the ledger stores str(request_id)
        # in its leases, and _live teardown keys must match admission's.
        # Only None/"" mean "absent" — a falsy id like 0 is a real id,
        # and generating a fresh one for it would void exactly-once.
        if request.request_id is None or request.request_id == "":
            rid = f"req-{uuid.uuid4().hex[:12]}"
        else:
            rid = str(request.request_id)
        # One trace context per request, bound on the CALLER's thread
        # for the whole admission path: every span/event under it is
        # stamped (trace_id, tenant, request_id), and _Pending captures
        # it for the explicit handoffs to the fuser/worker threads.
        # Telemetry-only — binding never touches DP arithmetic (PARITY
        # row 42).
        with trace_context.bind(tenant=request.tenant, request_id=rid):
            return self._submit_bound(request, rid)

    def _submit_bound(self, request: ServeRequest, rid: str):
        """The body of ``submit`` under the request's bound trace
        context (same contract, same return values)."""
        tenant = request.tenant
        if self._closed.is_set():
            return self._refuse(rid, tenant, "shutdown",
                                "service is draining; submit refused")
        degraded = self._degraded
        if degraded is not None:
            # Refused BEFORE any budget reserve: a degraded process
            # must not spend a tenant's charge on untrustworthy work.
            return self._refuse(rid, tenant, "degraded", degraded)
        detail = self._validate(request)
        if detail is not None:
            return self._refuse(rid, tenant, "malformed", detail)
        if not self.budgets.has_tenant(tenant):
            # Before the tentative admission: a resident process must
            # not grow per-tenant state (in-flight slots, ledger
            # locks) for arbitrary unknown tenant names.
            return self._refuse(
                rid, tenant, "malformed",
                f"tenant '{tenant}' has no ledger under "
                f"{self.budgets.directory}; register_tenant first")
        # Row quota: stateless, so it refuses before any shared state
        # is touched — an oversized request never costs a slot, a
        # reserve, or any compute.
        rows_cap = self._tenant_quota(tenant, "rows",
                                      self.max_rows_per_request)
        if rows_cap > 0:
            try:
                n_rows = len(request.dataset)
            except TypeError:  # _validate vouched it is sized
                n_rows = 0
            if n_rows > rows_cap:
                return self._refuse(
                    rid, tenant, "quota",
                    f"request carries {n_rows} rows, over tenant "
                    f"'{tenant}'s per-request row quota of {rows_cap}")
        full_detail = (f"request queue is full ({self.max_queue} "
                       "deep); back off and resubmit")
        verdict: Optional[Tuple[str, str]] = None
        with self._admit:
            if self._closed.is_set():
                verdict = ("shutdown",
                           "service is draining; submit refused")
            elif (tenant, rid) in self._live:
                verdict = (
                    "duplicate",
                    f"request id '{rid}' is already in flight; one "
                    "charge can never release two noisy views — wait "
                    "for the original to finish or use a fresh id")
            else:
                rate_cap = self._tenant_quota(tenant, "reqs_per_s",
                                              self.max_reqs_per_s)
                rate_verdict = (self._check_rate(tenant, rate_cap)
                                if rate_cap > 0 else None)
                inflight = self._inflight.get(tenant, 0)
                if rate_verdict is not None:
                    verdict = rate_verdict
                elif inflight >= self.max_inflight_per_tenant:
                    verdict = (
                        "tenant_busy",
                        f"tenant '{tenant}' already has {inflight} "
                        f"request(s) in flight (cap "
                        f"{self.max_inflight_per_tenant})")
                elif self._q.full():
                    verdict = ("queue_full", full_detail)
                else:
                    # Tentative admission: hold the in-flight slot and
                    # the live id while the durable (fsync'd) reserve
                    # runs OUTSIDE the global lock — one tenant's disk
                    # sync must not serialize every other tenant's
                    # admission.
                    self._inflight[tenant] = inflight + 1
                    self._live.add((tenant, rid))
                    if rate_cap > 0:
                        self._admit_times.setdefault(
                            tenant, []).append(self._clock.monotonic())
        if verdict is not None:
            return self._refuse(rid, tenant, *verdict)
        if request.kind == "tune":
            # Utility analysis releases no private data — the request's
            # (epsilon, delta) are the HYPOTHETICAL budget the error
            # model simulates, not a demand on the ledger. A synthetic
            # zero-amount lease (state="tune", never written to disk)
            # rides the same pending plumbing; _release_lease no-ops on
            # it and the worker routes it through _execute_tune /
            # _respond_tune, leaving the durable ledger untouched.
            lease = BudgetLease(tenant=tenant, request_id=rid,
                                epsilon=0.0, delta=0.0, state="tune")
            return self._enqueue_admitted(request, lease, rid, tenant)
        try:
            lease = self.budgets.reserve(tenant, rid, request.epsilon,
                                         request.delta)
        except Overdraw as e:
            self._rollback_admission(tenant, rid)
            return self._refuse(
                rid, tenant, "overdraw",
                f"insufficient budget: requested {e.requested}, "
                f"remaining {e.remaining}, shortfall "
                f"{e.shortfall}", remaining=e.remaining)
        except DuplicateRequest as e:
            self._rollback_admission(tenant, rid)
            return self._refuse(rid, tenant, "duplicate", str(e))
        except UnknownTenant as e:
            self._rollback_admission(tenant, rid)
            return self._refuse(rid, tenant, "malformed", str(e))
        except LedgerError as e:
            # e.g. a restart replay whose (eps, delta) do not match
            # the reserved debit's amounts.
            self._rollback_admission(tenant, rid)
            return self._refuse(rid, tenant, "malformed", str(e))
        except BaseException:
            self._rollback_admission(tenant, rid)
            raise
        return self._enqueue_admitted(request, lease, rid, tenant)

    def _enqueue_admitted(self, request: ServeRequest,
                          lease: BudgetLease, rid: str, tenant: str):
        """The post-reserve half of ``submit``: register with the
        monitor, route through fusion (aggregate kind only) or the solo
        queue, block for the outcome. Shared by aggregates (durable
        lease) and tunes (synthetic zero-debit lease)."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        full_detail = (f"request queue is full ({self.max_queue} "
                       "deep); back off and resubmit")
        verdict: Optional[Tuple[str, str]] = None
        # The admission span is the request's causal ROOT: _Pending is
        # constructed inside it, so the captured context carries this
        # span as parent — the worker/fuser/commit spans nest beneath
        # it and the Chrome-trace flow arc starts on this thread.
        with self._tr.span("serve.admit", cat="serve", tenant=tenant,
                           kind=request.kind):
            # Register BEFORE the enqueue: the worker's
            # update/unregister must always follow the registration, or
            # a fast completion would leave a phantom live request in
            # every later heartbeat.
            obs_monitor.register_request(rid, tenant=tenant,
                                         phase="queued",
                                         kind=request.kind)
            routed = False
            with self._admit:
                if self._closed.is_set():  # raced close()
                    verdict = ("shutdown",
                               "service is draining; submit refused")
                else:
                    pending = _Pending(request, lease, self._seq)
                    self._seq += 1
            if (verdict is None and self._fuser is not None
                    and request.kind == "aggregate"):
                # The fusion layer sits between admission and the
                # workers: a fusable request joins its shape bucket
                # here (the host-side encode runs on THIS caller's
                # thread, so it parallelizes across tenants);
                # everything else falls through to the solo queue,
                # including anything offered while the fuser is
                # closing. Tune requests never fuse — the megasweep is
                # its own batched program.
                try:
                    routed = self._fuser.offer(pending)
                except Exception:
                    routed = False
            if verdict is None and not routed:
                with self._admit:
                    if self._closed.is_set():  # raced close()
                        verdict = ("shutdown",
                                   "service is draining; submit refused")
                    else:
                        try:
                            self._q.put_nowait(pending)
                        except queue.Full:  # raced another admitter
                            verdict = ("queue_full", full_detail)
            if verdict is not None:
                # Release BEFORE the rollback drops the id from _live —
                # see _release_lease for the dedup race this order
                # closes.
                self._release_lease(lease)
                self._rollback_admission(tenant, rid)
                obs_monitor.unregister_request(rid)
                return self._refuse(rid, tenant, *verdict)
            obs.inc("serve.requests_admitted")
            self._push_occupancy()
        pending.done.wait()
        kind, value = pending.outcome
        if kind == "raise":
            raise value
        return value

    def _check_rate(self, tenant: str,
                    cap: int) -> Optional[Tuple[str, str]]:
        """Per-tenant admission-rate quota, evaluated (and recorded)
        under the admission lock: a sliding one-second window of prior
        admissions on the injectable clock. Refused attempts do not
        count toward the window — a refused client retrying is not
        admitted traffic."""
        now = self._clock.monotonic()
        times = self._admit_times.get(tenant)
        if times:
            cutoff = now - _RATE_WINDOW_S
            while times and times[0] <= cutoff:
                times.pop(0)
            if len(times) >= cap:
                return ("quota",
                        f"tenant '{tenant}' exceeded its rate quota "
                        f"of {cap} request(s)/s; back off and "
                        "resubmit")
        return None

    def _rollback_admission(self, tenant: str, rid: str) -> None:
        """Undo a tentative admission: give back the in-flight slot,
        the live request id AND the rate-window slot — a request later
        refused (overdraw, queue race, shutdown race) was never
        admitted traffic, so it must not eat into the tenant's rate
        quota (the _check_rate contract)."""
        with self._admit:
            self._inflight[tenant] = max(
                0, self._inflight.get(tenant, 0) - 1)
            self._live.discard((tenant, rid))
            if self._tenant_quota(tenant, "reqs_per_s",
                                  self.max_reqs_per_s) > 0:
                times = self._admit_times.get(tenant)
                if times:
                    times.pop()

    def _release_lease(self, lease: BudgetLease) -> None:
        """Refund a reserve that failed cleanly before any DP output
        existed — unless the lease is a restart replay, whose
        pre-death attempt may have drawn noise: that debit stays
        spent. Every caller MUST invoke this BEFORE removing the id
        from ``_live``: released first, a same-id retry arriving in
        between sees a 'released' debit and reserves fresh; removed
        first, the retry would dedup onto the still-'reserved' debit
        as a replayed lease whose budget this refund then yanks away.
        Tune leases are synthetic (zero amounts, never on disk):
        nothing to refund."""
        if lease.replayed or lease.state == "tune":
            return
        from pipelinedp_tpu_torch import obs
        try:
            self.budgets.release(lease.tenant, lease.request_id)
        except Exception:
            obs.event("serve.release_failed",
                      request_id=lease.request_id, tenant=lease.tenant)
        self._push_tenant_state()

    def _refuse(self, rid: str, tenant: str, reason: str, detail: str,
                remaining: Optional[Budget] = None) -> Refusal:
        from pipelinedp_tpu_torch import obs
        obs.inc("serve.requests_refused")
        obs.inc(f"serve.refusals.{reason}")
        obs.event("serve.refusal", request_id=rid, tenant=str(tenant),
                  reason=reason, detail=detail)
        refusal = Refusal(request_id=rid, tenant=str(tenant),
                          reason=reason, detail=detail,
                          remaining=remaining)
        # Books only for tenants that exist: refusals naming garbage
        # tenants must not grow directories/stores without bound.
        if self.budgets.has_tenant(str(tenant)):
            self._append_books(str(tenant), "serve.refusal", {
                "request_id": rid, "reason": reason, "detail": detail})
        return refusal

    # --- the workers ---

    def _make_teardown(self, pending: "_Pending"):
        def _teardown():
            with self._admit:
                tenant = pending.request.tenant
                self._inflight[tenant] = max(
                    0, self._inflight.get(tenant, 0) - 1)
                self._live.discard((tenant,
                                    pending.lease.request_id))
        return _teardown

    def _worker_loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            # A queue item is one pending OR a whole fused batch
            # (serve/fusion.FusedBatch): the worker serves either as a
            # unit, but every member keeps its own teardown/finish —
            # leases resolve exactly once per request, batch or not.
            fused = hasattr(item, "entries")
            pendings = item.entries if fused else [item]
            for pending in pendings:
                pending.teardown = self._make_teardown(pending)
            try:
                if fused:
                    # Per-member contexts are restored inside the
                    # fused executor — one batch carries many traces.
                    self._fuser.execute(item)
                else:
                    # Explicit context handoff: contextvars never flow
                    # into this worker thread on their own.
                    with trace_context.restore(item.ctx):
                        self._execute(item)
            except BaseException as e:  # safety net: a worker must
                # never die holding an unfinished pending — the
                # submitter would block forever and the pool would
                # shrink. Surface the failure on the caller instead.
                for pending in pendings:
                    if not pending.done.is_set():
                        pending.finish("raise", e)
            finally:
                # finish() ran the teardown before unblocking the
                # submitter; this residual only fires if the execution
                # somehow exited without ever finishing a pending.
                for pending in pendings:
                    teardown, pending.teardown = pending.teardown, None
                    if teardown is not None:
                        teardown()

    def _warm_entry(self, request: ServeRequest,
                    signature: str) -> Tuple[_WarmEntry, bool]:
        key = (request.tenant, signature)
        with self._registry_lock:
            entry = self._registry.get(key)
            if entry is not None:
                entry.hits += 1
                return entry, True
        # Build outside the registry lock (backend construction may
        # probe); last writer wins on a same-key race — both entries
        # work, one simply stays cold.
        backend = self._backend_factory(request)
        engine = DPEngine(None, backend)
        entry = _WarmEntry(engine, backend)
        with self._registry_lock:
            self._registry.setdefault(key, entry)
            return self._registry[key], False

    def _drop_entry(self, request: ServeRequest, signature: str) -> None:
        """A failed request may leave its engine holding a half-run
        accountant; drop the slot so the next request rebuilds clean."""
        with self._registry_lock:
            self._registry.pop((request.tenant, signature), None)

    def _execute(self, pending: _Pending) -> None:
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import audit as obs_audit
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        from pipelinedp_tpu_torch.resilience import faults
        request, lease = pending.request, pending.lease
        rid, tenant = lease.request_id, lease.tenant
        signature = params_signature(request)
        obs_monitor.update_request(rid, phase="running",
                                   signature=signature)
        if request.kind == "tune":
            self._execute_tune(pending, signature)
            return
        try:
            # The injected hard-kill seam: between the durable reserve
            # and any commit/release — a FaultInjected here models the
            # process dying mid-request, so the reserve MUST stand.
            faults.check_serve_request(pending.seq)
            entry, warm = self._warm_entry(request, signature)
            obs.inc("serve.warm_hits" if warm else "serve.cold_builds")
            with entry.lock:
                try:
                    # Per-request noise state on the resident backend:
                    # the engine reads ``backend.rng_seed`` at
                    # aggregate time, and the entry lock serializes
                    # same-key requests, so each request's noise
                    # stream is its own while the engine stays shared.
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
                        with self._tr.span("serve.request", cat="serve",
                                           tenant=tenant,
                                           warm=warm) as sp:
                            result = entry.engine.aggregate(
                                request.dataset, request.params,
                                extractors,
                                public_partitions=(
                                    request.public_partitions))
                            accountant.compute_budgets()
                            results = list(result)
                except BaseException:
                    # Heal BEFORE the lock releases: a same-signature
                    # waiter may already hold this entry (fetched
                    # before the failure dropped it from the registry)
                    # and must rebind a fresh accountant, not be
                    # refused over this request's half-run one.
                    entry.engine.clear_budget_accountant()
                    raise
        except faults.FaultInjected as e:
            # Hard kill: do NOT release — noise may have been drawn.
            # The submitting caller sees the crash; the durable ledger
            # keeps the reserved debit, exactly what a real process
            # death leaves behind. The warm slot IS dropped: its engine
            # may hold a half-run accountant that would spuriously
            # refuse the next same-signature request.
            self._drop_entry(request, signature)
            obs.inc("serve.requests_killed")
            obs.event("serve.request_killed", request_id=rid,
                      tenant=tenant, error=repr(e))
            obs_monitor.unregister_request(rid)
            pending.finish("raise", e)
            return
        except Exception as e:
            # Clean failure before any DP release: refund the reserve
            # and refuse with the error — the engine slot is dropped
            # so half-run accountant state cannot leak into the next
            # request. A REPLAYED lease is the exception: its
            # pre-restart attempt may have drawn noise, so the debit
            # stays spent even though this attempt failed cleanly.
            self._drop_entry(request, signature)
            self._release_lease(lease)
            obs_monitor.unregister_request(rid)
            pending.finish("refusal", self._refuse(
                rid, tenant, "error",
                f"{type(e).__name__}: {e}"))
            return
        self._commit_and_respond(pending, accountant, results, warm,
                                 signature, sp.duration)

    def _commit_and_respond(self, pending: "_Pending", accountant,
                            results, warm: bool, signature: str,
                            wall_s: float, fused: bool = False) -> None:
        """The post-compute tail shared by the solo worker and the
        fused-batch executor: commit the durable debit, read the
        remaining budget, snapshot the audit record, append the books
        entry, unblock the submitter. The DP output exists by now, so
        a bookkeeping failure surfaces on the CALLER with the reserve
        left standing — refunding would be the unsafe direction.
        Restores the request's context itself: the fused executor
        reaches here on the fuser/worker thread with a DIFFERENT
        member's context (or none) bound."""
        with trace_context.restore(pending.ctx):
            self._commit_and_respond_bound(pending, accountant, results,
                                           warm, signature, wall_s,
                                           fused)

    def _commit_and_respond_bound(self, pending: "_Pending", accountant,
                                  results, warm: bool, signature: str,
                                  wall_s: float, fused: bool) -> None:
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        lease = pending.lease
        rid, tenant = lease.request_id, lease.tenant
        try:
            # The host release tail, as its own span: the last hop of
            # the request's causal chain (admit -> execute -> commit).
            with self._tr.span("serve.commit", cat="serve",
                               tenant=tenant):
                self.budgets.commit(tenant, rid)
                remaining = self.budgets.remaining(tenant)
                audit_record = accountant.audit_record()
        except Exception as e:
            obs.event("serve.commit_failed", request_id=rid,
                      tenant=tenant, error=repr(e))
            obs_monitor.unregister_request(rid)
            pending.finish("raise", e)
            return
        books = {
            "request_id": rid,
            "signature": signature,
            "warm": warm,
            "wall_s": round(wall_s, 6),
            "partitions_released": len(results),
            "epsilon": lease.epsilon,
            "delta": lease.delta,
            "remaining_epsilon": remaining.epsilon,
            "remaining_delta": remaining.delta,
            "audit": audit_record,
        }
        if fused:
            books["fused"] = True
        if pending.ctx is not None:
            # The durable half of the causal chain: store --summarize
            # --trace-id surfaces this books entry in the tree.
            books["trace_id"] = pending.ctx.trace_id
        self._append_books(tenant, "serve.request", books)
        if pending.ctx is not None and self._tr.recording:
            # Flush the commit span itself to the obs store: the
            # engine's run-report delta was appended BEFORE the span
            # above closed, so without this tail append the durable
            # chain would stop at the release — one cursor-delta entry
            # completes admission-through-commit for --trace-id.
            from pipelinedp_tpu_torch.obs import store as obs_store
            obs_store.maybe_append_run_report("serve.commit")
        obs.inc("serve.requests_served")
        obs.metrics.observe(
            "serve.request_seconds", wall_s,
            help="end-to-end serve request wall seconds")
        self._push_tenant_state()
        self._push_occupancy()
        obs_monitor.unregister_request(rid)
        pending.finish("response", ServeResponse(
            request_id=rid, tenant=tenant, results=results,
            remaining=remaining, warm=warm, signature=signature,
            wall_s=wall_s, audit=audit_record,
            trace_id=(pending.ctx.trace_id
                      if pending.ctx is not None else None)))

    def _execute_tune(self, pending: "_Pending", signature: str) -> None:
        """Serve one ``kind="tune"`` request: contribution histograms +
        the utility-analysis megasweep + argmin over the batched error
        surface, on the warm (tenant, signature) backend. The sweep
        releases error estimates of hypothetical mechanisms, never
        private data, so the synthetic lease debits zero (ε, δ) — but
        the request is still books-stamped like any other. A second
        same-signature tune reuses the warm backend."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        from pipelinedp_tpu_torch.resilience import faults
        request, lease = pending.request, pending.lease
        rid, tenant = lease.request_id, lease.tenant
        try:
            # Same hard-kill seam as aggregate execution; with no
            # reserve outstanding there is nothing durable to protect,
            # but the caller must still see the crash.
            faults.check_serve_request(pending.seq)
            entry, warm = self._warm_entry(request, signature)
            obs.inc("serve.warm_hits" if warm else "serve.cold_builds")
            with entry.lock:
                from pipelinedp_tpu_torch.analysis import parameter_tuning
                from pipelinedp_tpu_torch.analysis import torch_sweep
                extractors = (request.data_extractors
                              if request.data_extractors is not None
                              else DataExtractors())
                to_tune = request.tune_parameters
                if to_tune is None:
                    metric = request.params.metrics[0]
                    to_tune = parameter_tuning.ParametersToTune(
                        max_partitions_contributed=True,
                        max_contributions_per_partition=(
                            metric == Metrics.COUNT))
                tune_options = parameter_tuning.TuneOptions(
                    epsilon=float(request.epsilon),
                    delta=float(request.delta),
                    aggregate_params=request.params,
                    function_to_minimize=(
                        parameter_tuning.MinimizingFunction
                        .ABSOLUTE_ERROR),
                    parameters_to_tune=to_tune)
                with self._tr.span("serve.request", cat="serve",
                                   tenant=tenant, warm=warm,
                                   kind="tune") as sp:
                    hist = list(torch_sweep.fused_dataset_histograms(
                        request.dataset, extractors,
                        getattr(entry.backend, "device", self.device)))[0]
                    tuned = parameter_tuning.tune(
                        request.dataset, entry.backend, hist,
                        tune_options, extractors,
                        request.public_partitions)
                    tune_result = list(tuned)[0]
        except faults.FaultInjected as e:
            # Hard kill mid-tune: no reserve to preserve (tune debits
            # nothing), but the warm slot is dropped and the caller
            # sees the crash, mirroring the aggregate path.
            self._drop_entry(request, signature)
            obs.inc("serve.requests_killed")
            obs.event("serve.request_killed", request_id=rid,
                      tenant=tenant, error=repr(e))
            obs_monitor.unregister_request(rid)
            pending.finish("raise", e)
            return
        except Exception as e:
            self._drop_entry(request, signature)
            self._release_lease(lease)  # no-op for a tune lease
            obs_monitor.unregister_request(rid)
            pending.finish("refusal", self._refuse(
                rid, tenant, "error",
                f"{type(e).__name__}: {e}"))
            return
        self._respond_tune(pending, tune_result, warm, signature,
                           sp.duration)

    def _respond_tune(self, pending: "_Pending", tune_result, warm: bool,
                      signature: str, wall_s: float) -> None:
        """The tune twin of ``_commit_and_respond``: there is no
        durable debit to commit — the lease was synthesized with zero
        (ε, δ) and never reserved — so the tail only stamps the books
        (with ``kind="tune"`` and ``budget_debited=False``) and hands
        the TuneResult back. ``remaining`` is read purely to show the
        caller their balance is untouched."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        lease = pending.lease
        rid, tenant = lease.request_id, lease.tenant
        try:
            remaining = self.budgets.remaining(tenant)
        except Exception as e:
            obs.event("serve.commit_failed", request_id=rid,
                      tenant=tenant, error=repr(e))
            obs_monitor.unregister_request(rid)
            pending.finish("raise", e)
            return
        cfg = tune_result.utility_analysis_parameters
        best: Dict[str, Any] = {}
        if cfg.max_partitions_contributed is not None:
            best["max_partitions_contributed"] = int(
                cfg.max_partitions_contributed[tune_result.index_best])
        if cfg.max_contributions_per_partition is not None:
            best["max_contributions_per_partition"] = int(
                cfg.max_contributions_per_partition[
                    tune_result.index_best])
        audit_record = {
            "kind": "tune",
            "budget_debited": False,
            "simulated_epsilon": float(pending.request.epsilon),
            "simulated_delta": float(pending.request.delta),
            "candidates": int(cfg.size),
            "index_best": int(tune_result.index_best),
            "best": best,
        }
        books = {
            "request_id": rid,
            "signature": signature,
            "kind": "tune",
            "warm": warm,
            "wall_s": round(wall_s, 6),
            "candidates": int(cfg.size),
            "epsilon": 0.0,
            "delta": 0.0,
            "remaining_epsilon": remaining.epsilon,
            "remaining_delta": remaining.delta,
            "audit": audit_record,
        }
        if pending.ctx is not None:
            books["trace_id"] = pending.ctx.trace_id
        self._append_books(tenant, "serve.request", books)
        obs.inc("serve.requests_served")
        obs.inc("serve.tunes_served")
        obs.metrics.observe(
            "serve.request_seconds", wall_s,
            help="end-to-end serve request wall seconds")
        self._push_occupancy()
        obs_monitor.unregister_request(rid)
        pending.finish("response", ServeResponse(
            request_id=rid, tenant=tenant,
            results=[("tune", tune_result)],
            remaining=remaining, warm=warm, signature=signature,
            wall_s=wall_s, audit=audit_record,
            trace_id=(pending.ctx.trace_id
                      if pending.ctx is not None else None)))

    # --- the metrics plane (obs/metrics.py + heartbeat tenants) ---

    def _push_occupancy(self) -> None:
        """Serve occupancy gauges for ``/metrics``: queue depth,
        admitted-in-flight count, and fusion bucket fill. Pushed at
        admission and at every completion — cheap last-write-wins
        writes, recorded whether or not the endpoint is on (the
        always-on counter discipline)."""
        from pipelinedp_tpu_torch.obs import metrics
        metrics.set_gauge("serve.queue_depth", float(self._q.qsize()),
                          help="serve queue depth (pendings + fused "
                          "batches)")
        with self._admit:
            inflight = sum(self._inflight.values())
        metrics.set_gauge("serve.inflight", float(inflight),
                          help="requests admitted and not yet finished")
        if self._fuser is not None:
            try:
                snap = self._fuser.snapshot()
            except Exception:
                return
            metrics.set_gauge("serve.fusion_queued",
                              float(snap.get("queued", 0)),
                              help="requests waiting in open fusion "
                              "windows")
            for label, b in (snap.get("buckets") or {}).items():
                metrics.set_gauge("serve.fusion_bucket_fill",
                                  float(b.get("queued", 0)),
                                  help="per-bucket fusion window fill",
                                  bucket=label)

    def _push_tenant_state(self) -> None:
        """Per-tenant budget gauges for ``/metrics`` plus the
        heartbeat's ``tenants`` section, both fed by the durable
        ledger's :meth:`TenantBudgetLedger.overview`. Burn rate is
        committed epsilon over service uptime on the injectable clock
        — the metrics plane never reads wall time itself. Never takes
        a request down."""
        from pipelinedp_tpu_torch.obs import metrics
        from pipelinedp_tpu_torch.obs import monitor as obs_monitor
        try:
            overview = self.budgets.overview()
        except Exception:
            return
        uptime = max(self._clock.monotonic() - self._t0, 1e-9)
        with self._admit:
            inflight = dict(self._inflight)
        tenants_hb: Dict[str, Any] = {}
        for tenant, info in overview.items():
            metrics.set_gauge("tenant.epsilon_remaining",
                              info["remaining_epsilon"],
                              help="tenant budget epsilon remaining",
                              tenant=tenant)
            metrics.set_gauge("tenant.delta_remaining",
                              info["remaining_delta"],
                              help="tenant budget delta remaining",
                              tenant=tenant)
            metrics.set_gauge("tenant.reserves_in_flight",
                              float(info["reserves_in_flight"]),
                              help="durable reserves neither committed "
                              "nor released",
                              tenant=tenant)
            metrics.set_gauge("tenant.epsilon_burn_per_s",
                              info["committed_epsilon"] / uptime,
                              help="committed epsilon per uptime second",
                              tenant=tenant)
            tenants_hb[tenant] = {
                "epsilon_remaining": info["remaining_epsilon"],
                "delta_remaining": info["remaining_delta"],
                "reserves_in_flight": info["reserves_in_flight"],
                "committed_epsilon": info["committed_epsilon"],
                "inflight": int(inflight.get(tenant, 0)),
            }
        obs_monitor.update_tenants(tenants_hb or None)

    # --- per-tenant books ---

    def books_dir(self, tenant: str) -> str:
        return os.path.join(self.ledger_dir, "books",
                            tenant_slug(tenant))

    def _append_books(self, tenant: str, name: str,
                      payload: Dict[str, Any]) -> None:
        """Append one entry to the tenant's own run-ledger store (the
        fsync'd JSONL appender — the store appends deltas linearly, so
        the books come for free). Never takes a request down."""
        try:
            from pipelinedp_tpu_torch import obs
            from pipelinedp_tpu_torch.obs.store import LedgerStore
            # Creation is serialized so each tenant gets exactly ONE
            # LedgerStore instance (the store's one-lock-per-file
            # contract); the append itself runs outside the lock —
            # the store has its own.
            with self._books_lock:
                store = self._books_stores.get(tenant)
                if store is None:
                    # Only makes the directory; the fsync'd append
                    # runs outside the lock.
                    # lint: disable=blocking-under-lock(mkdir-only creation; the fsync'd append runs outside)
                    store = LedgerStore(self.books_dir(tenant))
                    self._books_stores[tenant] = store
                if self._env is None:
                    self._env = obs.environment_fingerprint()
                env = self._env
            store.append(name, {"serve": dict(payload, tenant=tenant)},
                         env=env)
        except Exception:
            pass
