"""Live run telemetry: heartbeat progress stream + stall watchdog with
flight recorder.

Everything else in ``obs/`` is post-hoc — spans, run reports, audit
records, and the durable store all materialize AFTER the work they
describe. A wedged device or a stalled pass-B sweep therefore produces
*nothing* until the process dies. PipelineDP delegates progress
visibility to the Beam/Spark runner UIs, which a single process does
not have. This module is the in-flight half of the obs stack:

* **Heartbeat** — a single monitor thread (``pdp-monitor``) snapshots
  the live counter/span ledger every ``PIPELINEDP_TPU_HEARTBEAT_S``
  seconds into an atomically-replaced JSON file
  (``<ledger_dir>/heartbeat-<run>.json`` by default — namespaced by
  run name so resident processes sharing one ledger directory never
  clobber each other — or the path named by
  ``PIPELINEDP_TPU_HEARTBEAT``): current phase, batches/sweeps done vs
  planned, rows/s so far, wall time per active span, every live
  request registered via :func:`register_request` (the resident
  service's in-flight picture, all requests in ONE document) — and,
  when the durable ledger store holds a same-fingerprint baseline run
  report, an on-pace/behind verdict with a projected ETA.
  ``os.replace`` makes every write atomic: a concurrent ``watch cat``
  or dashboard poller never sees a torn file.
* **Stall watchdog** — if no span opens or closes for
  ``PIPELINEDP_TPU_STALL_S`` seconds, emit a structured
  ``watchdog.stalled`` event into the ledger and dump a **flight
  record** (``<run>.flightrec.json``): the active spans with their
  ages, a bounded ring of the last-N completed spans and ledger
  events, the counters, and ``sys._current_frames()`` stack summaries
  for every named ``pdp-*`` worker thread — then invoke a pluggable
  ``on_stall`` action (default: record-and-continue; the bench wires
  an action that cancels a wedged device probe so degradation happens
  at the stall deadline, not the 300 s probe wall).
* **Zero overhead when off** — with ``PIPELINEDP_TPU_HEARTBEAT``
  unset nothing starts, the activity registry stays disabled, and the
  only residual cost anywhere is one module-level bool check per span
  enter/exit on the always-measuring tracers.

Clock discipline: ALL deadline and age arithmetic runs on an
injectable ``resilience.clock`` (tests drive the watchdog to its exact
deadline on a ``FakeClock`` in zero wall time;
``tests/test_torch_monitor.py`` scans this module for any ``time`` call). Only
the inter-beat pacing of the background thread uses
``threading.Event.wait`` — so ``stop()`` wakes it immediately — and
the thread itself is an ingest ``_CaptureThread``, keeping the
"no bare threading.Thread" drain invariant intact.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

from pipelinedp_tpu_torch.obs import costs as _costs
from pipelinedp_tpu_torch.obs import store as _store
from pipelinedp_tpu_torch.obs import tracer as _tracer

ENV_VAR = "PIPELINEDP_TPU_HEARTBEAT"
INTERVAL_ENV = "PIPELINEDP_TPU_HEARTBEAT_S"
STALL_ENV = "PIPELINEDP_TPU_STALL_S"

DEFAULT_INTERVAL_S = 5.0
DEFAULT_STALL_S = 60.0
HEARTBEAT_FILENAME = "heartbeat.json"

#: Events kept in a flight record / heartbeat (the ledger itself keeps
#: up to MAX_EVENTS; the dump wants the recent tail, not the history).
FLIGHT_RING_EVENTS = 64
#: Innermost frames kept per thread in a flight-record stack summary.
STACK_DEPTH = 16
#: On-pace slack: the verdict is "behind" only when the observed
#: rows/s falls below this fraction of the baseline's — half, so link
#: jitter and cold compiles don't cry wolf on every beat.
PACE_SLACK = 0.5


def heartbeat_enabled() -> bool:
    """True when ``PIPELINEDP_TPU_HEARTBEAT`` requests the monitor (any
    value except empty/0/false/off; a path value also names the
    heartbeat file)."""
    return os.environ.get(ENV_VAR, "").lower() not in ("", "0", "false",
                                                       "off")


def heartbeat_destination(default_dir: Optional[str] = None,
                          run: Optional[str] = None) -> str:
    """Where the heartbeat lands: a path-like ``PIPELINEDP_TPU_HEARTBEAT``
    value (contains a separator or ends in ``.json``) names the file
    verbatim; bare switch values use ``<ledger_dir>/heartbeat-<run>.json``
    so the live view sits next to the durable history it projects AND
    two resident processes sharing one ledger directory never clobber
    each other's beat (without ``run`` the legacy shared
    ``heartbeat.json`` name is kept for explicit single-run callers)."""
    v = os.environ.get(ENV_VAR, "")
    if os.sep in v or "/" in v or v.endswith(".json"):
        return v
    d = _store.ledger_dir(default=default_dir or
                          os.path.join(os.getcwd(), ".pdp_ledger"))
    if run:
        safe = "".join(c if (c.isalnum() or c in "-_.") else "-"
                       for c in str(run))
        return os.path.join(d, f"heartbeat-{safe}.json")
    return os.path.join(d, HEARTBEAT_FILENAME)


# --- live-request registry -------------------------------------------
#
# A resident multi-tenant service runs MANY requests through one
# process at once; a heartbeat that only says "phase: engine.device"
# cannot say whose. Each in-flight request registers here (the serve
# layer does it at admission), and every beat snapshots ALL live
# requests into the one heartbeat document — one file, the whole
# process's in-flight picture, instead of N requests clobbering a
# single phase field.

_REQS_LOCK = threading.Lock()
_LIVE_REQUESTS: Dict[str, Dict[str, Any]] = {}
_REQS_SEQ = 0


def register_request(request_id: str, **attrs) -> None:
    """Register one in-flight request (tenant, phase, ... — any
    JSON-able attrs). Idempotent per ``request_id``; registration is a
    dict write, cheap enough to do whether or not a monitor runs."""
    global _REQS_SEQ
    with _REQS_LOCK:
        _REQS_SEQ += 1
        rec = _LIVE_REQUESTS.setdefault(str(request_id),
                                        {"request_id": str(request_id),
                                         "seq": _REQS_SEQ})
        rec.update(attrs)


def update_request(request_id: str, **attrs) -> None:
    """Update a live request's attrs (e.g. phase transitions); unknown
    ids are ignored — the request may already have completed."""
    with _REQS_LOCK:
        rec = _LIVE_REQUESTS.get(str(request_id))
        if rec is not None:
            rec.update(attrs)


def unregister_request(request_id: str) -> None:
    """Drop a completed/refused request from the live set."""
    with _REQS_LOCK:
        _LIVE_REQUESTS.pop(str(request_id), None)


def live_requests() -> List[Dict[str, Any]]:
    """Snapshot of all live requests, admission order."""
    with _REQS_LOCK:
        return [dict(r) for r in sorted(_LIVE_REQUESTS.values(),
                                        key=lambda r: r.get("seq", 0))]


def reset_requests() -> None:
    """Forget all live-request registrations (tests)."""
    with _REQS_LOCK:
        _LIVE_REQUESTS.clear()
    update_fusion(None)
    update_mesh(None)
    update_serve_health(None)
    update_sweep(None)
    update_tenants(None)


# The serve-fusion bucket registry: the fusion layer of the resident
# service (not yet in this package: nothing pushes here before it comes)
# PUSHES its live bucket occupancy here on every change — the monitor
# must never import serve/ (the engine-never-imports-serve invariant),
# so the heartbeat pulls from this registry instead. One document then
# answers "why is this window not flushing": requests queued per
# bucket and the seconds left on each window, next to the in-flight
# request list.

_FUSION_LOCK = threading.Lock()
_FUSION_STATE: Optional[Dict[str, Any]] = None


def update_fusion(snapshot: Optional[Dict[str, Any]]) -> None:
    """Install (or, with None, clear) the serve-fusion occupancy
    snapshot the next heartbeat embeds."""
    global _FUSION_STATE
    with _FUSION_LOCK:
        _FUSION_STATE = dict(snapshot) if snapshot is not None else None


def fusion_snapshot() -> Optional[Dict[str, Any]]:
    with _FUSION_LOCK:
        return dict(_FUSION_STATE) if _FUSION_STATE is not None else None


# The mesh-recovery registry: the elastic streaming wrapper PUSHES the
# mesh's recovery state here on every reshard (old shape -> new shape,
# reason, reshard count) — same push-registry pattern as the fusion
# occupancy above, for the same reason: the monitor must never import
# the layers it observes. The heartbeat grows a "mesh" section while a
# snapshot is installed, so a run that survived a device loss says so
# live, not only in the post-hoc report.

_MESH_LOCK = threading.Lock()
_MESH_STATE: Optional[Dict[str, Any]] = None

# The serve-health registry: the resident service pushes its degraded
# state (reason + detail) so the heartbeat's serve section reports WHY
# submits are being refused while the device is wedged.

_SERVE_HEALTH_LOCK = threading.Lock()
_SERVE_HEALTH: Optional[Dict[str, Any]] = None


def update_mesh(snapshot: Optional[Dict[str, Any]]) -> None:
    """Install (or, with None, clear) the elastic-mesh recovery
    snapshot the next heartbeat embeds."""
    global _MESH_STATE
    with _MESH_LOCK:
        _MESH_STATE = dict(snapshot) if snapshot is not None else None


def mesh_snapshot() -> Optional[Dict[str, Any]]:
    with _MESH_LOCK:
        return dict(_MESH_STATE) if _MESH_STATE is not None else None


def update_serve_health(snapshot: Optional[Dict[str, Any]]) -> None:
    """Install (or, with None, clear) the resident service's degraded
    state for the heartbeat's serve section."""
    global _SERVE_HEALTH
    with _SERVE_HEALTH_LOCK:
        _SERVE_HEALTH = (dict(snapshot) if snapshot is not None
                         else None)


def serve_health_snapshot() -> Optional[Dict[str, Any]]:
    with _SERVE_HEALTH_LOCK:
        return (dict(_SERVE_HEALTH) if _SERVE_HEALTH is not None
                else None)


# The megasweep-progress registry: the utility-analysis sweep
# (analysis/torch_sweep.py) pushes its config-chunk progress here — same
# push pattern as fusion/mesh above (the monitor never imports the
# layers it observes). The heartbeat grows a "sweep" section while a
# megasweep is in flight (configs enqueued vs planned, current chunk),
# so the stall watchdog can name the blocked config batch.

_SWEEP_LOCK = threading.Lock()
_SWEEP_STATE: Optional[Dict[str, Any]] = None


def update_sweep(snapshot: Optional[Dict[str, Any]]) -> None:
    """Install (or, with None, clear) the megasweep progress snapshot
    the next heartbeat embeds."""
    global _SWEEP_STATE
    with _SWEEP_LOCK:
        _SWEEP_STATE = dict(snapshot) if snapshot is not None else None


def sweep_snapshot() -> Optional[Dict[str, Any]]:
    with _SWEEP_LOCK:
        return dict(_SWEEP_STATE) if _SWEEP_STATE is not None else None


# The tenant-budget registry: the serve layer pushes each tenant's
# budget picture (ε/δ remaining, reserves in flight) from its durable
# budget ledger on every reserve/commit/release — same push pattern as
# fusion/mesh/sweep above, because the monitor never imports serve/.
# The heartbeat grows a "tenants" section while a snapshot is
# installed, so "who is burning budget" is answerable from the monitor
# document alone, no HTTP endpoint armed.

_TENANTS_LOCK = threading.Lock()
_TENANTS_STATE: Optional[Dict[str, Any]] = None


def update_tenants(snapshot: Optional[Dict[str, Any]]) -> None:
    """Install (or, with None, clear) the per-tenant budget snapshot
    the next heartbeat embeds (``{tenant: {epsilon_remaining, ...}}``)."""
    global _TENANTS_STATE
    with _TENANTS_LOCK:
        _TENANTS_STATE = (dict(snapshot) if snapshot is not None
                          else None)


def tenants_snapshot() -> Optional[Dict[str, Any]]:
    with _TENANTS_LOCK:
        return (dict(_TENANTS_STATE) if _TENANTS_STATE is not None
                else None)


class Monitor:
    """The monitor: one background thread (or inline test driving via
    :meth:`poll_once`) that writes heartbeats and ages the stall
    watchdog.

    ``on_stall(info)`` is the pluggable stall action — ``info`` carries
    the diagnosis, phase, and flight-record path. The default (None) is
    record-and-continue; an action that raises is itself recorded
    (``watchdog.action_error``) and never kills the monitor.
    ``fingerprint`` (installable later via :meth:`attach_baseline`)
    keys the pace baseline lookup in the durable ledger store."""

    def __init__(self, clock=None, interval_s: Optional[float] = None,
                 stall_s: Optional[float] = None,
                 heartbeat_path: Optional[str] = None,
                 run_name: Optional[str] = None,
                 on_stall: Optional[Callable[[Dict[str, Any]],
                                             None]] = None,
                 fingerprint: Optional[str] = None,
                 store_dir: Optional[str] = None):
        if clock is None:
            from pipelinedp_tpu_torch.resilience.clock import SystemClock
            clock = SystemClock()
        self.clock = clock
        self.interval_s = (float(os.environ.get(INTERVAL_ENV,
                                                DEFAULT_INTERVAL_S))
                           if interval_s is None else float(interval_s))
        self.stall_s = (float(os.environ.get(STALL_ENV, DEFAULT_STALL_S))
                        if stall_s is None else float(stall_s))
        self.run_name = run_name or f"run-{os.getpid()}"
        self.heartbeat_path = (heartbeat_path or
                               heartbeat_destination(run=self.run_name))
        self.flight_path = os.path.join(
            os.path.dirname(os.path.abspath(self.heartbeat_path)),
            f"{self.run_name}.flightrec.json")
        self.on_stall = on_stall
        self.fingerprint = fingerprint
        self._store_dir = store_dir
        self._baseline: Optional[Dict[str, Any]] = None
        self._baseline_loaded = False
        #: Every stall fired this run, oldest first (the bench embeds
        #: the last one into a degraded artifact).
        self.stalls: List[Dict[str, Any]] = []
        self.beats = 0
        self.write_errors = 0
        #: The most recent heartbeat payload (``/heartbeat`` serves it
        #: without forcing an off-schedule beat).
        self.last_heartbeat: Optional[Dict[str, Any]] = None
        self._stop = threading.Event()
        self._thread = None
        self._t_start = self.clock.monotonic()
        self._last_change = self._t_start
        self._last_seq = -1
        self._stall_open = False
        self._rows_anchor: Optional[Tuple[float, int]] = None

    # --- lifecycle ---

    def _arm(self) -> None:
        _tracer.ACTIVITY.reset(enabled=True, clock=self.clock)
        self._t_start = self.clock.monotonic()
        self._last_change = self._t_start
        self._last_seq = -1
        self._stall_open = False
        self._rows_anchor = None

    def start(self) -> "Monitor":
        """Arm activity tracking and spawn the ``pdp-monitor`` thread."""
        self._arm()
        from pipelinedp_tpu_torch.ingest.executor import _CaptureThread
        self._stop.clear()
        self._thread = _CaptureThread(self._loop, "pdp-monitor")
        self._thread.start()
        return self

    def start_inline(self) -> "Monitor":
        """Arm activity tracking WITHOUT a thread — tests drive beats
        deterministically via :meth:`poll_once` on a ``FakeClock``."""
        self._arm()
        return self

    def _loop(self) -> None:
        # Event.wait paces the beats (stop() wakes it immediately);
        # every deadline/age computation inside poll_once runs on the
        # injectable clock.
        while not self._stop.wait(self.interval_s):
            self.poll_once()
        self.poll_once()  # final beat: short runs still leave a file

    def stop(self) -> None:
        """Stop the thread (writing one final heartbeat) and disarm
        activity tracking."""
        self._stop.set()
        if self._thread is not None:
            while self._thread.is_alive():
                self._thread.join(timeout=0.05)
            self._thread = None
        _tracer.ACTIVITY.reset(enabled=False)

    # --- baseline / pace ---

    def attach_baseline(self, fingerprint: str,
                        store_dir: Optional[str] = None) -> None:
        """Install the fingerprint the pace verdict keys on (the bench
        calls this once the environment probe has settled — computing
        the fingerprint itself touches ``torch.cuda``, which is the
        very call a wedged runtime blocks in)."""
        self.fingerprint = fingerprint
        if store_dir is not None:
            self._store_dir = store_dir
        self._baseline = None
        self._baseline_loaded = False

    def _load_baseline(self) -> Optional[Dict[str, Any]]:
        if self._baseline_loaded or self.fingerprint is None:
            return self._baseline
        self._baseline_loaded = True
        try:
            # Same default resolution as the bench's ledger connection
            # (cwd/.pdp_ledger) — the baseline must be found exactly
            # where the bench writes it, env knobs set or not.
            directory = self._store_dir or _store.ledger_dir(
                default=os.path.join(os.getcwd(), ".pdp_ledger"))
            if not directory:
                return None
            entry = _store.LedgerStore(directory).last_known_good(
                "run_report", self.fingerprint)
            self._baseline = ((entry or {}).get("payload")
                              or {}).get("run_report")
        except Exception:
            self._baseline = None
        return self._baseline

    def _pace(self, rows_done: int, rows_planned: int,
              rate: float) -> Optional[Dict[str, Any]]:
        """On-pace/behind verdict vs the same-fingerprint baseline run:
        the baseline's pass-A rows/s is the bar, the projected ETA is
        remaining rows over the CURRENT rate. None when no baseline
        resolves or the baseline lacks the needed fields."""
        baseline = self._load_baseline()
        if not baseline:
            return None
        base_counters = baseline.get("counters") or {}
        base_spans = baseline.get("spans") or {}
        base_rows = base_counters.get("progress.rows_staged")
        base_wall = (base_spans.get("ingest.pass_a") or {}).get("total_s")
        if not base_rows or not base_wall:
            return None
        expected = base_rows / base_wall
        pace = {
            "baseline_rows_per_s": round(expected, 1),
            "rows_per_s": round(rate, 1),
            "verdict": ("on_pace" if rate >= PACE_SLACK * expected
                        else "behind"),
            "slack": PACE_SLACK,
        }
        if rows_planned and rate > 0:
            pace["projected_eta_s"] = round(
                max(0, rows_planned - rows_done) / rate, 1)
        return pace

    # --- the beat ---

    def poll_once(self) -> Dict[str, Any]:
        """One monitor beat: age the watchdog, (maybe) fire the stall
        path, write the heartbeat. Returns the heartbeat payload."""
        from pipelinedp_tpu_torch import obs
        now = self.clock.monotonic()
        seq, active, recent = _tracer.ACTIVITY.snapshot()
        if seq != self._last_seq:
            self._last_seq = seq
            self._last_change = now
            self._stall_open = False
        stalled_for = now - self._last_change
        # Device-memory watermark sampling rides the beat when the cost
        # observatory is on (``PIPELINEDP_TPU_COSTS``): live-array
        # bytes land in the hbm.* gauges BEFORE the counter snapshot
        # below, so this very heartbeat already carries them.
        _costs.sample_live_bytes()
        counters, recent_events = obs.ledger().tail_snapshot(
            FLIGHT_RING_EVENTS)
        stalled = stalled_for >= self.stall_s
        if stalled and not self._stall_open:
            # Fire once per stall episode; any later span open/close
            # re-arms the watchdog for the next one.
            self._stall_open = True
            self._fire_watchdog(stalled_for, active, recent, counters,
                                recent_events)
        hb = self._build_heartbeat(now, active, recent, counters,
                                   stalled, stalled_for)
        self._write_atomic(self.heartbeat_path, hb)
        self.beats += 1
        self.last_heartbeat = hb
        return hb

    def _rate(self, now: float, rows_done: int,
              uptime: float) -> float:
        """Observed staging rate, anchored at the first beat that saw
        any staged rows: the bench arms the monitor BEFORE the device
        probe and the cold compiles, and a pace verdict diluted by that
        pre-ingest wall time would read "behind" on a perfectly healthy
        run. Falls back to rows/uptime until the anchor has elapsed
        (short runs whose staging finished within one beat)."""
        if rows_done and self._rows_anchor is None:
            self._rows_anchor = (now, rows_done)
        if self._rows_anchor is not None:
            t0, r0 = self._rows_anchor
            if now > t0:
                return (rows_done - r0) / (now - t0)
        return rows_done / uptime if uptime > 0 else 0.0

    def _phase(self, active, recent=None) -> str:
        if active:
            return active[-1]["name"]  # most recently opened
        if recent:
            return recent[-1]["name"]
        return "idle"

    def _build_heartbeat(self, now: float, active, recent, counters,
                         stalled: bool, stalled_for: float
                         ) -> Dict[str, Any]:
        uptime = now - self._t_start
        rows_done = counters.get("progress.rows_staged", 0)
        rows_planned = counters.get("ingest.rows_ingested", 0)
        rate = self._rate(now, rows_done, uptime)
        hb: Dict[str, Any] = {
            "run": self.run_name,
            "beat": self.beats,
            "uptime_s": round(uptime, 3),
            "phase": self._phase(active, recent),
            "active_spans": [
                {"name": a["name"], "cat": a["cat"],
                 "thread": a["thread"], "age_s": round(a["age_s"], 3)}
                for a in active],
            "progress": {
                "batches_done": counters.get("progress.batches_staged",
                                             0),
                "batches_planned": counters.get(
                    "progress.batches_planned", 0),
                "sweeps_done": counters.get(
                    "stream.pass_b_stream_sweeps", 0),
                "sweeps_planned": counters.get(
                    "progress.sweeps_planned", 0),
                "rows_done": rows_done,
                "rows_planned": rows_planned,
                "rows_per_s": round(rate, 1),
            },
            "counters": counters,
            "stalled": stalled,
        }
        hbm = _costs.hbm_snapshot()
        if hbm is not None:
            hb["hbm"] = hbm
        reqs = live_requests()
        if reqs:
            # One document snapshots EVERY in-flight request of this
            # resident process (tenant, phase, age) — the multi-tenant
            # answer to "whose work is the current phase".
            hb["requests"] = reqs
        fusion = fusion_snapshot()
        if fusion is not None:
            # The serve section: live fusion-bucket occupancy (queued
            # requests per bucket + window deadlines), so a stalled
            # batching window self-diagnoses from the heartbeat alone.
            hb["serve"] = {"fusion": fusion}
        serve_health = serve_health_snapshot()
        if serve_health is not None:
            # Degraded serve state: submits are being refused (the
            # structured "degraded" refusal) — the heartbeat says WHY
            # next to the live request list.
            hb.setdefault("serve", {})["health"] = serve_health
        mesh = mesh_snapshot()
        if mesh is not None:
            # Elastic-recovery trail: the mesh re-formed mid-run
            # (old shape -> new shape, reason, reshard count).
            hb["mesh"] = mesh
        if counters.get("comms.collectives"):
            # Collective traffic estimate: how much of the exchange
            # volume stays inside a host vs crossing hosts. No module
            # of the port counts it until the mesh is ported.
            hb["comms"] = {
                "collectives": counters.get("comms.collectives", 0),
                "ici_bytes": counters.get("comms.ici_bytes", 0),
                "dcn_bytes": counters.get("comms.dcn_bytes", 0),
            }
        sweep = sweep_snapshot()
        if sweep is not None:
            # Megasweep progress: configs enqueued vs planned, so a long
            # utility-analysis sweep is visible live and a stall names
            # its blocked config batch.
            hb["sweep"] = sweep
        tenants = tenants_snapshot()
        if tenants is not None:
            # Per-tenant budget burn-down (ε/δ remaining, reserves in
            # flight) from the serve layer's durable budget ledger:
            # "who is burning budget" without reading ledger JSON.
            hb["tenants"] = tenants
        if stalled:
            hb["stall"] = {"stalled_for_s": round(stalled_for, 3),
                           "deadline_s": self.stall_s,
                           "flight_record": self.flight_path}
        pace = self._pace(rows_done, rows_planned, rate)
        if pace is not None:
            hb["pace"] = pace
        return hb

    def _fire_watchdog(self, stalled_for: float, active, recent,
                       counters, recent_events) -> None:
        from pipelinedp_tpu_torch import obs
        phase = self._phase(active, recent)
        diagnosis = (f"no span opened or closed for {stalled_for:.1f}s "
                     f"(deadline {self.stall_s:g}s) during phase "
                     f"'{phase}'")
        if len(active) == 1:
            diagnosis += f"; blocked thread: {active[0]['thread']}"
        elif active:
            # Several spans are open: the root blocker is ambiguous
            # (an upstream wedge backs every downstream worker up into
            # its own open span), so enumerate rather than guess — the
            # flight record's per-thread stacks settle it.
            frag = ", ".join(
                f"{a['name']}@{a['thread']} ({a['age_s']:.1f}s)"
                for a in active[:4])
            if len(active) > 4:
                frag += f", +{len(active) - 4} more"
            diagnosis += f"; open spans (oldest first): {frag}"
        obs.inc("watchdog.stalls")
        obs.event("watchdog.stalled", run=self.run_name, phase=phase,
                  stalled_for_s=round(stalled_for, 3),
                  deadline_s=self.stall_s,
                  flight_record=self.flight_path)
        record = {
            "run": self.run_name,
            "stall": {"diagnosis": diagnosis, "phase": phase,
                      "stalled_for_s": round(stalled_for, 3),
                      "deadline_s": self.stall_s},
            "active_spans": [
                {**{k: a[k] for k in ("name", "cat", "thread", "tid",
                                      "args")},
                 "age_s": round(a["age_s"], 3)} for a in active],
            "recent_spans": [
                {k: s[k] for k in ("name", "cat", "thread", "tid",
                                   "dur")} for s in recent],
            "recent_events": recent_events,
            "counters": counters,
            "threads": self._thread_stacks(),
        }
        reqs = live_requests()
        if reqs:
            record["requests"] = reqs
        self._write_atomic(self.flight_path, record)
        info = {"diagnosis": diagnosis, "phase": phase,
                "stalled_for_s": round(stalled_for, 3),
                "deadline_s": self.stall_s,
                "flight_record": self.flight_path}
        self.stalls.append(info)
        if self.on_stall is not None:
            try:
                self.on_stall(info)
            except Exception as e:  # an action must not kill the beat
                obs.event("watchdog.action_error", error=repr(e))

    def _thread_stacks(self) -> Dict[str, Dict[str, Any]]:
        """Stack summaries for every named ``pdp-*`` worker thread (plus
        the main thread): innermost frames last, one ``file:line fn``
        string per frame — enough to see WHERE a wedged worker is
        blocked without a debugger attached to a half-dead run."""
        frames = sys._current_frames()
        out: Dict[str, Dict[str, Any]] = {}
        for t in threading.enumerate():
            if not (t.name.startswith("pdp-") or t.name == "MainThread"):
                continue
            frame = frames.get(t.ident)
            if frame is None:
                continue
            stack = traceback.extract_stack(frame)[-STACK_DEPTH:]
            out[str(t.ident)] = {
                "name": t.name,
                "stack": [f"{os.path.basename(fr.filename)}:{fr.lineno} "
                          f"{fr.name}" for fr in stack]}
        return out

    def _write_atomic(self, path: str, payload: Dict[str, Any]) -> None:
        """Write-then-``os.replace``: a concurrent reader sees the old
        file or the new one, never a torn mix. Write failures are
        counted, not raised — telemetry must never take the run down."""
        try:
            d = os.path.dirname(os.path.abspath(path))
            os.makedirs(d, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(json.dumps(payload, default=repr))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            self.write_errors += 1


#: The process-global monitor (one per process, like the run ledger).
_MONITOR: Optional[Monitor] = None


def active_monitor() -> Optional[Monitor]:
    return _MONITOR


def maybe_start(**kwargs) -> Optional[Monitor]:
    """Start the global monitor when ``PIPELINEDP_TPU_HEARTBEAT`` asks
    for one (idempotent — a monitor already running wins, so the bench
    can configure its stall action before the engine's own call).
    Returns None, at zero cost, when the knob is off."""
    global _MONITOR
    if not heartbeat_enabled():
        return None
    if _MONITOR is None:
        _MONITOR = Monitor(**kwargs).start()
    return _MONITOR


def stop() -> None:
    """Stop and forget the global monitor (tests; bench run end)."""
    global _MONITOR
    if _MONITOR is not None:
        _MONITOR.stop()
        _MONITOR = None


def heartbeat_payload() -> Optional[Dict[str, Any]]:
    """The active monitor's most recent heartbeat document (None when
    no monitor runs or it has not beat yet). ``obs/http.py`` serves
    this on ``/heartbeat``; with the monitor off, the endpoint falls
    back to the live push registries instead."""
    m = _MONITOR
    if m is None:
        return None
    return m.last_heartbeat
