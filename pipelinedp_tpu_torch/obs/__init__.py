"""Run-ledger observability layer: spans, counters, and the run report.

Port of ``pipelinedp_tpu/obs``. Every run records *what* executed (which
code path, which environment, where the wall time went), not just how
fast. This package is the one place that knowledge accumulates:

* :func:`run_tracer` — per-run span tracer. ALWAYS measures (the bench
  timing fields ``t_stage``/``t_fold``/``t_device``/``host_encode_s``/…
  are derived views over its span totals — same names, same semantics
  as the ad-hoc ``perf_counter`` plumbing it replaced); records full
  spans into the ledger only when ``PIPELINEDP_TPU_TRACE`` is set.
* :func:`tracer` — the global tracer for ledger-only call sites (sweep
  chunks, checkpoint phases, walk rounds): a recording tracer when
  tracing is on, a range-only tracer while ``torch.profiler`` records,
  the shared zero-overhead no-op otherwise.
* Profiler ranges: while ``torch.profiler`` records, every span of every
  tracer opens a ``record_function`` range ``pdp.<span name>`` on the
  profiler's clock, beside the device operations it launched; under
  ``PIPELINEDP_TPU_TRACE`` a span also pushes an NVTX range on the card.
* :func:`inc` / :func:`event` — the counters/events registry. Always
  on: retries, health degradations, checkpoint saves/resumes/refusals,
  fault injections, cache hits, and which fallback path fired are rare
  and load-bearing — invisible branches are how artifacts stop being
  self-describing. The streamed pass-B sweep planner reports through
  here too: ``stream.pass_b_stream_sweeps`` (batch-stream traversals
  paid), ``stream.pass_b_tiles`` (tiles those traversals served — the
  collapse evidence is sweeps < tiles), and
  ``stream.pass_b_reshipped_bytes`` (host-link bytes past the device
  cache's resident prefix).
* :func:`build_run_report` / :func:`write_chrome_trace` — exporters:
  the schema-versioned run report (merged into bench records) and the
  Perfetto-loadable Chrome-trace file.
* :mod:`~pipelinedp_tpu_torch.obs.audit` — the structured privacy/utility
  audit registry behind the run report's schema-v2 ``privacy`` section:
  per-mechanism eps/delta splits + noise stddevs (pushed by
  ``BudgetAccountant.compute_budgets``), aggregation shapes (pushed by
  ``DPEngine``), selection pre/post counts, per-metric expected errors.
  Default-on; ``PIPELINEDP_TPU_AUDIT=0`` opts out (DP outputs are
  bit-identical either way).
* :mod:`~pipelinedp_tpu_torch.obs.store` — the durable append-only JSONL
  run-ledger store (``PIPELINEDP_TPU_LEDGER_DIR``, default a sibling of
  the compile cache): fsync'd per-entry appends keyed by an
  environment-fingerprint hash, torn-line-tolerant reads, and
  ``last_known_good`` queries that never hand back a degraded run —
  the substrate a benchmark's ``--compare`` gates regressions on. Also
  the ledger-analytics CLI (``python -m pipelinedp_tpu_torch.obs.store
  --summarize``): per-(fingerprint, phase) cost tables with trends.
* :mod:`~pipelinedp_tpu_torch.obs.monitor` — the LIVE half
  (``PIPELINEDP_TPU_HEARTBEAT``): a monitor thread streaming an
  atomically-replaced heartbeat file (phase, progress vs plan, rows/s,
  pace vs the store's baseline) and a stall watchdog
  (``PIPELINEDP_TPU_STALL_S``) that dumps a flight record — active
  spans, recent ring, per-``pdp-*``-thread stacks — when no span opens
  or closes for the deadline, then runs a pluggable action.

Threading/cycles: this package imports only the stdlib at module level
(``resilience`` and the engine import it lazily or downstream), and the
ledger/tracers are lock-guarded so the ingest executor's stager and
fold threads emit concurrently with the dispatch thread.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from pipelinedp_tpu_torch.obs import (audit, costs, metrics, store,
                                      trace_context)
from pipelinedp_tpu_torch.obs import report as _report
from pipelinedp_tpu_torch.obs.tracer import (
    ACTIVITY, ENV_VAR, MAX_EVENTS, MAX_SPANS, NOOP_SPAN, NOOP_TRACER,
    RANGE_PREFIX, RANGE_TRACER, NoopTracer, RangeTracer, RunLedger, Span,
    Tracer, profiler_recording, trace_destination, trace_enabled)
from pipelinedp_tpu_torch.obs.report import (SCHEMA_VERSION,
                                             environment_fingerprint)
from pipelinedp_tpu_torch.obs import monitor  # noqa: E402 (needs store first)

__all__ = [
    "ENV_VAR", "SCHEMA_VERSION", "MAX_SPANS", "MAX_EVENTS",
    "Span", "Tracer", "NoopTracer", "RangeTracer", "RunLedger",
    "NOOP_SPAN", "NOOP_TRACER", "RANGE_TRACER", "RANGE_PREFIX", "ACTIVITY",
    "trace_enabled", "trace_destination", "profiler_recording",
    "ledger", "tracer", "run_tracer", "span", "inc", "event", "reset",
    "gauge", "gauge_max", "sample",
    "environment_fingerprint", "build_run_report", "write_chrome_trace",
    "audit", "costs", "store", "monitor",
    "metrics", "trace_context",
]

#: The process-global run ledger.
_LEDGER = RunLedger()

#: The one recording tracer behind :func:`tracer` (its totals are
#: global and unread; sites that need per-run totals use run_tracer).
_RECORDING = Tracer(ledger=_LEDGER)

#: Measuring-only tracer handed out when the live monitor is armed but
#: full tracing is off: real span handles (so the activity registry —
#: and thus the heartbeat/watchdog — sees opens/closes) without any
#: ledger growth.
_MEASURING = Tracer()


def ledger() -> RunLedger:
    return _LEDGER


def tracer() -> Any:
    """Global tracer for ledger-only span sites: recording when
    ``PIPELINEDP_TPU_TRACE`` is set, measuring-only when the live
    monitor is armed (its watchdog needs real span open/close signals),
    range-only while ``torch.profiler`` records, the shared no-op
    otherwise."""
    if trace_enabled():
        return _RECORDING
    if ACTIVITY.enabled:
        return _MEASURING
    if profiler_recording():
        return RANGE_TRACER
    return NOOP_TRACER


def run_tracer(clock=None) -> Tracer:
    """Fresh always-measuring tracer for one run/section: per-name span
    totals accumulate regardless of the trace flag (bench timing fields
    read them), full spans reach the ledger only when tracing is on."""
    return Tracer(clock=clock,
                  ledger=_LEDGER if trace_enabled() else None)


def span(name: str, cat: str = "run", **args):
    """Convenience: a span on the global tracer (no-op when disabled)."""
    return tracer().span(name, cat, **args)


def inc(name: str, n: int = 1) -> None:
    """Increment a ledger counter (always on)."""
    _LEDGER.inc(name, n)


def event(name: str, **attrs) -> None:
    """Record a structured ledger event (always on)."""
    _LEDGER.event(name, **attrs)


def gauge(name: str, value: int) -> None:
    """Set a ledger counter to an instantaneous value (live HBM)."""
    _LEDGER.gauge(name, value)


def gauge_max(name: str, value: int) -> None:
    """Raise a ledger counter to ``value`` if larger (watermarks)."""
    _LEDGER.gauge_max(name, value)


def sample(name: str, value: float) -> None:
    """Append one (ts, value) sample to a ledger time series — the
    Chrome-trace export renders these as counter tracks."""
    _LEDGER.sample(name, value)


def reset() -> None:
    """Start a fresh ledger AND audit registry AND device-cost table
    AND planner applied-state (tests; bench run boundaries)."""
    _LEDGER.reset()
    audit.reset()
    costs.reset()
    metrics.reset()
    store.reset_run_report_cursor()
    monitor.reset_requests()
    # Lazy: plan imports obs, so a module-level import would cycle.
    from pipelinedp_tpu_torch import plan as _plan
    _plan.reset()


def build_run_report(mesh=None, extra: Optional[Dict[str, Any]] = None,
                     env: Optional[Dict[str, Any]] = None,
                     snapshot: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """The schema-versioned self-describing run report (see
    ``obs.report``) over the current ledger state. Pass the SAME
    ``snapshot`` to this and :func:`write_chrome_trace` when the pair
    must agree span-for-span (worker threads may still be emitting)."""
    return _report.build_run_report(
        snapshot if snapshot is not None else _LEDGER.snapshot(),
        mesh=mesh, extra=extra, env=env)


def write_chrome_trace(path: Optional[str] = None,
                       snapshot: Optional[Dict[str, Any]] = None) -> str:
    """Write the ledger's spans/events as a Chrome-trace JSON file
    (Perfetto-loadable); returns the path written."""
    return _report.write_chrome_trace(
        path or trace_destination(),
        snapshot if snapshot is not None else _LEDGER.snapshot())
