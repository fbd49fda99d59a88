"""Structured span tracing + the process-global run ledger.

The observability layer has two always-distinct cost tiers:

* **Counters and events** record ALWAYS — they mark rare, load-bearing
  occurrences (a retry attempt, a checkpoint resume, a fallback path
  firing) whose absence would leave a run's record unable to say what
  executed. An increment is a
  dict update under a lock; an event is one small dict append.
* **Spans** are the hot-path tier. A :class:`Tracer` always accumulates
  per-name busy totals (that is the substrate the bench timing fields
  ``t_stage``/``t_fold``/``t_device``/... derive from — the exact same
  two-timestamp cost the ad-hoc ``perf_counter`` plumbing paid before),
  but full :class:`Span` records flow into the :class:`RunLedger` only
  when ``PIPELINEDP_TPU_TRACE`` is set. With tracing off, call sites
  that only want ledger spans get the shared :data:`NOOP_TRACER`, whose
  ``span()`` hands back ONE preallocated no-op context manager: no
  allocation, nothing recorded, no attributes added to any hot object.

Thread safety: the streaming ingest runs a ``BackgroundStager`` thread
and an ``OrderedFoldWorker`` thread concurrently with the dispatch
thread, and all three emit spans into one tracer — every mutation here
is lock-guarded, and each completed span carries its thread identity so
the Chrome-trace export lays the three lanes out side by side.

Profiler ranges: while ``torch.profiler`` records, every span of every
tracer also opens a ``torch.profiler.record_function`` range named
``pdp.<span name>``, so the span lands on the profiler's clock beside the
device operations it launched; a recording tracer (``PIPELINEDP_TPU_TRACE``)
also pushes an NVTX range once CUDA is initialised. The profiler's state is
read through ``sys.modules``: a process that never imported torch runs no
profiler, and this module keeps to the standard library.

Clock: tracers accept any ``pipelinedp_tpu_torch.resilience.clock.Clock``
(``monotonic()`` is the only method used), so fault tests drive spans
with a ``FakeClock`` and assert exact durations in zero wall time. The
default clock reads ``time.perf_counter`` — ``obs/`` is the ONE package
allowed to touch the raw timer (``tests/test_torch_obs.py`` scans for
it elsewhere).
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time as _time
from typing import Any, Dict, List, Optional, Tuple

from pipelinedp_tpu_torch.obs import trace_context

ENV_VAR = "PIPELINEDP_TPU_TRACE"

#: Retention caps: a pathological run (millions of batches) must not
#: OOM the host through its own telemetry. Drops are counted and
#: surfaced in the run report — silent truncation would read as
#: "covered everything".
MAX_SPANS = 200_000
MAX_EVENTS = 20_000
#: Per-track retention for sampled time-series (the Chrome-trace
#: counter tracks): one sample is (ts, value); 8192 beats covers >11h
#: of 5s heartbeats before drops start counting.
MAX_SAMPLES = 8_192

#: Counters whose increments also append a (ts, cumulative) sample to
#: the series ledger when tracing is on — the Chrome-trace export
#: differentiates ``progress.rows_staged`` into a rows/s counter track.
SAMPLED_COUNTERS = ("progress.rows_staged",)

#: Flight-recorder ring size: the live-activity registry keeps the
#: last N COMPLETED spans so a stall dump can show what ran just
#: before the silence (obs/monitor.py).
FLIGHT_RING_SPANS = 256


def trace_enabled() -> bool:
    """True when ``PIPELINEDP_TPU_TRACE`` requests span recording (any
    value except empty/0/false/off; a path value also names the
    Chrome-trace output file)."""
    return os.environ.get(ENV_VAR, "").lower() not in ("", "0", "false",
                                                       "off")


def trace_destination(default: str = "pdp_trace.json") -> str:
    """Where the Chrome-trace export should land: a path-like
    ``PIPELINEDP_TPU_TRACE`` value (contains a separator or ends in
    ``.json``) names the file; bare switch values ("1") use
    ``default``."""
    v = os.environ.get(ENV_VAR, "")
    if os.sep in v or "/" in v or v.endswith(".json"):
        return v
    return default


#: The prefix of the profiler range (and NVTX range) a span opens.
RANGE_PREFIX = "pdp."


def _profiler():
    """``torch.autograd.profiler`` while a ``torch.profiler`` records,
    else None (one dict lookup and one attribute read)."""
    mod = sys.modules.get("torch.autograd.profiler")
    if mod is not None and mod._is_profiler_enabled:
        return mod
    return None


def profiler_recording() -> bool:
    """True while a ``torch.profiler`` records in this process."""
    return _profiler() is not None


def _open_range(name: str):
    """The span's profiler range, entered, or None when no profiler
    records."""
    prof = _profiler()
    if prof is None:
        return None
    rf = prof.record_function(RANGE_PREFIX + name)
    rf.__enter__()
    return rf


def _nvtx():
    """``torch.cuda.nvtx`` once this process has initialised CUDA, else
    None."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return None
    return torch.cuda.nvtx


class _PerfClock:
    """Default tracer clock. Satisfies the ``Clock.monotonic`` protocol
    without importing ``resilience`` (which may import ``obs`` lazily —
    keeping this module stdlib-only breaks the cycle)."""

    def monotonic(self) -> float:
        return _time.perf_counter()


class _Activity:
    """Live span activity for the stall watchdog and heartbeat
    (``obs/monitor.py``): which spans are OPEN right now (and on which
    thread), a bounded ring of the most recently COMPLETED spans, and a
    change counter (``seq``) that bumps on every span open/close — the
    signal the watchdog ages to detect a wedged run.

    Disabled (the default) this costs one module-level bool check per
    span enter/exit and nothing else; enabled, one small lock-guarded
    dict write. The registry stamps times with ITS OWN clock — the
    monitor installs its clock here on start — so stall deadlines and
    active-span ages share one time base regardless of which clock each
    individual tracer was built with (streaming's run tracer keeps its
    default ``perf_counter`` clock even under a ``FakeClock`` test)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.enabled = False
        self.clock = _PerfClock()
        self.seq = 0
        self.active: Dict[int, Dict[str, Any]] = {}
        self.recent: collections.deque = collections.deque(
            maxlen=FLIGHT_RING_SPANS)

    def span_opened(self, handle: "_SpanHandle") -> None:
        t = threading.current_thread()
        with self.lock:
            self.seq += 1
            self.active[id(handle)] = {
                "name": handle.name, "cat": handle.cat,
                "thread": t.name, "tid": t.ident or 0,
                "t0": self.clock.monotonic(),
                "args": {k: v for k, v in handle.args.items()
                         if isinstance(v, (str, int, float, bool))}}

    def span_closed(self, handle: "_SpanHandle", dur: float) -> None:
        with self.lock:
            self.seq += 1
            info = self.active.pop(id(handle), None)
            if info is not None:
                self.recent.append({**info, "dur": dur})

    def snapshot(self) -> Tuple[int, List[Dict[str, Any]],
                                List[Dict[str, Any]]]:
        """``(seq, active spans oldest-first with age_s, recent ring)``
        — one consistent view for a heartbeat/flight-record dump."""
        with self.lock:
            now = self.clock.monotonic()
            active = sorted(
                ({**info, "age_s": now - info["t0"]}
                 for info in self.active.values()),
                key=lambda i: i["t0"])
            return self.seq, active, list(self.recent)

    def reset(self, enabled: bool = False, clock=None) -> None:
        """Install/clear activity tracking (the monitor's start/stop)."""
        with self.lock:
            self.enabled = enabled
            if clock is not None:
                self.clock = clock
            self.seq = 0
            self.active.clear()
            self.recent.clear()


#: The one process-global activity registry.
ACTIVITY = _Activity()


class Span:
    """One completed span: ``[ts, ts + dur)`` seconds on thread ``tid``
    (clock-relative timestamps; the Chrome export rebases to the run's
    earliest span)."""

    __slots__ = ("name", "cat", "ts", "dur", "tid", "thread", "args")

    def __init__(self, name: str, cat: str, ts: float, dur: float,
                 tid: int, thread: str, args: Dict[str, Any]):
        self.name = name
        self.cat = cat
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.thread = thread
        self.args = args

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "cat": self.cat, "ts": self.ts,
                "dur": self.dur, "tid": self.tid, "thread": self.thread,
                "args": dict(self.args)}


class RunLedger:
    """Process-global sink for spans, counters, and events
    (thread-safe). One ledger per process; ``pipelinedp_tpu_torch.obs``
    owns the singleton and ``reset()`` starts a fresh run."""

    def __init__(self, clock=None):
        self._lock = threading.Lock()
        self._clock = clock if clock is not None else _PerfClock()
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.events: List[Dict[str, Any]] = []
        self.series: Dict[str, List[Tuple[float, float]]] = {}
        self.dropped_spans = 0
        self.dropped_events = 0
        self.dropped_samples = 0

    def add_span(self, span: Span) -> None:
        with self._lock:
            if len(self.spans) < MAX_SPANS:
                self.spans.append(span)
            else:
                self.dropped_spans += 1

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            total = self.counters.get(name, 0) + int(n)
            self.counters[name] = total
            # Progress counters double as a time series under tracing:
            # the Chrome export turns the cumulative samples into a
            # rows/s counter track (``ph: "C"``).
            if name in SAMPLED_COUNTERS and trace_enabled():
                self._sample_locked(name, float(total))

    def gauge(self, name: str, value: int) -> None:
        """Set a counter to an instantaneous value (live HBM bytes)."""
        with self._lock:
            self.counters[name] = int(value)

    def gauge_max(self, name: str, value: int) -> None:
        """Raise a counter to ``value`` if larger (watermarks)."""
        with self._lock:
            self.counters[name] = max(self.counters.get(name, 0),
                                      int(value))

    def sample(self, name: str, value: float) -> None:
        """Append one (ts, value) sample to the named series (bounded;
        drops counted). Feeds the Chrome-trace counter tracks."""
        with self._lock:
            self._sample_locked(name, float(value))

    def _sample_locked(self, name: str, value: float) -> None:
        track = self.series.setdefault(name, [])
        if len(track) < MAX_SAMPLES:
            track.append((self._clock.monotonic(), value))
        else:
            self.dropped_samples += 1

    def event(self, name: str, **attrs) -> None:
        # A bound request context marks the event as part of that
        # request's causal chain (events record always; the stamp is
        # one ContextVar read when no context is bound).
        trace_context.stamp_event_attrs(attrs)
        with self._lock:
            if len(self.events) < MAX_EVENTS:
                self.events.append({"name": name,
                                    "ts": self._clock.monotonic(),
                                    **attrs})
            else:
                self.dropped_events += 1

    def snapshot(self) -> Dict[str, Any]:
        """Consistent copy of the ledger state (safe to serialize while
        worker threads keep emitting)."""
        with self._lock:
            return {"spans": list(self.spans),
                    "counters": dict(self.counters),
                    "events": [dict(e) for e in self.events],
                    "series": {k: list(v)
                               for k, v in self.series.items()},
                    "dropped_spans": self.dropped_spans,
                    "dropped_events": self.dropped_events,
                    "dropped_samples": self.dropped_samples}

    def tail_snapshot(self, n_events: int = 64
                      ) -> Tuple[Dict[str, int], List[Dict[str, Any]]]:
        """Counters + the last ``n_events`` events, WITHOUT copying the
        span list — the monitor polls this every heartbeat beat, and a
        traced run can hold 200k spans."""
        with self._lock:
            return (dict(self.counters),
                    [dict(e) for e in self.events[-n_events:]])

    def reset(self) -> None:
        with self._lock:
            self.spans = []
            self.counters = {}
            self.events = []
            self.series = {}
            self.dropped_spans = 0
            self.dropped_events = 0
            self.dropped_samples = 0


class _SpanHandle:
    """Context manager for one span. ``duration`` holds the measured
    seconds after exit (bench helpers read it directly, replacing their
    two-``perf_counter`` idiom)."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "duration",
                 "_ctx_token", "_range", "_nvtx")

    def __init__(self, tracer: "Tracer", name: str, cat: str,
                 args: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self.duration = 0.0
        self._ctx_token = None
        self._range = None
        self._nvtx = None

    def __enter__(self) -> "_SpanHandle":
        self._range = _open_range(self.name)
        if self._tracer._ledger is not None:
            self._nvtx = _nvtx()
            if self._nvtx is not None:
                self._nvtx.range_push(RANGE_PREFIX + self.name)
        self._t0 = self._tracer._clock.monotonic()
        sid = self.args.get("span_id")
        if sid is not None:
            # A context-stamped span is the parent of everything in its
            # dynamic extent — /trace/<id> rebuilds the tree from this.
            self._ctx_token = trace_context.child_of(sid)
        if ACTIVITY.enabled:
            ACTIVITY.span_opened(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = self._tracer._clock.monotonic()
        self.duration = t1 - self._t0
        if self._ctx_token is not None:
            trace_context.pop(self._ctx_token)
            self._ctx_token = None
        if ACTIVITY.enabled:
            ACTIVITY.span_closed(self, self.duration)
        self._tracer._finish(self, self._t0, self.duration)
        if self._nvtx is not None:
            self._nvtx.range_pop()
            self._nvtx = None
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False


class Tracer:
    """Thread-safe span tracer.

    Always accumulates per-name busy totals (``total(name)``) — the
    derived view the bench timing fields are built from, bit-identical
    in semantics to the former ad-hoc accumulators. When constructed
    with a ``ledger`` (i.e. ``PIPELINEDP_TPU_TRACE`` is set), every
    completed span is also appended there with its thread identity for
    the Chrome-trace export.
    """

    def __init__(self, clock=None, ledger: Optional[RunLedger] = None):
        self._clock = clock if clock is not None else _PerfClock()
        self._ledger = ledger
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    @property
    def recording(self) -> bool:
        return self._ledger is not None

    def span(self, name: str, cat: str = "run", **args) -> _SpanHandle:
        if self._ledger is not None:
            # Recording tracer only: spans that land in the ledger carry
            # the bound request context (trace_id / span_id / parentage)
            # so a multi-tenant run stays causally separable. Measuring
            # tracers skip the stamp — the zero-overhead-off discipline.
            trace_context.stamp_span_args(args)
        return _SpanHandle(self, name, cat, args)

    def _finish(self, handle: _SpanHandle, t0: float, dur: float) -> None:
        with self._lock:
            self._totals[handle.name] = (
                self._totals.get(handle.name, 0.0) + dur)
            self._counts[handle.name] = self._counts.get(handle.name,
                                                         0) + 1
        if self._ledger is not None:
            t = threading.current_thread()
            self._ledger.add_span(Span(handle.name, handle.cat, t0, dur,
                                       t.ident or 0, t.name,
                                       handle.args))

    def total(self, name: str) -> float:
        """Accumulated busy seconds across completed spans of ``name``."""
        with self._lock:
            return self._totals.get(name, 0.0)

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def totals(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._totals)


class _NoopSpan:
    """The shared do-nothing span context (one instance per process)."""

    __slots__ = ()
    duration = 0.0

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


#: The one no-op span handle — ``NoopTracer.span`` returns THIS object,
#: never a fresh one.
NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Zero-overhead disabled tracer: emits nothing, allocates nothing,
    adds no attributes anywhere. ``total`` is honestly 0.0 — call sites
    that need real totals with tracing off use ``obs.run_tracer()``."""

    __slots__ = ()
    recording = False

    def span(self, name: str, cat: str = "run", **args) -> _NoopSpan:
        return NOOP_SPAN

    def total(self, name: str) -> float:
        return 0.0

    def count(self, name: str) -> int:
        return 0

    def totals(self) -> Dict[str, float]:
        return {}


#: The one no-op tracer instance.
NOOP_TRACER = NoopTracer()


class _RangeSpan:
    """A span that is only its profiler range (see ``RangeTracer``)."""

    __slots__ = ("name", "_range")
    duration = 0.0

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self) -> "_RangeSpan":
        self._range = _open_range(self.name)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._range is not None:
            self._range.__exit__(exc_type, exc, tb)
            self._range = None
        return False


class RangeTracer(NoopTracer):
    """The tracer ``obs.tracer()`` hands out while ``torch.profiler``
    records and span recording is off: each span opens its ``pdp.`` range
    and nothing else — no totals, nothing in the ledger, no run report."""

    __slots__ = ()

    def span(self, name: str, cat: str = "run", **args) -> _RangeSpan:
        return _RangeSpan(name)


#: The one range-only tracer instance.
RANGE_TRACER = RangeTracer()
