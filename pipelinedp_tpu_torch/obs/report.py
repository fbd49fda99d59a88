"""Exporters: the self-describing run report and the Chrome-trace file.

The run report is the answer to "what actually executed": a
schema-versioned JSON object carrying an environment fingerprint
(torch/CUDA versions, device kind and count, the card's power limit,
mesh shape, git SHA, every active ``PIPELINEDP_TPU_*`` flag, the ``degraded``
flag), the counters and events the run emitted (retries, checkpoint
saves/resumes, cache hits, which fallback path fired), and a per-name
span summary. A benchmark merges it into its output record so the record
explains itself.

The Chrome-trace export writes the full span list as trace-event JSON
(``ph: "X"`` complete events, microsecond ``ts``/``dur``, one ``tid``
lane per thread; ledger events ride along as ``ph: "i"`` instants) —
load it at https://ui.perfetto.dev to see the stager / dispatch / fold
lanes overlap batch by batch.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

from pipelinedp_tpu_torch.obs import audit as _audit
from pipelinedp_tpu_torch.obs import costs as _costs

#: Version of the run-report layout. Bump on any breaking change to the
#: top-level keys; readers refuse (or warn on) unknown majors.
#: v2 (run-ledger PR): adds the structured ``privacy`` audit section;
#: v1 reports differ only by its absence, so readers treat v1 as
#: "privacy unknown", never as an error.
#: v3 (device-cost PR): adds the ``device_costs`` section (per-program
#: compile wall/cache verdict, flops/bytes, memory stats, per-phase
#: roofline verdicts — ``obs.costs``); absent in v1/v2 reports, which
#: readers treat as "device costs not captured".
#: v4 (execution-planner PR): adds the ``plan`` section (the resolved
#: knob vector with per-knob source env/seam/plan/default, the plan
#: file hash, predicted vs observed seconds — ``pipelinedp_tpu_torch.plan``);
#: absent in v1–v3 reports AND in v4 runs that resolved no knobs,
#: which readers treat as "default knobs, no plan in force".
#: v5 (sketch-first PR): adds the ``sketch`` section (per sketch-first
#: phase-1 run: width/depth/cap/backend, selection budget + threshold,
#: bucket pre/post and candidate counts — ``obs.audit.record_sketch``);
#: absent in v1–v4 reports AND in v5 runs with no sketch phase, which
#: readers treat as "no sketch-first request ran".
#: v6 (causal-tracing PR): adds the ``trace_spans`` section — the raw
#: span dicts of every span stamped with a request trace context
#: (``obs.trace_context``), the material ``store --summarize
#: --trace-id`` rebuilds a request's causal chain from; absent in
#: v1–v5 reports AND in v6 runs with no context-stamped spans, which
#: readers treat as "no request-scoped tracing captured".
SCHEMA_VERSION = 6

_git_probe_cache: Optional[Tuple[str, bool]] = None


def _git_sha() -> Optional[str]:
    """Best-effort git SHA of the source tree this process imported,
    with ``-dirty`` appended when ``git status --porcelain`` is
    non-empty — an env fingerprint must never alias uncommitted code to
    a committed SHA. Both probes run once and cache together (None
    outside a work tree or without git)."""
    global _git_probe_cache
    if _git_probe_cache is None:
        sha, dirty = "", False
        here = os.path.dirname(os.path.abspath(__file__))
        try:
            out = subprocess.run(
                ["git", "rev-parse", "HEAD"], cwd=here, timeout=10,
                capture_output=True, text=True)
            sha = out.stdout.strip() if out.returncode == 0 else ""
        except Exception:
            sha = ""
        if sha:
            # An unreadable/failed status is NOT clean evidence: keep
            # the resolved SHA but flag dirty unless status says clean
            # — discarding the SHA here would silently re-key the
            # ledger fingerprint and orphan every baseline.
            try:
                st = subprocess.run(
                    ["git", "status", "--porcelain"], cwd=here,
                    timeout=10, capture_output=True, text=True)
                dirty = (st.returncode != 0) or bool(st.stdout.strip())
            except Exception:
                dirty = True
        _git_probe_cache = (sha, dirty)
    sha, dirty = _git_probe_cache
    if not sha:
        return None
    return sha + ("-dirty" if dirty else "")


def _power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it (``"700.00
    W"``), or None where ``nvidia-smi`` does not answer. A card set below
    its maximum runs slower under load, so runs under different caps are
    different setups. Probed once per process."""
    global _power_limit_cache
    if _power_limit_cache is None:
        try:
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader"], timeout=10,
                capture_output=True, text=True)
            lines = out.stdout.strip().splitlines()
            _power_limit_cache = (lines[0].strip() if out.returncode == 0
                                  and lines else "")
        except (OSError, subprocess.SubprocessError):
            _power_limit_cache = ""
    return _power_limit_cache or None


_power_limit_cache: Optional[str] = None


def environment_fingerprint(mesh=None) -> Dict[str, Any]:
    """What this process is running on — attached to every run report
    (traced or not) so the artifact is attributable: the torch and CUDA
    versions, the device name, count and platform, the card's power
    limit where ``nvidia-smi`` answers, the process count, an optional
    mesh shape, the git SHA, the active ``PIPELINEDP_TPU_*`` env flags
    and the ``degraded`` flag. It holds no jax field, so a port run's
    fingerprint never equals a JAX run's. Never raises: a wedged runtime
    reports ``device_error`` instead of killing the run that is trying
    to describe it."""
    fp: Dict[str, Any] = {}
    try:
        import torch
        fp["torch_version"] = torch.__version__
        fp["cuda_version"] = torch.version.cuda
        if torch.cuda.is_available():
            fp["platform"] = "gpu"
            fp["device_kind"] = torch.cuda.get_device_name(0)
            fp["device_count"] = torch.cuda.device_count()
            fp["power_limit"] = _power_limit()
        else:
            fp["platform"] = "cpu"
            fp["device_kind"] = "cpu"
            fp["device_count"] = 1
        fp["process_count"] = (torch.distributed.get_world_size()
                               if torch.distributed.is_available()
                               and torch.distributed.is_initialized()
                               else 1)
    except Exception as e:  # a fingerprint must never take the run down
        fp["device_error"] = f"{type(e).__name__}: {e}"
    if mesh is not None:
        try:
            fp["mesh_shape"] = {str(name): int(size) for name, size in
                                zip(mesh.axis_names, mesh.devices.shape)}
        except Exception:
            fp["mesh_shape"] = None
    fp["git_sha"] = _git_sha()
    fp["flags"] = {k: os.environ[k] for k in sorted(os.environ)
                   if k.startswith("PIPELINEDP_TPU_")}
    fp["degraded"] = bool(os.environ.get("PIPELINEDP_TPU_DEGRADED"))
    return fp


def span_summary(spans) -> Dict[str, Dict[str, Any]]:
    """Per-name rollup of a span list: count / total / max seconds.
    The full per-span detail lives in the Chrome trace; the report
    stays record-sized no matter how many batches streamed."""
    out: Dict[str, Dict[str, Any]] = {}
    for s in spans:
        agg = out.setdefault(s.name, {"cat": s.cat, "count": 0,
                                      "total_s": 0.0, "max_s": 0.0})
        agg["count"] += 1
        agg["total_s"] += s.dur
        agg["max_s"] = max(agg["max_s"], s.dur)
    for agg in out.values():
        agg["total_s"] = round(agg["total_s"], 6)
        agg["max_s"] = round(agg["max_s"], 6)
    return out


def build_run_report(snapshot: Dict[str, Any], mesh=None,
                     extra: Optional[Dict[str, Any]] = None,
                     env: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Assemble the self-describing run report from a
    ``RunLedger.snapshot()``. Pass a precomputed ``env`` fingerprint to
    skip the device/git re-probe (bench computes it once per run)."""
    report = {
        "schema_version": SCHEMA_VERSION,
        "env": env if env is not None else
               environment_fingerprint(mesh=mesh),
        "counters": dict(snapshot.get("counters", {})),
        "events": list(snapshot.get("events", [])),
        "spans": span_summary(snapshot.get("spans", [])),
        # v2: the structured privacy/utility audit — per-mechanism
        # eps/delta splits and noise stddevs, aggregation shapes,
        # selection pre/post counts, expected errors (obs.audit).
        "privacy": _audit.build_privacy_section(
            counters=snapshot.get("counters", {})),
        "dropped": {"spans": snapshot.get("dropped_spans", 0),
                    "events": snapshot.get("dropped_events", 0),
                    "samples": snapshot.get("dropped_samples", 0)},
    }
    # v5: the sketch-first phase-1 records — included whenever a
    # sketch ran this run (absent = no sketch, the v1–v4-compatible
    # reading).
    sketch_runs = _audit.build_sketch_section()
    if sketch_runs:
        report["sketch"] = {"runs": sketch_runs}
    # v3: the device-cost observatory — included whenever programs were
    # captured (absent = not captured, the v1/v2-compatible reading).
    device_costs = _costs.TABLE.snapshot()
    if device_costs["programs"]:
        report["device_costs"] = device_costs
    # v4: the execution planner's resolved knob vector — included
    # whenever a request resolved knobs this run (absent = default
    # knobs / no plan, the v1–v3-compatible reading). Lazy import:
    # ``plan`` imports obs, so a module-level import here would cycle.
    try:
        from pipelinedp_tpu_torch import plan as _plan
        plan_section = _plan.snapshot()
    except Exception:
        plan_section = None
    if plan_section:
        report["plan"] = plan_section
    # v6: raw span dicts for every span a request trace context stamped
    # (absent = no request-scoped tracing, the v1–v5-compatible
    # reading). The ``spans`` section above is a per-NAME summary;
    # rebuilding one request's causal chain (``store --summarize
    # --trace-id``, ``/trace/<id>``) needs the per-SPAN detail — but
    # only for the stamped subset, so an untraced run adds nothing.
    trace_spans = [s.to_dict() for s in snapshot.get("spans", [])
                   if "trace_id" in s.args]
    if trace_spans:
        report["trace_spans"] = trace_spans
    if extra:
        report.update(extra)
    return report


def thread_name_map(snapshot: Dict[str, Any]) -> Dict[int, str]:
    """tid → stable thread name, from BOTH the recorded spans and the
    live ``pdp-*`` worker threads (a worker that staged batches but
    never completed a span — e.g. one wedged mid-fetch — must still
    label its Perfetto lane and its flight-record stack)."""
    names: Dict[int, str] = {}
    for s in snapshot.get("spans", []):
        names.setdefault(s.tid, s.thread)
    for t in threading.enumerate():
        if t.name.startswith("pdp-") and t.ident is not None:
            names.setdefault(t.ident, t.name)
    return names


#: Series rendered as RATE counter tracks: the stored samples are a
#: cumulative counter, so the track value is the per-interval delta
#: over elapsed time (rows/s), not the raw running total.
_RATE_TRACKS = {"progress.rows_staged": "rows/s"}


def _counter_track_events(series: Dict[str, Any], t0: float,
                          pid: int) -> List[Dict[str, Any]]:
    """``ph: "C"`` counter events from the sampled ledger series —
    Perfetto draws them as a value timeline under the span lanes.
    Cumulative progress counters differentiate into rates; everything
    else (live-HBM bytes) plots raw."""
    out: List[Dict[str, Any]] = []
    for name, samples in sorted(series.items()):
        rate_name = _RATE_TRACKS.get(name)
        prev: Optional[Tuple[float, float]] = None
        for ts, value in samples:
            if rate_name is not None:
                if prev is None or ts <= prev[0]:
                    prev = (ts, value)
                    continue
                track, v = rate_name, (value - prev[1]) / (ts - prev[0])
                prev = (ts, value)
            else:
                track, v = name, value
            out.append({"ph": "C", "name": track, "pid": pid, "tid": 0,
                        "ts": (ts - t0) * 1e6,
                        "args": {"value": round(v, 1)}})
    return out


def chrome_trace_events(snapshot: Dict[str, Any],
                        threads: Optional[Dict[int, str]] = None
                        ) -> List[Dict[str, Any]]:
    """Convert a ledger snapshot to Chrome trace-event dicts. Spans
    become ``ph: "X"`` complete events; ledger events become ``ph: "i"``
    instants; sampled series become ``ph: "C"`` counter tracks.
    Timestamps rebase to the earliest record (µs)."""
    spans = snapshot.get("spans", [])
    events = snapshot.get("events", [])
    series = snapshot.get("series", {})
    pid = os.getpid()
    t0 = min([s.ts for s in spans] +
             [e["ts"] for e in events if "ts" in e] +
             [ts for samples in series.values()
              for ts, _ in samples[:1]], default=0.0)
    out: List[Dict[str, Any]] = []
    if threads is None:
        threads = thread_name_map(snapshot)
    for s in spans:
        out.append({"ph": "X", "name": s.name, "cat": s.cat,
                    "pid": pid, "tid": s.tid,
                    "ts": (s.ts - t0) * 1e6, "dur": s.dur * 1e6,
                    "args": {k: _jsonable(v) for k, v in s.args.items()}})
    for e in events:
        args = {k: _jsonable(v) for k, v in e.items()
                if k not in ("name", "ts")}
        out.append({"ph": "i", "name": e["name"], "cat": "event",
                    "pid": pid, "tid": 0, "s": "p",
                    "ts": (e.get("ts", t0) - t0) * 1e6, "args": args})
    out.extend(_flow_events(spans, t0, pid))
    out.extend(_counter_track_events(series, t0, pid))
    # Thread-name metadata rows make the Perfetto lanes self-labeling.
    for tid, name in sorted(threads.items()):
        out.append({"ph": "M", "name": "thread_name", "pid": pid,
                    "tid": tid, "args": {"name": name}})
    return out


def _flow_events(spans, t0: float, pid: int) -> List[Dict[str, Any]]:
    """Chrome flow events (``ph: "s"`` / ``ph: "f"``) chaining the
    context-stamped spans of each request across thread lanes, so
    Perfetto draws one connected arc per ``trace_id`` (admission →
    fuse → worker → release tail). For each consecutive pair of a
    request's spans (by start time) the start event fires at the
    earlier span's end on its lane, the finish event (``bp: "e"``:
    bind to the ENCLOSING slice, not the next one) at the later span's
    start on its lane; one deterministic numeric id per trace keeps
    the whole chain a single flow."""
    by_trace: Dict[str, List[Any]] = {}
    for s in spans:
        tid = s.args.get("trace_id")
        if tid is not None:
            by_trace.setdefault(str(tid), []).append(s)
    out: List[Dict[str, Any]] = []
    for trace_id, group in sorted(by_trace.items()):
        if len(group) < 2:
            continue
        group.sort(key=lambda s: (s.ts, s.args.get("span_id", 0)))
        fid = zlib.crc32(trace_id.encode("utf-8")) & 0x7FFFFFFF
        for prev, nxt in zip(group, group[1:]):
            out.append({"ph": "s", "name": "request", "cat": "flow",
                        "id": fid, "pid": pid, "tid": prev.tid,
                        "ts": (prev.ts - t0) * 1e6 + prev.dur * 1e6})
            out.append({"ph": "f", "bp": "e", "name": "request",
                        "cat": "flow", "id": fid, "pid": pid,
                        "tid": nxt.tid, "ts": (nxt.ts - t0) * 1e6})
    return out


def build_trace_tree(trace_id: str, spans: List[Dict[str, Any]],
                     events: Optional[List[Dict[str, Any]]] = None
                     ) -> Dict[str, Any]:
    """Rebuild one request's causal span tree from span/event DICTS
    (``Span.to_dict()`` shape — works on a live snapshot, a persisted
    run report's ``trace_spans`` section, or entries merged across
    both). Spans nest by the ``parent_span`` arg the context stamp
    recorded; events attach to their recorded ``parent_span`` when it
    resolved, otherwise land in the top-level ``events`` list. The
    shared engine behind ``/trace/<id>`` (obs/http.py) and ``store
    --summarize --trace-id``."""
    events = events or []
    sel = [s for s in spans
           if (s.get("args") or {}).get("trace_id") == trace_id]
    sel.sort(key=lambda s: (s.get("ts", 0.0),
                            (s.get("args") or {}).get("span_id", 0)))
    nodes: Dict[int, Dict[str, Any]] = {}
    ordered: List[Dict[str, Any]] = []
    for s in sel:
        node = dict(s)
        node["children"] = []
        node["events"] = []
        ordered.append(node)
        sid = (s.get("args") or {}).get("span_id")
        if sid is not None and sid not in nodes:
            nodes[sid] = node
    roots: List[Dict[str, Any]] = []
    for node in ordered:
        args = node.get("args") or {}
        parent = args.get("parent_span")
        target = nodes.get(parent)
        if target is not None and target is not node:
            target["children"].append(node)
        else:
            roots.append(node)
    loose: List[Dict[str, Any]] = []
    for e in sorted((e for e in events if e.get("trace_id") == trace_id),
                    key=lambda e: e.get("ts", 0.0)):
        target = nodes.get(e.get("parent_span"))
        if target is not None:
            target["events"].append(dict(e))
        else:
            loose.append(dict(e))
    tenant = request_id = None
    for s in sel:
        args = s.get("args") or {}
        tenant = tenant or args.get("tenant")
        request_id = request_id or args.get("request_id")
    return {"trace_id": trace_id, "tenant": tenant,
            "request_id": request_id, "span_count": len(sel),
            "event_count": sum(1 for e in events
                               if e.get("trace_id") == trace_id),
            "roots": roots, "events": loose}


def format_trace_tree(tree: Dict[str, Any]) -> str:
    """Human-readable rendering of :func:`build_trace_tree` output:
    one indented line per span (start offset, duration, thread) with
    attached events inline — what ``store --summarize --trace-id``
    prints."""
    lines = [f"trace {tree['trace_id']}"
             f"  tenant={tree.get('tenant') or '-'}"
             f"  request={tree.get('request_id') or '-'}"
             f"  spans={tree['span_count']}"
             f"  events={tree['event_count']}"]
    all_ts = [s.get("ts", 0.0) for s in _iter_tree_spans(tree["roots"])]
    t0 = min(all_ts) if all_ts else 0.0

    def emit(node: Dict[str, Any], depth: int) -> None:
        pad = "  " * depth
        lines.append(
            f"{pad}+{(node.get('ts', 0.0) - t0) * 1e3:9.3f}ms "
            f"{node.get('name', '?')} "
            f"[{node.get('dur', 0.0) * 1e3:.3f}ms] "
            f"({node.get('thread', '?')})")
        for e in node.get("events", []):
            lines.append(f"{pad}    ! {e.get('name', '?')}")
        for child in node.get("children", []):
            emit(child, depth + 1)

    for root in tree["roots"]:
        emit(root, 1)
    for e in tree["events"]:
        lines.append(f"  ! {e.get('name', '?')} (unparented)")
    return "\n".join(lines)


def _iter_tree_spans(roots: List[Dict[str, Any]]):
    stack = list(roots)
    while stack:
        node = stack.pop()
        yield node
        stack.extend(node.get("children", []))


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return repr(v)


def write_chrome_trace(path: str, snapshot: Dict[str, Any]) -> str:
    """Write the Chrome-trace JSON for ``snapshot``; returns ``path``.
    ``otherData.thread_names`` duplicates the tid→name metadata rows as
    one flat map, so flight-record consumers (and humans grepping the
    file) can label stacks without replaying the event stream."""
    threads = thread_name_map(snapshot)
    payload = {"traceEvents": chrome_trace_events(snapshot, threads),
               "displayTimeUnit": "ms",
               "otherData": {"schema_version": SCHEMA_VERSION,
                             "thread_names": {
                                 str(tid): name for tid, name in
                                 sorted(threads.items())}}}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f)
    return path
