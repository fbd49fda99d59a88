"""Durable cross-run ledger store: append-only JSONL of run reports.

The run report makes one run self-describing; this store makes that
knowledge **outlive the process** — the substrate the self-tuning
planner ("fit from accumulated run reports, persisted next to the
compile cache") and the long-lived DP service's per-request audit
records both build on.

One entry per line::

    {"schema_version": 2, "name": "<record name>",
     "fingerprint": "<16-hex env hash>", "degraded": false,
     "ts": <unix seconds>, "payload": {...}}

* **Location** — ``PIPELINEDP_TPU_LEDGER_DIR`` names the directory;
  unset, it defaults to a ``pdp_run_ledger`` sibling of the persistent
  compile cache (``PIPELINEDP_TPU_COMPILE_CACHE``) so the two durable
  artifacts live together. With neither set, callers may pass their own
  default (bench uses ``./.pdp_ledger``); library code appends nothing.
* **Durability** — every append is one line written under a lock and
  fsync'd before returning; a crash can lose at most the in-flight
  line, never a previously acknowledged one.
* **Torn-line tolerance** — the reader skips unparseable lines (the
  truncated trailing line a crash mid-write leaves) and counts them in
  ``skipped_lines``; the appender re-establishes line-start first, so a
  store with a torn tail keeps accepting records.
* **Fingerprint keying** — entries key on a hash of the STABLE
  environment-fingerprint fields (versions, device kind/count, git SHA
  incl. ``-dirty``, mesh shape) — NOT the volatile flag set, so a
  traced and an untraced run on the same build compare against each
  other.
* **Baseline discipline** — ``last_known_good`` NEVER returns a
  ``degraded: true`` entry: a run that fell back from a wedged device
  can neither become a baseline nor mask one.

Readers tolerate schema v1 entries (pre-``privacy``-section reports):
``schema_version``/``degraded`` default to 1/False when absent.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from pipelinedp_tpu_torch.obs.report import SCHEMA_VERSION

ENV_VAR = "PIPELINEDP_TPU_LEDGER_DIR"
LEDGER_FILENAME = "run_ledger.jsonl"

#: Environment-fingerprint fields that define "the same setup" across
#: runs. Deliberately excludes ``flags`` (PIPELINEDP_TPU_TRACE etc. must
#: not split baselines) and ``degraded`` (tracked per entry instead).
FINGERPRINT_FIELDS = ("torch_version", "cuda_version", "platform",
                      "device_kind", "device_count", "power_limit",
                      "process_count", "git_sha", "mesh_shape")


def ledger_dir(default: Optional[str] = None) -> Optional[str]:
    """Resolve the store directory: ``PIPELINEDP_TPU_LEDGER_DIR``, else
    a ``pdp_run_ledger`` sibling of the compile cache, else
    ``default`` (None: no store — library code then appends nothing)."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    cache = os.environ.get("PIPELINEDP_TPU_COMPILE_CACHE")
    if cache:
        return os.path.join(os.path.dirname(os.path.abspath(cache)),
                            "pdp_run_ledger")
    return default


def fingerprint_key(env: Optional[Dict[str, Any]]) -> str:
    """16-hex digest of the stable fingerprint fields of ``env`` (an
    ``obs.environment_fingerprint()`` dict)."""
    env = env or {}
    basis = {k: env.get(k) for k in FINGERPRINT_FIELDS}
    blob = json.dumps(basis, sort_keys=True, default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


class LedgerStore:
    """Append-only JSONL store over one ``run_ledger.jsonl`` file.

    Thread-safe within a process (one lock per store instance; share
    the instance across threads). Cross-process appends rely on
    O_APPEND single-write lines; the tolerant reader absorbs the rare
    torn line either way."""

    def __init__(self, directory: str):
        self.directory = directory
        self.path = os.path.join(directory, LEDGER_FILENAME)
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        #: Unparseable lines seen by the last ``entries()`` read.
        self.skipped_lines = 0

    # --- writing ---

    def append(self, name: str, payload: Dict[str, Any],
               env: Optional[Dict[str, Any]] = None,
               degraded: Optional[bool] = None,
               run_id: Optional[str] = None) -> Dict[str, Any]:
        """Append one entry; fsync before returning. ``env`` is the
        environment fingerprint the entry keys on (falls back to a
        ``payload["env"]`` if present); ``degraded`` defaults to the
        fingerprint's flag. ``run_id`` groups entries emitted by one
        process run (bench re-samples a metric within a run; baseline
        queries use the grouping to apply per-run best-sample rules)."""
        if env is None and isinstance(payload, dict):
            env = payload.get("env")
        env = env or {}
        entry = {
            "schema_version": SCHEMA_VERSION,
            "name": name,
            "fingerprint": fingerprint_key(env),
            "degraded": (bool(env.get("degraded")) if degraded is None
                         else bool(degraded)),
            "ts": time.time(),
            "payload": payload,
        }
        if run_id is not None:
            entry["run_id"] = run_id
        line = (json.dumps(entry, default=repr) + "\n").encode("utf-8")
        with self._lock:
            with open(self.path, "ab") as f:
                if f.tell() > 0 and not self._ends_with_newline():
                    # A torn trailing line from a crashed writer: start a
                    # fresh line so THIS record stays parseable (the torn
                    # one is skipped by the tolerant reader).
                    f.write(b"\n")
                f.write(line)
                f.flush()
                # lint: disable=blocking-under-lock(the fsync IS the append lock's durability contract)
                os.fsync(f.fileno())
        return entry

    def _ends_with_newline(self) -> bool:
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                return f.read(1) == b"\n"
        except OSError:
            return True

    # --- reading ---

    def entries(self) -> List[Dict[str, Any]]:
        """All parseable entries in append order. Skips (and counts)
        torn/corrupt lines instead of failing the read — a crashed
        writer must not take the whole history down."""
        return self.read_from(0)[0]

    def read_from(self, offset: int = 0
                  ) -> Tuple[List[Dict[str, Any]], int]:
        """(entries, end_offset) for the ledger bytes past ``offset``
        — the incremental read behind run-windowed fitting: a caller
        that remembers ``end_offset`` re-reads only what was appended
        since, so consuming a growing service ledger stays linear
        instead of quadratic."""
        out: List[Dict[str, Any]] = []
        skipped = 0
        try:
            with open(self.path, "rb") as f:
                f.seek(int(offset))
                data = f.read()
                end = f.tell()
        except OSError:
            self.skipped_lines = 0
            return out, int(offset)
        if data and not data.endswith(b"\n"):
            # An unterminated tail is an entry still being written (or
            # a crashed writer's torn line the next append repairs with
            # a leading newline): do NOT consume it — advancing the
            # cursor past a half-written line would split one entry
            # across two reads and drop it forever. Leave it for the
            # next read; the writer's completion (or repair) makes it
            # parseable-or-skippable then.
            cut = data.rfind(b"\n") + 1
            end = int(offset) + cut
            data = data[:cut]
        for raw in data.split(b"\n"):
            if not raw.strip():
                continue
            try:
                entry = json.loads(raw.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                skipped += 1
                continue
            if not isinstance(entry, dict):
                skipped += 1
                continue
            # v1 tolerance: absent fields read as their v1 meaning.
            entry.setdefault("schema_version", 1)
            entry.setdefault("degraded", False)
            out.append(entry)
        self.skipped_lines = skipped
        return out, end

    @staticmethod
    def _matches(entry: Dict[str, Any], name: str,
                 fingerprint: Optional[str]) -> bool:
        return entry.get("name") == name and (
            fingerprint is None or entry.get("fingerprint") == fingerprint)

    def latest(self, name: str, fingerprint: Optional[str] = None,
               entries: Optional[List[Dict[str, Any]]] = None
               ) -> Optional[Dict[str, Any]]:
        """Most recent entry for (name, fingerprint) — degraded or not
        (pass a pre-read ``entries`` snapshot to pin the view)."""
        pool = self.entries() if entries is None else entries
        for entry in reversed(pool):
            if self._matches(entry, name, fingerprint):
                return entry
        return None

    def last_known_good(self, name: str,
                        fingerprint: Optional[str] = None,
                        entries: Optional[List[Dict[str, Any]]] = None
                        ) -> Optional[Dict[str, Any]]:
        """Most recent NON-degraded entry for (name, fingerprint): the
        wedged-run-masquerade guard — a ``degraded: true`` capture is
        never a baseline."""
        pool = self.entries() if entries is None else entries
        for entry in reversed(pool):
            if self._matches(entry, name, fingerprint) and (
                    not entry.get("degraded")):
                return entry
        return None

    def last_known_good_map(self, fingerprint: Optional[str] = None
                            ) -> Dict[str, Dict[str, Any]]:
        """{record name -> last-known-good entry} for a fingerprint."""
        out: Dict[str, Dict[str, Any]] = {}
        for entry in self.entries():
            if fingerprint is not None and (
                    entry.get("fingerprint") != fingerprint):
                continue
            if not entry.get("degraded"):
                out[entry.get("name")] = entry
        return out


#: Process-lifetime caches behind :func:`maybe_append_run_report`: one
#: store handle per directory and one environment probe per mesh shape,
#: so the per-request hook never pays makedirs/device-probe on the
#: release hot path.
_proc_stores: Dict[str, LedgerStore] = {}
_env_cache: Dict[Any, Dict[str, Any]] = {}
#: Delta cursors for per-request appends, KEYED BY RESOLVED DIRECTORY:
#: audit-registry lengths and the event count already persisted to
#: each store, so entry k carries ONLY what request k added — never a
#: cumulative duplicate of entries 1..k-1 (O(N^2) ledger growth
#: otherwise). Per-directory, not per-process: a resident multi-tenant
#: service appends to one ledger directory per tenant, and a single
#: process-wide cursor would let tenant A's append swallow the records
#: tenant B's next entry still needs.
_report_cursors: Dict[str, Dict[str, Any]] = {}
#: One lock per resolved directory serializing the cursor's
#: read-delta-append-advance cycle: concurrent producers (the serve
#: workers) racing a lock-free cursor would persist the same records
#: twice — exactly the duplication the cursor exists to prevent.
_report_locks: Dict[str, threading.Lock] = {}
_report_locks_guard = threading.Lock()


def _cursor_for(directory: str) -> Dict[str, Any]:
    key = os.path.abspath(directory)
    cur = _report_cursors.get(key)
    if cur is None:
        cur = {"audit": None, "events": 0, "trace_spans": 0}
        _report_cursors[key] = cur
    return cur


def _report_lock_for(directory: str) -> threading.Lock:
    key = os.path.abspath(directory)
    with _report_locks_guard:
        lock = _report_locks.get(key)
        if lock is None:
            lock = threading.Lock()
            _report_locks[key] = lock
        return lock


def reset_run_report_cursor() -> None:
    """Forget the per-directory delta cursors and the cached
    environment probe (``obs.reset()`` calls this: a fresh ledger/audit
    registry restarts the deltas from zero, and a run boundary may
    change the flag set the fingerprint records)."""
    _report_cursors.clear()
    _env_cache.clear()


def _mesh_env_key(mesh) -> Any:
    if mesh is None:
        return None
    try:
        return tuple(zip(mesh.axis_names, mesh.devices.shape))
    except Exception:
        return ("unknown_mesh",)


def entries_since_run_id(entries: List[Dict[str, Any]],
                         run_id: str) -> List[Dict[str, Any]]:
    """The suffix of ``entries`` starting at the FIRST entry tagged
    with ``run_id`` — the ``--since-run-id`` window. The autotune
    fitter uses it (and :meth:`LedgerStore.read_from`) to fit from
    post-sweep entries instead of the whole history: a long-lived
    service ledger grows linearly, and fitting must not go quadratic.
    An unknown run id windows to nothing (an honest empty answer
    beats silently fitting the full ledger)."""
    for i, e in enumerate(entries):
        if e.get("run_id") == run_id:
            return entries[i:]
    return []


# --- ledger analytics (``python -m pipelinedp_tpu_torch.obs.store``) ---


def trace_chain_from_entries(entries: List[Dict[str, Any]],
                             trace_id: str) -> Dict[str, Any]:
    """One request's causal span tree rebuilt from PERSISTED ledger
    entries: every run-report ``trace_spans`` span and every stamped
    event across ``entries`` is pooled, then handed to
    ``report.build_trace_tree`` — the CLI twin of the live
    ``/trace/<id>`` endpoint (obs/http.py), reading the durable store
    instead of the in-process ledger."""
    from pipelinedp_tpu_torch.obs.report import build_trace_tree
    spans: List[Dict[str, Any]] = []
    events: List[Dict[str, Any]] = []
    for e in entries:
        payload = e.get("payload") or {}
        rr = payload.get("run_report")
        if isinstance(rr, dict):
            for s in rr.get("trace_spans") or []:
                if isinstance(s, dict):
                    spans.append(s)
            for ev in rr.get("events") or []:
                if isinstance(ev, dict) and ev.get("trace_id"):
                    events.append(ev)
        # Serve books entries stamp trace_id inside their ``serve``
        # payload — surface each as a synthetic event so the chain
        # shows its durable books commit even when the run report's
        # delta landed in a different store.
        serve_books = payload.get("serve")
        if (isinstance(serve_books, dict)
                and serve_books.get("trace_id") == trace_id):
            events.append({"name": f"books.{e.get('name')}",
                           "ts": e.get("ts", 0.0),
                           "trace_id": trace_id,
                           "tenant": serve_books.get("tenant"),
                           "request_id": serve_books.get("request_id")})
    return build_trace_tree(trace_id, spans, events)


def _trend(samples: List[float]) -> Optional[float]:
    """Latest sample vs the mean of the PRIOR samples, as a signed
    fractional delta (+0.2 = latest costs 20% more than history).
    None until there are two samples."""
    if len(samples) < 2:
        return None
    prior = samples[:-1]
    mean = sum(prior) / len(prior)
    if mean <= 0:
        return None
    return samples[-1] / mean - 1.0


def summarize_entries(entries: List[Dict[str, Any]]
                      ) -> Dict[str, Dict[str, Any]]:
    """Aggregate accumulated ledger entries into per-(fingerprint,
    phase) cost tables with trend deltas — the raw material the future
    autotune planner consumes (ROADMAP: "fit from accumulated run
    reports"). Two tables per fingerprint:

    * ``phases`` — from every ``run_report`` entry's span summary:
      per span name, how many reports carried it, summed/mean/latest
      busy seconds, and ``trend`` (latest vs the mean of prior
      reports — the regression direction at a glance);
    * ``metrics`` — from every rate-carrying bench record
      (``payload.record.value`` with a ``.../s`` unit): samples,
      best/latest value, and the same trend delta (positive = faster);
    * ``programs`` — from every schema-v3 report's ``device_costs``
      section: per (program, abstract-shape signature), compile-wall
      samples with trend, the latest flops/bytes/intensity/roofline
      verdict and cache verdict — the cost/roofline columns the
      planner fits against (v1/v2 entries simply contribute no rows
      here).
    """
    out: Dict[str, Dict[str, Any]] = {}
    for e in entries:
        fp = e.get("fingerprint")
        agg = out.setdefault(fp, {"runs": 0, "degraded_runs": 0,
                                  "phases": {}, "metrics": {},
                                  "programs": {}})
        payload = e.get("payload") or {}
        rr = payload.get("run_report")
        if isinstance(rr, dict) and rr.get("spans"):
            agg["runs"] += 1
            if e.get("degraded"):
                agg["degraded_runs"] += 1
            for name, sp in rr["spans"].items():
                total = sp.get("total_s")
                if not isinstance(total, (int, float)):
                    continue
                agg["phases"].setdefault(name, []).append(float(total))
        if isinstance(rr, dict):
            dc = rr.get("device_costs")
            for prog in ((dc or {}).get("programs") or {}).values():
                if not isinstance(prog, dict) or "program" not in prog:
                    continue
                row = agg["programs"].setdefault(_program_row_key(prog), {
                    "compile_samples": [], "latest": None})
                if isinstance(prog.get("compile_s"), (int, float)):
                    row["compile_samples"].append(
                        float(prog["compile_s"]))
                row["latest"] = prog
        rec = payload.get("record")
        if isinstance(rec, dict):
            value = rec.get("value")
            unit = rec.get("unit") or ""
            if isinstance(value, (int, float)) and unit.endswith("/s"):
                agg["metrics"].setdefault(
                    e.get("name"), []).append(float(value))
    for agg in out.values():
        agg["phases"] = {
            name: {"reports": len(samples),
                   "total_s": round(sum(samples), 6),
                   "mean_s": round(sum(samples) / len(samples), 6),
                   "latest_s": round(samples[-1], 6),
                   "trend": (None if _trend(samples) is None
                             else round(_trend(samples), 4))}
            for name, samples in agg["phases"].items()}
        agg["metrics"] = {
            name: {"samples": len(samples),
                   "best": round(max(samples), 3),
                   "latest": round(samples[-1], 3),
                   "trend": (None if _trend(samples) is None
                             else round(_trend(samples), 4))}
            for name, samples in agg["metrics"].items()}
        agg["programs"] = {
            name: _program_columns(row)
            for name, row in agg["programs"].items()}
    return out


def _program_row_key(prog: Dict[str, Any]) -> str:
    """Stable per-(program, abstract-shape signature) aggregation key.
    The report's own table keys are process-hash-seeded (never match
    across runs), and the bare function name would conflate every
    shape signature of one kernel into a single compile-trend series —
    so rows re-key off the signature CONTENT."""
    sig = prog.get("signature")
    if not sig:
        return str(prog["program"])
    digest = hashlib.sha1(str(sig).encode("utf-8")).hexdigest()[:8]
    return f"{prog['program']}@{digest}"


def _program_columns(row: Dict[str, Any]) -> Dict[str, Any]:
    """One program's cost/roofline columns from its accumulated
    ``device_costs`` entries (the latest entry carries the analysis;
    compile wall keeps the full sample list for the trend)."""
    samples = row["compile_samples"]
    latest = row["latest"] or {}
    return {
        "samples": len(samples),
        "compile_s_mean": (round(sum(samples) / len(samples), 6)
                           if samples else None),
        "compile_s_latest": (round(samples[-1], 6) if samples
                             else None),
        "compile_trend": (None if _trend(samples) is None
                          else round(_trend(samples), 4)),
        "compile_cache": latest.get("compile_cache"),
        "phase": latest.get("phase"),
        "flops": latest.get("flops"),
        "bytes_accessed": latest.get("bytes_accessed"),
        "intensity": latest.get("intensity"),
        "verdict": latest.get("verdict"),
        "hbm_peak_bytes": (latest.get("memory") or {}).get("peak_bytes"),
        # The port's measured time: summed over the latest report's calls.
        "ms": latest.get("ms"),
        "calls": latest.get("calls"),
    }


def _fmt_trend(trend: Optional[float]) -> str:
    return "n/a" if trend is None else f"{trend:+.0%}"


#: The flat CSV schema ``--csv`` emits: one row per (fingerprint, kind,
#: name) where kind is phase / metric / program; columns that don't
#: apply to a kind stay empty. One parse-free table for spreadsheets
#: and planner fitting.
CSV_COLUMNS = ("fingerprint", "kind", "name", "samples", "total_s",
               "mean_s", "latest_s", "best", "latest", "trend",
               "compile_s_mean", "compile_s_latest", "compile_cache",
               "phase", "flops", "bytes_accessed", "intensity",
               "verdict", "hbm_peak_bytes")


def _csv_rows(summary: Dict[str, Dict[str, Any]]
              ) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    for fp, agg in summary.items():
        for name, ph in sorted(agg["phases"].items()):
            rows.append({"fingerprint": fp, "kind": "phase",
                         "name": name, "samples": ph["reports"],
                         "total_s": ph["total_s"],
                         "mean_s": ph["mean_s"],
                         "latest_s": ph["latest_s"],
                         "trend": ph["trend"]})
        for name, m in sorted(agg["metrics"].items()):
            rows.append({"fingerprint": fp, "kind": "metric",
                         "name": name, "samples": m["samples"],
                         "best": m["best"], "latest": m["latest"],
                         "trend": m["trend"]})
        for name, pr in sorted(agg["programs"].items()):
            rows.append({"fingerprint": fp, "kind": "program",
                         "name": name, "samples": pr["samples"],
                         "trend": pr["compile_trend"],
                         **{k: pr[k] for k in
                            ("compile_s_mean", "compile_s_latest",
                             "compile_cache", "phase", "flops",
                             "bytes_accessed", "intensity", "verdict",
                             "hbm_peak_bytes")}})
    return rows


def write_csv(summary: Dict[str, Dict[str, Any]], out) -> None:
    """Write the flat ``--csv`` table for a summary to a text stream."""
    import csv
    writer = csv.DictWriter(out, fieldnames=CSV_COLUMNS,
                            restval="", extrasaction="ignore")
    writer.writeheader()
    for row in _csv_rows(summary):
        writer.writerow({k: ("" if v is None else v)
                         for k, v in row.items()})


def fsck(directory: str, repair: bool = True) -> Dict[str, Any]:
    """Crash-consistency check over a ledger tree: every ``*.jsonl``
    run ledger and ``*.json`` budget/heartbeat document under
    ``directory``, recursively.

    The contract mirrors what the readers already tolerate:

    * an UNTERMINATED ``.jsonl`` tail (a writer died mid-line) is
      repaired by appending the line terminator — exactly the repair
      the next :meth:`LedgerStore.append` would make; the tail then
      parses as a record or joins the skipped-line count;
    * interior corrupt ``.jsonl`` lines are REPORTED, never rewritten
      — the tolerant reader skips and counts them, and rewriting
      history is not fsck's call;
    * leftover ``*.tmp`` files from a crashed atomic writer are
      removed (no reader ever opens them);
    * a corrupt ``*.json`` document is DAMAGE: :func:`atomic_write_json`
      can never produce one, readers raise on it (for a budget ledger,
      silently starting fresh would forget spent budget), so fsck
      reports it and leaves it byte-for-byte intact.

    Returns a summary dict; ``summary["clean"]`` is True when nothing
    unrepairable remains.
    """
    repaired: List[Dict[str, Any]] = []
    tolerated: List[Dict[str, Any]] = []
    damaged: List[Dict[str, Any]] = []
    files_scanned = 0
    for root, _dirs, names in sorted(os.walk(directory)):
        for fname in sorted(names):
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, directory)
            if fname.endswith(".tmp"):
                files_scanned += 1
                if repair:
                    try:
                        os.unlink(path)
                        repaired.append({"path": rel,
                                         "action": "removed orphan "
                                         "temp file"})
                    except OSError as exc:
                        damaged.append({"path": rel,
                                        "problem": f"orphan temp file "
                                        f"not removable: {exc}"})
                else:
                    tolerated.append({"path": rel,
                                      "problem": "orphan temp file"})
                continue
            if fname.endswith(".jsonl"):
                files_scanned += 1
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError as exc:
                    damaged.append({"path": rel,
                                    "problem": f"unreadable: {exc}"})
                    continue
                if data and not data.endswith(b"\n"):
                    if repair:
                        with open(path, "ab") as f:
                            f.write(b"\n")
                            f.flush()
                            os.fsync(f.fileno())
                        data += b"\n"
                        repaired.append({"path": rel,
                                         "action": "terminated torn "
                                         "trailing line"})
                    else:
                        tolerated.append({"path": rel,
                                          "problem": "unterminated "
                                          "trailing line"})
                corrupt = 0
                entries = 0
                for raw in data.split(b"\n"):
                    if not raw.strip():
                        continue
                    try:
                        entry = json.loads(raw.decode("utf-8"))
                    except (ValueError, UnicodeDecodeError):
                        corrupt += 1
                        continue
                    if isinstance(entry, dict):
                        entries += 1
                    else:
                        corrupt += 1
                if corrupt:
                    tolerated.append({"path": rel,
                                      "problem": f"{corrupt} corrupt "
                                      "line(s) the tolerant reader "
                                      "skips; left intact",
                                      "entries": entries})
                continue
            if fname.endswith(".json"):
                files_scanned += 1
                try:
                    with open(path, encoding="utf-8") as f:
                        json.loads(f.read())
                except (OSError, ValueError, UnicodeDecodeError) as exc:
                    damaged.append({"path": rel,
                                    "problem": "corrupt document "
                                    "(atomic_write_json can never "
                                    f"produce this): {exc}"})
    return {"directory": directory,
            "files_scanned": files_scanned,
            "repaired": repaired,
            "tolerated": tolerated,
            "damaged": damaged,
            "clean": not damaged}


def _print_fsck(summary: Dict[str, Any]) -> None:
    print(f"fsck: {summary['directory']} "
          f"({summary['files_scanned']} file(s) scanned)")
    for rec in summary["repaired"]:
        print(f"  repaired   {rec['path']}: {rec['action']}")
    for rec in summary["tolerated"]:
        print(f"  tolerated  {rec['path']}: {rec['problem']}")
    for rec in summary["damaged"]:
        print(f"  DAMAGED    {rec['path']}: {rec['problem']}")
    print("clean" if summary["clean"] else
          "damage found: corrupt documents left byte-for-byte intact "
          "— repair needs an operator decision")


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m pipelinedp_tpu_torch.obs.store --summarize [--dir D]
    [--fingerprint FP] [--json | --csv]`` — print per-(fingerprint,
    phase/metric/program) cost tables with trend deltas and roofline
    columns from the accumulated run ledger."""
    import argparse
    import sys
    parser = argparse.ArgumentParser(
        prog="python -m pipelinedp_tpu_torch.obs.store",
        description="Ledger analytics over the durable run-ledger "
                    "store (run reports + bench records).")
    parser.add_argument("--summarize", action="store_true",
                        help="aggregate run reports into per-"
                        "(fingerprint, phase) cost tables with trends")
    parser.add_argument("--dir", default=None,
                        help="ledger directory (default: "
                        "PIPELINEDP_TPU_LEDGER_DIR resolution, else "
                        "./.pdp_ledger)")
    parser.add_argument("--fingerprint", default=None,
                        help="restrict to one environment fingerprint")
    parser.add_argument("--trace-id", default=None, dest="trace_id",
                        help="with --summarize: print ONE request's "
                        "causal span tree (admission through books "
                        "commit) rebuilt from persisted trace_spans — "
                        "the CLI twin of the /trace/<id> endpoint")
    parser.add_argument("--since-run-id", default=None,
                        dest="since_run_id",
                        help="window to entries at/after the first "
                        "one tagged with this run id (the autotune "
                        "fitter's post-sweep window)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable output (the autotune "
                        "planner's input shape)")
    parser.add_argument("--csv", action="store_true", dest="as_csv",
                        help="flat CSV table (phases, metrics, program "
                        "cost/roofline columns) for spreadsheets")
    parser.add_argument("--fsck", action="store_true",
                        help="crash-consistency check over the ledger "
                        "tree: repair torn .jsonl tails and orphan "
                        ".tmp files, report (never rewrite) corrupt "
                        "lines and documents; rc 2 when unrepairable "
                        "damage remains")
    parser.add_argument("--no-repair", action="store_true",
                        dest="no_repair",
                        help="with --fsck: report only, change nothing")
    args = parser.parse_args(argv)
    if not (args.summarize or args.fsck):
        parser.error("nothing to do: pass --summarize or --fsck")
    if args.as_json and args.as_csv:
        parser.error("--json and --csv are mutually exclusive")
    directory = args.dir or ledger_dir(
        default=os.path.join(os.getcwd(), ".pdp_ledger"))
    if args.fsck:
        summary = fsck(directory, repair=not args.no_repair)
        if args.as_json:
            print(json.dumps(summary))
        else:
            _print_fsck(summary)
        return 0 if summary["clean"] else 2
    s = LedgerStore(directory)
    entries = s.entries()
    if args.since_run_id:
        entries = entries_since_run_id(entries, args.since_run_id)
    if args.fingerprint:
        entries = [e for e in entries
                   if e.get("fingerprint") == args.fingerprint]
    if args.trace_id:
        if args.as_csv:
            parser.error("--trace-id has no CSV shape; use --json")
        tree = trace_chain_from_entries(entries, args.trace_id)
        if args.as_json:
            print(json.dumps({"ledger": s.path,
                              "entries": len(entries), "trace": tree}))
            return 0 if tree["span_count"] else 3
        from pipelinedp_tpu_torch.obs.report import format_trace_tree
        print(f"ledger: {s.path} ({len(entries)} entries)")
        print(format_trace_tree(tree))
        if not tree["span_count"]:
            print(f"no spans recorded for trace {args.trace_id} "
                  "(was PIPELINEDP_TPU_TRACE set during the run?)")
            return 3
        return 0
    summary = summarize_entries(entries)
    if args.as_json:
        print(json.dumps({"ledger": s.path, "entries": len(entries),
                          "skipped_lines": s.skipped_lines,
                          "fingerprints": summary}))
        return 0
    if args.as_csv:
        write_csv(summary, sys.stdout)
        return 0
    print(f"ledger: {s.path} ({len(entries)} entries, "
          f"{s.skipped_lines} skipped lines)")
    for fp, agg in summary.items():
        print(f"\nfingerprint {fp} — {agg['runs']} run report(s), "
              f"{agg['degraded_runs']} degraded")
        if agg["phases"]:
            print(f"  {'phase':<28} {'reports':>7} {'total_s':>10} "
                  f"{'mean_s':>10} {'latest_s':>10} {'trend':>7}")
            ordered = sorted(agg["phases"].items(),
                             key=lambda kv: -kv[1]["total_s"])
            for name, ph in ordered:
                print(f"  {name:<28} {ph['reports']:>7} "
                      f"{ph['total_s']:>10.3f} {ph['mean_s']:>10.3f} "
                      f"{ph['latest_s']:>10.3f} "
                      f"{_fmt_trend(ph['trend']):>7}")
        if agg["metrics"]:
            print(f"  {'metric':<44} {'samples':>7} {'best':>12} "
                  f"{'latest':>12} {'trend':>7}")
            for name, m in sorted(agg["metrics"].items()):
                print(f"  {name:<44} {m['samples']:>7} {m['best']:>12.1f}"
                      f" {m['latest']:>12.1f} "
                      f"{_fmt_trend(m['trend']):>7}")
        if agg["programs"]:
            print(f"  {'program':<28} {'phase':<8} {'compile_s':>10} "
                  f"{'cache':>8} {'gflops':>9} {'GB':>8} "
                  f"{'flop/B':>7} {'verdict':<15}")
            for name, pr in sorted(agg["programs"].items()):
                gflops = ("n/a" if pr["flops"] is None
                          else f"{pr['flops'] / 1e9:.3f}")
                gbytes = ("n/a" if pr["bytes_accessed"] is None
                          else f"{pr['bytes_accessed'] / 1e9:.3f}")
                inten = ("n/a" if pr["intensity"] is None
                         else f"{pr['intensity']:.2f}")
                print(f"  {name:<28} {(pr['phase'] or '?'):<8} "
                      f"{(pr['compile_s_latest'] or 0):>10.3f} "
                      f"{(pr['compile_cache'] or 'n/a'):>8} "
                      f"{gflops:>9} {gbytes:>8} {inten:>7} "
                      f"{(pr['verdict'] or 'unknown'):<15}")
    return 0


def maybe_append_run_report(name: str,
                            default_dir: Optional[str] = None,
                            extra: Optional[Dict[str, Any]] = None,
                            mesh=None,
                            directory: Optional[str] = None
                            ) -> Optional[Dict[str, Any]]:
    """Append this request's run-report DELTA as entry ``name`` — the
    traced-engine-run hook. The entry keeps the run-report shape but
    its ``privacy`` lists and ``events`` carry only records new since
    this process's previous append TO THE SAME DIRECTORY (cumulative
    counters/span rollups stay whole: they are fixed-size). A request
    that added nothing appends nothing. ``mesh`` keys the entry's
    fingerprint on the mesh shape actually used. ``directory`` pins
    the store outright, for embedders that must not let the env var
    reroute entries (the serve layer's per-tenant books use their own
    ``LedgerStore`` appends; engine-run reports during a serve request
    still land in the process's obs ledger via the default
    resolution); without it the usual ``ledger_dir`` applies. No-op
    (returns None) when no ledger directory resolves, and swallows
    every failure: the store must never take an aggregation down."""
    try:
        directory = directory or ledger_dir(default=default_dir)
        if not directory:
            return None
        from pipelinedp_tpu_torch import obs
        mesh_key = _mesh_env_key(mesh)
        env = _env_cache.get(mesh_key)
        if env is None:
            env = obs.environment_fingerprint(mesh=mesh)
            _env_cache[mesh_key] = env
        report = obs.build_run_report(mesh=mesh, env=env)
        # The cursor's read -> delta -> append -> advance cycle is
        # atomic per directory: two concurrent producers on one store
        # must not both carry the same not-yet-persisted records.
        with _report_lock_for(directory):
            cursor = _cursor_for(directory)
            audit_since = dict(cursor["audit"] or {})
            report["privacy"] = obs.audit.build_privacy_section(
                counters=report.get("counters", {}), since=audit_since)
            events = report.get("events", [])
            ev_start = min(int(cursor["events"]), len(events))
            report["events"] = events[ev_start:]
            # v6 trace_spans ride the same delta discipline: entry k
            # carries only the context-stamped spans recorded since the
            # previous append to this directory.
            trace_spans = report.pop("trace_spans", [])
            ts_start = min(int(cursor.get("trace_spans", 0)),
                           len(trace_spans))
            if trace_spans[ts_start:]:
                report["trace_spans"] = trace_spans[ts_start:]
            priv = report["privacy"]
            if not (priv["accountants"] or priv["aggregations"] or
                    priv["expected_errors"] or report["events"] or
                    report.get("trace_spans")):
                return None
            if extra:
                report.update(extra)
            store = _proc_stores.get(directory)
            if store is None:
                # lint: disable=blocking-under-lock(one-store-per-directory creation serialized with the report cursor)
                store = LedgerStore(directory)
                _proc_stores[directory] = store
            entry = store.append(name, {"run_report": report, "env": env},
                                 env=env)
            # Advance by exactly what this entry carried — concurrent
            # producers building mid-append land in the next entry.
            cursor["audit"] = {
                "accountants": audit_since.get("accountants", 0) +
                len(priv["accountants"]),
                "aggregations": audit_since.get("aggregations", 0) +
                len(priv["aggregations"]),
                "expected_errors": audit_since.get("expected_errors", 0) +
                len(priv["expected_errors"]),
            }
            # max(): a producer whose snapshot predates a concurrent
            # append must never move the cursor BACKWARDS — that would
            # re-persist events a later entry already carried.
            cursor["events"] = max(int(cursor["events"]), len(events))
            cursor["trace_spans"] = max(
                int(cursor.get("trace_spans", 0)), len(trace_spans))
        return entry
    except Exception:
        return None


if __name__ == "__main__":
    raise SystemExit(main())
