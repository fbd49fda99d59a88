"""The plan resolver: plan file IO + per-request knob resolution.

The decide half of the measure→decide loop. A **plan file** is one
atomically-replaced JSON document (``pdp_plan/plan.json`` in
``PIPELINEDP_TPU_PLAN_DIR``, or beside ``PIPELINEDP_TPU_COMPILE_CACHE``
where a deployment shares that variable with the JAX package;
``0``/``off`` disables loading entirely), keyed by the SAME
stable environment-fingerprint hash the run ledger uses. It carries,
per shape-signature bucket, the knob vector a tuning run measured best
(:func:`build_plan` over the trials of :func:`autotune_candidates`),
plus the fitted :class:`~pipelinedp_tpu_torch.plan.model.CostModel` for
predicted-vs-observed accounting.

Resolution (:func:`resolve`) runs once per streamed request: every
registered knob resolves through the registry precedence (env >
seam > plan > default — ``plan.knobs``), emits a ``plan.applied``
event carrying the chosen value, its source and the model's predicted
seconds, and lands in a process-global applied-state the run report
exports as its schema-v4 ``plan`` section. A plan file written under
a DIFFERENT fingerprint is ignored with a ``plan.stale`` event — a
plan tuned on one device kind (or one git SHA) never steers another.

DP-bit-identity: the resolver can only apply ``dp_safe`` knobs (the
registry refuses the rest), every one of which selects among
bit-parity-tested execution paths — planner on vs off is asserted
bit-identical as PARITY row 32.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, Optional

from pipelinedp_tpu_torch.plan import knobs as knobs_mod
from pipelinedp_tpu_torch.plan import model as model_mod

ENV_DIR = "PIPELINEDP_TPU_PLAN_DIR"
PLAN_FILENAME = "plan.json"
PLAN_SCHEMA = 1

#: Process-default plan directory (:func:`set_default_dir`); None =
#: library runs resolve no plan file unless the environment names one.
_default_dir: Optional[str] = None

_lock = threading.Lock()
#: Cached parse of the current plan file: {path, mtime, size, plan}.
_file_cache: Dict[str, Any] = {}
#: Cached stable fingerprint hash (one device/git probe per process).
_fp_cache: Optional[str] = None
#: The applied-state the run report's ``plan`` section exports:
#: set by :func:`resolve`, cleared by :func:`reset` (obs.reset).
_applied: Dict[str, Any] = {}
#: Last stale-plan observation already reported — load_plan runs on
#: EVERY knob read, and re-emitting per read would flood the bounded
#: obs event ring with plan.stale spam.
_stale_seen: Optional[tuple] = None
#: (plan dict ref, constructed CostModel) — the plan object is cached
#: by load_plan, so identity pins the deserialized model to the same
#: file observation instead of rebuilding it every request.
_model_cache: Optional[tuple] = None


def set_default_dir(directory: Optional[str]) -> None:
    """Process fallback for the plan directory (a driver that keeps its
    plans under ``./.pdp_plan`` calls this; tests use the env var)."""
    global _default_dir
    _default_dir = directory


def plan_dir(default: Optional[str] = None) -> Optional[str]:
    """Resolve the plan directory: ``PIPELINEDP_TPU_PLAN_DIR`` (the
    values ``0``/``off``/``none`` disable plan loading), else a
    ``pdp_plan`` sibling of ``PIPELINEDP_TPU_COMPILE_CACHE``, else
    ``default`` / the process default. None = no plan file in force."""
    path = os.environ.get(ENV_DIR)
    if path:
        if path.lower() in ("0", "off", "none", "false"):
            return None
        return path
    cache = os.environ.get("PIPELINEDP_TPU_COMPILE_CACHE")
    if cache:
        return os.path.join(os.path.dirname(os.path.abspath(cache)),
                            "pdp_plan")
    return default if default is not None else _default_dir


def plan_path(directory: Optional[str] = None) -> Optional[str]:
    d = plan_dir() if directory is None else directory
    return os.path.join(d, PLAN_FILENAME) if d else None


def plan_hash(plan: Dict[str, Any]) -> str:
    """12-hex digest of the plan's execution-relevant content — the
    knob tables ONLY, not the write timestamp or the fitted model
    blob. A re-tune that lands on the same knob vector keeps the same
    identity, so two runs' records compare as the same plan after the
    file is rewritten."""
    blob = json.dumps(plan.get("knobs") or {}, sort_keys=True,
                      default=repr)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def fingerprint() -> str:
    """The stable environment-fingerprint hash plans key on — the SAME
    16-hex key the run-ledger store uses (mesh-less: a plan steers the
    process, the mesh shape is a per-request detail)."""
    global _fp_cache
    if _fp_cache is None:
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.obs import store as obs_store
        _fp_cache = obs_store.fingerprint_key(
            obs.environment_fingerprint())
    return _fp_cache


def write_plan(plan: Dict[str, Any],
               directory: Optional[str] = None) -> str:
    """Atomically persist ``plan`` (tmp file + ``os.replace`` — a
    reader never sees a torn plan; fsync'd like the ledger store).
    Returns the path written."""
    d = plan_dir() if directory is None else directory
    if not d:
        raise ValueError("no plan directory resolves "
                         f"(set {ENV_DIR} or pass directory=)")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, PLAN_FILENAME)
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(plan, f, indent=1, sort_keys=True, default=repr)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    with _lock:
        _file_cache.clear()
    return path


def build_plan(best_by_bucket: Dict[str, Dict[str, Any]],
               model: model_mod.CostModel,
               device_kind: Optional[str],
               created_by: str = "autotune",
               trials: int = 0) -> Dict[str, Any]:
    """Assemble a plan document from the autotune decision
    (:func:`model.choose_best_trial`) + the fitted model. Only
    dp-safe knobs land in the knob tables — the registry would refuse
    the rest at resolve time anyway, but a plan file should never
    even carry a value it must not apply."""
    safe = {name for name, spec in knobs_mod.BY_NAME.items()
            if spec.dp_safe}
    knob_tables: Dict[str, Dict[str, Any]] = {}
    default_vec: Optional[Dict[str, Any]] = None
    for bucket, row in sorted(best_by_bucket.items()):
        vec = {k: v for k, v in row["knobs"].items() if k in safe}
        knob_tables[bucket] = vec
        default_vec = vec if default_vec is None else default_vec
    if default_vec is not None:
        # The fallback bucket: requests at un-swept shapes get the
        # first swept bucket's vector rather than nothing (every value
        # is dp-safe, so the worst case is a performance miss).
        knob_tables.setdefault("default", default_vec)
    return {
        "schema_version": PLAN_SCHEMA,
        "fingerprint": fingerprint(),
        "device_kind": device_kind,
        "created_by": created_by,
        "ts": time.time(),
        "trials": trials,
        "knobs": knob_tables,
        "model": model.to_dict(),
    }


def load_plan(directory: Optional[str] = None,
              expect_fingerprint: Optional[str] = None
              ) -> Optional[Dict[str, Any]]:
    """The current plan file, parsed and fingerprint-checked, or None
    (no directory, no file, unreadable, or stale). A fingerprint
    mismatch emits ONE ``plan.stale`` event per observation — the run
    report then shows exactly why no plan steered the run."""
    path = plan_path(directory)
    if path is None:
        return None
    try:
        st = os.stat(path)
    except OSError:
        return None
    key = (path, st.st_mtime_ns, st.st_size)
    with _lock:
        cached = _file_cache.get("entry")
        if cached is not None and cached[0] == key:
            plan = cached[1]
        else:
            try:
                with open(path, "r", encoding="utf-8") as f:
                    plan = json.load(f)
            except (OSError, ValueError):
                plan = None
            if not isinstance(plan, dict):
                plan = None
            _file_cache["entry"] = (key, plan)
    if plan is None:
        return None
    fp = fingerprint() if expect_fingerprint is None else (
        expect_fingerprint)
    if plan.get("fingerprint") != fp:
        global _stale_seen
        stale_key = (path, st.st_mtime_ns, plan.get("fingerprint"), fp)
        with _lock:
            already = _stale_seen == stale_key
            _stale_seen = stale_key
        if not already:
            from pipelinedp_tpu_torch import obs
            obs.inc("plan.stale")
            obs.event("plan.stale", path=path,
                      plan_fingerprint=plan.get("fingerprint"),
                      env_fingerprint=fp)
        return None
    return plan


def _plan_model(plan: Dict[str, Any]) -> model_mod.CostModel:
    """The plan's fitted cost model, deserialized once per file
    observation (keyed on the cached plan object's identity)."""
    global _model_cache
    with _lock:
        cached = _model_cache
    if cached is not None and cached[0] is plan:
        return cached[1]
    m = model_mod.CostModel.from_dict(plan.get("model") or {})
    with _lock:
        _model_cache = (plan, m)
    return m


def _knobs_from(plan: Dict[str, Any],
                shape: Optional[Dict[str, int]]
                ) -> Optional[Dict[str, Any]]:
    """The ONE bucket-then-default knob-table lookup — both the
    request resolver and the mid-request :func:`knobs.value` path go
    through it, so a change to the fallback policy cannot make them
    diverge on which vector they apply."""
    tables = plan.get("knobs") or {}
    if shape:
        bucket = model_mod.bucket_key(shape.get("rows", 0),
                                      shape.get("partitions", 1),
                                      shape.get("quantiles", 0))
        if bucket in tables:
            return tables[bucket]
    return tables.get("default")


def current_plan_knobs(shape: Optional[Dict[str, int]] = None
                       ) -> Optional[Dict[str, Any]]:
    """The knob dict the current plan file offers for ``shape`` (bucket
    lookup, then the ``default`` bucket), or None when no valid plan
    is in force — the layer :func:`knobs.value` consults."""
    plan = load_plan()
    if plan is None:
        return None
    return _knobs_from(plan, shape)


def current_cost_model() -> Optional[model_mod.CostModel]:
    """The current plan file's fitted :class:`model_mod.CostModel`, or
    None when no valid plan is in force — the layer performance
    consumers (the megasweep's HBM-aware chunk sizing) query for
    measured-peak predictions. A plan whose history was poisoned
    (degraded runs, foreign fingerprints) fits an EMPTY model whose
    predictions are all None, so consumers degrade to their static
    formulas, never to a bad fit."""
    plan = load_plan()
    if plan is None:
        return None
    return _plan_model(plan)


class Resolved:
    """One request's resolved knob vector: ``values[name]`` and
    ``sources[name]`` (env / seam / plan / default), plus the plan
    file's identity when one was in force."""

    def __init__(self, resolutions: Dict[str, Any],
                 plan_hash_: Optional[str],
                 predicted: Optional[Dict[str, Any]]):
        self.values = {k: v for k, (v, _) in resolutions.items()}
        self.sources = {k: s for k, (_, s) in resolutions.items()}
        self.plan_hash = plan_hash_
        self.predicted = predicted

    @property
    def plan_source(self) -> str:
        """The record-level provenance label: ``autotuned`` when any
        knob came from a plan file, ``env-override`` when any knob was
        explicitly overridden (env or test seam), else ``default``."""
        sources = set(self.sources.values())
        if "plan" in sources:
            return "autotuned"
        if "env" in sources or "seam" in sources:
            return "env-override"
        return "default"


def resolve(shape: Optional[Dict[str, int]] = None, mesh=None,
            emit: bool = True) -> Resolved:
    """Resolve the full knob vector for one request and (with
    ``emit``) record it: one ``plan.applied`` event per knob (value,
    source, predicted seconds where the model has one) and the
    process applied-state behind the run report's ``plan`` section.
    ``shape`` is {rows, partitions, quantiles}; ``mesh`` is accepted
    for signature symmetry (plans key on the mesh-less fingerprint)."""
    del mesh  # plans are per-process; the mesh is a request detail
    plan = load_plan()
    plan_knobs = _knobs_from(plan, shape) if plan is not None else None
    resolutions = knobs_mod.resolve_all(plan_knobs)
    predicted = None
    if plan is not None and shape:
        m = _plan_model(plan)
        dk = plan.get("device_kind")
        preds = {}
        for phase in ("pass_a", "pass_b", "walk", "sweep"):
            p = m.predict_seconds(dk, phase, shape.get("rows", 0),
                                  shape.get("partitions", 1),
                                  shape.get("quantiles", 0))
            if p is not None:
                preds[phase] = round(p, 6)
        hbm = m.predict_hbm_peak(dk, "pass_b", shape.get("rows", 0),
                                 shape.get("partitions", 1),
                                 shape.get("quantiles", 0))
        if preds or hbm:
            predicted = {"seconds": preds or None,
                         "hbm_peak_bytes": hbm}
    out = Resolved(resolutions, plan_hash(plan) if plan else None,
                   predicted)
    if emit:
        from pipelinedp_tpu_torch import obs
        total_pred = None
        if predicted and predicted.get("seconds"):
            total_pred = round(sum(predicted["seconds"].values()), 6)
        for name, (value, source) in sorted(resolutions.items()):
            # request_predicted_s is the REQUEST-total prediction (the
            # same value on every knob's event), not a per-knob share —
            # summing it across a request's plan.applied events would
            # overcount.
            obs.event("plan.applied", knob=name,
                      value=(int(value) if isinstance(value, bool)
                             else value),
                      source=source,
                      request_predicted_s=total_pred)
        obs.inc("plan.resolutions")
        with _lock:
            _applied["knobs"] = {
                name: {"value": (int(v) if isinstance(v, bool) else v),
                       "source": s}
                for name, (v, s) in sorted(resolutions.items())}
            _applied["plan_hash"] = out.plan_hash
            _applied["plan_file"] = plan_path() if plan else None
            _applied["source"] = out.plan_source
            if shape:
                _applied["shape"] = dict(shape)
            if predicted:
                _applied["predicted"] = predicted
    return out


def last_resolved_shape() -> Optional[Dict[str, int]]:
    """The request shape of the most recent :func:`resolve` this run
    (None before any request resolved). Shape-blind knob reads deeper
    in the stack — the walk's subhist-cap lookup as it plans its blocks —
    use it so they bucket against the SAME plan vector the request
    resolved, not whichever vector the ``default`` bucket carries."""
    with _lock:
        shape = _applied.get("shape")
        return dict(shape) if shape else None


def note_observed(name: str, seconds: float) -> None:
    """Record an observed phase wall (streaming calls this after the
    run) so the report's ``plan`` section shows predicted vs observed
    side by side."""
    with _lock:
        if _applied:
            _applied.setdefault("observed", {})[name] = round(
                float(seconds), 6)


def source_summary() -> Dict[str, Any]:
    """{plan_source, plan_hash} for run records: the applied-state
    when a request resolved this run, else a quiet resolution of the
    current file/env state (no events, no applied-state)."""
    with _lock:
        if _applied:
            return {"plan_source": _applied.get("source", "default"),
                    "plan_hash": _applied.get("plan_hash")}
    r = resolve(emit=False)
    return {"plan_source": r.plan_source, "plan_hash": r.plan_hash}


def snapshot() -> Optional[Dict[str, Any]]:
    """The run report's ``plan`` section (schema v4), or None when no
    request resolved knobs this run (the section is then absent —
    the v1–v3-compatible reading)."""
    with _lock:
        return dict(_applied) if _applied else None


def reset() -> None:
    """Clear the applied-state and caches (run boundaries; tests).
    ``obs.reset()`` calls this alongside the audit/cost resets."""
    global _fp_cache, _stale_seen, _model_cache
    with _lock:
        _applied.clear()
        _file_cache.clear()
        _stale_seen = None
        _model_cache = None
    knobs_mod._dp_unsafe_seen.clear()
    _fp_cache = None


def autotune_candidates() -> list:
    """The bounded one-factor-at-a-time sweep a tuning run measures: the
    default vector plus single-knob deviations of every dp-safe knob.
    Small by design — each candidate is one full streamed run; the
    ledger accumulates across invocations, so depth comes from
    history, not from one sweep."""
    base = {name: spec.default
            for name, spec in knobs_mod.BY_NAME.items() if spec.dp_safe}
    cands = [dict(base)]
    for deviation in (
            {"ingest_executor": False},
            {"stream_cache_bytes": 0},
            {"q_chunk": 1},
            {"subhist_byte_cap": 64 << 20},
            # Sweep config-batch widths: dp-safe (every width is
            # bit-identical per config, PARITY row 41); only the
            # utility-analysis sweep reads them, so a trial that runs
            # no sweep measures the default's no-op.
            {"sweep_config_batch": 64},
            {"sweep_config_batch": 256},
            # The hierarchical exchange: dp-safe (hier and flat are
            # bit-identical, PARITY row 43). On a single-host trial the
            # topology layer degrades to flat, so this measures a no-op.
            {"mesh_topology": "hier"},
            # The sketch binner's scatter reference: dp-safe (PARITY
            # row 36) so it sweeps with the rest; a trial that runs no
            # sketch-first request measures the default's no-op. Kept
            # LAST: the sketch suite pins this position.
            {"sketch_backend": "xla"},
    ):
        vec = dict(base)
        vec.update(deviation)
        cands.append(vec)
    return cands
