"""The knob registry: every planner-visible tunable, in ONE place.

Port of ``pipelinedp_tpu/plan/knobs.py``, without two of its knobs:
``kernel_backend`` (on the card the port's hand kernels always run, and on
the CPU their plain versions do; a knob that could send the card to the
plain versions would hide the kernels) and ``segsum_wide_d_block`` (a TPU
VMEM tile hint with no counterpart here). A plan file that names either is
handled as any knob this registry does not know: ignored. The mesh's
knob (``mesh_topology``) is read by ``parallel/sharded.py``; the
resident service's (``serve_*``) are read by ``serve/service.py`` and
``serve/fusion.py``.

The stack grew a forest of hand-set execution knobs — HBM byte caps,
stream batch sizing, cache budgets, the ingest-executor switch — each
living as a module constant or an env var at its point of use. This
module is the single registry over them: one :class:`KnobSpec` per
knob recording its unit, hardcoded default, env-override name, module
seam (the test-injectable constant) and whether a plan file may change
it, plus the one resolution function every consumer goes through.

Resolution precedence (most explicit wins)::

    explicit env override  >  test-seam mutation  >  plan file  >  default

* **env** — the knob's ``PIPELINEDP_TPU_*`` variable is set (any
  value, including the default: setting it is the explicit act).
* **seam** — the module constant (``torch_engine._SUBHIST_BYTE_CAP``,
  ``streaming._SELECT_UNITS_CAP``, ...) differs from the registered
  default. Tests and ``chip_smoke.py`` inject caps by mutating these (via
  :func:`seam_override`); a mutated seam must outrank any plan file or
  existing suites would silently run planned values.
* **plan** — the loaded plan file carries the knob AND the knob is
  ``dp_safe``: a plan may only select among execution paths that are
  bit-parity-tested (PARITY row 32). ``stream_chunk_rows`` is NOT
  dp-safe — batch membership decides which rows a unit's bounding
  subsample sees, so replanning it would change DP outputs — and the
  int32 guard caps are refusal thresholds, not performance choices;
  plan values for non-dp-safe knobs are ignored with a
  ``plan.skipped_dp_unsafe`` event.
* **default** — today's hardcoded value, byte-for-byte: cold start
  (empty ledger, no plan file, no env) resolves to exactly the
  pre-planner behavior.

Direct reads of the registered constants outside this package are
banned (the source scan of ``tests/test_torch_plan.py``);
consumers call :func:`value` / ``plan.resolve()`` instead, and the
module-level names survive purely as test seams.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class KnobSpec:
    """One registered execution knob."""
    name: str
    unit: str                       #: human unit ("bytes", "rows", ...)
    default: Any                    #: today's hardcoded default
    env_var: Optional[str]          #: explicit-override env name
    seam: Optional[Tuple[str, str]]  #: (module, attr) test seam
    dp_safe: bool                   #: may a plan file change it?
    kind: type                      #: int, bool or str (enumerated)
    doc: str
    choices: Tuple[str, ...] = ()   #: legal values for str knobs

    def parse(self, raw: Any) -> Any:
        if self.kind is bool:
            if isinstance(raw, str):
                return raw.lower() not in ("0", "false", "off")
            return bool(raw)
        if self.kind is str:
            # Enumerated string knobs (sketch_backend): an unknown
            # value — a typo'd env var, a plan from a future schema —
            # resolves to the default rather than crashing a request
            # over a performance choice.
            v = str(raw).strip().lower()
            return v if v in self.choices else self.default
        return int(raw)


_I32_MAX = int(np.iinfo(np.int32).max)

#: (knob, value) pairs whose plan.skipped_dp_unsafe event already
#: fired — cleared by planner.reset() at run boundaries.
_dp_unsafe_seen: set = set()

#: The registry. Units and defaults are the documentation of record
#: (mirrored in README "Execution planner"); ``seam`` names the
#: module constant kept alive as the test seam.
REGISTRY: Tuple[KnobSpec, ...] = (
    KnobSpec(
        "subhist_byte_cap", "bytes", 600 << 20,
        "PIPELINEDP_TPU_SUBHIST_CAP",
        ("pipelinedp_tpu_torch.torch_engine", "_SUBHIST_BYTE_CAP"), True, int,
        "HBM budget for the walk's [P, Q, span] subtree histogram AND "
        "the pass-B sweep planner's tile-packing budget: above it the "
        "walk partition-block-chunks and pass B tiles the (quantile x "
        "partition) grid. Any tiling is bit-identical to the unchunked "
        "walk (node noise is a pure function of the global (partition, "
        "node id))."),
    KnobSpec(
        "stream_chunk_rows", "rows per device batch", 1 << 26,
        "PIPELINEDP_TPU_STREAM_CHUNK", None, False, int,
        "Rows per streamed device batch (and the engine's streaming "
        "trigger). NOT dp-safe: batch membership decides which rows a "
        "privacy unit's bounding subsample sees, so a plan never "
        "changes it — env override and default only."),
    KnobSpec(
        "stream_cache_bytes", "bytes", 4 << 30,
        "PIPELINEDP_TPU_STREAM_CACHE", None, True, int,
        "Per-device HBM budget for the pass-B prefix cache (0 "
        "disables). device_cache / hybrid / reship are bit-identical "
        "(PARITY row 3), so the plan may trade HBM for link traffic."),
    KnobSpec(
        "ingest_executor", "bool", True,
        "PIPELINEDP_TPU_INGEST_EXECUTOR", None, True, bool,
        "Overlapped staging/compute/fold executor for streamed runs; "
        "off = the serial bit-parity reference path (identical "
        "outputs, PARITY row 11)."),
    KnobSpec(
        "q_chunk", "quantiles per pass-B tile (0 = planner search)", 0,
        "PIPELINEDP_TPU_Q_CHUNK",
        ("pipelinedp_tpu_torch.streaming", "_Q_CHUNK"), True, int,
        "Pins the sweep planner's quantiles-per-tile choice; 0 lets "
        "plan_pass_b_sweeps search the (q_chunk, p_blk) grid. Every "
        "tiling is bit-identical (PARITY row 3); an infeasible pin "
        "falls back to the search."),
    KnobSpec(
        # The unit string is the JAX package's, shared by plan files
        # and ledgers of both packages.
        "sweep_config_batch", "configs per compiled sweep chunk "
        "(0 = widest in-HBM-budget)", 0,
        "PIPELINEDP_TPU_SWEEP_CONFIG_BATCH",
        ("pipelinedp_tpu_torch.analysis.torch_sweep", "_SWEEP_CONFIG_BATCH"),
        True, int,
        "Pins the configuration-axis batch width of the utility-analysis "
        "megasweep (analysis/torch_sweep.py): every sweep chunk runs "
        "this many configs through one pass of the sweep's torch "
        "operators and K5 launches, its bounds / eps-splits / selection "
        "tables / noise kinds held as tensors. 0 lets the sweep pick the "
        "widest chunk inside the device-memory row-broadcast and "
        "selection-window budgets. dp-safe: every batch width is "
        "bit-identical per config (PARITY row 41 — padding-invariant, "
        "walked == batched), so a tuning run may sweep it. Note the "
        "sweep checkpoint fingerprint covers the width: a "
        "resume must run the same batch width it was killed at."),
    KnobSpec(
        "vector_accumulator", "f32 | fx", "f32",
        "PIPELINEDP_TPU_VECTOR_ACCUMULATOR",
        ("pipelinedp_tpu_torch.torch_engine", "_VECTOR_ACCUMULATOR"),
        False, str,
        "VECTOR_SUM per-coordinate accumulator: 'f32' (plain float32 "
        "segment_sum — the historical default, drift hazard past ~2^24 "
        "contributions per coordinate) or 'fx' (24-bit fixed-point "
        "coordinate lanes quantized against the norm clip bound, int32 "
        "lane sums, float64 host reassembly — exact, backend- and "
        "mesh-bit-identical, the wide-D kernel K2's operand). NOT "
        "dp-safe: the two accumulators release different floats (fx "
        "quantizes at the clip bound), so a plan never flips it — env "
        "override, test seam and default only.",
        choices=("f32", "fx")),
    KnobSpec(
        "serve_fusion", "bool", False,
        "PIPELINEDP_TPU_SERVE_FUSION", None, True, bool,
        "Shape-bucketed request fusion in the resident service "
        "(serve/fusion.py): admitted compatible requests of one shape "
        "bucket run as ONE batched device path (one K1 launch per fused "
        "batch). dp-safe: fusion on/off is bit-identical per request — "
        "per-request noise keys, per-request row tie-breaks and run "
        "boundaries that break at every request keep every request's "
        "stream its own. Default off; the serve knobs carry no module "
        "seam, so resolving them never imports serve/ into batch mode "
        "(Service constructor args are the injection point)."),
    KnobSpec(
        "serve_fuse_window_ms", "milliseconds", 8,
        "PIPELINEDP_TPU_SERVE_FUSE_WINDOW_MS", None, True, int,
        "Bounded wait window of an open fusion bucket: the first "
        "request in a bucket waits at most this long for companions "
        "before the batch flushes. A latency<->throughput trade only "
        "(dp-safe; outputs are window-invariant)."),
    KnobSpec(
        "serve_fuse_batch", "requests per fused batch", 8,
        "PIPELINEDP_TPU_SERVE_FUSE_BATCH", None, True, int,
        "Max requests one fused batch carries; a full bucket flushes "
        "immediately, before its window expires. dp-safe (batch "
        "membership never reaches the per-request noise streams)."),
    KnobSpec(
        "serve_fuse_rows_floor", "rows (pow2 bucket floor)", 8192,
        "PIPELINEDP_TPU_SERVE_FUSE_ROWS_FLOOR", None, True, int,
        "Smallest row-bucket edge: requests bucket at max(floor, the "
        "next 8192-row multiple of their rows), the JAX package's "
        "buckets. Raising the floor merges small-request buckets into "
        "bigger batches; clamped to >= 8192. dp-safe: the batched path "
        "concatenates its members' rows unpadded, so the edge decides "
        "only who fuses with whom."),
    KnobSpec(
        "sketch_width", "hash buckets (row-0 selection axis)", 1 << 16,
        "PIPELINEDP_TPU_SKETCH_WIDTH", None, False, int,
        "Buckets per counting-sketch row in the sketch-first path "
        "(sketch/). NOT dp-safe: the bucket grid decides which keys "
        "become candidates, so a plan never changes it — env override, "
        "explicit SketchParams and default only. Rounded up to a "
        "multiple of 256 on device (the matmul binner's radix width)."),
    KnobSpec(
        "sketch_depth", "sketch rows (hash remixes)", 2,
        "PIPELINEDP_TPU_SKETCH_DEPTH", None, False, int,
        "Counting-sketch depth: row 0 selects candidate buckets, rows "
        "1+ refine the count-min mass estimate in the run report. NOT "
        "dp-safe (part of the selection mechanism's shape)."),
    KnobSpec(
        "sketch_candidate_cap", "selected buckets (DP top-K cap)", 4096,
        "PIPELINEDP_TPU_SKETCH_CANDIDATE_CAP", None, False, int,
        "Max buckets phase-1 selection keeps (the DP top-K cap over "
        "noisy sketch mass — the cap lives INSIDE the DP mechanism, on "
        "buckets, never on data-derived key lists). NOT dp-safe: it "
        "changes the releasable candidate set."),
    KnobSpec(
        "sketch_backend", "matmul | xla", "matmul",
        "PIPELINEDP_TPU_SKETCH_BACKEND", None, True, str,
        "Device formulation of the sketch binner: 'matmul' (radix "
        "one-hot factors contracted by one torch.matmul, "
        "sketch/device.py — the default) or 'xla' (the index_add_ "
        "scatter reference; the name is the JAX package's). dp-safe: "
        "both are exact integer arithmetic and bit-identical (PARITY row "
        "36), so a tuning run may measure either. No module seam — "
        "SketchParams.backend is the injection point, so "
        "resolving the registry never imports sketch/ into non-sketch "
        "runs.", choices=("matmul", "xla")),
    KnobSpec(
        "mesh_topology", "flat | hier | auto", "flat",
        "PIPELINEDP_TPU_MESH_TOPOLOGY",
        ("pipelinedp_tpu_torch.parallel.sharded", "_MESH_TOPOLOGY"),
        True, str,
        "Cross-shard exchange layout (parallel/sharded.py): 'flat' "
        "(one collective over the whole rank axis — the default), "
        "'hier' (two stages: an owner-block reduce_scatter over each "
        "host's ici group, then one block exchange over the dcn groups "
        "— scatter traffic stays within the host, only 1/per_host of "
        "the payload crosses hosts) or 'auto' (hier iff the mesh spans "
        "more than one host; ranks group into hosts by host name, "
        "PIPELINEDP_TPU_MESH_HOSTS simulates hosts). dp-safe: every "
        "payload is exact integer data, so hier and flat release "
        "bit-identical values and kept sets (PARITY row 43); ragged "
        "host groups fall back to flat with a mesh.topology_fallback "
        "event.",
        choices=("flat", "hier", "auto")),
    KnobSpec(
        "select_units_cap", "privacy units per partition", _I32_MAX,
        None, ("pipelinedp_tpu_torch.streaming", "_SELECT_UNITS_CAP"),
        False, int,
        "int32 guard cap: privacy units per partition at streamed "
        "selection time. A refusal threshold, not a performance "
        "choice — never planned; the seam exists so boundary tests "
        "can pin the exact cliff."),
    KnobSpec(
        "tree_rows_cap", "kept rows per partition", _I32_MAX,
        None, ("pipelinedp_tpu_torch.streaming", "_TREE_ROWS_CAP"),
        False, int,
        "int32 guard cap: kept rows per partition in the streamed "
        "percentile tree histograms. A refusal threshold — never "
        "planned; seam for boundary tests."),
)

BY_NAME: Dict[str, KnobSpec] = {spec.name: spec for spec in REGISTRY}


def _seam_value(spec: KnobSpec) -> Any:
    mod = importlib.import_module(spec.seam[0])
    return getattr(mod, spec.seam[1])


def resolve_value(spec: KnobSpec,
                  plan_knobs: Optional[Dict[str, Any]] = None
                  ) -> Tuple[Any, str]:
    """(value, source) for one knob under the registry precedence.
    ``plan_knobs`` is the knob dict of an already-validated plan file
    (None: no plan in force). Source is one of ``env`` / ``seam`` /
    ``plan`` / ``default``."""
    if spec.env_var is not None:
        raw = os.environ.get(spec.env_var)
        if raw is not None and raw != "":
            return spec.parse(raw), "env"
    if spec.seam is not None:
        current = _seam_value(spec)
        if current != spec.default:
            return current, "seam"
    if plan_knobs is not None and spec.name in plan_knobs:
        if spec.dp_safe:
            return spec.parse(plan_knobs[spec.name]), "plan"
        # Once per (knob, offending value) observation — resolution
        # runs on every knob read, and re-emitting per read would
        # flood the bounded obs event ring (same dedup contract as
        # plan.stale).
        skip_key = (spec.name, repr(plan_knobs[spec.name]))
        if skip_key not in _dp_unsafe_seen:
            _dp_unsafe_seen.add(skip_key)
            from pipelinedp_tpu_torch import obs
            obs.event("plan.skipped_dp_unsafe", knob=spec.name,
                      plan_value=plan_knobs[spec.name])
    return spec.default, "default"


def value(name: str, plan_knobs: Optional[Dict[str, Any]] = None) -> Any:
    """The resolved value of one knob (see :func:`resolve_value`).
    With ``plan_knobs`` omitted the current plan file (if any) is
    consulted through the planner's cached load, bucketed at the last
    resolved request shape — so a mid-request read (the walk's cap, read
    when the walk plans its partition blocks) sees the same vector the
    request resolved."""
    spec = BY_NAME[name]
    if plan_knobs is None:
        from pipelinedp_tpu_torch.plan import planner
        plan_knobs = planner.current_plan_knobs(
            planner.last_resolved_shape())
    return resolve_value(spec, plan_knobs)[0]


def defaults() -> Dict[str, Any]:
    """{name: hardcoded default} — the cold-start resolution vector."""
    return {spec.name: spec.default for spec in REGISTRY}


def resolve_all(plan_knobs: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Tuple[Any, str]]:
    """{name: (value, source)} for every registered knob."""
    return {spec.name: resolve_value(spec, plan_knobs)
            for spec in REGISTRY}


@contextlib.contextmanager
def seam_override(name: str, value: Any):
    """Temporarily set a knob's module seam (the blessed injection
    idiom for tests and probe runs — a mutated seam outranks any plan
    file, so an injected-cap run measures the injected cap)."""
    spec = BY_NAME[name]
    if spec.seam is None:
        raise ValueError(f"knob {name!r} has no module seam")
    mod = importlib.import_module(spec.seam[0])
    saved = getattr(mod, spec.seam[1])
    setattr(mod, spec.seam[1], spec.parse(value))
    try:
        yield
    finally:
        setattr(mod, spec.seam[1], saved)


#: The checkpoint cadence's variable. Not a registered knob, as in the JAX
#: package (a plan never moves it): read here so that every environment
#: read of a tuning variable sits in this module.
CKPT_EVERY_ENV = "PIPELINEDP_TPU_CKPT_EVERY"


def checkpoint_every() -> int:
    """Folds (stream) or chunks (sweep) between two checkpoint writes:
    ``PIPELINEDP_TPU_CKPT_EVERY``, at least 1, default 1."""
    return max(1, int(os.environ.get(CKPT_EVERY_ENV) or 1))
