"""Seeded chaos campaign: one seed -> a deterministic schedule of fault
injections across EVERY ``FaultPlan`` seam, driven against a mixed
workload (streamed aggregation with percentiles, resident serve requests,
sketch-first heavy hitters, the utility-analysis megasweep, run-ledger
writers, the elastic mesh), with the recovery invariants asserted after
every episode. A port of ``pipelinedp_tpu/resilience/chaos.py``:

* zero orphan ``pdp-*`` threads: every kill drains the ingest and serve
  executors completely; and once the campaign returns, no rank process
  of its mesh pool is left;
* every budget lease resolves exactly once: a killed serve request leaves
  exactly one ``reserved`` debit that a restart replays, never zero and
  never two;
* checkpoint resume is bit-identical: the resumed (or elastically
  re-formed) run releases the same noisy values as an uninterrupted run,
  float for float;
* no silent refusal: every refusal carries a structured reason AND a
  ``serve.refusal`` ledger event;
* torn ledger writes are repaired or reported by ``fsck``, never silently
  lost.

The campaign is deterministic end to end: ``random.Random(episode_seed)``
draws each episode's scenario parameters in the reference's order, so a
seed picks the same kill index, loss set and hold index in both packages;
the rotation fires every seam in any campaign of >= 11 episodes; and a
failing episode prints the exact reproduction command
(``PIPELINEDP_TPU_CHAOS_SEED=<seed> python -m
pipelinedp_tpu_torch.resilience.chaos --schedules N --only-episode K``,
with ``--device`` where it is not the default).

It runs on the campaign's ``device``: the card by default (``"cuda"``;
without one it raises, as ``TorchBackend`` does, and never carries on on
the CPU by itself), or ``"cpu"``. A port mesh is one process per rank,
so the two mesh scenarios (device_loss, topo_kill) run on a 4-rank gloo
``RankPool(elastic=True)`` on the campaign's device, started at the
first mesh episode and closed when the campaign ends; the fault plan, the
stream chunk and the topology reach the ranks through the call's
environment. Every wedge and backoff rides a ``FakeClock`` (no real
sleep). Each episode's record carries its wall and the kernel launches
of its recovered run (``launches``; ``launches_per_rank`` for a mesh
episode's survivors), which ``chip_smoke.py`` reads on the card.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import tempfile
import threading
from typing import Any, Callable, Dict, List, Optional

CHAOS_SEED_ENV = "PIPELINEDP_TPU_CHAOS_SEED"
DEFAULT_SCHEDULES = 20
DEFAULT_DEVICE = "cuda"
#: Rows per streamed batch during the campaign: the 9,000-row stream runs
#: ten batches, so every kill index lands mid-stream.
STREAM_CHUNK_ROWS = "997"
#: Ranks of the campaign's mesh pool.
MESH_RANKS = 4

#: Scenario rotation. Order matters only for coverage: a campaign of
#: ``n >= len(SCENARIO_NAMES)`` episodes fires every seam at least once.
SCENARIO_NAMES = (
    "stream_kill",      # fail_chunks: kill pass A mid-stream, resume
    "device_loss",      # lose_device_chunks: elastic mesh re-form
    "pass_b_kill",      # fail_pass_b_chunks: kill the percentile sweep
    "hold_wedge",       # hold_fetch_batches: wedged fetch, released
    "wedged_probe",     # wedged_init (+ wedged_hold): probe degrades
    "serve_kill",       # fail_serve_requests: reserve survives restart
    "sketch_kill",      # fail_sketch_chunks: sketch-first drain proof
    "torn_ledger",      # torn run-ledger tail: fsck repairs it
    "sweep_kill",       # fail_sweep_config_chunks: megasweep resume
    "obs_endpoint",     # ServeKill under a live wire surface: the
                        # introspection endpoint answers mid-crash and
                        # drains with the service (no orphan listener)
    "topo_kill",        # lose_device_chunks on a hier(2,2) mesh: the
                        # elastic shrink regroups survivors within
                        # their host, release stays bit-identical
)


class ChaosViolation(AssertionError):
    """An episode's recovery invariant did not hold."""


def _check(cond: bool, detail: str) -> None:
    if not cond:
        raise ChaosViolation(detail)


def _env_names() -> Dict[str, str]:
    """The variables the campaign sets, by role (the knobs' names come
    from the plan registry)."""
    from pipelinedp_tpu_torch.obs import http as obs_http
    from pipelinedp_tpu_torch.parallel import sharded as psh
    from pipelinedp_tpu_torch.plan import knobs
    from pipelinedp_tpu_torch.resilience import faults, health
    return {"chunk": knobs.BY_NAME["stream_chunk_rows"].env_var,
            "topology": knobs.BY_NAME["mesh_topology"].env_var,
            "hosts": psh._MESH_HOSTS_ENV, "faults": faults.ENV_VAR,
            "metrics_port": obs_http.ENV_VAR,
            "degraded": health.DEGRADED_ENV}


def require_device(device: str) -> str:
    """``device`` when the campaign can run there; raises, as
    ``TorchBackend`` does, for ``"cuda"`` without a card."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the chaos campaign on device='cuda' needs a CUDA device and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "it on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the chaos campaign runs on cuda or cpu, not "
                         f"{device}")
    return str(device)


# ---------------------------------------------------------------------
# kernel launches of a recovered run
# ---------------------------------------------------------------------


def _kernel_modules():
    from pipelinedp_tpu_torch.ops.kernels import (hist, segkeyed, segscan,
                                                  segsum, segtotal)
    return (segsum, hist, segtotal, segkeyed, segscan)


def kernel_launches() -> Dict[str, int]:
    """Each hand kernel's launches in this process since the last reset
    (the CPU path never counts)."""
    out: Dict[str, int] = {}
    for mod in _kernel_modules():
        out.update(mod.LAUNCHES)
    return out


def reset_kernel_launches() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


# ---------------------------------------------------------------------
# shared fixtures: FIXED shapes so episodes reuse warm state
# ---------------------------------------------------------------------


class _Fixtures:
    """Datasets, per-workload clean baselines and the mesh pool, built
    once per campaign on its ``device``. Baselines are computed with NO
    fault plan active; episode recoveries compare against them.
    ``record`` is the running episode's record (its wall, the launches
    of its recovered run)."""

    def __init__(self, device: str = DEFAULT_DEVICE) -> None:
        self.device = require_device(device)
        self._ds: Dict[str, Any] = {}
        self._baselines: Dict[str, Any] = {}
        self._pool = None
        self.record: Dict[str, Any] = {}

    def stream_columns(self):
        import numpy as np
        if "stream" not in self._ds:
            # lint: disable=rng-purity(chaos fixture data synthesis, seeded, never a DP draw)
            rng = np.random.default_rng(8)
            n = 9_000
            self._ds["stream"] = (rng.integers(0, 2_000, n),
                                  rng.integers(0, 12, n),
                                  rng.uniform(0.0, 10.0, n))
        return self._ds["stream"]

    def stream_ds(self):
        import pipelinedp_tpu_torch as pdt
        pid, pk, values = self.stream_columns()
        if "stream_ds" not in self._ds:
            self._ds["stream_ds"] = pdt.ArrayDataset(
                privacy_ids=pid, partition_keys=pk, values=values)
        return self._ds["stream_ds"], 12

    def sketch_ds(self):
        import numpy as np
        import pipelinedp_tpu_torch as pdt
        if "sketch" not in self._ds:
            # lint: disable=rng-purity(chaos fixture data synthesis, seeded, never a DP draw)
            rng = np.random.default_rng(3)
            n = 8_000
            raw = rng.zipf(1.4, n) % 300
            self._ds["sketch"] = pdt.ArrayDataset(
                privacy_ids=rng.integers(0, 1_500, n),
                partition_keys=np.char.add("key/", raw.astype("U6")),
                values=rng.uniform(0.0, 10.0, n))
        return self._ds["sketch"]

    def sweep_ds(self):
        import numpy as np
        import pipelinedp_tpu_torch as pdt
        if "sweep" not in self._ds:
            # lint: disable=rng-purity(chaos fixture data synthesis, seeded, never a DP draw)
            rng = np.random.default_rng(31)
            n = 8_000
            self._ds["sweep"] = pdt.ArrayDataset(
                privacy_ids=rng.integers(0, 600, n),
                partition_keys=rng.integers(0, 40, n),
                values=rng.uniform(0.0, 10.0, n))
        return self._ds["sweep"]

    def sweep_baseline(self) -> List[Dict[str, Any]]:
        """Per-config metric dicts of one uninterrupted megasweep (no
        fault plan, no checkpoint): the bit-parity oracle for the
        ``sweep_kill`` scenario's resumed grid."""
        if "sweep" not in self._baselines:
            from pipelinedp_tpu_torch.resilience import faults
            _check(faults.active() is None,
                   "sweep baseline computed under an active fault plan")
            self._baselines["sweep"], _ = run_megasweep(self)
        return self._baselines["sweep"]

    def params(self, workload: str):
        import pipelinedp_tpu_torch as pdt
        _, parts = self.stream_ds()
        if workload == "percentile":
            return pdt.AggregateParams(
                metrics=[pdt.Metrics.PERCENTILE(50), pdt.Metrics.COUNT],
                max_partitions_contributed=parts,
                max_contributions_per_partition=50,
                min_value=0.0, max_value=10.0)
        return pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
            max_partitions_contributed=parts,
            max_contributions_per_partition=50,
            min_value=0.0, max_value=10.0)

    def public(self, workload: str) -> Optional[list]:
        # Percentiles stream pass B over the kept set; a public set keeps
        # the kept universe fixed so the baseline cache is exact.
        return list(range(12)) if workload == "percentile" else None

    def baseline(self, workload: str) -> Dict[str, Any]:
        """The clean single-device streamed run of ``workload`` on the
        campaign's device. The caps do not bind on this data, so it is
        also the clean run at every mesh shape the mesh episodes shrink
        to: ``tests/test_torch_chaos.py`` holds it to the JAX package's
        clean ``make_mesh(2)`` and ``make_mesh(1)`` runs, bit for bit."""
        if workload not in self._baselines:
            from pipelinedp_tpu_torch.resilience import faults
            _check(faults.active() is None,
                   "baseline computed under an active fault plan")
            ds, _ = self.stream_ds()
            got, _ = run_streamed(ds, self.params(workload), seed=21,
                                  public=self.public(workload),
                                  device=self.device)
            self._baselines[workload] = got
        return self._baselines[workload]

    def pool(self):
        """The campaign's elastic 4-rank gloo pool, started at the first
        mesh episode. Its ranks inherit only the environment of their
        start; every call passes the variables it needs."""
        if self._pool is None or not self._pool.alive:
            from pipelinedp_tpu_torch.parallel import launch
            if self._pool is not None:
                self._pool.close()
            self._pool = launch.RankPool(
                MESH_RANKS, threads=1, elastic=True, timeout_s=60.0,
                deadline_s=300.0)
            self._pool.start()
        return self._pool

    def close(self) -> None:
        """Ends the mesh pool's ranks (a campaign's ``finally``)."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    @contextlib.contextmanager
    def recovered(self):
        """Around an episode's recovered run: the kernel launches inside
        it land in ``record["launches"]``."""
        reset_kernel_launches()
        try:
            yield
        finally:
            self.record["launches"] = kernel_launches()


def run_streamed(ds, params, seed=21, eps=5.0, delta=1e-6, public=None,
                 checkpoint=None, mesh=None, device=DEFAULT_DEVICE):
    """One streamed aggregation through the public engine on ``device``;
    returns (results dict, timings). Asserts the run actually streamed."""
    import pipelinedp_tpu_torch as pdt
    ds.invalidate_cache()
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(
        device=device, rng_seed=seed, mesh=mesh, checkpoint=checkpoint))
    res = engine.aggregate(ds, params, pdt.DataExtractors(),
                           public_partitions=public)
    acc.compute_budgets()
    got = dict(res)
    _check(res.timings.get("stream_batches", 0) > 1,
           "dataset did not stream — the kill seam was not exercised")
    return got, res.timings


def run_megasweep(fx: "_Fixtures", checkpoint: Optional[str] = None):
    """One config-batched utility-analysis megasweep through the public
    entry point: a fixed 12-config grid at ``sweep_config_batch=4`` (3
    config chunks, so every kill index lands between batches). Returns
    ``([per-config count-metric dicts], LazySweepResult)``."""
    import dataclasses

    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis, plan as plan_mod
    from pipelinedp_tpu_torch.analysis import data_structures
    ds = fx.sweep_ds()
    multi = data_structures.MultiParameterConfiguration(
        max_partitions_contributed=list(range(1, 13)),
        max_contributions_per_partition=[1, 2] * 6)
    options = analysis.UtilityAnalysisOptions(
        epsilon=1.0, delta=1e-6,
        aggregate_params=pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT],
            max_partitions_contributed=4,
            max_contributions_per_partition=2),
        multi_param_configuration=multi)
    with plan_mod.seam_override("sweep_config_batch", 4):
        res = analysis.perform_utility_analysis(
            ds, pdt.TorchBackend(device=fx.device, rng_seed=0,
                                 checkpoint=checkpoint),
            options, pdt.DataExtractors())
        out = list(res)[0]
    return [dataclasses.asdict(m.count_metrics) for m in out], res


def released(got) -> Dict[Any, Dict[str, Any]]:
    """``{partition key: {field: array}}`` of a release, whether its values
    are metric tuples or already plain dicts (a rank's release comes back
    plain, so it pickles)."""
    import numpy as np
    out = {}
    for k, t in got.items():
        fields = t if isinstance(t, dict) else {
            f: getattr(t, f) for f in t._fields}
        out[k] = {f: np.asarray(v) for f, v in fields.items()}
    return out


def assert_bit_identical(got_a, got_b, context: str) -> None:
    import numpy as np
    a, b = released(got_a), released(got_b)
    _check(set(a) == set(b),
           f"{context}: kept sets differ "
           f"({sorted(map(str, set(a) ^ set(b)))})")
    for k in a:
        _check(list(a[k]) == list(b[k]), f"{context}: fields differ")
        for f in a[k]:
            _check(bool(np.array_equal(a[k][f], b[k][f])),
                   f"{context}: partition {k}.{f} differs "
                   f"({a[k][f]!r} vs {b[k][f]!r})")


def assert_sweep_identical(got_a, got_b, context: str) -> None:
    """Two megasweep grids (per-config metric dicts) equal field for
    field."""
    import numpy as np
    _check(len(got_a) == len(got_b),
           f"{context}: {len(got_a)} configs vs {len(got_b)}")
    for ci, (a, b) in enumerate(zip(got_a, got_b)):
        _check(set(a) == set(b), f"{context}: cfg{ci} fields differ")
        for field in a:
            _check(bool(np.array_equal(np.asarray(a[field]),
                                       np.asarray(b[field]))),
                   f"{context}: cfg{ci}.{field} differs "
                   f"({a[field]!r} vs {b[field]!r})")


# ---------------------------------------------------------------------
# per-episode invariants
# ---------------------------------------------------------------------


def _pdp_threads() -> List[str]:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("pdp-") and t.is_alive()]


def _assert_drained(before: List[str], context: str) -> None:
    """Zero orphan ``pdp-*`` threads beyond what existed before the
    episode (joins stragglers briefly first: a drain in progress is not
    an orphan; a drain that never finishes is)."""
    for t in threading.enumerate():
        if (t.name.startswith("pdp-") and t.name not in before
                and t.is_alive()):
            t.join(timeout=10.0)
    orphans = [n for n in _pdp_threads() if n not in before]
    _check(not orphans, f"{context}: orphan threads {orphans}")


def _rank_processes() -> List[str]:
    """Live rank processes of a ``parallel.launch`` pool."""
    import multiprocessing as mp
    return [p.name for p in mp.active_children()
            if p.name.startswith("pdp-rank-")]


def _assert_faults_recorded(minimum: int, context: str) -> None:
    """Every injected fault is in the ledger: synthetic failures must be
    distinguishable from real ones in any run artifact."""
    from pipelinedp_tpu_torch import obs
    snap = obs.ledger().snapshot()
    counted = snap["counters"].get("faults.injected", 0)
    events = [e for e in snap["events"] if e["name"] == "fault.injected"]
    _check(counted >= minimum,
           f"{context}: faults.injected={counted} < {minimum}")
    _check(len(events) == counted,
           f"{context}: {counted} counted vs {len(events)} events")


# ---------------------------------------------------------------------
# the scenarios
# ---------------------------------------------------------------------


def _scenario_stream_kill(rng: random.Random, fx: _Fixtures,
                          tmp: str) -> None:
    from pipelinedp_tpu_torch.resilience import (CheckpointStore, FaultPlan,
                                                 injected_faults)
    from pipelinedp_tpu_torch.resilience.faults import ChunkFailure
    workload = rng.choice(("count_sum", "percentile"))
    kill_at = rng.randint(1, 4)
    ds, _ = fx.stream_ds()
    params = fx.params(workload)
    public = fx.public(workload)
    baseline = fx.baseline(workload)
    store = CheckpointStore(os.path.join(tmp, "stream.ckpt"))
    killed = False
    with injected_faults(FaultPlan(fail_chunks=(kill_at,))):
        try:
            run_streamed(ds, params, public=public, checkpoint=store,
                         device=fx.device)
        except ChunkFailure:
            killed = True
    _check(killed, f"fail_chunks=({kill_at},) never fired")
    with fx.recovered():
        resumed, timings = run_streamed(ds, params, public=public,
                                        checkpoint=store, device=fx.device)
    assert_bit_identical(baseline, resumed,
                         f"stream_kill@{kill_at}/{workload}")
    _check(not store.exists(), "success did not clear the checkpoint")
    _check(timings.get("stream_resumed_from", -1) >= 0,
           "resume did not report a restore point")


def mesh_rank_stream(params, columns, checkpoint, device):
    """One rank of a mesh episode: this rank's mesh over the pool's group,
    then one streamed aggregation under the fault plan of the call's
    ``PIPELINEDP_TPU_FAULTS``, with this rank's ledger and kernel counts
    from zero. Returns the plain release, the timings, the mesh and fault
    records, whether the mesh came up hierarchical, the kernel launches
    and the wall. A rank that leaves the re-formed mesh raises
    ``MeshDeparted``, which the pool reports as departed."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import obs
    from pipelinedp_tpu_torch.parallel import sharded as psh
    from pipelinedp_tpu_torch.resilience import faults
    from pipelinedp_tpu_torch.resilience.clock import SystemClock
    obs.reset()
    reset_kernel_launches()
    # The plan of the call's environment, with its counters from zero: a
    # pool's ranks outlive a call.
    plan = faults.active()
    if plan is not None:
        faults.install(plan)
    try:
        mesh = psh.make_mesh(device=device)
        hier = psh.topology_of(mesh).hierarchical
        pid, pk, values = columns
        ds = pdt.ArrayDataset(privacy_ids=pid, partition_keys=pk,
                              values=values)
        clock = SystemClock()
        t0 = clock.monotonic()
        got, timings = run_streamed(ds, params, checkpoint=checkpoint,
                                    mesh=mesh, device=device)
        wall = clock.monotonic() - t0
    finally:
        faults.clear()
    snap = obs.ledger().snapshot()
    return {"release": released(got), "timings": dict(timings),
            "events": [e for e in snap["events"] if e["name"] in (
                "mesh.reshard", "mesh.reformed", "fault.injected")],
            "faults_counted": snap["counters"].get("faults.injected", 0),
            "hier": hier, "launches": kernel_launches(), "wall_s": wall}


def _mesh_episode(fx: _Fixtures, losses, tmp: str, name: str,
                  hier: bool) -> List[Dict[str, Any]]:
    """The streamed count_sum workload on the campaign's 4-rank pool under
    ``lose_device_chunks=losses``; returns the survivors' records after
    checking that the rest departed. The survivors' injected faults are
    re-recorded in this process's ledger, each with its rank."""
    from pipelinedp_tpu_torch import obs
    from pipelinedp_tpu_torch.parallel import launch
    from pipelinedp_tpu_torch.resilience import FaultPlan
    names = _env_names()
    env = {names["faults"]: FaultPlan(lose_device_chunks=losses).to_env(),
           names["chunk"]: STREAM_CHUNK_ROWS, names["degraded"]: None,
           names["topology"]: "hier" if hier else None,
           names["hosts"]: "2" if hier else None}
    outs = fx.pool().run(mesh_rank_stream, fx.params("count_sum"),
                         fx.stream_columns(),
                         os.path.join(tmp, f"{name}.ckpt"), fx.device,
                         env=env)
    gone = [o for o in outs if isinstance(o, launch.RankGone)]
    _check(all(o.reason == "departed" for o in gone),
           f"{name}: a rank died instead of departing: {gone}")
    survivors = [(r, o) for r, o in enumerate(outs)
                 if not isinstance(o, launch.RankGone)]
    for r, o in survivors:
        faults_seen = [e for e in o["events"]
                       if e["name"] == "fault.injected"]
        _check(o["faults_counted"] == len(faults_seen) >= 1,
               f"{name}: rank {r} counted {o['faults_counted']} faults, "
               f"{len(faults_seen)} events")
        _check(o["hier"] == hier,
               f"{name}: rank {r}'s mesh came up "
               f"{'hier' if o['hier'] else 'flat'}")
    if survivors:
        r0, o0 = survivors[0]
        for e in o0["events"]:
            if e["name"] == "fault.injected":
                attrs = {k: v for k, v in e.items()
                         if k in ("kind", "index", "site")}
                obs.inc("faults.injected")
                obs.event("fault.injected", rank=r0, **attrs)
    fx.record["launches_per_rank"] = {r: o["launches"]
                                      for r, o in survivors}
    fx.record["rank_walls_s"] = {r: o["wall_s"] for r, o in survivors}
    return [o for _, o in survivors]


def _scenario_device_loss(rng: random.Random, fx: _Fixtures,
                          tmp: str) -> None:
    double = rng.random() < 0.5
    losses = (1, 3) if double else (rng.randint(1, 2),)
    surviving = 1 if double else 2
    # The single-device clean run: the caps do not bind, so it is the
    # clean run at the surviving shape (_Fixtures.baseline).
    baseline = fx.baseline("count_sum")
    survivors = _mesh_episode(fx, losses, tmp, "elastic", hier=False)
    _check(len(survivors) == surviving,
           f"{len(survivors)} survivors, expected {surviving}")
    for o in survivors:
        timings = o["timings"]
        _check(timings.get("stream_mesh_reshards") == len(losses),
               f"expected {len(losses)} reshard(s), got "
               f"{timings.get('stream_mesh_reshards')}")
        events = [e for e in o["events"] if e["name"] == "mesh.reshard"]
        _check(len(events) == len(losses),
               f"mesh.reshard events: {len(events)} != {len(losses)}")
        _check(events[-1]["new_devices"] == surviving,
               f"final mesh {events[-1]['new_devices']} != {surviving}")
        assert_bit_identical(baseline, o["release"],
                             f"device_loss@{losses}")


def _scenario_pass_b_kill(rng: random.Random, fx: _Fixtures,
                          tmp: str) -> None:
    from pipelinedp_tpu_torch.resilience import (CheckpointStore, FaultPlan,
                                                 injected_faults)
    from pipelinedp_tpu_torch.resilience.faults import ChunkFailure
    kill_at = rng.randint(0, 1)
    ds, _ = fx.stream_ds()
    params = fx.params("percentile")
    public = fx.public("percentile")
    baseline = fx.baseline("percentile")
    store = CheckpointStore(os.path.join(tmp, "passb.ckpt"))
    killed = False
    with injected_faults(FaultPlan(fail_pass_b_chunks=(kill_at,))):
        try:
            run_streamed(ds, params, public=public, checkpoint=store,
                         device=fx.device)
        except ChunkFailure:
            killed = True
    _check(killed, f"fail_pass_b_chunks=({kill_at},) never fired")
    with fx.recovered():
        resumed, timings = run_streamed(ds, params, public=public,
                                        checkpoint=store, device=fx.device)
    if timings.get("stream_resumed_from", 0) >= 1:
        _check(timings.get("stream_pass_b") == "reship",
               "resumed percentile run kept a partial pass-B cache")
    assert_bit_identical(baseline, resumed, f"pass_b_kill@{kill_at}")


def _scenario_hold_wedge(rng: random.Random, fx: _Fixtures,
                         tmp: str) -> None:
    from pipelinedp_tpu_torch.resilience import FaultPlan, injected_faults
    from pipelinedp_tpu_torch.resilience import faults
    hold_at = rng.randint(1, 2)
    ds, _ = fx.stream_ds()
    params = fx.params("count_sum")
    baseline = fx.baseline("count_sum")
    results: Dict[str, Any] = {}
    errors: List[BaseException] = []

    def run() -> None:
        try:
            with fx.recovered():
                results["out"] = run_streamed(ds, params,
                                              device=fx.device)[0]
        except BaseException as exc:  # surfaced below, never swallowed
            errors.append(exc)

    from pipelinedp_tpu_torch.ingest.executor import _CaptureThread
    with injected_faults(FaultPlan(hold_fetch_batches=(hold_at,))):
        t = _CaptureThread(run, "chaos-hold-driver")
        t.start()
        try:
            _check(faults.hold_started().wait(60.0),
                   f"hold_fetch_batches=({hold_at},) never engaged")
        finally:
            faults.release_holds()
            t.join(timeout=120.0)
    _check(not t.is_alive(), "held run never completed after release")
    _check(not errors, f"held run raised: {errors}")
    assert_bit_identical(baseline, results["out"],
                         f"hold_wedge@{hold_at}")


def _scenario_wedged_probe(rng: random.Random, fx: _Fixtures,
                           tmp: str) -> None:
    from pipelinedp_tpu_torch.resilience import (FakeClock, FaultPlan,
                                                 RetryPolicy, injected_faults)
    from pipelinedp_tpu_torch.resilience import health
    attempts = rng.randint(2, 3)
    hold = rng.random() < 0.5
    policy = RetryPolicy(max_attempts=attempts, base_delay_s=2.0,
                         multiplier=2.0, max_delay_s=60.0, jitter=0.1,
                         seed=rng.randint(0, 1_000))
    clock = FakeClock()
    env: Dict[str, str] = {}
    before = os.environ.get(health.DEGRADED_ENV)
    with injected_faults(FaultPlan(wedged_init=99, wedged_hold=hold)):
        report = health.ensure_device_or_degrade(
            policy=policy, clock=clock, timeout_s=300.0, env=env,
            device=fx.device)
    _check(report.degraded and not report.healthy,
           "wedged probe did not degrade")
    _check(report.attempts == attempts,
           f"attempts {report.attempts} != {attempts}")
    _check(clock.sleeps[-len(policy.delays()):] == policy.delays(),
           "backoff schedule not honored on the fake clock")
    # The port's steering: the degrade flag every later TorchBackend reads,
    # set in the caller's mapping and nowhere else.
    _check(env.get(health.DEGRADED_ENV) == "1",
           "degradation did not steer to the CPU (no degrade flag)")
    _check(os.environ.get(health.DEGRADED_ENV) == before,
           "the probe touched the process's environment")


def _serve_requests(svc, ds, params, kill: int, n_requests: int) -> None:
    """``n_requests`` admitted requests, request ``kill`` killed."""
    # lint: disable=noserve(the chaos harness exercises the serve seam by design; serve loads lazily, only in its episodes)
    from pipelinedp_tpu_torch import serve
    from pipelinedp_tpu_torch.resilience import faults
    for i in range(n_requests):
        ds.invalidate_cache()
        try:
            out = svc.submit(serve.ServeRequest(
                tenant="t", params=params, dataset=ds, epsilon=1.0,
                delta=1e-8, rng_seed=7, request_id=f"req-{i}"))
            _check(i != kill, f"request {kill} was not killed")
            _check(out.ok, f"request {i} refused: {out}")
        except faults.ServeKill:
            _check(i == kill, f"request {i} killed, planned {kill}")


def _serve_ds(seed: int):
    import numpy as np
    import pipelinedp_tpu_torch as pdt
    # lint: disable=rng-purity(chaos fixture data synthesis, seeded, never a DP draw)
    d_rng = np.random.default_rng(seed)
    n = 1_000
    ds = pdt.ArrayDataset(privacy_ids=d_rng.integers(0, 300, n),
                          partition_keys=d_rng.integers(0, 4, n),
                          values=d_rng.uniform(0.0, 10.0, n))
    params = pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT], max_partitions_contributed=4,
        max_contributions_per_partition=20)
    return ds, params


def _scenario_serve_kill(rng: random.Random, fx: _Fixtures,
                         tmp: str) -> None:
    from pipelinedp_tpu_torch import obs
    # lint: disable=noserve(the chaos harness exercises the serve seam by design; serve loads lazily, only in its episodes)
    from pipelinedp_tpu_torch import serve
    from pipelinedp_tpu_torch.resilience import FaultPlan, injected_faults
    # lint: disable=noserve(the chaos harness exercises the serve seam by design; serve loads lazily, only in its episodes)
    from pipelinedp_tpu_torch.serve.budget_ledger import TenantBudgetLedger
    n_requests = 3
    kill = rng.randint(0, n_requests - 1)
    ds, params = _serve_ds(5)
    ledger_dir = os.path.join(tmp, "svc")
    total_eps = 10.0
    with injected_faults(FaultPlan(fail_serve_requests=(kill,))):
        with fx.recovered():
            with serve.Service(ledger_dir, tenants={"t": (total_eps, 1e-6)},
                               device=fx.device) as svc:
                _serve_requests(svc, ds, params, kill, n_requests)
                # No silent refusal: an overdraw refuses with a reason AND
                # a serve.refusal ledger event.
                ds.invalidate_cache()
                big = svc.submit(serve.ServeRequest(
                    tenant="t", params=params, dataset=ds,
                    epsilon=100.0, delta=1e-8, rng_seed=7))
                _check((not big.ok) and big.reason == "overdraw",
                       f"expected structured overdraw, got {big}")
    refusal_events = [e for e in obs.ledger().snapshot()["events"]
                      if e["name"] == "serve.refusal"]
    _check(any(e["reason"] == "overdraw" for e in refusal_events),
           "refusal happened with no serve.refusal event (silent)")
    # Every lease resolved exactly once: the killed id's reserve stands
    # (DP-conservative: noise may have been drawn), the others committed,
    # and no id has more than one debit.
    # lint: disable=noserve(exactly-once lease audit reads the episode's own ledger directory)
    led = TenantBudgetLedger(os.path.join(ledger_dir, "budgets"))
    debits = led.debits("t")
    _check(len(debits) == n_requests,
           f"{len(debits)} debits for {n_requests} admitted requests")
    for i in range(n_requests):
        state = debits[f"req-{i}"]["state"]
        want = "reserved" if i == kill else "committed"
        _check(state == want, f"req-{i}: {state} != {want}")
    _check(abs(led.remaining("t").epsilon
               - (total_eps - n_requests)) < 1e-9,
           "remaining budget drifted from exactly-once accounting")
    # A restarted service replays the same books: the dead request's
    # retry dedupes onto the existing debit, never double-spends.
    with serve.Service(ledger_dir, tenants={"t": (total_eps, 1e-6)},
                       device=fx.device) as svc2:
        lease = svc2.budgets.reserve("t", f"req-{kill}", 1.0, 1e-8)
        _check(lease.replayed, "killed id's reserve did not dedup")
        _check(len(svc2.budgets.debits("t")) == n_requests,
               "retry of the killed id grew a second debit")


def _scenario_sketch_kill(rng: random.Random, fx: _Fixtures,
                          tmp: str) -> None:
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.resilience import FaultPlan, injected_faults
    from pipelinedp_tpu_torch.resilience.faults import ChunkFailure
    from pipelinedp_tpu_torch.sketch import SketchParams
    kill_at = rng.randint(1, 2)
    ds = fx.sketch_ds()
    params = pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
        max_partitions_contributed=3,
        max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0)
    sk = SketchParams(eps=1e6, delta=1e-6, width=2048, depth=2,
                      candidate_cap=2048, threshold=0.5, chunk_rows=512)

    def run(sketch):
        ds.invalidate_cache()
        acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0,
                                        total_delta=1e-6)
        engine = pdt.DPEngine(acc, pdt.TorchBackend(device=fx.device,
                                                    rng_seed=0))
        res = engine.aggregate(ds, params, pdt.DataExtractors(),
                               sketch_first=sketch)
        acc.compute_budgets()
        return dict(res)

    killed = False
    with injected_faults(FaultPlan(fail_sketch_chunks=(kill_at,))):
        try:
            run(sk)
        except ChunkFailure:
            killed = True
    _check(killed, f"fail_sketch_chunks=({kill_at},) never fired")
    # The same process serves a healthy sketch-first run afterwards: the
    # kill left no wedged stager behind.
    with fx.recovered():
        out = run(sk)
    _check(len(out) > 0, "post-kill sketch run released nothing")


def _scenario_sweep_kill(rng: random.Random, fx: _Fixtures,
                         tmp: str) -> None:
    """Kill the utility-analysis megasweep between config batches
    (``fail_sweep_config_chunks``); the ``.sweep`` sibling checkpoint must
    resume ONLY the remaining config chunks, and the resumed grid must be
    bit-identical to an uninterrupted batched run."""
    from pipelinedp_tpu_torch.resilience import (CheckpointStore, FaultPlan,
                                                 injected_faults)
    from pipelinedp_tpu_torch.resilience.faults import ChunkFailure
    kill_at = rng.randint(0, 2)
    baseline = fx.sweep_baseline()
    path = os.path.join(tmp, "ua.ckpt")
    killed = False
    with injected_faults(FaultPlan(fail_sweep_config_chunks=(kill_at,))):
        try:
            run_megasweep(fx, checkpoint=path)
        except ChunkFailure:
            killed = True
    _check(killed, f"fail_sweep_config_chunks=({kill_at},) never fired")
    with fx.recovered():
        resumed, res = run_megasweep(fx, checkpoint=path)
    _check(res._resumed_from_chunk == kill_at,
           f"sweep resumed from chunk {res._resumed_from_chunk}, "
           f"expected {kill_at}")
    assert_sweep_identical(resumed, baseline, f"sweep_kill@{kill_at}")
    _check(not CheckpointStore(path + ".sweep").exists(),
           "success did not clear the .sweep checkpoint")


def _scenario_torn_ledger(rng: random.Random, fx: _Fixtures,
                          tmp: str) -> None:
    from pipelinedp_tpu_torch.obs import store as obs_store
    d = os.path.join(tmp, "ledger")
    s = obs_store.LedgerStore(d)
    for i in range(3):
        s.append("run.report", {"phase_s": {"a": float(i)}},
                 env={"k": "v"})
    with open(s.path, "rb") as f:
        data = f.read()
    cut = rng.randint(1, len(data) - 1)
    with open(s.path, "wb") as f:
        f.write(data[:cut])
    summary = obs_store.fsck(d)
    _check(summary["clean"], f"fsck reported damage: {summary}")
    committed = data[:cut].count(b"\n")
    entries = obs_store.LedgerStore(d).entries()
    _check(len(entries) >= committed,
           f"fsck lost committed entries ({len(entries)} < {committed})")
    again = obs_store.fsck(d)
    _check(again["repaired"] == [] and again["clean"],
           f"fsck not idempotent: {again}")


def _scenario_obs_endpoint(rng: random.Random, fx: _Fixtures,
                           tmp: str) -> None:
    """The wire surface under fire: a serve lifetime with the
    introspection endpoint armed takes a planned ServeKill mid-burst; the
    endpoint keeps answering (``/healthz`` and a ``/metrics`` scrape that
    carries the tenant's budget gauges) while the crash is live, and
    ``Service.close`` drains the ``pdp-obs-http`` accept loop with
    everything else: the campaign's orphan check is the no-leaked-listener
    proof."""
    import urllib.request

    # lint: disable=noserve(the chaos harness exercises the serve seam by design; serve loads lazily, only in its episodes)
    from pipelinedp_tpu_torch import serve
    from pipelinedp_tpu_torch.resilience import FaultPlan, injected_faults
    n_requests = 3
    kill = rng.randint(0, n_requests - 1)
    ds, params = _serve_ds(11)
    port_env = _env_names()["metrics_port"]
    saved_port = os.environ.get(port_env)
    os.environ[port_env] = "0"
    try:
        with injected_faults(FaultPlan(fail_serve_requests=(kill,))):
            with fx.recovered():
                with serve.Service(os.path.join(tmp, "svc"),
                                   tenants={"t": (10.0, 1e-6)},
                                   device=fx.device) as svc:
                    _check(svc._http is not None,
                           "endpoint did not start under METRICS_PORT=0")
                    base = svc._http.url
                    _serve_requests(svc, ds, params, kill, n_requests)
                    # The surface answers WHILE the crash is on the books.
                    with urllib.request.urlopen(f"{base}/healthz") as r:
                        hz = json.loads(r.read())
                    _check(hz["status"] in ("ok", "degraded"),
                           f"unparseable healthz: {hz}")
                    with urllib.request.urlopen(f"{base}/metrics") as r:
                        text = r.read().decode("utf-8")
                    _check("pdp_tenant_epsilon_remaining" in text,
                           "scrape missing the tenant budget gauge")
                    _check('tenant="t"' in text,
                           "scrape missing the episode's tenant label")
    finally:
        if saved_port is None:
            os.environ.pop(port_env, None)
        else:
            os.environ[port_env] = saved_port
    # Drained listener: close() already ran (context exit); the accept
    # thread must be gone NOW, not merely by campaign teardown.
    _check(not any(t.name == "pdp-obs-http"
                   for t in threading.enumerate() if t.is_alive()),
           "pdp-obs-http accept thread survived Service.close")


def _scenario_topo_kill(rng: random.Random, fx: _Fixtures,
                        tmp: str) -> None:
    """Device loss with the hierarchical topology in force: the mesh comes
    up ``hier`` over two simulated hosts, a participant drops out
    mid-stream, ``reform_mesh`` regroups the survivors within their host
    (the divisor prefix of the interleave keeps the topology:
    hier(2,2) -> hier(2,1)), and the resumed release is bit-identical to
    the clean run at the surviving shape: the mesh_topology knob and the
    elastic shrink compose without touching released values."""
    losses = (rng.randint(1, 2),)
    # The single-device clean run: the caps do not bind, so it is the
    # clean flat run at the surviving shape (_Fixtures.baseline).
    baseline = fx.baseline("count_sum")
    survivors = _mesh_episode(fx, losses, tmp, "topo", hier=True)
    _check(len(survivors) == 2, f"{len(survivors)} survivors, expected 2")
    for o in survivors:
        reshards = o["timings"].get("stream_mesh_reshards")
        _check(reshards == 1, f"expected 1 reshard, got {reshards}")
        reformed = [e for e in o["events"] if e["name"] == "mesh.reformed"]
        _check(bool(reformed), "no mesh.reformed event recorded")
        last = reformed[-1]
        _check((last["topology"], last["hosts"], last["per_host"])
               == ("hier", 2, 1),
               f"shrink lost the hier topology: {last}")
        assert_bit_identical(baseline, o["release"], f"topo_kill@{losses}")


_SCENARIOS: Dict[str, Callable[[random.Random, _Fixtures, str], None]] = {
    "stream_kill": _scenario_stream_kill,
    "device_loss": _scenario_device_loss,
    "pass_b_kill": _scenario_pass_b_kill,
    "hold_wedge": _scenario_hold_wedge,
    "wedged_probe": _scenario_wedged_probe,
    "serve_kill": _scenario_serve_kill,
    "sketch_kill": _scenario_sketch_kill,
    "sweep_kill": _scenario_sweep_kill,
    "torn_ledger": _scenario_torn_ledger,
    "obs_endpoint": _scenario_obs_endpoint,
    "topo_kill": _scenario_topo_kill,
}

#: Scenarios whose plan is guaranteed to fire at least one fault (the
#: hold and wedge scenarios record holds and wedges instead of raising).
_EXPECT_INJECTED = {"stream_kill", "device_loss", "pass_b_kill",
                    "hold_wedge", "wedged_probe", "serve_kill",
                    "sketch_kill", "sweep_kill", "obs_endpoint",
                    "topo_kill"}


def schedule_for(seed: int, n_schedules: int) -> List[Dict[str, Any]]:
    """The deterministic episode list one campaign seed expands to:
    ``[{episode, scenario, episode_seed}, ...]``. Pure: two calls with the
    same arguments return the same schedule, which is the whole
    reproducibility contract (and the JAX package's schedule)."""
    return [{"episode": i,
             "scenario": SCENARIO_NAMES[i % len(SCENARIO_NAMES)],
             "episode_seed": f"{seed}:{i}"}
            for i in range(n_schedules)]


def repro_command(seed: int, n_schedules: int, episode: int,
                  device: str = DEFAULT_DEVICE) -> str:
    """The command that replays one episode of a campaign."""
    dev = "" if device == DEFAULT_DEVICE else f" --device {device}"
    return (f"{CHAOS_SEED_ENV}={seed} python -m "
            f"pipelinedp_tpu_torch.resilience.chaos "
            f"--schedules {n_schedules} --only-episode {episode}{dev}")


def run_episode(seed: int, episode: int, fx: Optional[_Fixtures] = None,
                device: str = DEFAULT_DEVICE) -> Dict[str, Any]:
    """Run ONE episode of campaign ``seed`` (for reproducing a failure in
    isolation) on ``fx``'s device, or on ``device`` with fixtures of its
    own (their mesh pool closed before it returns); returns its record:
    the schedule entry, ``wall_s`` and the recovered run's ``launches``
    (``launches_per_rank`` for a mesh episode). Raises
    :class:`ChaosViolation` on an invariant breach."""
    from pipelinedp_tpu_torch import obs
    from pipelinedp_tpu_torch.resilience.clock import SystemClock
    spec = schedule_for(seed, episode + 1)[episode]
    own = fx is None
    fx = fx or _Fixtures(device)
    # lint: disable=rng-purity(episode schedule derivation, pure in the campaign seed)
    rng = random.Random(spec["episode_seed"])
    before = _pdp_threads()
    obs.reset()
    fx.record = {}
    context = f"episode {episode} ({spec['scenario']})"
    clock = SystemClock()
    t0 = clock.monotonic()
    try:
        with tempfile.TemporaryDirectory(prefix="pdp-chaos-") as tmp:
            _SCENARIOS[spec["scenario"]](rng, fx, tmp)
            if spec["scenario"] in _EXPECT_INJECTED:
                _assert_faults_recorded(1, context)
            _assert_drained(before, context)
    finally:
        if own:
            fx.close()
    if own:
        left = _rank_processes()
        _check(not left, f"{context}: rank processes outlived it: {left}")
    return {**spec, "wall_s": clock.monotonic() - t0, "launches": {},
            **fx.record}


def run_campaign(seed: int, n_schedules: int = DEFAULT_SCHEDULES,
                 out: Callable[[str], None] = print,
                 device: str = DEFAULT_DEVICE) -> Dict[str, Any]:
    """Run the whole campaign on ``device``: ``n_schedules`` seeded
    episodes, every FaultPlan seam covered, invariants asserted per
    episode. Returns ``{"seed", "episodes", "passed", "failures",
    "records"}``; a failure record carries the exact reproduction
    command. Raises without a card for ``device="cuda"``, and
    :class:`ChaosViolation` when a rank process outlives the campaign."""
    fx = _Fixtures(device)
    failures: List[Dict[str, Any]] = []
    records: List[Dict[str, Any]] = []
    chunk_env = _env_names()["chunk"]
    old_chunk = os.environ.get(chunk_env)
    os.environ[chunk_env] = STREAM_CHUNK_ROWS
    try:
        for spec in schedule_for(seed, n_schedules):
            i = spec["episode"]
            try:
                records.append(run_episode(seed, i, fx))
                out(f"chaos episode {i:>3} {spec['scenario']:<13} ok")
            except Exception as exc:
                repro = repro_command(seed, n_schedules, i, device)
                failures.append({**spec, "error": f"{exc}",
                                 "repro": repro})
                out(f"chaos episode {i:>3} {spec['scenario']:<13} "
                    f"FAILED: {exc}\n  reproduce with: {repro}")
    finally:
        fx.close()
        if old_chunk is None:
            os.environ.pop(chunk_env, None)
        else:
            os.environ[chunk_env] = old_chunk
    left = _rank_processes()
    _check(not left, f"rank processes outlived the campaign: {left}")
    return {"seed": seed, "episodes": n_schedules,
            "passed": n_schedules - len(failures),
            "failures": failures, "records": records}


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m pipelinedp_tpu_torch.resilience.chaos [--seed S]
    [--schedules N] [--only-episode K] [--json] [--device cuda|cpu]``: the
    seeded chaos campaign. The seed defaults to
    ``PIPELINEDP_TPU_CHAOS_SEED`` (else 0), so a failure's printed
    reproduction command replays the identical schedule."""
    # Every variable this entry point or its episodes touch is RESTORED on
    # the way out: tests (and anything else embedding the CLI) call main()
    # in-process, and a leaked stream chunk would silently re-chunk every
    # later streaming run of the process.
    saved = {k: os.environ.get(k) for k in _env_names().values()}
    try:
        return _main_inner(argv)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _main_inner(argv: Optional[List[str]]) -> int:
    import argparse
    parser = argparse.ArgumentParser(
        prog="python -m pipelinedp_tpu_torch.resilience.chaos",
        description="Seeded chaos campaign across every FaultPlan seam "
                    "with per-episode recovery invariants.")
    parser.add_argument("--seed", type=int,
                        default=int(os.environ.get(CHAOS_SEED_ENV, "0")),
                        help=f"campaign seed (default: ${CHAOS_SEED_ENV}, "
                             "else 0)")
    parser.add_argument("--schedules", type=int, default=DEFAULT_SCHEDULES,
                        help="number of seeded episodes (default "
                             f"{DEFAULT_SCHEDULES})")
    parser.add_argument("--only-episode", type=int, default=None,
                        dest="only_episode",
                        help="run ONE episode of the schedule (the "
                             "reproduction path a failure prints)")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="machine-readable summary")
    parser.add_argument("--device", default=DEFAULT_DEVICE,
                        choices=("cuda", "cpu"),
                        help=f"where the campaign runs (default "
                             f"{DEFAULT_DEVICE}; without a card it raises)")
    args = parser.parse_args(argv)
    if args.only_episode is not None:
        spec = schedule_for(args.seed,
                            args.only_episode + 1)[args.only_episode]
        os.environ.setdefault(_env_names()["chunk"], STREAM_CHUNK_ROWS)
        try:
            run_episode(args.seed, args.only_episode, device=args.device)
        except Exception as exc:
            print(f"chaos episode {args.only_episode} "
                  f"({spec['scenario']}) FAILED: {exc}")
            return 1
        print(f"chaos episode {args.only_episode} ({spec['scenario']}) ok")
        return 0
    summary = run_campaign(args.seed, args.schedules, device=args.device)
    if args.as_json:
        print(json.dumps({k: v for k, v in summary.items()
                          if k != "records"}))
    else:
        print(f"chaos campaign seed={summary['seed']}: "
              f"{summary['passed']}/{summary['episodes']} episodes "
              "passed")
        for f in summary["failures"]:
            print(f"  FAILED episode {f['episode']} ({f['scenario']}): "
                  f"{f['error']}")
            print(f"    reproduce with: {f['repro']}")
    return 0 if not summary["failures"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
