"""Deterministic, seeded fault injection for tests and the smoke run.

A ``FaultPlan`` names the faults to inject; instrumented sites of the
port consult the active plan:

* ``wedged("device.probe")`` / ``wedged("mesh.init")``: the first
  ``wedged_init`` probe or mesh attempts behave as a wedged runtime (a
  timeout) without spending real wall time (``resilience/health.py``);
* ``check_chunk(b)``: raise ``ChunkFailure`` when pass A of the stream
  (``pipelinedp_tpu_torch/streaming.py``) reaches batch ``b``;
* ``check_pass_b_chunk(b)``: the same for batch ``b`` of a percentile
  pass-B sweep (pass A reuses the batch indices and survives, so the kill
  lands mid-sweep);
* ``check_device_loss()``: raise ``DeviceLost`` at the planned global
  dispatch ordinals of the stream: a mesh participant drops out and the
  elastic wrapper re-forms the mesh from the survivors;
* ``check_fetch_hold(b)``: hold the first fetch of batch ``b`` until
  ``release_holds()`` (a wedged device mid-stream, what the stall watchdog
  exists to catch);
* ``check_coordinator()``: the first ``coordinator_timeouts`` calls raise
  ``CoordinatorTimeout`` (a rendezvous of ``torch.distributed`` that never
  answers; ``health.resilient_init_process_group``);
* ``check_sweep_config_chunk(k)``: raise ``ChunkFailure`` when the
  utility-analysis sweep (``analysis/torch_sweep.py``) reaches config
  chunk ``k``, between the ``.sweep`` checkpoint of the chunks before it
  and the chunk's dispatch;
* ``check_sketch_chunk(b)``: raise ``ChunkFailure`` when the sketch-first
  phase-1 accumulation (``sketch/engine.py``) dispatches chunk ``b``,
  between the stager's handoff and the binner;
* ``check_serve_request(i)``: raise ``ServeKill`` when the resident
  service (``serve/``) reaches admitted request ``i``, between the
  durable budget reserve and its commit (the reserve must survive a
  restart).

A plan installs in process (the ``injected_faults(plan)`` context
manager) or across a process boundary through the ``PIPELINEDP_TPU_FAULTS``
variable (``wedged_init=2,fail_chunks=3:5,coordinator_timeouts=1``), so a
rank or a subprocess of a harness injects the same faults; the string is
the JAX package's, field for field. Counters are deterministic: the Nth
call to a site always sees the same verdict for a given plan.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Dict, Optional, Tuple

ENV_VAR = "PIPELINEDP_TPU_FAULTS"

#: Poll beat and safety cap of the cooperative fetch hold (the wait rides
#: ``threading.Event`` beats, never ``time.sleep``).
_HOLD_POLL_S = 0.02
_HOLD_MAX_S = 60.0

#: The plan fields that hold index tuples (``a:b:c`` in the variable).
_TUPLE_FIELDS = ("fail_chunks", "fail_pass_b_chunks", "fail_sketch_chunks",
                 "fail_sweep_config_chunks", "hold_fetch_batches",
                 "fail_serve_requests", "lose_device_chunks")


class FaultInjected(Exception):
    """Base class for injected faults."""


class ChunkFailure(FaultInjected):
    """Injected failure while processing one streaming chunk."""


class CoordinatorTimeout(FaultInjected):
    """Injected timeout of the ``torch.distributed`` rendezvous."""


class ServeKill(FaultInjected):
    """Injected hard kill of a resident-service request mid-compute
    (between the durable budget reserve and its commit/release)."""


class DeviceLost(FaultInjected):
    """Injected loss of a mesh participant mid-stream. Unlike
    :class:`ChunkFailure`, a transient kill that the same mesh resumes
    from, this one means the mesh shape is gone: the elastic wrapper of
    ``streaming.py`` catches it, re-forms the mesh from the survivors and
    resumes from the last checkpoint at the new shape. Every rank of a
    port mesh holds the same plan and counts the same dispatches, so every
    rank raises it at the same ordinal."""

    def __init__(self, msg: str, index: int = -1):
        super().__init__(msg)
        self.index = int(index)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    #: the first N device-probe / mesh-init attempts wedge (per site).
    wedged_init: int = 0
    #: streaming batch indices whose pass-A dispatch raises
    #: ``ChunkFailure``.
    fail_chunks: Tuple[int, ...] = ()
    #: batch indices whose percentile pass-B dispatch raises
    #: ``ChunkFailure``.
    fail_pass_b_chunks: Tuple[int, ...] = ()
    #: the first N rendezvous attempts raise ``CoordinatorTimeout``.
    coordinator_timeouts: int = 0
    #: sketch-accumulation chunk indices whose dispatch raises
    #: ``ChunkFailure`` (kills a sketch-first phase 1 mid-stream; the
    #: ingest stager must drain to zero orphan ``pdp-*`` threads).
    fail_sketch_chunks: Tuple[int, ...] = ()
    #: utility-analysis sweep config-chunk indices whose dispatch raises
    #: ``ChunkFailure``.
    fail_sweep_config_chunks: Tuple[int, ...] = ()
    #: serve-request admission indices (0-based, in admission order)
    #: whose compute raises ``ServeKill`` mid-request — AFTER the
    #: durable budget reserve, BEFORE commit/release. The resident
    #: service treats any ``FaultInjected`` as a hard process kill:
    #: the reserved debit stands (noise may already have been drawn).
    fail_serve_requests: Tuple[int, ...] = ()
    #: batch indices whose pass-A fetch holds until :func:`release_holds`
    #: (once per index; fails loudly after ``_HOLD_MAX_S`` so a forgotten
    #: release never hangs a suite).
    hold_fetch_batches: Tuple[int, ...] = ()
    #: injected probe wedges hold for the probe timeout on the caller's
    #: clock (cancellable by the stall watchdog) instead of returning at
    #: once.
    wedged_hold: bool = False
    #: GLOBAL device-loss ordinals (the Nth ``check_device_loss`` call of
    #: the run, counted across elastic retries) at which a participant
    #: drops out: ``(1, 3)`` loses the first mesh at its second dispatch
    #: and the re-formed mesh two dispatches later.
    lose_device_chunks: Tuple[int, ...] = ()

    def to_env(self) -> str:
        """The plan as the ``PIPELINEDP_TPU_FAULTS`` string, in the JAX
        package's field order."""
        parts = []
        if self.wedged_init:
            parts.append(f"wedged_init={self.wedged_init}")
        for name in ("fail_chunks", "fail_pass_b_chunks",
                     "fail_sketch_chunks", "fail_sweep_config_chunks"):
            if getattr(self, name):
                parts.append(f"{name}=" + ":".join(
                    str(c) for c in getattr(self, name)))
        if self.coordinator_timeouts:
            parts.append(f"coordinator_timeouts={self.coordinator_timeouts}")
        for name in ("fail_serve_requests", "hold_fetch_batches"):
            if getattr(self, name):
                parts.append(f"{name}=" + ":".join(
                    str(c) for c in getattr(self, name)))
        if self.wedged_hold:
            parts.append("wedged_hold=1")
        if self.lose_device_chunks:
            parts.append("lose_device_chunks=" +
                         ":".join(str(c) for c in self.lose_device_chunks))
        return ",".join(parts)


def plan_from_env(spec: str) -> FaultPlan:
    """The plan of a ``PIPELINEDP_TPU_FAULTS`` string."""
    kw: Dict = {}
    for item in spec.split(","):
        item = item.strip()
        if not item:
            continue
        k, _, v = item.partition("=")
        if k in _TUPLE_FIELDS:
            kw[k] = tuple(int(c) for c in v.split(":") if c)
        elif k == "wedged_hold":
            kw[k] = bool(int(v))
        else:
            kw[k] = int(v)
    return FaultPlan(**kw)


_plan: Optional[FaultPlan] = None
_counters: Dict[str, int] = {}
#: The fetch-hold handshake: ``_hold_started`` is set the moment a fetch
#: begins holding (tests wait on it before advancing a fake clock);
#: ``_hold_release`` wakes every held fetch.
_hold_started = threading.Event()
_hold_release = threading.Event()


def hold_started() -> threading.Event:
    """The event set when an injected fetch hold actually blocks."""
    return _hold_started


def release_holds() -> None:
    """Releases every held fetch (the test's un-wedge switch)."""
    _hold_release.set()


def install(plan: FaultPlan) -> None:
    global _plan
    _plan = plan
    _counters.clear()
    _hold_started.clear()
    _hold_release.clear()


def clear() -> None:
    global _plan
    _plan = None
    _counters.clear()
    # Wake any fetch still held, so a teardown always drains.
    _hold_release.set()


@contextlib.contextmanager
def injected_faults(plan: FaultPlan):
    """Install ``plan`` for the duration of the block."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def active() -> Optional[FaultPlan]:
    """The installed plan, else the one in ``PIPELINEDP_TPU_FAULTS``."""
    if _plan is not None:
        return _plan
    spec = os.environ.get(ENV_VAR)
    if spec:
        return plan_from_env(spec)
    return None


def _consume(site: str) -> int:
    n = _counters.get(site, 0)
    _counters[site] = n + 1
    return n


def _record(kind: str, **attrs) -> None:
    """Every injected fault lands in the run ledger: a fault test's record
    says which failures were synthetic."""
    from pipelinedp_tpu_torch import obs
    obs.inc("faults.injected")
    obs.event("fault.injected", kind=kind, **attrs)


def wedged(site: str) -> bool:
    """True when this attempt at ``site`` behaves as a wedged runtime
    (counted per site, deterministic)."""
    plan = active()
    hit = plan is not None and _consume(site) < plan.wedged_init
    if hit:
        _record("wedged_init", site=site)
    return hit


def check_chunk(index: int) -> None:
    plan = active()
    if plan is not None and index in plan.fail_chunks:
        _record("chunk_failure", index=int(index))
        raise ChunkFailure(f"injected failure at streaming chunk {index}")


def check_fetch_hold(index: int) -> None:
    """Holds the first fetch of batch ``index`` when the active plan asks
    for it: the calling worker (the fold thread of the overlapped stream)
    blocks inside its ``ingest.fetch`` span until :func:`release_holds`,
    which is what a wedged device looks like to the rest of the pipeline
    and to the stall watchdog (an ageing active span with no activity
    behind it)."""
    plan = active()
    if plan is None or index not in plan.hold_fetch_batches:
        return
    if _consume(f"hold_fetch.{index}"):
        return  # hold only the first fetch of the batch
    _record("hold_fetch", index=int(index))
    _hold_started.set()
    for _ in range(int(_HOLD_MAX_S / _HOLD_POLL_S)):
        if _hold_release.wait(_HOLD_POLL_S):
            return
    raise RuntimeError(
        f"injected hold at batch {index} was never released within "
        f"{_HOLD_MAX_S:g}s — call faults.release_holds()")


def check_pass_b_chunk(index: int) -> None:
    plan = active()
    if plan is not None and index in plan.fail_pass_b_chunks:
        _record("pass_b_chunk_failure", index=int(index))
        raise ChunkFailure(
            f"injected failure at pass-B sweep batch {index}")


def check_device_loss() -> None:
    """Raises :class:`DeviceLost` when the active plan loses a mesh
    participant at this dispatch. The ordinal is global across the run
    (``install`` resets it, an elastic re-entry does not), so a plan like
    ``lose_device_chunks=(1, 3)`` shrinks the mesh twice: 4 -> 2 -> 1."""
    plan = active()
    if plan is None or not plan.lose_device_chunks:
        return
    n = _consume("device_loss")
    if n in plan.lose_device_chunks:
        _record("device_lost", index=n)
        raise DeviceLost(
            f"injected mesh participant loss at dispatch {n}", index=n)


def check_coordinator() -> None:
    plan = active()
    if (plan is not None and
            _consume("distributed.init") < plan.coordinator_timeouts):
        _record("coordinator_timeout")
        raise CoordinatorTimeout(
            "injected coordinator timeout (a torch.distributed rendezvous "
            "that never answered)")


def check_sweep_config_chunk(index: int) -> None:
    plan = active()
    if plan is not None and index in plan.fail_sweep_config_chunks:
        _record("sweep_config_chunk_failure", index=int(index))
        raise ChunkFailure(
            f"injected failure at sweep config chunk {index}")


def check_sketch_chunk(index: int) -> None:
    plan = active()
    if plan is not None and index in plan.fail_sketch_chunks:
        _record("sketch_chunk_failure", index=int(index))
        raise ChunkFailure(f"injected failure at sketch chunk {index}")


def check_serve_request(index: int) -> None:
    """Raise :class:`ServeKill` when the active plan kills serve
    request ``index`` (admission order) mid-compute. The serve worker
    lets this propagate WITHOUT releasing the budget reserve —
    simulating the process dying between reserve and commit, the
    window the durable ledger's replay semantics exist for."""
    plan = active()
    if plan is not None and index in plan.fail_serve_requests:
        _record("serve_kill", index=int(index))
        raise ServeKill(
            f"injected hard kill at serve request {index} (reserved "
            "budget debit must survive the restart)")
