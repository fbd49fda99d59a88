"""Device health and mesh supervision: the probe with its flagged degrade,
the liveness beats of a mesh's ranks, and the resilient forms of the
mesh and of the rendezvous. A port of
``pipelinedp_tpu/resilience/health.py``.

The probe guards against a wedged runtime: a CUDA init that blocks
forever (or a card that faults at its first launch) would hang any
in-process call, so the probe runs the init and one tiny launch in a
subprocess it can kill. On exhaustion of its retries the caller gets a
``HealthReport`` with ``degraded=True`` and ``DEGRADED_ENV`` is set: every
later ``TorchBackend`` of the process then runs the device path on the
CPU and says so on ``backend.degraded``, the resident service refuses
its submits with the ``"degraded"`` reason, and the ``health.degraded``
event is on the run record. The degrade happens only where a caller
asked for it (``TorchBackend(health_policy=...)``,
``ensure_device_or_degrade``, ``resilient_make_mesh``): without one, a
missing card raises, and no kernel wrapper ever falls back to its plain
version.

The mesh supervisor (``MeshSupervisor``) is the file-based liveness
rendezvous of a port mesh's ranks: before every collective dispatch of
the stream each rank publishes its beat and waits for its peers', so a
rank that died is found by the survivors before they enter the
collective that would wait on it. ``collective_failure_to_loss`` turns
a collective that failed under a rank (its peer died while it waited
inside) into the same verdict, but only when the beat files prove a peer
process dead.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import threading
from datetime import timedelta
from typing import List, Optional

from pipelinedp_tpu_torch.resilience import faults
from pipelinedp_tpu_torch.resilience.clock import Clock, SystemClock
from pipelinedp_tpu_torch.resilience.retry import (RetriesExhausted,
                                                   RetryPolicy,
                                                   call_with_retry)

#: Seconds one probe attempt may take.
PROBE_TIMEOUT_ENV = "PIPELINEDP_TPU_PROBE_TIMEOUT"
DEFAULT_PROBE_TIMEOUT_S = 300.0

#: Poll beat while waiting on the probe subprocess: each beat checks the
#: watchdog's cancel event, so a stalled probe dies at the stall deadline
#: instead of the full timeout.
_PROBE_POLL_S = 0.25

#: What the probe subprocess runs, by the device it probes: the CUDA
#: init and one tiny launch on the card; the CPU runtime for a mesh the
#: caller put on the CPU.
_PROBE_CODE = {
    "cuda": "import torch; torch.zeros(1, device='cuda').sum().item()",
    "cpu": "import torch; torch.zeros(1).sum().item()",
}

#: Set by :func:`cancel_active_probe` (the live monitor's stall action):
#: the probe attempt in flight is killed and reported as cancelled.
#: Cleared at the start of every attempt.
_PROBE_CANCEL = threading.Event()

#: Set when a degrade steered this process off its card: every later
#: ``TorchBackend`` runs on the CPU and reports ``degraded=True``, and the
#: resident service refuses its submits. A later healthy probe through
#: ``ensure_device_or_degrade`` clears it.
DEGRADED_ENV = "PIPELINEDP_TPU_DEGRADED"

DEFAULT_HEALTH_POLICY = RetryPolicy(max_attempts=3, base_delay_s=2.0,
                                    multiplier=2.0, max_delay_s=60.0,
                                    jitter=0.1, seed=0)


def cancel_active_probe() -> None:
    """Aborts the probe attempt in flight, if any: the live monitor's
    ``on_stall`` hook. A probe that shows no activity past the stall
    deadline is almost certainly wedged; it is killed now and the retry
    and degrade take over, instead of waiting out the probe timeout."""
    _PROBE_CANCEL.set()


@dataclasses.dataclass
class HealthReport:
    """The outcome of a probe-with-retry (or a resilient mesh) sequence."""

    healthy: bool
    #: True when execution fell back to the CPU, never silently: callers
    #: carry the flag into their results.
    degraded: bool
    attempts: int
    #: the backoff delays slept (the schedule honoured).
    backoff_s: List[float]
    detail: str = ""


def probe_timeout_s() -> float:
    return float(os.environ.get(PROBE_TIMEOUT_ENV, DEFAULT_PROBE_TIMEOUT_S))


def probe_devices(timeout_s: Optional[float] = None,
                  clock: Optional[Clock] = None, device: str = "cuda"):
    """One probe: the CUDA init and one tiny launch (``device="cpu"``: the
    CPU runtime) in a killable subprocess. The wait polls in short beats,
    so :func:`cancel_active_probe` cuts a wedged probe short. Returns
    ``(ok, detail)``."""
    timeout_s = probe_timeout_s() if timeout_s is None else timeout_s
    clock = clock or SystemClock()
    _PROBE_CANCEL.clear()
    if faults.wedged("device.probe"):
        plan = faults.active()
        if plan is not None and plan.wedged_hold:
            # The blocked window on the injectable clock, in cancellable
            # beats (a FakeClock burns it in no wall time).
            step = min(0.05, timeout_s) if timeout_s > 0 else 0.0
            waited = 0.0
            while waited < timeout_s and step > 0:
                if _PROBE_CANCEL.is_set():
                    return False, (
                        "device probe cancelled by the stall watchdog "
                        f"after {waited:.1f}s (injected wedge)")
                clock.sleep(step)
                waited += step
        return False, (f"device probe did not return within {timeout_s:g}s"
                       " (injected wedge)")
    code = _PROBE_CODE[str(device).split(":")[0]]
    try:
        # stderr goes to a file, not a pipe: nobody drains a pipe during
        # the poll, and a chatty child would block on a full one and read
        # as a wedge.
        with tempfile.TemporaryFile() as errf:
            proc = subprocess.Popen([sys.executable, "-c", code],
                                    stdout=subprocess.DEVNULL, stderr=errf)
            waited = 0.0
            while True:
                try:
                    proc.wait(timeout=_PROBE_POLL_S)
                    break
                except subprocess.TimeoutExpired:
                    waited += _PROBE_POLL_S
                    cancelled = _PROBE_CANCEL.is_set()
                    if cancelled or waited >= timeout_s:
                        proc.kill()
                        proc.wait()
                        if cancelled:
                            return False, (
                                "device probe cancelled by the stall "
                                f"watchdog after {waited:.1f}s (wedged "
                                "runtime?)")
                        return False, (f"device probe did not return "
                                       f"within {timeout_s:g}s")
            errf.seek(0)
            err = errf.read().decode("utf-8", errors="replace")
        if proc.returncode == 0:
            return True, "ok"
        return False, err[-300:]
    except OSError as e:
        return False, f"{type(e).__name__}: {e}"


class _ProbeFailed(Exception):
    """One probe attempt failed; ``str()`` is the probe's detail."""


# --- mesh supervision --------------------------------------------------------

#: The directory of the ranks' beat files. Set (by the harness that starts
#: the ranks; ``launch.RankPool(elastic=True)`` sets it) to arm
#: :func:`supervisor_from_env`; unset, a stream on a mesh runs as before
#: and a lost rank fails its peers' collectives at their timeout.
MESH_DIR_ENV = "PIPELINEDP_TPU_MESH_DIR"
#: Seconds a peer's beat may lag before the supervisor declares it lost
#: (consulted only while its pid is alive: a dead pid is lost at once).
MESH_STALL_ENV = "PIPELINEDP_TPU_MESH_STALL_S"
DEFAULT_MESH_STALL_S = 60.0

#: Poll beat while waiting on peers (rides the injectable clock).
_MESH_POLL_S = 0.02


def mesh_stall_s() -> float:
    return float(os.environ.get(MESH_STALL_ENV, DEFAULT_MESH_STALL_S))


def member_path(mesh_dir: str, rank: int) -> str:
    """The beat file of the rank ``rank`` of the default group."""
    return os.path.join(mesh_dir, f"mesh-{rank}.json")


def pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def read_member(mesh_dir: str, rank: int):
    """A rank's beat document, or None (absent, or a write in flight)."""
    from pipelinedp_tpu_torch.resilience import checkpoint as ckpt_mod
    try:
        return ckpt_mod.read_json(member_path(mesh_dir, rank))
    except ValueError:
        return None


class MeshParticipantLost(Exception):
    """A rank of the mesh died (or stalled) mid-stream. The elastic
    wrapper of ``streaming.py`` treats it like an injected
    :class:`faults.DeviceLost`: re-form the mesh from the survivors and
    resume from the last checkpoint."""

    def __init__(self, msg: str, process_id: int = -1, beat: int = -1,
                 reason: str = ""):
        super().__init__(msg)
        self.process_id = int(process_id)
        self.beat = int(beat)
        self.reason = reason


class MeshSupervisor:
    """File-based liveness rendezvous of a mesh's ranks.

    Every rank writes an atomic member file ``mesh-<rank>.json`` =
    ``{"process_id", "pid", "beat"}`` into the shared
    :data:`MESH_DIR_ENV` directory (``rank`` is the rank of the default
    group, which a re-formed mesh keeps) and bumps ``beat`` once per
    collective dispatch (``gate()``), just before the collective. Before
    dispatching, each rank waits until every peer reached the same beat,
    so a peer that died at dispatch ``n`` is found by the survivors at
    dispatch ``n``, before they enter the collective that would wait on
    it:

    * the peer's pid is gone: :class:`MeshParticipantLost` now;
    * the peer's beat stalled past the stall deadline: the same, with
      ``reason="stalled"``.

    The wait polls on the injectable clock (never ``time.sleep``), so a
    test drives the stall verdict on a ``FakeClock``. ``members`` are the
    peers' ranks (all of ``range(n_processes)`` by default)."""

    def __init__(self, mesh_dir: str, process_id: int, n_processes: int,
                 stall_s: Optional[float] = None,
                 clock: Optional[Clock] = None, members=None):
        from pipelinedp_tpu_torch.resilience import checkpoint as ckpt_mod
        self._ckpt_mod = ckpt_mod
        self.mesh_dir = str(mesh_dir)
        self.process_id = int(process_id)
        self.n_processes = int(n_processes)
        self.members = ([int(m) for m in members] if members is not None
                        else list(range(self.n_processes)))
        self.stall_s = mesh_stall_s() if stall_s is None else float(stall_s)
        self.clock = clock or SystemClock()
        self.beat = 0
        self.state = "forming"
        os.makedirs(self.mesh_dir, exist_ok=True)
        self._write()
        self.state = "formed"

    def _write(self) -> None:
        self._ckpt_mod.atomic_write_json(
            member_path(self.mesh_dir, self.process_id),
            {"process_id": self.process_id, "pid": os.getpid(),
             "beat": self.beat})

    def gate(self) -> None:
        """One collective dispatch: publish my beat, then wait until every
        peer reached it. Raises :class:`MeshParticipantLost` the moment a
        peer is provably gone, before this rank enters the collective."""
        self.beat += 1
        self._write()
        deadline = self.clock.monotonic() + self.stall_s
        while True:
            waiting = []
            for p in self.members:
                if p == self.process_id:
                    continue
                doc = read_member(self.mesh_dir, p)
                if doc is None:
                    waiting.append((p, None))
                    continue
                if int(doc.get("beat", 0)) >= self.beat:
                    continue
                if not pid_alive(int(doc.get("pid", -1))):
                    self._lost(p, "process died",
                               beat=int(doc.get("beat", 0)))
                waiting.append((p, doc))
            if not waiting:
                return
            if self.clock.monotonic() >= deadline:
                p, doc = waiting[0]
                self._lost(p, "stalled",
                           beat=int(doc.get("beat", 0)) if doc else -1)
            self.clock.sleep(_MESH_POLL_S)

    def _lost(self, process_id: int, reason: str, beat: int):
        from pipelinedp_tpu_torch import obs
        self.state = "lost"
        obs.inc("mesh.participant_lost")
        obs.event("mesh.participant_lost", process_id=int(process_id),
                  reason=reason, beat=int(beat), at_beat=int(self.beat))
        raise MeshParticipantLost(
            f"mesh participant {process_id} lost at beat {self.beat} "
            f"({reason})", process_id=process_id, beat=beat, reason=reason)


#: Substrings that mark an error as a failed collective across ranks
#: (torch's gloo and NCCL wording: "Connection closed by peer", "Timed
#: out waiting ... for recv operation", ``DistBackendError``). Matched
#: case-insensitively against ``str(exc)``; text alone never shrinks a
#: mesh.
_COLLECTIVE_FAILURE_MARKERS = (
    "gloo", "nccl", "all-reduce", "allreduce", "all-gather", "allgather",
    "reduce_scatter", "collective", "connection reset", "connection closed",
    "broken pipe", "timed out waiting", "preamble")

#: How long a survivor waits for a suspected peer's pid to exit before it
#: decides the failure was not a lost rank (a dying peer exits within
#: milliseconds; a transient transport error never leaves a dead pid).
_COLLECTIVE_LOSS_CONFIRM_S = 10.0


def collective_failure_to_loss(exc, mesh, clock: Optional[Clock] = None
                               ) -> Optional[MeshParticipantLost]:
    """Maps an error out of a failed collective to
    :class:`MeshParticipantLost`, only when a peer's beat file proves the
    peer dead.

    ``gate()`` catches a peer that died between dispatches; one that dies
    while this rank already waits inside the matching collective surfaces
    here as the transport's error (``RuntimeError``, torch's
    ``DistBackendError``). That error alone is ambiguous, and a transient
    fault must not shrink the mesh, so some peer's recorded pid must be
    gone (polled for a while: the survivor often sees the reset before the
    dying peer's exit lands). None (the caller re-raises) when unarmed, on
    a one-rank mesh, when the error does not read as a collective failure,
    or when every peer is alive."""
    mesh_dir = os.environ.get(MESH_DIR_ENV)
    members = [int(m) for m in getattr(mesh, "devices", ())]
    if (not mesh_dir or not getattr(mesh, "is_multi_process", False)
            or len(members) <= 1):
        return None
    msg = str(exc).lower()
    if not any(m in msg for m in _COLLECTIVE_FAILURE_MARKERS):
        return None
    from pipelinedp_tpu_torch import obs
    clock = clock or SystemClock()
    me = int(getattr(mesh, "rank", -1))
    deadline = clock.monotonic() + _COLLECTIVE_LOSS_CONFIRM_S
    while True:
        for p in members:
            if p == me:
                continue
            doc = read_member(mesh_dir, p)
            if doc is None:
                continue
            pid = int(doc.get("pid", -1))
            if pid > 0 and not pid_alive(pid):
                beat = int(doc.get("beat", 0))
                obs.inc("mesh.participant_lost")
                obs.event("mesh.participant_lost", process_id=p,
                          reason="collective_failure", beat=beat,
                          at_beat=-1)
                return MeshParticipantLost(
                    f"mesh participant {p} died mid-collective "
                    f"({str(exc)[:300]})", process_id=p, beat=beat,
                    reason="collective_failure")
        if clock.monotonic() >= deadline:
            return None
        clock.sleep(_MESH_POLL_S)


def supervisor_from_env(mesh) -> Optional[MeshSupervisor]:
    """A :class:`MeshSupervisor` for ``mesh`` when :data:`MESH_DIR_ENV` is
    armed and the mesh has more than one rank; None otherwise."""
    mesh_dir = os.environ.get(MESH_DIR_ENV)
    if not mesh_dir or mesh is None or int(mesh.size) <= 1:
        return None
    return MeshSupervisor(mesh_dir, mesh.rank, mesh.size,
                          members=[int(m) for m in mesh.devices])


# --- the probe with its degrade ---------------------------------------------

def ensure_device_or_degrade(policy: Optional[RetryPolicy] = None,
                             clock: Optional[Clock] = None,
                             timeout_s: Optional[float] = None,
                             env=None, device: str = "cuda") -> HealthReport:
    """Probes the card under bounded retry and backoff; on exhaustion
    degrades: sets :data:`DEGRADED_ENV` in ``env`` (so every later
    ``TorchBackend`` runs on the CPU, flagged) and reports
    ``degraded=True``. Never raises: the caller always gets an honest
    report. A healthy probe after a degrade lifts the flag.

    ``env`` defaults to ``os.environ``, the mapping the backends read. A
    mapping of the caller's own is a test seam: it records what the call
    would install without touching the process."""
    policy = policy or DEFAULT_HEALTH_POLICY
    env = os.environ if env is None else env
    attempts = [0]
    backoffs: List[float] = []

    from pipelinedp_tpu_torch import obs

    def attempt():
        attempts[0] += 1
        # The span makes the probe visible to the live monitor: its open
        # is activity, and a probe that then blocks ages as an active span
        # the watchdog can diagnose and cancel.
        with obs.tracer().span("health.device_probe", cat="health",
                               attempt=attempts[0]):
            ok, detail = probe_devices(timeout_s, clock=clock, device=device)
        if not ok:
            raise _ProbeFailed(detail)
        return detail

    try:
        detail = call_with_retry(
            attempt, policy, clock, retry_on=(_ProbeFailed,),
            on_retry=lambda a, d, e: backoffs.append(d),
            label="health.device_probe")
        if env.get(DEGRADED_ENV):
            # The card recovered: lift the degrade this module installed.
            env.pop(DEGRADED_ENV, None)
            obs.event("health.recovered", attempts=attempts[0])
        return HealthReport(healthy=True, degraded=False,
                            attempts=attempts[0], backoff_s=backoffs,
                            detail=detail)
    except RetriesExhausted as e:
        env[DEGRADED_ENV] = "1"
        obs.inc("health.degradations")
        obs.event("health.degraded", target="cpu_platform",
                  attempts=attempts[0], detail=str(e.last_error))
        return HealthReport(healthy=False, degraded=True,
                            attempts=attempts[0], backoff_s=backoffs,
                            detail=str(e.last_error))


#: The detail of a rank degraded because a peer's probe failed.
PEER_DEGRADED = "a peer rank's device probe failed"


def agree_degraded(degraded: bool, pg) -> bool:
    """One verdict for every rank of the gloo group ``pg``: True when any
    rank is degraded (a MAX all-reduce of the flags). A rank that left a
    mesh alone would leave its peers waiting in the mesh's collectives
    until their timeout, and then re-forming without it: every rank of
    the group calls this at the same point and acts on the one verdict."""
    import torch

    from pipelinedp_tpu_torch.parallel import sharded
    flag = torch.tensor([int(degraded)], dtype=torch.int32)
    return bool(int(sharded.all_reduce_max(pg, flag)))


def resilient_make_mesh(n_devices: Optional[int] = None,
                        axis_name: str = "data",
                        policy: Optional[RetryPolicy] = None,
                        clock: Optional[Clock] = None,
                        backend: Optional[str] = None, device=None,
                        probe_timeout: Optional[float] = None):
    """``parallel.sharded.make_mesh`` behind the probe, under bounded
    retry; on exhaustion a mesh over the same ranks on the CPU (gloo).
    Returns ``(mesh, HealthReport)``: a degraded mesh is a correct mesh,
    slower, and the report says so (``health.degraded`` with
    ``target="cpu_mesh"``).

    Each attempt runs the killable subprocess probe of the mesh's device
    first: a wedged runtime blocks inside the CUDA init, so making the
    mesh directly could hang. The ranks then agree on one verdict (any
    rank degraded degrades them all) over a gloo all-reduce, so that
    every rank makes the same mesh. Every rank of the default group calls
    it at the same point, as ``make_mesh``."""
    import torch
    import torch.distributed as dist

    from pipelinedp_tpu_torch import obs
    from pipelinedp_tpu_torch.parallel import sharded

    policy = policy or DEFAULT_HEALTH_POLICY
    attempts = [0]
    backoffs: List[float] = []
    target = "cpu" if device is not None and torch.device(
        device).type == "cpu" else "cuda"

    def attempt():
        attempts[0] += 1
        if faults.wedged("mesh.init"):
            raise TimeoutError(
                "injected wedge: mesh construction did not return")
        ok, detail = probe_devices(probe_timeout, clock=clock,
                                   device=target)
        if not ok:
            raise TimeoutError(detail)
        return detail

    detail = "ok"
    degraded = False
    try:
        call_with_retry(attempt, policy, clock,
                        retry_on=(RuntimeError, TimeoutError),
                        on_retry=lambda a, d, e: backoffs.append(d),
                        label="health.make_mesh")
    except RetriesExhausted as e:
        degraded, detail = True, str(e.last_error)
    if dist.is_initialized() and dist.get_world_size() > 1:
        gloo = (dist.group.WORLD if str(dist.get_backend()).lower() == "gloo"
                else dist.new_group(backend="gloo"))
        if agree_degraded(degraded, gloo) and not degraded:
            degraded, detail = True, PEER_DEGRADED
    if not degraded:
        mesh = sharded.make_mesh(n_devices, axis_name, backend=backend,
                                 device=device)
        return mesh, HealthReport(healthy=True, degraded=False,
                                  attempts=attempts[0], backoff_s=backoffs,
                                  detail=detail)
    mesh = sharded.make_mesh(n_devices, axis_name, backend="gloo",
                             device="cpu")
    obs.inc("health.degradations")
    obs.event("health.degraded", target="cpu_mesh",
              n_devices=int(mesh.size), attempts=attempts[0], detail=detail)
    return mesh, HealthReport(healthy=False, degraded=True,
                              attempts=attempts[0], backoff_s=backoffs,
                              detail=detail)


def resilient_init_process_group(backend: str, rank: int, world_size: int,
                                 store=None, timeout_s: float = 300.0,
                                 policy: Optional[RetryPolicy] = None,
                                 clock: Optional[Clock] = None) -> None:
    """``torch.distributed.init_process_group`` under bounded retry (a
    rendezvous loses races on a busy host): the counterpart of the JAX
    package's ``resilient_distributed_initialize``. Each attempt passes
    ``faults.check_coordinator()`` first; the jitter is seeded by the
    rank, so the ranks do not retry in lockstep. Raises
    ``RetriesExhausted`` when the rendezvous never answers: a deadline,
    not a hang."""
    import torch.distributed as dist

    policy = policy or RetryPolicy(max_attempts=2, base_delay_s=1.0,
                                   multiplier=2.0, max_delay_s=10.0,
                                   jitter=0.25, seed=int(rank))

    def attempt():
        faults.check_coordinator()
        try:
            dist.init_process_group(
                backend, store=store, rank=rank,
                world_size=world_size, timeout=timedelta(seconds=timeout_s))
        except Exception:
            # A failed rendezvous may leave the default group assigned;
            # without this every retry would fail at once.
            if dist.is_initialized():
                dist.destroy_process_group()
            raise

    call_with_retry(attempt, policy, clock,
                    retry_on=(RuntimeError, TimeoutError,
                              faults.CoordinatorTimeout),
                    label="health.init_process_group")
