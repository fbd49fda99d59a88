"""Deterministic fault injection at the chunk sites of the stream.

A ``FaultPlan`` names the faults to inject; the stream
(``pipelinedp_tpu_torch/streaming.py``) consults the active plan at two
sites:

* ``check_chunk(b)``: raise ``ChunkFailure`` when pass A reaches batch
  ``b`` (kills a streamed run mid-flight);
* ``check_pass_b_chunk(b)``: the same for batch ``b`` of a percentile
  pass-B sweep (pass A reuses the batch indices and survives, so the kill
  lands mid-sweep);
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

A plan installs in process, with the ``injected_faults(plan)`` context
manager. A port of the chunk, sweep, sketch and serve sites of
``pipelinedp_tpu/resilience/faults.py``; its other sites (coordinator,
mesh, fetch holds) and its ``PIPELINEDP_TPU_FAULTS`` transport to
subprocess harnesses belong to ROADMAP steps 5b and 7b.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple


class FaultInjected(Exception):
    """Base class for injected faults."""


class ChunkFailure(FaultInjected):
    """Injected failure while processing one streaming chunk."""


class ServeKill(FaultInjected):
    """Injected hard kill of a resident-service request mid-compute
    (between the durable budget reserve and its commit/release)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    #: streaming batch indices whose pass-A dispatch raises
    #: ``ChunkFailure``.
    fail_chunks: Tuple[int, ...] = ()
    #: batch indices whose percentile pass-B dispatch raises
    #: ``ChunkFailure``.
    fail_pass_b_chunks: Tuple[int, ...] = ()
    #: utility-analysis sweep config-chunk indices whose dispatch raises
    #: ``ChunkFailure``.
    fail_sweep_config_chunks: Tuple[int, ...] = ()
    #: sketch-accumulation chunk indices whose dispatch raises
    #: ``ChunkFailure`` (kills a sketch-first phase 1 mid-stream; the
    #: ingest stager must drain to zero orphan ``pdp-*`` threads).
    fail_sketch_chunks: Tuple[int, ...] = ()
    #: serve-request admission indices (0-based, in admission order)
    #: whose compute raises ``ServeKill`` mid-request — AFTER the
    #: durable budget reserve, BEFORE commit/release. The resident
    #: service treats any ``FaultInjected`` as a hard process kill:
    #: the reserved debit stands (noise may already have been drawn).
    fail_serve_requests: Tuple[int, ...] = ()


_plan: Optional[FaultPlan] = None


def install(plan: FaultPlan) -> None:
    global _plan
    _plan = plan


def clear() -> None:
    global _plan
    _plan = None


@contextlib.contextmanager
def injected_faults(plan: FaultPlan):
    """Install ``plan`` for the duration of the block."""
    install(plan)
    try:
        yield plan
    finally:
        clear()


def _record(kind: str, **attrs) -> None:
    """Every injected fault lands in the run ledger: a fault test's record
    says which failures were synthetic."""
    from pipelinedp_tpu_torch import obs
    obs.inc("faults.injected")
    obs.event("fault.injected", kind=kind, **attrs)


def check_chunk(index: int) -> None:
    plan = _plan
    if plan is not None and index in plan.fail_chunks:
        _record("chunk_failure", index=int(index))
        raise ChunkFailure(f"injected failure at streaming chunk {index}")


def check_pass_b_chunk(index: int) -> None:
    plan = _plan
    if plan is not None and index in plan.fail_pass_b_chunks:
        _record("pass_b_chunk_failure", index=int(index))
        raise ChunkFailure(
            f"injected failure at pass-B sweep batch {index}")


def check_sweep_config_chunk(index: int) -> None:
    plan = _plan
    if plan is not None and index in plan.fail_sweep_config_chunks:
        _record("sweep_config_chunk_failure", index=int(index))
        raise ChunkFailure(
            f"injected failure at sweep config chunk {index}")


def check_sketch_chunk(index: int) -> None:
    plan = _plan
    if plan is not None and index in plan.fail_sketch_chunks:
        _record("sketch_chunk_failure", index=int(index))
        raise ChunkFailure(f"injected failure at sketch chunk {index}")


def check_serve_request(index: int) -> None:
    """Raise :class:`ServeKill` when the active plan kills serve
    request ``index`` (admission order) mid-compute. The serve worker
    lets this propagate WITHOUT releasing the budget reserve —
    simulating the process dying between reserve and commit, the
    window the durable ledger's replay semantics exist for."""
    plan = _plan
    if plan is not None and index in plan.fail_serve_requests:
        _record("serve_kill", index=int(index))
        raise ServeKill(
            f"injected hard kill at serve request {index} (reserved "
            "budget debit must survive the restart)")
