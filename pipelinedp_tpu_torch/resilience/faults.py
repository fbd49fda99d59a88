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
  between the stager's handoff and the binner.

A plan installs in process, with the ``injected_faults(plan)`` context
manager. A port of the chunk, sweep and sketch sites of
``pipelinedp_tpu/resilience/faults.py``; its other sites (serve,
coordinator, mesh) and its ``PIPELINEDP_TPU_FAULTS`` transport to
subprocess harnesses belong to later ROADMAP steps.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple


class FaultInjected(Exception):
    """Base class for injected faults."""


class ChunkFailure(FaultInjected):
    """Injected failure while processing one streaming chunk."""


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
