"""Request-scoped causal trace context.

The run ledger is process-global: once a resident service interleaves
two tenants' requests, their spans and events land in one flat list
and a single request's journey — admission → budget reserve → fuse
bucket → batched dispatch → release → commit → books — cannot be
reconstructed after the fact. This module is the identity that makes
the flat ledger causally separable again:

* a :class:`TraceContext` is an immutable ``(trace_id, tenant,
  request_id, parent_span_id)`` tuple carried in a
  :class:`contextvars.ContextVar`;
* ``obs/tracer.py`` stamps the bound context onto every span and event
  it records (span stamping only when ``PIPELINEDP_TPU_TRACE`` is on —
  the zero-overhead-off discipline; events record always and stamp
  whenever a context is bound);
* **contextvars do NOT flow into threads**: the serve layer hands off
  work across the admission thread → ``pdp-serve-fuse`` fuser →
  worker → host release tail, so it ``capture()``\\ s the context onto
  the queued item at admission and ``restore()``\\ s it on every thread
  that later acts for that request. Nothing here sniffs thread
  identity — propagation is explicit or it does not happen;
* span PARENTAGE rides the same context: a recorded span allocates a
  process-unique ``span_id`` and pushes itself as the current parent
  for its dynamic extent, so ``/trace/<id>`` and ``store --summarize
  --trace-id`` can rebuild the span TREE, not just the span set.

Stamping is telemetry-only — it never touches datasets, budgets, or
noise, so trace on/off stays DP-bit-identical (PARITY row 42).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import uuid
from typing import Any, Dict, Iterator, Optional

#: The one context variable. ``None`` means "no request context bound"
#: — the batch path's default, costing one ContextVar read per stamp.
_CURRENT: contextvars.ContextVar[Optional["TraceContext"]] = (
    contextvars.ContextVar("pdp_trace_context", default=None))

#: Process-unique span ids (itertools.count is atomic under the GIL).
_SPAN_IDS = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One request's causal identity. Immutable — thread handoffs share
    the instance; re-parenting derives a new one (:func:`child_of`)."""
    trace_id: str
    tenant: Optional[str] = None
    request_id: Optional[str] = None
    parent_span_id: Optional[int] = None


def new_trace_id() -> str:
    """A fresh 16-hex trace id (collision-safe per uuid4)."""
    return uuid.uuid4().hex[:16]


def next_span_id() -> int:
    """Allocate a process-unique span id."""
    return next(_SPAN_IDS)


def current() -> Optional[TraceContext]:
    """The context bound on THIS thread's execution context, if any."""
    return _CURRENT.get()


#: Alias spelling the thread-handoff half of the contract: the serve
#: layer captures at admission and restores on each acting thread.
capture = current


@contextlib.contextmanager
def bind(trace_id: Optional[str] = None, tenant: Optional[str] = None,
         request_id: Optional[str] = None,
         parent_span_id: Optional[int] = None
         ) -> Iterator[TraceContext]:
    """Bind a (new or explicit) context for the ``with`` body."""
    ctx = TraceContext(trace_id=trace_id or new_trace_id(),
                       tenant=tenant, request_id=request_id,
                       parent_span_id=parent_span_id)
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


@contextlib.contextmanager
def restore(ctx: Optional[TraceContext]) -> Iterator[Optional[TraceContext]]:
    """Re-enter a captured context on another thread (``None`` is a
    no-op pass-through, so call sites need no branch)."""
    if ctx is None:
        yield None
        return
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def child_of(span_id: int) -> Optional[contextvars.Token]:
    """Make ``span_id`` the current parent for the bound context's
    dynamic extent; returns the reset token (``None`` when no context
    is bound). The tracer pushes this on span enter / pops on exit so
    nested spans record their true parent."""
    ctx = _CURRENT.get()
    if ctx is None:
        return None
    return _CURRENT.set(dataclasses.replace(ctx, parent_span_id=span_id))


def pop(token: Optional[contextvars.Token]) -> None:
    """Undo a :func:`child_of` push (``None`` token: no-op)."""
    if token is not None:
        _CURRENT.reset(token)


def stamp_span_args(args: Dict[str, Any]) -> None:
    """Merge the bound context into a span's args in place, allocating
    the span's own id. No context bound → args untouched. Explicit
    caller-passed keys win (``setdefault``)."""
    ctx = _CURRENT.get()
    if ctx is None:
        return
    args.setdefault("trace_id", ctx.trace_id)
    args.setdefault("span_id", next_span_id())
    if ctx.parent_span_id is not None:
        args.setdefault("parent_span", ctx.parent_span_id)
    if ctx.tenant is not None:
        args.setdefault("tenant", ctx.tenant)
    if ctx.request_id is not None:
        args.setdefault("request_id", ctx.request_id)


def stamp_event_attrs(attrs: Dict[str, Any]) -> None:
    """Merge the bound context into an event's attrs in place (events
    carry no span id of their own — they hang off the parent span)."""
    ctx = _CURRENT.get()
    if ctx is None:
        return
    attrs.setdefault("trace_id", ctx.trace_id)
    if ctx.parent_span_id is not None:
        attrs.setdefault("parent_span", ctx.parent_span_id)
    if ctx.tenant is not None:
        attrs.setdefault("tenant", ctx.tenant)
    if ctx.request_id is not None:
        attrs.setdefault("request_id", ctx.request_id)
