"""Cancellable worker threads for the overlapped streaming ingest.

Threading model (one producer and one consumer per queue, as the stream
in ``pipelinedp_tpu_torch/streaming.py`` uses them)::

    stager thread ──staged queue──> dispatch (caller) ──fold queue──> fold thread

The dispatch thread is the caller's own: it takes staged batches, runs
the fault-injection check, launches the batch's device work (asynchronous
on a card) and submits the launched batch to the fold worker. The fold
worker fetches each batch's results, which waits for that batch's work
alone, so the dispatch thread never waits on the device and the stager
never waits on the fold.

Every blocking primitive here polls with a short timeout instead of
waiting forever, checking a cancel event (and, through ``poll``
callbacks, the health of the peer worker) on each beat. That makes the
pipeline drainable: when fault injection raises ``ChunkFailure`` on the
dispatch thread, ``close()`` and ``cancel()`` unblock every queue and
semaphore, the threads exit after at most one item in flight, and the
joins leave no orphan thread.

Worker exceptions are captured and raised again on the dispatch thread at
its next interaction (``submit``, iteration, ``finish``), never
swallowed. A port of ``pipelinedp_tpu/ingest/executor.py``.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Callable, Iterable, Iterator, Optional

#: Every thread this package starts carries this name prefix, so tests can
#: assert that a severed run left no orphans.
THREAD_PREFIX = "pdp-ingest"

#: Seconds between cancel and health polls while blocked on a queue or the
#: staging ring.
_POLL_S = 0.02

ENV_VAR = "PIPELINEDP_TPU_INGEST_EXECUTOR"


def executor_enabled() -> bool:
    """The overlapped executor is on unless ``PIPELINEDP_TPU_INGEST_EXECUTOR``
    is ``0``, ``false`` or ``off``, which selects the serial stream."""
    return os.environ.get(ENV_VAR, "1").lower() not in ("0", "false", "off")


class IngestCancelled(Exception):
    """Raised inside a worker blocked on a queue or the ring while the
    pipeline is torn down; never reaches the caller."""


class StagingRing:
    """Reuse gate for a rotating set of staging buffers.

    The stager writes batch b into buffer set ``b % n_slots`` and ships
    it; on the card the copy to the device is asynchronous, so the set
    must not be written again until nothing can still read batch b's
    bytes. ``acquire()`` blocks the stager before it reuses a set;
    ``retire()`` is called by the consumer once batch b's device outputs
    have been fetched (a fetch proves the work ran, so its inputs were
    read). With ``n_slots=2`` this is double buffering: batch b+1 stages
    while batch b computes, and batch b+2 waits for b's fetch.
    """

    def __init__(self, n_slots: int = 2):
        self.n_slots = n_slots
        self._sem = threading.Semaphore(n_slots)

    def acquire(self, cancelled: Optional[threading.Event] = None) -> None:
        while not self._sem.acquire(timeout=_POLL_S):
            if cancelled is not None and cancelled.is_set():
                raise IngestCancelled()

    def retire(self) -> None:
        self._sem.release()


class _CaptureThread(threading.Thread):
    """A worker thread that keeps its body's exception for the dispatch
    thread to raise (``IngestCancelled`` is a clean exit). Its name starts
    with ``THREAD_PREFIX``."""

    def __init__(self, body, name: str):
        super().__init__(name=f"{THREAD_PREFIX}-{name}", daemon=True)
        self._body = body
        self.exc: Optional[BaseException] = None

    def run(self):
        try:
            self._body()
        except IngestCancelled:
            pass
        except BaseException as e:  # raised again by the owner, not lost
            self.exc = e


class BackgroundStager:
    """Runs a staging generator on a worker thread, one batch ahead.

    ``gen_factory(cancelled)`` builds the generator; it receives the
    cancel event so that staging primitives that block (``StagingRing``)
    abort a teardown promptly. ``depth`` bounds the handoff queue: the
    default 1, plus the item the caller holds, is the double buffer.

    Iterate with :meth:`items` (``poll`` runs on every wait beat: pass the
    fold worker's ``raise_if_failed`` so that a dead consumer cannot
    deadlock the pipeline). Always ``close()`` it (or use it as a context
    manager): that cancels, unblocks and joins the thread, and raises any
    staging exception not delivered yet.
    """

    def __init__(self, gen_factory: Callable[[threading.Event], Iterable],
                 depth: int = 1, name: str = "stager"):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._cancelled = threading.Event()
        self._done = object()  # sentinel: generator exhausted
        self._raised = False
        gen = gen_factory(self._cancelled)

        def body():
            try:
                for item in gen:
                    self._put(item)
            finally:
                getattr(gen, "close", lambda: None)()
                self._put(self._done, sentinel=True)

        self._thread = _CaptureThread(body, name)
        self._thread.start()

    def _put(self, item, sentinel: bool = False) -> None:
        while True:
            try:
                self._q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                if not self._cancelled.is_set():
                    continue  # consumer alive: keep waiting for room
                if not sentinel:
                    raise IngestCancelled()
                # Teardown with a full queue: the staged items will never
                # be consumed, so drop one to make room for the sentinel.
                try:
                    self._q.get_nowait()
                except queue.Empty:
                    pass

    def items(self, poll: Optional[Callable[[], None]] = None) -> Iterator:
        """Yields the staged batches in order; raises stager exceptions.
        ``poll()`` runs on every wait beat."""
        while True:
            try:
                item = self._q.get(timeout=_POLL_S)
            except queue.Empty:
                if poll is not None:
                    poll()
                if self._thread.exc is not None:
                    self._raised = True
                    raise self._thread.exc
                continue
            if item is self._done:
                if self._thread.exc is not None:
                    self._raised = True
                    raise self._thread.exc
                return
            yield item

    def __iter__(self) -> Iterator:
        return self.items()

    def close(self) -> None:
        """Cancel and join; raise a staging error not delivered yet."""
        self._cancelled.set()
        while self._thread.is_alive():
            try:  # drain so that a blocked put wakes at once
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=_POLL_S)
        if self._thread.exc is not None and not self._raised:
            self._raised = True
            raise self._thread.exc

    def __enter__(self) -> "BackgroundStager":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:  # already unwinding: do not mask the original error
            try:
                self.close()
            except BaseException:
                pass


class OrderedFoldWorker:
    """Drains a bounded FIFO of launched batches on one worker thread,
    applying ``fold_fn(item)`` strictly in submission order: the left-fold
    sequence of the serial path, so the float64 accumulators and the
    checkpoints written inside ``fold_fn`` are bit-identical.

    ``submit`` blocks on backpressure (bounding the batches in flight on
    the device) and raises a fold failure instead of wedging when the
    worker died. ``finish`` waits for every submitted fold, then joins.
    ``cancel`` severs: the worker stops after the fold in progress, queued
    batches are dropped (the checkpointed prefix stays a valid resume
    point), and the thread is joined.
    """

    def __init__(self, fold_fn: Callable, depth: int = 2,
                 name: str = "fold"):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._cancelled = threading.Event()
        self._done = object()

        def body():
            while True:
                try:
                    item = self._q.get(timeout=_POLL_S)
                except queue.Empty:
                    if self._cancelled.is_set():
                        return
                    continue
                if item is self._done or self._cancelled.is_set():
                    return
                fold_fn(item)

        self._thread = _CaptureThread(body, name)
        self._thread.start()

    def raise_if_failed(self) -> None:
        if self._thread.exc is not None:
            exc = self._thread.exc
            self._thread.exc = None
            raise exc

    def submit(self, item) -> None:
        while True:
            self.raise_if_failed()
            if not self._thread.is_alive():
                raise RuntimeError("fold worker exited early")
            try:
                self._q.put(item, timeout=_POLL_S)
                return
            except queue.Full:
                continue

    def finish(self) -> None:
        """Fold everything submitted, stop, join, raise any error."""
        while True:
            self.raise_if_failed()
            try:
                self._q.put(self._done, timeout=_POLL_S)
                break
            except queue.Full:
                continue
        while self._thread.is_alive():
            self._thread.join(timeout=_POLL_S)
            self.raise_if_failed()
        self.raise_if_failed()

    def cancel(self) -> None:
        """Sever: drop queued batches, stop after the fold in progress,
        join. Fold errors are not raised here (cancel runs while another
        exception is already unwinding)."""
        self._cancelled.set()
        while self._thread.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=_POLL_S)
