"""Starting N ranks: spawned processes joined in one ``torch.distributed``
group, each returning its result.

The port's counterpart of the JAX package's ``jax.distributed``
rendezvous. The ranks meet at a ``FileStore`` in a fresh temporary
directory, not at a TCP port the parent picks: a port picked by the
parent can be taken by another process before the ranks bind it, and a
file in a directory of its own belongs to this pool alone. The group gets
``timeout=`` so a collective that waits for a dead peer fails instead of
waiting forever. Each rank joins through
``resilience.health.resilient_init_process_group`` (bounded retry, the
``coordinator_timeouts`` fault site).

Every wait of the parent has a deadline. Past it, or as soon as one rank
fails or dies, the parent kills every rank and raises: the peers of a
failed rank would otherwise wait in a collective that can never
complete. A later ``run`` starts a fresh group.

An ELASTIC pool (``elastic=True``) lets its ranks survive a lost peer:
it arms the mesh supervisor (``PIPELINEDP_TPU_MESH_DIR``, a directory of
the pool), a rank that dies is recorded instead of failing the call, and
``run`` returns the survivors' results, with a ``RankGone`` marker in the
place of each rank that died or left the re-formed mesh
(``parallel.sharded.MeshDeparted``). A rank that raises anything else
still fails the call, and the deadline still holds for every wait.

    with RankPool(4) as pool:                  # gloo on the CPU
        results = pool.run(module.fn, arg)     # fn(arg) on every rank

``fn`` runs on every rank and must be importable by the spawned process
(a module-level function); its arguments and result are pickled. Inside
it, ``parallel.make_mesh(device=...)`` makes the rank's mesh.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

#: Seconds one ``run`` may take, from the start of the ranks (when the run
#: starts them) to the last rank's result.
DEFAULT_DEADLINE_S = 600.0


class RankFailure(RuntimeError):
    """A rank raised, died or missed the deadline; every rank was killed."""


class RankGone:
    """The result of a rank that did not finish a call of an elastic pool:
    ``reason`` is ``"departed"`` (it left the re-formed mesh, alive) or
    ``"died"`` (its process ended; ``detail`` holds the exit code)."""

    def __init__(self, rank: int, reason: str, detail: str = ""):
        self.rank = int(rank)
        self.reason = reason
        self.detail = detail

    def __repr__(self) -> str:
        return f"RankGone(rank={self.rank}, reason={self.reason!r})"

    def __eq__(self, other) -> bool:
        return (isinstance(other, RankGone) and other.rank == self.rank
                and other.reason == self.reason)


def _rank_main(rank: int, world_size: int, store_path: str, backend: str,
               timeout_s: float, threads: Optional[int], tasks, results,
               mesh_dir: Optional[str] = None) -> None:
    """One rank: join the group, then run tasks until a None arrives."""
    os.environ["RANK"] = str(rank)
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["WORLD_SIZE"] = str(world_size)
    if mesh_dir:
        from pipelinedp_tpu_torch.resilience import health
        os.environ[health.MESH_DIR_ENV] = mesh_dir
    import torch
    import torch.distributed as dist

    from pipelinedp_tpu_torch.parallel.sharded import MeshDeparted
    from pipelinedp_tpu_torch.resilience.health import (
        resilient_init_process_group)
    if threads:
        torch.set_num_threads(threads)
    resilient_init_process_group(
        backend, rank, world_size,
        store=dist.FileStore(store_path, world_size), timeout_s=timeout_s)
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, args, kwargs, env = task
            saved = {k: os.environ.get(k) for k in env}
            for k, v in env.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            try:
                results.put((rank, "ok", fn(*args, **kwargs)))
            except MeshDeparted as e:
                results.put((rank, "departed", str(e)))
            except BaseException:  # reported to the parent, which raises
                results.put((rank, "error", traceback.format_exc()))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world_size`` ranks in spawned processes, one group over a file
    store, reused by every ``run`` until ``close`` (or a failure)."""

    def __init__(self, world_size: int, backend: str = "gloo",
                 timeout_s: float = 300.0,
                 deadline_s: float = DEFAULT_DEADLINE_S,
                 threads: Optional[int] = None, elastic: bool = False):
        self.world_size = int(world_size)
        self.backend = backend
        self.timeout_s = float(timeout_s)
        self.deadline_s = float(deadline_s)
        self.threads = threads
        self.elastic = bool(elastic)
        self._procs: List = []
        self._tasks: List = []
        self._results = None
        self._dir: Optional[str] = None

    def __enter__(self) -> "RankPool":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(
            p.pid is not None and p.is_alive() for p in self._procs)

    @property
    def mesh_dir(self) -> Optional[str]:
        """The directory of the ranks' beat files (an elastic pool's)."""
        if not self.elastic or self._dir is None:
            return None
        return os.path.join(self._dir, "mesh")

    def start(self) -> None:
        """Starts the ranks now (a ``run`` starts them when they are not
        running). The ranks inherit the environment of this moment."""
        if not self.alive:
            self.close()
            self._start()

    def _start(self) -> None:
        ctx = mp.get_context("spawn")
        self._dir = tempfile.mkdtemp(prefix="pdp_ranks_")
        store = os.path.join(self._dir, "rendezvous")
        if self.elastic:
            os.makedirs(self.mesh_dir)
        self._results = ctx.Queue()
        self._tasks = [ctx.Queue() for _ in range(self.world_size)]
        self._procs = [
            ctx.Process(target=_rank_main, name=f"pdp-rank-{r}", daemon=True,
                        args=(r, self.world_size, store, self.backend,
                              self.timeout_s, self.threads, self._tasks[r],
                              self._results, self.mesh_dir))
            for r in range(self.world_size)]
        try:
            for p in self._procs:
                p.start()
        except BaseException:
            self.kill()
            raise

    def run(self, fn: Callable, *args,
            env: Optional[Dict[str, Optional[str]]] = None,
            rank_env: Optional[Dict[int, Dict[str, Optional[str]]]] = None,
            deadline_s: Optional[float] = None, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; returns the results by
        rank. ``env`` sets (or, with None, unsets) environment variables
        for the call, and ``rank_env[r]`` more of them on rank ``r`` alone
        (a fault plan for one rank, say). Raises ``RankFailure`` when a
        rank raises, or (unless the pool is elastic) dies, or the deadline
        passes, after killing every rank. An elastic pool returns a
        ``RankGone`` in the place of a rank that died or departed."""
        self.start()
        name = getattr(fn, "__name__", fn)
        deadline = time.monotonic() + (self.deadline_s if deadline_s is None
                                       else float(deadline_s))
        for r, q in enumerate(self._tasks):
            call_env = dict(env or {})
            call_env.update((rank_env or {}).get(r, {}))
            q.put((fn, args, kwargs, call_env))
        got: Dict[int, Any] = {}
        while len(got) < self.world_size:
            try:
                rank, status, value = self._results.get(timeout=0.2)
            except queue.Empty:
                if time.monotonic() > deadline:
                    self._fail(f"{name} missed its deadline with {len(got)} "
                               f"of {self.world_size} ranks done")
                dead = [r for r, p in enumerate(self._procs)
                        if not p.is_alive() and r not in got]
                if dead and not self.elastic:
                    self._fail(f"rank process(es) "
                               f"{[self._procs[r].name for r in dead]} died "
                               f"during {name}")
                for r in dead:
                    # A result it put before it died is still in flight.
                    got.update(self._drain())
                    if r not in got:
                        got[r] = RankGone(r, "died",
                                          str(self._procs[r].exitcode))
                continue
            if status == "departed":
                got[rank] = RankGone(rank, "departed", value)
                continue
            if status != "ok":
                self._fail(f"rank {rank} raised:\n{value}")
            got[rank] = value
        return [got[r] for r in range(self.world_size)]

    def _drain(self) -> Dict[int, Any]:
        """The results already queued (an elastic pool reads them before it
        marks a rank dead)."""
        out: Dict[int, Any] = {}
        while True:
            try:
                rank, status, value = self._results.get(timeout=0.5)
            except queue.Empty:
                return out
            if status == "error":
                self._fail(f"rank {rank} raised:\n{value}")
            out[rank] = (RankGone(rank, "departed", value)
                         if status == "departed" else value)

    def _fail(self, why: str) -> None:
        self.kill()
        raise RankFailure(why)

    def kill(self) -> None:
        """Ends every rank at once (no clean exit: a rank may be waiting in
        a collective that can never complete)."""
        started = [p for p in self._procs if p.pid is not None]
        for p in started:
            if p.is_alive():
                p.kill()
        for p in started:
            p.join(timeout=10)
        self._cleanup()

    def close(self) -> None:
        """Asks every rank to leave the group and exit; kills the ones that
        do not within a few seconds."""
        if self._procs:
            for q in self._tasks:
                try:
                    q.put(None)
                except (OSError, ValueError):
                    pass
            end = time.monotonic() + 10.0
            for p in self._procs:
                p.join(timeout=max(0.0, end - time.monotonic()))
        self.kill()

    def _cleanup(self) -> None:
        for q in self._tasks + ([self._results] if self._results else []):
            q.close()
            q.cancel_join_thread()
        self._procs, self._tasks, self._results = [], [], None
        if self._dir is not None:
            shutil.rmtree(self._dir, ignore_errors=True)
            self._dir = None


def run_ranks(world_size: int, fn: Callable, *args, backend: str = "gloo",
              deadline_s: float = DEFAULT_DEADLINE_S,
              env: Optional[Dict[str, Optional[str]]] = None,
              threads: Optional[int] = None, **kwargs) -> List[Any]:
    """One-shot: starts ``world_size`` ranks, runs ``fn`` on each, stops
    them, returns the results by rank."""
    with RankPool(world_size, backend=backend, deadline_s=deadline_s,
                  threads=threads) as pool:
        return pool.run(fn, *args, env=env, **kwargs)
