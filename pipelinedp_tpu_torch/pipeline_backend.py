"""Pipeline backends: the data-plane abstraction the engine builds graphs
against. A copy of ``pipelinedp_tpu/pipeline_backend.py`` on the port's
own modules (capability parity with the reference's
``pipeline_dp/pipeline_backend.py:38-191``: about 17 collection ops; the
engine never touches an execution framework directly).

Backends in this package:

* ``LocalBackend``: single-process lazy Python generators; the
  correctness oracle, and the host path of ``TorchBackend``.
* ``MultiProcLocalBackend``: process-pool data parallelism, every op
  implemented (chunked ``Pool.map`` for elementwise ops, hash-partitioned
  shuffles for keyed ops). Its pool is a ``spawn`` pool: a worker starts
  a fresh interpreter instead of forking a parent that may hold threads
  (a forked pool can deadlock in ``Pool.map`` under a threaded parent).
* ``TorchBackend`` (``pipelinedp_tpu_torch.backends``): the device plane;
  the engine lowers fusable aggregations to the fused path there.
* ``SparkRDDBackend``: an adapter over a live ``SparkContext``.

* ``BeamBackend`` (``pipelinedp_tpu_torch.beam_backend``): the Apache
  Beam adapter, re-exported here when ``apache_beam`` imports.

Every op takes a ``stage_name`` used for report and debug labels.
"""

from __future__ import annotations

import abc
import collections
import functools
import itertools
import operator
import random
from typing import Callable, Iterable, List

from pipelinedp_tpu_torch.ops import noise as noise_ops


class PipelineBackend(abc.ABC):
    """Abstract collection ops (reference :38-191)."""

    def to_collection(self, collection_or_iterable, col, stage_name: str):
        """Converts an iterable to the backend's native collection (no-op
        for already-native collections)."""
        return collection_or_iterable

    def to_multi_transformable_collection(self, col):
        """Returns a collection that tolerates multiple downstream
        transformations (generators are single-shot)."""
        return col

    @abc.abstractmethod
    def map(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def flat_map(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def map_tuple(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def map_values(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def group_by_key(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def filter(self, col, fn, stage_name: str):
        pass

    @abc.abstractmethod
    def filter_by_key(self, col, keys_to_keep, stage_name: str):
        pass

    @abc.abstractmethod
    def keys(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def values(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def sample_fixed_per_key(self, col, n: int, stage_name: str):
        """(key, value) -> (key, [<=n values sampled w/o replacement])."""

    @abc.abstractmethod
    def count_per_element(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def sum_per_key(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def combine_accumulators_per_key(self, col, combiner, stage_name: str):
        """(key, accumulator) -> (key, merged accumulator) using
        ``combiner.merge_accumulators``."""

    @abc.abstractmethod
    def reduce_per_key(self, col, fn: Callable, stage_name: str):
        """(key, value) -> (key, reduced) with an associative commutative
        binary fn."""

    @abc.abstractmethod
    def flatten(self, cols: Iterable, stage_name: str):
        pass

    @abc.abstractmethod
    def distinct(self, col, stage_name: str):
        pass

    @abc.abstractmethod
    def to_list(self, col, stage_name: str):
        pass

    def annotate(self, col, stage_name: str, **kwargs):
        """Applies registered annotators (no-op unless implemented)."""
        return col


class UniqueLabelsGenerator:
    """Unique stage labels (reference :194-216)."""

    def __init__(self, suffix=""):
        self._labels = set()
        self._suffix = ("_" + suffix) if suffix else ""

    def unique(self, label):
        if not label:
            label = "UNDEFINED_STAGE_NAME"
        candidate = label + self._suffix
        if candidate not in self._labels:
            self._labels.add(candidate)
            return candidate
        for i in itertools.count(1):
            candidate = f"{label}_{i}{self._suffix}"
            if candidate not in self._labels:
                self._labels.add(candidate)
                return candidate


# ---------------------------------------------------------------------------
# Annotators (reference :791-814)
# ---------------------------------------------------------------------------


class Annotator(abc.ABC):
    """Annotates a collection with aggregation metadata at the end of each
    DP aggregation (reference :791-805)."""

    @abc.abstractmethod
    def annotate(self, col, params, budget):
        """Returns the (possibly wrapped) collection."""


_annotators: List[Annotator] = []


def register_annotator(annotator: Annotator):
    _annotators.append(annotator)


def registered_annotators() -> List[Annotator]:
    return list(_annotators)


# ---------------------------------------------------------------------------
# LocalBackend — lazy single-process generators (reference :458-556)
# ---------------------------------------------------------------------------


class LocalBackend(PipelineBackend):
    """Fully lazy generator chains; execution happens when the caller
    iterates the final result."""

    def to_multi_transformable_collection(self, col):
        return list(col)

    def map(self, col, fn, stage_name: str = None):
        return map(fn, col)

    def flat_map(self, col, fn, stage_name: str = None):
        return (e for x in col for e in fn(x))

    def map_tuple(self, col, fn, stage_name: str = None):
        return (fn(*x) for x in col)

    def map_values(self, col, fn, stage_name: str = None):
        return ((k, fn(v)) for k, v in col)

    def group_by_key(self, col, stage_name: str = None):

        def generator():
            d = collections.defaultdict(list)
            for k, v in col:
                d[k].append(v)
            yield from d.items()

        return generator()

    def filter(self, col, fn, stage_name: str = None):
        return filter(fn, col)

    def filter_by_key(self, col, keys_to_keep, stage_name: str = None):
        keys = (keys_to_keep if isinstance(keys_to_keep, (set, frozenset))
                else set(keys_to_keep))
        return ((k, v) for k, v in col if k in keys)

    def keys(self, col, stage_name: str = None):
        return (k for k, _ in col)

    def values(self, col, stage_name: str = None):
        return (v for _, v in col)

    def sample_fixed_per_key(self, col, n: int, stage_name: str = None):

        def generator():
            for k, values in self.group_by_key(col):
                if len(values) > n:
                    # lint: disable=rng-purity(contribution sampling from the seed_host_rng generator, the JAX package's order)
                    idx = noise_ops._host_rng.choice(len(values), n,
                                                     replace=False)
                    values = [values[i] for i in idx]
                yield k, values

        return generator()

    def count_per_element(self, col, stage_name: str = None):

        def generator():
            yield from collections.Counter(col).items()

        return generator()

    def sum_per_key(self, col, stage_name: str = None):
        return self.reduce_per_key(col, operator.add, stage_name)

    def combine_accumulators_per_key(self, col, combiner,
                                     stage_name: str = None):
        return self.reduce_per_key(col, combiner.merge_accumulators,
                                   stage_name)

    def reduce_per_key(self, col, fn, stage_name: str = None):

        def generator():
            d = {}
            for k, v in col:
                d[k] = fn(d[k], v) if k in d else v
            yield from d.items()

        return generator()

    def flatten(self, cols, stage_name: str = None):
        return itertools.chain(*cols)

    def distinct(self, col, stage_name: str = None):

        def generator():
            yield from set(col)

        return generator()

    def to_list(self, col, stage_name: str = None):
        return iter([list(col)])

    def annotate(self, col, stage_name: str = None, **kwargs):
        for annotator in _annotators:
            col = annotator.annotate(col, **kwargs)
        return col


# ---------------------------------------------------------------------------
# MultiProcLocalBackend — working process-pool data parallelism
# ---------------------------------------------------------------------------

# Top-level helpers so closures survive pickling into worker processes.


def _mp_worker_init():
    """Pool-worker initializer: every worker reseeds the host RNG and
    ``random`` from OS entropy. Workers that drew from one RNG state would
    draw identical noise and selection randomness, and identical noise
    across partitions cancels in pairwise differences, which voids DP. A
    spawned worker starts from a fresh import, but the reseed keeps the
    guarantee whatever the start method or a parent's seeding does."""
    noise_ops.reseed_host_rng_from_entropy()
    # lint: disable=rng-purity(DP-required entropy reseed of forked workers)
    random.seed()


def _mp_apply_chunk(task, chunk):
    """Runs one elementwise chunk. A spawned worker starts with secure host
    noise off, while the release stages (``compute_metrics``) run in the
    workers, so every task carries the parent's flag and sets it here: a
    hardened run stays hardened in every process. A worker's native
    CSPRNG seeds itself from OS entropy when the library first loads
    there."""
    fn, mode, secure_host_noise = task
    if secure_host_noise != noise_ops.secure_host_noise_enabled():
        noise_ops.set_secure_host_noise(secure_host_noise)
    if mode == "map":
        return [fn(x) for x in chunk]
    if mode == "map_tuple":
        return [fn(*x) for x in chunk]
    if mode == "map_values":
        return [(k, fn(v)) for k, v in chunk]
    if mode == "flat_map":
        return [e for x in chunk for e in fn(x)]
    if mode == "filter":
        return [x for x in chunk if fn(x)]
    raise ValueError(mode)


def _mp_reduce_shard(fn, shard):
    d = {}
    for k, v in shard:
        d[k] = fn(d[k], v) if k in d else v
    return list(d.items())


def _mp_group_shard(shard):
    d = collections.defaultdict(list)
    for k, v in shard:
        d[k].append(v)
    return list(d.items())


class _LazyCollection:
    """A deferred, cached collection node: the thunk runs on first
    iteration and its result is memoized (so the collection is
    multi-transformable). Laziness is load-bearing: the two-phase budget
    protocol requires that no DP stage executes before
    ``compute_budgets()``."""

    def __init__(self, thunk: Callable[[], list]):
        self._thunk = thunk
        self._cache = None

    def __iter__(self):
        if self._cache is None:
            self._cache = self._thunk()
        return iter(self._cache)


class MultiProcLocalBackend(PipelineBackend):
    """Process-pool backend: elementwise ops fan chunks over a ``spawn``
    ``multiprocessing.Pool``; keyed ops hash-partition by key and reduce
    each shard in a worker, a real (if single-host) shuffle (the
    reference's experimental version left the DP path unimplemented,
    reference :685-788).

    Graphs are lazy ``_LazyCollection`` chains (execution starts when the
    final collection is iterated, after budgets are computed). Functions
    must be picklable (module-level, not lambdas) when collections are
    large enough to fan out to workers; a spawned worker imports them by
    module name. Call ``close()`` to stop the pool.
    """

    def __init__(self, n_jobs: int = None, chunk_size: int = 10_000):
        import multiprocessing
        self._n_jobs = n_jobs or multiprocessing.cpu_count()
        self._chunk_size = chunk_size
        self._pool_instance = None

    def _pool(self):
        # One long-lived pool per backend instance: keyed stages run several
        # times per aggregation, and a spawned worker pays an interpreter
        # start and the import of this package (and torch) once.
        if self._pool_instance is None:
            import multiprocessing
            self._pool_instance = multiprocessing.get_context(
                "spawn").Pool(self._n_jobs, initializer=_mp_worker_init)
        return self._pool_instance

    def close(self):
        if self._pool_instance is not None:
            self._pool_instance.terminate()
            self._pool_instance = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def _picklable(fn) -> bool:
        import pickle
        try:
            pickle.dumps(fn)
            return True
        except Exception:
            return False

    def _apply_chunked(self, col, fn, mode):
        data = list(col)
        # In-process for small data or unpicklable fns (engine graphs close
        # over lambdas; those stages run locally while picklable stages
        # still fan out).
        secure = noise_ops.secure_host_noise_enabled()
        if len(data) < 2 * self._chunk_size or not self._picklable(fn):
            return _mp_apply_chunk((fn, mode, secure), data)
        chunks = [
            data[i:i + self._chunk_size]
            for i in range(0, len(data), self._chunk_size)
        ]
        results = self._pool().map(
            functools.partial(_mp_apply_chunk, (fn, mode, secure)), chunks)
        return [e for r in results for e in r]

    def map(self, col, fn, stage_name: str = None):
        return _LazyCollection(
            lambda: self._apply_chunked(col, fn, "map"))

    def flat_map(self, col, fn, stage_name: str = None):
        return _LazyCollection(
            lambda: self._apply_chunked(col, fn, "flat_map"))

    def map_tuple(self, col, fn, stage_name: str = None):
        return _LazyCollection(
            lambda: self._apply_chunked(col, fn, "map_tuple"))

    def map_values(self, col, fn, stage_name: str = None):
        return _LazyCollection(
            lambda: self._apply_chunked(col, fn, "map_values"))

    def filter(self, col, fn, stage_name: str = None):
        return _LazyCollection(
            lambda: self._apply_chunked(col, fn, "filter"))

    def _shard_by_key(self, col):
        # Builtin hash() is CORRECT here and the stable key hash is
        # not: shard assignment must agree with key EQUALITY (custom
        # __eq__/__hash__ objects, 1 == 1.0) or one key's rows split
        # across shards and group_by_key silently emits duplicate
        # groups. It runs only in the parent process (workers receive
        # already-built shards) and is never persisted, so process-
        # salting is irrelevant — this is load balancing, not a
        # replayable key→bucket map.
        shards = [[] for _ in range(self._n_jobs)]
        for kv in col:
            # lint: disable=sketch-confinement(in-process shard balancing must follow key equality; parent process only, never persisted or replayed)
            shards[hash(kv[0]) % self._n_jobs].append(kv)
        return shards

    def _group_now(self, col):
        data = list(col)
        if len(data) < 2 * self._chunk_size:
            return _mp_group_shard(data)
        shards = self._shard_by_key(data)
        results = self._pool().map(_mp_group_shard, shards)
        return [e for r in results for e in r]

    def group_by_key(self, col, stage_name: str = None):
        return _LazyCollection(lambda: self._group_now(col))

    def reduce_per_key(self, col, fn, stage_name: str = None):

        def run():
            data = list(col)
            if len(data) < 2 * self._chunk_size or not self._picklable(fn):
                return _mp_reduce_shard(fn, data)
            shards = self._shard_by_key(data)
            results = self._pool().map(
                functools.partial(_mp_reduce_shard, fn), shards)
            return [e for r in results for e in r]

        return _LazyCollection(run)

    def sum_per_key(self, col, stage_name: str = None):
        return self.reduce_per_key(col, operator.add, stage_name)

    def combine_accumulators_per_key(self, col, combiner,
                                     stage_name: str = None):
        return self.reduce_per_key(col, combiner.merge_accumulators,
                                   stage_name)

    def filter_by_key(self, col, keys_to_keep, stage_name: str = None):

        def run():
            keys = set(keys_to_keep)
            return [(k, v) for k, v in col if k in keys]

        return _LazyCollection(run)

    def keys(self, col, stage_name: str = None):
        return _LazyCollection(lambda: [k for k, _ in col])

    def values(self, col, stage_name: str = None):
        return _LazyCollection(lambda: [v for _, v in col])

    def sample_fixed_per_key(self, col, n: int, stage_name: str = None):

        def run():
            out = []
            for k, vs in self._group_now(col):
                if len(vs) > n:
                    # lint: disable=rng-purity(contribution sampling from the seed_host_rng generator, the JAX package's order)
                    idx = noise_ops._host_rng.choice(len(vs), n,
                                                     replace=False)
                    vs = [vs[i] for i in idx]
                out.append((k, vs))
            return out

        return _LazyCollection(run)

    def count_per_element(self, col, stage_name: str = None):
        return _LazyCollection(
            lambda: list(collections.Counter(col).items()))

    def flatten(self, cols, stage_name: str = None):
        cols = tuple(cols)
        return _LazyCollection(lambda: [e for c in cols for e in c])

    def distinct(self, col, stage_name: str = None):
        return _LazyCollection(lambda: list(set(col)))

    def to_list(self, col, stage_name: str = None):
        return _LazyCollection(lambda: [list(col)])

    def annotate(self, col, stage_name: str = None, **kwargs):
        for annotator in _annotators:
            col = annotator.annotate(col, **kwargs)
        return col


# ---------------------------------------------------------------------------
# Optional cluster adapters
# ---------------------------------------------------------------------------

class SparkRDDBackend(PipelineBackend):
    """Apache Spark RDD adapter (reference :362-455). Construct with a live
    ``SparkContext``."""

    def __init__(self, sc):
        self._sc = sc

    def to_collection(self, collection_or_iterable, col, stage_name):
        if hasattr(collection_or_iterable, "mapValues"):
            return collection_or_iterable
        return self._sc.parallelize(list(collection_or_iterable))

    def _ensure_rdd(self, col):
        if hasattr(col, "mapValues"):
            return col
        return self._sc.parallelize(list(col))

    def map(self, col, fn, stage_name=None):
        return self._ensure_rdd(col).map(fn)

    def flat_map(self, col, fn, stage_name=None):
        return self._ensure_rdd(col).flatMap(fn)

    def map_tuple(self, col, fn, stage_name=None):
        return self._ensure_rdd(col).map(lambda x: fn(*x))

    def map_values(self, col, fn, stage_name=None):
        return self._ensure_rdd(col).mapValues(fn)

    def group_by_key(self, col, stage_name=None):
        return self._ensure_rdd(col).groupByKey().mapValues(list)

    def filter(self, col, fn, stage_name=None):
        return self._ensure_rdd(col).filter(fn)

    def filter_by_key(self, col, keys_to_keep, stage_name=None):
        col = self._ensure_rdd(col)
        if isinstance(keys_to_keep, (list, set, frozenset)):
            keys = set(keys_to_keep)
            return col.filter(lambda kv: kv[0] in keys)
        keys_rdd = self.to_collection(keys_to_keep, col,
                                      stage_name).map(lambda k: (k, True))
        return col.join(keys_rdd).mapValues(lambda v: v[0])

    def keys(self, col, stage_name=None):
        return self._ensure_rdd(col).keys()

    def values(self, col, stage_name=None):
        return self._ensure_rdd(col).values()

    def sample_fixed_per_key(self, col, n, stage_name=None):
        # Same caveat as the reference (:427-430): reduce-side merge-sample
        # is not guaranteed uniform.
        return (self._ensure_rdd(col).mapValues(lambda v: [v]).reduceByKey(
            # lint: disable=rng-purity(reference-mirror merge-sample, host path)
            lambda a, b: random.sample(a + b, min(n, len(a) + len(b)))))

    def count_per_element(self, col, stage_name=None):
        return (self._ensure_rdd(col).map(lambda e: (e, 1)).reduceByKey(
            operator.add))

    def sum_per_key(self, col, stage_name=None):
        return self._ensure_rdd(col).reduceByKey(operator.add)

    def combine_accumulators_per_key(self, col, combiner, stage_name=None):
        return self._ensure_rdd(col).reduceByKey(
            combiner.merge_accumulators)

    def reduce_per_key(self, col, fn, stage_name=None):
        return self._ensure_rdd(col).reduceByKey(fn)

    def flatten(self, cols, stage_name=None):
        return self._sc.union([self._ensure_rdd(c) for c in cols])

    def distinct(self, col, stage_name=None):
        return self._ensure_rdd(col).distinct()

    def to_list(self, col, stage_name=None):
        raise NotImplementedError("to_list is not supported on Spark "
                                  "(mirrors the reference :454-455)")


# Optional Beam adapter: re-exported here for the reference-parity import
# path; the implementation lives in ``pipelinedp_tpu_torch.beam_backend``.
try:
    from pipelinedp_tpu_torch.beam_backend import BeamBackend  # noqa: F401
except ImportError:  # apache_beam not installed
    pass
