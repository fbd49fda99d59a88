"""Rank-side helpers of the port's mesh tests (``test_torch_mesh.py``,
``test_torch_stream_mesh.py``, ``test_torch_topology.py``).

The functions here run inside the ranks that ``parallel.launch`` spawns,
so they are importable module-level functions and import nothing of JAX:
each rank imports only the port. The test modules run the JAX package's
side in the pytest process and compare.
"""

import numpy as np
import torch

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.parallel import sharded as psh

#: Threads per rank: four ranks share the test worker's cores.
RANK_THREADS = 1
#: Ranks of the shared pool, and the seconds one call of it may take.
N_RANKS = 4
DEADLINE_S = 240

_POOL = None


def shared_pool():
    """The test process's one pool of ``N_RANKS`` gloo ranks, started at
    the first call and shared by every mesh test module the process runs
    (each start spawns four interpreters that import torch). Its ranks
    are daemon processes: they end with the test process, and
    ``parallel.launch`` kills them at once if a call fails or misses its
    deadline (the next call starts a fresh pool)."""
    global _POOL
    if _POOL is None:
        import atexit
        from pipelinedp_tpu_torch.parallel import launch
        _POOL = launch.RankPool(N_RANKS, threads=RANK_THREADS,
                                deadline_s=DEADLINE_S)
        atexit.register(_POOL.close)
    if not _POOL.alive:
        # The ranks inherit the environment of their start: none of the
        # package's variables a test of this process may have left set.
        import os
        saved = {k: os.environ.pop(k) for k in list(os.environ)
                 if k.startswith("PIPELINEDP_TPU_")}
        try:
            _POOL.start()
        finally:
            os.environ.update(saved)
    return _POOL


def dataset(seed=0, n=4000, users=800, parts=40, zipf=1.3, vector=None,
            enforced=False):
    """(pid or None, pk, values) from a numpy seed; ``vector`` makes
    [n, vector] values."""
    rng = np.random.default_rng(seed)
    pid = rng.integers(0, users, n)
    pk = (rng.zipf(zipf, n) % parts).astype(np.int64)
    if vector:
        values = rng.uniform(-1.0, 1.0, (n, vector))
    else:
        values = rng.uniform(0.0, 10.0, n)
    return (None if enforced else pid), pk, values


def released(result):
    """{partition key: {field: value}} of a lazy release, plain floats and
    arrays, so it pickles back to the parent."""
    out = {}
    for key, metrics in result:
        out[key] = {f: np.asarray(getattr(metrics, f)).copy()
                    for f in metrics._fields}
    return out


def mesh_here(device="cpu", backend=None):
    """This rank's mesh over the pool's group."""
    return psh.make_mesh(device=device, backend=backend)


def aggregate(params, data, rng_seed, eps=1.0, delta=1e-6, public=None,
              mesh=True, select=False, device="cpu", fail_chunks=(),
              **backend_kw):
    """One ``DPEngine.aggregate`` (or ``select_partitions``) on this rank's
    mesh (``mesh=False``: on one device). Returns (release, timings, obs
    counters, selected events); with ``fail_chunks`` the stream is killed
    at those batches and the release is the string ``"killed"``."""
    if fail_chunks:
        from pipelinedp_tpu_torch import resilience
        try:
            with resilience.injected_faults(resilience.FaultPlan(
                    fail_chunks=tuple(fail_chunks))):
                aggregate(params, data, rng_seed, eps, delta, public, mesh,
                          select, device, **backend_kw)
        except resilience.FaultInjected:
            return "killed", {}, {}, []
        raise AssertionError("the injected fault did not fire")
    obs.reset()
    noise_ops.seed_host_rng(0)
    m = mesh_here(device) if mesh else None
    ds = pdt.ArrayDataset(privacy_ids=data[0], partition_keys=data[1],
                          values=data[2])
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    backend = pdt.TorchBackend(device=device, rng_seed=rng_seed, mesh=m,
                               **backend_kw)
    engine = pdt.DPEngine(acc, backend)
    if select:
        res = engine.select_partitions(ds, params, pdt.DataExtractors())
    else:
        res = engine.aggregate(ds, params, pdt.DataExtractors(),
                               public_partitions=public)
    acc.compute_budgets()
    if select:
        out = sorted(res)
        timings = {}
    else:
        out = released(res)
        timings = dict(getattr(res, "timings", None) or {})
    snap = obs.ledger().snapshot()
    events = [e for e in snap["events"] if e["name"] in (
        "mesh.created", "mesh.topology_fallback", "backend.created",
        "ingest.forced_serial")]
    return out, timings, dict(snap["counters"]), events


def sharded_partials(config, P, pid, pk, values, key_words, fx_bits,
                     scales, keep_table, thr, s_scale, min_count,
                     rows_per_uid):
    """``sharded_fused_aggregate`` on this rank's mesh: the keep vector and
    every accumulator column, gathered to the whole axis."""
    mesh = mesh_here()
    key = torch.tensor(np.asarray(key_words, np.int64))
    keep, out = psh.sharded_fused_aggregate(
        mesh, config, P, pid, pk, values, scales, keep_table, thr, s_scale,
        min_count, rows_per_uid, key, fx_bits)
    return keep.numpy(), {k: v.numpy() for k, v in out.items()}


def collective(kind, x_global, replicate=False):
    """One exchange of ``parallel.sharded`` on this rank's row of
    ``x_global`` (one row per mesh position). Returns (result, comms
    counters, the mesh's position and topology)."""
    mesh = mesh_here()
    obs.reset()
    x = torch.from_numpy(np.ascontiguousarray(x_global[mesh.index]))
    if kind == "combine":
        y = psh.combine_shards(x, mesh, 0, replicate)
    elif kind == "gather":
        y = psh.gather_blocks(x, mesh, 0)
    else:
        y = psh.scatter_to_owner(x, mesh, 0)
    counters = {k: v for k, v in obs.ledger().snapshot()["counters"].items()
                if k.startswith("comms.")}
    t = mesh.topology
    return (y.numpy(), counters, mesh.index,
            (t.mode, t.n_hosts, t.per_host, t.simulated),
            mesh.devices.tolist())


def sweep(options, cols, public=None, pp=False, mesh=True):
    """``perform_utility_analysis`` on this rank's mesh (or one device):
    (repr of the result, repr of the per-partition rows or None, configs
    per chunk, chunks). ``repr`` keeps every float's bits."""
    from pipelinedp_tpu_torch import analysis
    obs.reset()
    m = mesh_here() if mesh else None
    backend = pdt.TorchBackend(device="cpu", mesh=m)
    out = analysis.perform_utility_analysis(
        pdt.ArrayDataset(*cols), backend, options, pdt.DataExtractors(),
        public_partitions=public, return_per_partition=pp)
    if pp:
        res, rows = out
        return repr(list(res)[0]), repr(sorted(dict(rows).items())), \
            res.chunk, res.n_chunks
    return repr(list(out)[0]), None, out.chunk, out.n_chunks


def sketch_first(params, sketch_kw, cols, rng_seed, eps=1.0, delta=1e-6,
                 mesh=True, dense=False):
    """Sketch-first (or, with ``dense``, the dense path) on this rank's
    mesh: (release, events of the sketch)."""
    obs.reset()
    m = mesh_here() if mesh else None
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(device="cpu",
                                                rng_seed=rng_seed, mesh=m))
    res = engine.aggregate(
        pdt.ArrayDataset(privacy_ids=cols[0], partition_keys=cols[1],
                         values=cols[2]), params, pdt.DataExtractors(),
        sketch_first=None if dense else pdt.SketchParams(**sketch_kw))
    acc.compute_budgets()
    out = released(res)
    events = [e for e in obs.ledger().snapshot()["events"]
              if e["name"] == "sketch.sharded"]
    return out, events


def accumulate_stream(raw, width, backend, chunk_rows, mesh=True):
    """The sketch's accumulation stream on this rank's mesh: (counts,
    chunks)."""
    from pipelinedp_tpu_torch.sketch import engine as sk_engine
    m = mesh_here() if mesh else None
    counts, chunks, _ = sk_engine._accumulate_stream(
        raw, width, backend, chunk_rows, torch.device("cpu"), obs.tracer(),
        mesh=m)
    return counts, chunks


def mesh_info(ragged=False):
    """This rank's mesh under the call's environment: (devices in position
    order, (mode, hosts, per_host, simulated, hierarchical, multi_host),
    the ici and dcn members, the mesh events). ``ragged`` splits the ranks
    into hosts of 1 and n - 1."""
    obs.reset()
    saved = psh._host_groups
    if ragged:
        psh._host_groups = lambda ranks, names: ([ranks[:1], ranks[1:]],
                                                 True)
    try:
        mesh = mesh_here()
    finally:
        psh._host_groups = saved
    t = mesh.topology
    events = [e for e in obs.ledger().snapshot()["events"]
              if e["name"].startswith("mesh.")]
    return (mesh.devices.tolist(),
            (t.mode, t.n_hosts, t.per_host, t.simulated, t.hierarchical,
             t.multi_host),
            mesh.ici.members if mesh.ici else None,
            mesh.dcn.members if mesh.dcn else None, events)


def mesh_fingerprint():
    """The run ledger's environment fingerprint's mesh shape on this
    rank's mesh."""
    return obs.environment_fingerprint(mesh=mesh_here())["mesh_shape"]
