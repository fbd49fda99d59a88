"""Rank-side helpers of the port's elastic-mesh tests
(``test_torch_elastic.py``).

The functions here run inside the ranks that ``parallel.launch`` spawns,
so they are importable module-level functions and import nothing of JAX.
A rank that is meant to die does so for real, with ``os._exit``: on its
injected chunk fault (the victim's ``PIPELINEDP_TPU_FAULTS`` carries
``fail_chunks``), or inside a collective (``die_in_collective``), as a
lost host looks from its peers.
"""

import os

import numpy as np
import torch

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.parallel import sharded as psh
from pipelinedp_tpu_torch.resilience import faults

#: The exit code of a rank that dies on purpose.
DIE_CODE = 17


def released(result):
    """{partition key: {field: value}} of a lazy release, plain arrays."""
    out = {}
    for key, metrics in result:
        out[key] = {f: np.asarray(getattr(metrics, f)).copy()
                    for f in metrics._fields}
    return out


def _die_in_collective(n: int) -> None:
    """Makes this rank's ``n``-th all-reduce end the process, after its
    gate and before the exchange: its peers are left waiting inside the
    collective."""
    calls = [0]
    real = psh._all_reduce

    def dying(mesh, g, x):
        calls[0] += 1
        if calls[0] == n:
            os._exit(DIE_CODE)
        return real(mesh, g, x)

    psh._all_reduce = dying


def elastic_aggregate(params, data, rng_seed, eps=1e4, delta=1e-6,
                      public=None, checkpoint=None, device="cpu",
                      die_in_collective=None, resilient=False):
    """One ``DPEngine.aggregate`` on this rank's mesh, under the fault plan
    of the call's ``PIPELINEDP_TPU_FAULTS``. Returns (release, timings,
    counters, mesh and checkpoint events) on a rank that finished, and
    ``("raised", name)`` where the loss re-raised. A rank whose plan fails
    a chunk (the victim) exits the process, and so does the rank ``r`` of
    ``die_in_collective=(r, n)`` in its ``n``-th all-reduce."""
    import torch.distributed as dist
    obs.reset()
    noise_ops.seed_host_rng(0)
    # The plan of the call's environment, with its counters from zero (the
    # pool's ranks outlive a call; a fresh process would start at zero).
    plan = faults.active()
    if plan is not None:
        faults.install(plan)
    try:
        return _aggregate(params, data, rng_seed, eps, delta, public,
                          checkpoint, device, resilient,
                          die_in_collective is not None and
                          dist.get_rank() == die_in_collective[0] and
                          die_in_collective[1])
    finally:
        faults.clear()


def _aggregate(params, data, rng_seed, eps, delta, public, checkpoint,
               device, resilient, die_at):
    if die_at:
        _die_in_collective(die_at)
    if resilient:
        from pipelinedp_tpu_torch.resilience import health
        mesh, report = health.resilient_make_mesh(device=device)
        assert not report.degraded, report
    else:
        mesh = psh.make_mesh(device=device)
    ds = pdt.ArrayDataset(privacy_ids=data[0], partition_keys=data[1],
                          values=data[2])
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    backend = pdt.TorchBackend(device=device, rng_seed=rng_seed, mesh=mesh,
                               checkpoint=checkpoint)
    engine = pdt.DPEngine(acc, backend)
    res = engine.aggregate(ds, params, pdt.DataExtractors(),
                           public_partitions=public)
    acc.compute_budgets()
    try:
        out = released(res)
    except faults.ChunkFailure:
        os._exit(DIE_CODE)
    except (faults.DeviceLost, pdt.resilience.MeshParticipantLost) as e:
        return "raised", type(e).__name__
    snap = obs.ledger().snapshot()
    events = [e for e in snap["events"] if e["name"].startswith("mesh.")
              or e["name"].startswith("checkpoint.")]
    return (out, dict(res.timings), dict(snap["counters"]), events)


def reform_positions(steps):
    """This rank's mesh under the call's environment, then ``steps``
    reforms after an injected loss: each mesh's (ranks in position order,
    (mode, hosts, per_host, hierarchical)) while this rank stays a member,
    and the sum of one all-reduce of each member's rank + 1 on each mesh
    (the re-formed groups work). Ends with ``"departed"`` where the rank
    left."""
    obs.reset()
    mesh = psh.make_mesh(device="cpu")
    out = []
    for step in range(steps + 1):
        t = mesh.topology
        total = psh.combine_shards(
            torch.full((4,), mesh.rank + 1, dtype=torch.int32), mesh, 0,
            True, f"elastic.check{step}")
        out.append((mesh.devices.tolist(),
                    (t.mode, t.n_hosts, t.per_host, t.hierarchical),
                    int(total[0])))
        if step == steps:
            break
        try:
            mesh = psh.reform_mesh(mesh)
        except psh.MeshDeparted:
            out.append("departed")
            break
        if mesh is None:
            out.append("none")
            break
    events = [e for e in obs.ledger().snapshot()["events"]
              if e["name"] == "mesh.reformed"]
    return out, events


def resilient_mesh(max_attempts, device="cpu"):
    """``resilient_make_mesh`` on this rank under the call's fault plan, on
    a FakeClock: (degraded, attempts, the clock's sleeps, the policy's
    delays, the mesh's size, device and backend, the sum of one all-reduce
    of ones over it, the report's detail)."""
    from pipelinedp_tpu_torch.resilience import FakeClock, RetryPolicy
    from pipelinedp_tpu_torch.resilience import health
    plan = faults.active()
    if plan is not None:
        faults.install(plan)
    try:
        obs.reset()
        policy = RetryPolicy(max_attempts=max_attempts, base_delay_s=1.0,
                             seed=0)
        clock = FakeClock()
        mesh, report = health.resilient_make_mesh(policy=policy,
                                                  clock=clock, device=device)
        total = psh.combine_shards(torch.ones(4, dtype=torch.int32), mesh,
                                   0, True, "health.check")
        return (report.degraded, report.attempts, clock.sleeps,
                policy.delays(), mesh.size, str(mesh.device), mesh.backend,
                int(total[0]), report.detail)
    finally:
        faults.clear()


def backend_health(max_attempts=2):
    """``TorchBackend(health_policy=...)`` on this rank's CPU mesh under the
    call's fault plan, on a FakeClock: (degraded, the degrade flag in the
    environment, the mesh kept, the report's detail, the release of a small
    aggregation with a fixed seed). The flag is cleared after the call: the
    pool's ranks outlive it."""
    from pipelinedp_tpu_torch.resilience import FakeClock, RetryPolicy
    from pipelinedp_tpu_torch.resilience import health
    plan = faults.active()
    if plan is not None:
        faults.install(plan)
    try:
        obs.reset()
        noise_ops.seed_host_rng(0)
        mesh = psh.make_mesh(device="cpu")
        backend = pdt.TorchBackend(
            device="cpu", rng_seed=5, mesh=mesh, clock=FakeClock(),
            health_policy=RetryPolicy(max_attempts=max_attempts,
                                      base_delay_s=1.0, seed=0))
        flagged = bool(os.environ.get(health.DEGRADED_ENV))
        rng = np.random.default_rng(3)
        n = 3_000
        ds = pdt.ArrayDataset(privacy_ids=rng.integers(0, 400, n),
                              partition_keys=rng.integers(0, 8, n),
                              values=rng.uniform(0.0, 10.0, n))
        params = pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
            max_partitions_contributed=8,
            max_contributions_per_partition=50, min_value=0.0,
            max_value=10.0)
        acc = pdt.NaiveBudgetAccountant(total_epsilon=1e4, total_delta=1e-6)
        res = pdt.DPEngine(acc, backend).aggregate(ds, params,
                                                   pdt.DataExtractors())
        acc.compute_budgets()
        return (backend.degraded, flagged, backend.mesh is not None,
                backend.health.detail, released(res))
    finally:
        os.environ.pop(health.DEGRADED_ENV, None)
        faults.clear()
