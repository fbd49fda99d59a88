"""Multi-GPU fused aggregation over a ``torch.distributed`` group: the
port of ``pipelinedp_tpu/parallel/sharded.py``.

A mesh here is one process per rank. Every rank encodes the whole
dataset and runs the same host code; the device work is split so:

* Rows are sharded **by privacy id**: a row belongs to the rank at mesh
  position ``fmix32(pid) % n`` (stable order within a rank), so
  contribution bounding, which must see all of a unit's rows, is
  rank-local. Each rank bounds under ``fold_in(k_bound, position)``, as
  the JAX package's shards do, so where caps bind a mesh samples other
  rows than one device (and the same rows as the JAX package's mesh of
  the same size).
* The partition axis is sharded too: the rank at position ``d`` OWNS the
  block of ``P / n`` partitions starting at ``d * P / n``. Each rank
  reduces its rows to dense per-partition columns (K1, K2), then one
  ``reduce_scatter`` per column hands every owner its block.
* Selection draws over the global axis and slices the owner's block, and
  the quantile walk's node noise is keyed by the global partition, so
  the mesh's keep decisions and walk equal one device's with the same
  key. The owner blocks are gathered at the end, and every rank runs the
  float64 host release on the same arrays and returns the same release.

Every payload that crosses ranks on these paths is exact int32 data, so
the bits do not depend on the order of the adds: a mesh of ``n`` ranks
gives the bits of the JAX package's single-controller mesh of ``n``
devices, and ``hier`` gives the bits of ``flat``.

A port mesh is what the JAX package calls a multi-process mesh
(``is_multi_process``): the stream, the sweep and the sketch take their
replicating branches on it. The backend is the caller's: NCCL when the
ranks hold CUDA tensors on distinct cards, gloo on the CPU or with
several ranks sharing one card, in which case each exchange stages its
payload through host memory. No code switches backends by itself.

A mesh that loses a rank re-forms over the survivors (``reform_mesh``):
the new size divides the old one, and the survivors' new group is a
process group of their own, built on a store of its generation, so no
collective of the re-formed mesh ever waits on the lost rank and the
default group is left as it was.
"""

from __future__ import annotations

import dataclasses
import os
# lint: disable=socket-confinement(socket.gethostname names each rank's host for the topology; no socket is opened)
import socket
import uuid
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pipelinedp_tpu_torch import obs
# Each row's mesh position, fmix32(pid) % n_dev: the single-batch path
# and the stream's cells both take it from there.
from pipelinedp_tpu_torch.ingest.assign import shard_of_rows

#: Knob seam (plan/knobs.py "mesh_topology"): "flat" (one collective over
#: the whole rank axis), "hier" (two stages: within each host, then across
#: hosts) or "auto" (hier iff the mesh spans more than one host). The
#: module constant is only the registry's test seam: readers go through
#: ``plan.knobs.value``.
_MESH_TOPOLOGY = "flat"

#: Simulated host count: splits the ranks into N contiguous "hosts" so the
#: two-stage exchange, and the cross-host byte attribution, run on one
#: machine.
_MESH_HOSTS_ENV = "PIPELINEDP_TPU_MESH_HOSTS"

#: How long a collective may wait for its peers before it fails.
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    """How the mesh's 1-D ``data`` axis maps onto hosts
    (``parallel.sharded.MeshTopology`` of the JAX package).

    Under ``hier`` the positions INTERLEAVE the hosts: position
    ``p = j * n_hosts + h`` holds host ``h``'s ``j``-th rank. The per-host
    ("ici") groups are then the strided position sets and the cross-host
    ("dcn") groups the contiguous runs ``[j * n_hosts, (j+1) * n_hosts)``,
    which lands the two-stage owner-block reduction of position ``p`` on
    global block ``p``: the flat mapping."""
    mode: str            #: "flat" | "hier"
    n_hosts: int
    per_host: int
    simulated: bool = False  #: hosts simulated via _MESH_HOSTS_ENV

    @property
    def hierarchical(self) -> bool:
        """True when the two-stage exchange differs from the flat one
        (both axes non-degenerate)."""
        return (self.mode == "hier" and self.n_hosts > 1
                and self.per_host > 1)

    @property
    def multi_host(self) -> bool:
        return self.n_hosts > 1

    @property
    def n_devices(self) -> int:
        return self.n_hosts * self.per_host


def _flat_topology(n_devices: int, n_hosts: int = 1,
                   simulated: bool = False) -> MeshTopology:
    n_hosts = max(1, n_hosts)
    return MeshTopology("flat", n_hosts, max(1, n_devices // n_hosts),
                        simulated)


def _ici_groups(topo: MeshTopology) -> List[List[int]]:
    """One group of positions per host (member ``j`` = the rank's slot
    within its host)."""
    H, k = topo.n_hosts, topo.per_host
    return [[j * H + h for j in range(k)] for h in range(H)]


def _dcn_groups(topo: MeshTopology) -> List[List[int]]:
    """One group of positions per within-host slot: one rank of every
    host (member ``h`` = the host)."""
    H, k = topo.n_hosts, topo.per_host
    return [[j * H + h for h in range(H)] for j in range(k)]


class _Group:
    """A process group and the global ranks of its members in MEMBER
    order (the order whose blocks the exchange scatters and gathers).
    ``perm[m]`` is member ``m``'s rank inside the torch group, which
    orders the chunks of a torch collective. The collectives are called
    on ``pg`` directly, which serves the default group, a ``new_group``
    and a re-formed mesh's own group (outside the default group's
    registry) alike."""

    def __init__(self, pg, members: List[int]):
        self.pg = pg
        self.members = list(members)
        self.size = len(members)
        by_rank = sorted(members)
        self.perm = [by_rank.index(r) for r in members]


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a mesh: its process group, its rank, the world
    size, its position on the ``data`` axis (``index``; the rank under
    ``flat``), its device, the collective backend and the topology.

    ``group`` is the process group with its ranks in position order;
    ``devices`` holds those ranks too (the JAX mesh's device array;
    ``devices.shape``/``devices.size`` key the run ledger's fingerprint,
    as the JAX package's mesh does). ``rank`` is the rank in the default
    group, which a re-formed mesh keeps; ``uid`` names the mesh's lineage
    (agreed by its ranks when it was made) and ``generation`` counts its
    re-formations, so the stores and files of a re-formation are its
    own."""
    group: "_Group"
    rank: int
    size: int
    index: int
    device: torch.device
    backend: str
    axis_name: str
    topology: MeshTopology
    devices: np.ndarray
    ici: Optional[_Group] = None
    dcn: Optional[_Group] = None
    uid: str = ""
    generation: int = 0
    timeout_s: float = DEFAULT_TIMEOUT_S

    #: Every port mesh spans processes: the JAX package's multi-process
    #: branches apply.
    is_multi_process = True

    @property
    def axis_names(self) -> Tuple[str]:
        return (self.axis_name,)

    @property
    def stages_on_host(self) -> bool:
        """gloo takes host tensors: a CUDA payload is copied to the host
        for the exchange and back after it."""
        return self.backend == "gloo" and self.device.type == "cuda"


def require_mesh(mesh) -> Mesh:
    """``mesh`` itself; a ``TypeError`` naming ``parallel.Mesh`` for
    anything else."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"a mesh is a parallel.Mesh (parallel.make_mesh), "
                        f"not {type(mesh).__name__}")
    return mesh


def topology_of(mesh: Optional[Mesh]) -> MeshTopology:
    """The mesh's topology; one device for no mesh."""
    if mesh is None:
        return _flat_topology(1)
    return mesh.topology


def resolved_topology_mode() -> str:
    """The ``mesh_topology`` knob in force (env > seam > plan > default)."""
    from pipelinedp_tpu_torch.plan import knobs
    return str(knobs.value("mesh_topology"))


def _host_groups(ranks: List[int], hostnames: List[str]
                 ) -> Tuple[List[List[int]], bool]:
    """(ranks grouped by host, simulated?). Ranks group by host name, the
    host a rank's process runs on (hosts ordered by their lowest rank);
    ``PIPELINEDP_TPU_MESH_HOSTS`` splits the ranks into N contiguous
    simulated hosts instead."""
    raw = os.environ.get(_MESH_HOSTS_ENV, "")
    if raw:
        try:
            n = int(raw)
        except ValueError:
            n = 0
        if n > 1 and len(ranks) % n == 0:
            k = len(ranks) // n
            return [list(ranks[h * k:(h + 1) * k]) for h in range(n)], True
    groups: Dict[str, List[int]] = {}
    for r, name in zip(ranks, hostnames):
        groups.setdefault(name, []).append(r)
    return sorted(groups.values(), key=min), False


def _build_topology(ranks: List[int], hostnames: List[str]
                    ) -> Tuple[List[int], MeshTopology]:
    """(ranks in position order, topology) under the resolved knob.
    ``hier`` interleaves the hosts; unequal per-host counts fall back to
    flat with a ``mesh.topology_fallback`` event."""
    mode = resolved_topology_mode()
    hosts, simulated = _host_groups(ranks, hostnames)
    n_hosts = len(hosts)
    if mode == "auto":
        mode = "hier" if n_hosts > 1 else "flat"
    if mode != "hier" or n_hosts <= 1:
        return list(ranks), _flat_topology(len(ranks), n_hosts, simulated)
    sizes = {len(g) for g in hosts}
    if len(sizes) != 1:
        obs.event("mesh.topology_fallback", reason="ragged_hosts",
                  hosts=n_hosts, sizes=sorted(sizes))
        return list(ranks), _flat_topology(len(ranks), n_hosts, simulated)
    k = len(hosts[0])
    order = [hosts[h][j] for j in range(k) for h in range(n_hosts)]
    return order, MeshTopology("hier", n_hosts, k, simulated)


def _default_device(backend: str) -> torch.device:
    """``cuda:<local rank>`` (modulo the cards this process sees, so
    several gloo ranks may share one card), else the CPU."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh needs a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' to run the mesh on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data",
              backend: Optional[str] = None, device=None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Mesh:
    """This rank's mesh over every rank of the default process group.

    Every rank of the group calls it at the same point (it makes
    subgroups, which is collective). ``n_devices`` must be None or the
    group's size. ``backend`` names the collective backend: None takes
    the default group's; another name makes a group of that backend over
    the same ranks (an NCCL error is raised, never retried on gloo).
    ``device`` is the rank's torch device: by default, or as ``"cuda"``,
    ``cuda:<local rank>``; ``"cpu"`` when the caller asks for the CPU."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh runs in a rank of a process group: start the ranks "
            "with parallel.launch.RankPool (or init_process_group)")
    world_size = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world_size:
        raise ValueError(
            f"a mesh spans every rank of the process group: asked for "
            f"{n_devices} devices on a group of {world_size} ranks")
    default_backend = str(dist.get_backend()).lower()
    backend = (backend or default_backend).lower()
    ranks = list(range(world_size))
    group = (dist.group.WORLD if backend == default_backend else
             dist.new_group(ranks, backend=backend,
                            timeout=timedelta(seconds=timeout_s)))
    device = (torch.device(device) if device is not None
              else _default_device(backend))
    if device.type == "cuda" and device.index is None:
        device = _default_device(backend)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("an NCCL mesh runs on CUDA devices")
        # NCCL's object collectives run on the current CUDA device.
        torch.cuda.set_device(device)
    # Each rank's host name, and rank 0's token for the mesh's lineage.
    gathered: List[Optional[Tuple[str, str]]] = [None] * world_size
    dist.all_gather_object(gathered, (socket.gethostname(),
                                      uuid.uuid4().hex[:12]))
    hostnames = [g[0] for g in gathered]
    order, topo = _build_topology(ranks, hostnames)
    rank = dist.get_rank()
    mesh = Mesh(group=_Group(group, order), rank=rank, size=world_size,
                index=order.index(rank), device=device, backend=backend,
                axis_name=axis_name, topology=topo,
                devices=np.asarray(order, dtype=np.int64),
                uid=gathered[0][1], timeout_s=float(timeout_s))
    if topo.hierarchical:
        # new_group is collective over the default group: every rank
        # makes every subgroup, in the same order, and keeps its own.
        timeout = timedelta(seconds=timeout_s)
        for kind, groups in (("ici", _ici_groups(topo)),
                             ("dcn", _dcn_groups(topo))):
            for positions in groups:
                members = [order[p] for p in positions]
                pg = dist.new_group(sorted(members), backend=backend,
                                    timeout=timeout)
                if rank in members:
                    setattr(mesh, kind, _Group(pg, members))
    obs.event("mesh.created", n_devices=world_size, axis_name=axis_name,
              platform="gpu" if device.type == "cuda" else "cpu",
              topology=topo.mode, hosts=topo.n_hosts,
              per_host=topo.per_host, simulated_hosts=topo.simulated)
    return mesh


# --- re-forming a mesh after a loss -----------------------------------------

class MeshDeparted(Exception):
    """This rank is not a member of the re-formed mesh: the new size
    divides the old one, so some survivors leave, and the rest go on
    without them. ``launch.RankPool`` reports such a rank with a marker,
    not as a failure."""

    def __init__(self, msg: str, rank: int = -1, old_devices: int = 0,
                 new_devices: int = 0):
        super().__init__(msg)
        self.rank = int(rank)
        self.old_devices = int(old_devices)
        self.new_devices = int(new_devices)


def _largest_proper_divisor(n: int, at_most: int) -> int:
    """The largest ``d < n`` dividing ``n`` with ``d <= at_most``; 0 when
    there is none."""
    return max((d for d in range(1, n) if n % d == 0 and d <= at_most),
               default=0)


def _mesh_dir() -> Optional[str]:
    from pipelinedp_tpu_torch.resilience import health
    return os.environ.get(health.MESH_DIR_ENV) or None


def _reform_store(mesh: Mesh):
    """The store the re-formed groups meet on: a file store in the mesh
    directory when one is armed (it outlives any rank), else the default
    group's store."""
    mesh_dir = _mesh_dir()
    if mesh_dir:
        return dist.FileStore(os.path.join(mesh_dir, f"store-{mesh.uid}"),
                              -1)
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


def _new_group(mesh: Mesh, store, name: str, members: List[int]) -> _Group:
    """A process group over ``members`` (global ranks, in member order)
    built without the default group: every member constructs it on its
    own prefix of ``store``, and no other rank takes part. gloo is what
    the CPU and the one-card runs use; the NCCL form is not exercised on
    a single card."""
    rank_in = sorted(members).index(mesh.rank)
    sub = dist.PrefixStore(f"{mesh.uid}/{name}", store)
    timeout = timedelta(seconds=mesh.timeout_s)
    if mesh.backend == "nccl":
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        pg = dist.ProcessGroupNCCL(sub, rank_in, len(members), opts)
    else:
        pg = dist.ProcessGroupGloo(sub, rank_in, len(members), timeout)
    return _Group(pg, members)


def _publish_once(path: str, payload) -> bool:
    """Writes ``payload`` to ``path`` unless the file exists (an atomic
    link of a complete temporary file); True when this call wrote it."""
    import json
    import tempfile
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(json.dumps(payload, sort_keys=True))
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)
        except FileExistsError:
            return False
        return True
    finally:
        os.unlink(tmp)


def _agree_survivors(mesh: Mesh, generation: int, clock,
                     stall_s: float) -> List[int]:
    """The survivors of a participant loss, in old position order, the
    same list on every survivor. Each survivor writes a join file; the
    joined survivor of lowest position decides once every old member has
    joined or is provably dead (its beat file's pid gone), or at the
    stall deadline, and publishes the decision exactly once; everyone
    reads the one decision. A survivor that dies before the decision is
    left out of it; a leader that dies before deciding hands the decision
    to the next joined survivor."""
    from pipelinedp_tpu_torch.resilience import checkpoint as ckpt_mod
    from pipelinedp_tpu_torch.resilience import health
    mesh_dir = _mesh_dir()
    if not mesh_dir:
        raise RuntimeError(
            f"re-forming after a lost rank needs {health.MESH_DIR_ENV}: the "
            "survivors agree on their set through the files there")
    key = f"reform-{mesh.uid}-g{generation}"
    decision = os.path.join(mesh_dir, f"{key}.json")

    def join_path(r):
        return os.path.join(mesh_dir, f"{key}-{r}.json")

    def read(path):
        try:
            return ckpt_mod.read_json(path)
        except ValueError:
            return None  # a write in flight; the next poll reads it

    ckpt_mod.atomic_write_json(join_path(mesh.rank),
                               {"rank": int(mesh.rank), "pid": os.getpid()})
    order = [int(r) for r in mesh.devices]
    deadline = clock.monotonic() + stall_s
    while True:
        doc = read(decision)
        if doc is not None:
            return [int(r) for r in doc["members"]]
        joined, pending = [], []
        for r in order:
            j = read(join_path(r))
            if j is not None:
                if health.pid_alive(int(j.get("pid", -1))):
                    joined.append(r)
                continue
            beat = health.read_member(mesh_dir, r)
            if beat is not None and not health.pid_alive(
                    int(beat.get("pid", -1))):
                continue
            pending.append(r)
        late = clock.monotonic() >= deadline
        if joined and joined[0] == mesh.rank and (not pending or late):
            _publish_once(decision, {"members": joined,
                                     "left_out": [r for r in order
                                                  if r not in joined]})
            continue
        if clock.monotonic() >= deadline + 2 * stall_s:
            raise RuntimeError(
                f"no survivor decided the re-formed mesh within "
                f"{3 * stall_s:g}s ({key})")
        clock.sleep(health._MESH_POLL_S)


def reform_mesh(mesh: Mesh, participant_lost: bool = False,
                axis_name: Optional[str] = None) -> Optional[Mesh]:
    """Re-forms ``mesh`` after a loss: this rank's view of a smaller mesh
    over the survivors, or None when nothing is left to shrink to (a
    one-rank mesh; the caller re-raises the loss). A survivor that is not
    a member of the new mesh gets ``MeshDeparted``. Every rank of the old
    mesh that is alive calls it at the same point.

    The new size always DIVIDES the old one, which lets the elastic resume
    regroup the saved per-(batch, rank) cells by summing contiguous groups
    (``ingest.assign.regroup_cells``):

    * an injected device loss (``participant_lost=False``: every rank
      raised ``DeviceLost`` at the same dispatch, the JAX package's
      single-controller case) keeps the largest proper-divisor prefix of
      the position order, and the ranks past it leave. Under ``hier`` the
      interleaved order puts host ``h``'s ``j``-th rank at position
      ``j * H + h``, so a prefix the host count divides is itself a
      ``hier`` interleave (each host sheds its highest slots); otherwise
      the new mesh is ``flat``;
    * a lost rank (``participant_lost=True``: dead, or stalled past the
      deadline) gives the largest proper divisor of the old size that is
      not above the number of survivors; the survivors agree on their set
      through the mesh directory's files, those of lowest position take
      positions 0..m-1 and the rest leave. The new mesh is ``flat`` (the
      JAX package's rule after a lost process). A survivor blocked in a
      collective of the old mesh joins when the group's timeout ends its
      wait; past the stall deadline the others decide without it, and it
      leaves.

    The new mesh's groups are process groups of its own, built on the
    generation's store, never through the default group (which still
    holds the lost rank) and never with ``new_group`` (collective over
    it)."""
    from pipelinedp_tpu_torch.resilience import health
    from pipelinedp_tpu_torch.resilience.clock import SystemClock
    mesh = require_mesh(mesh)
    axis_name = axis_name or mesh.axis_name
    old_n = int(mesh.size)
    old_topo = mesh.topology
    order = [int(r) for r in mesh.devices]
    generation = mesh.generation + 1
    if old_n <= 1:
        return None
    if participant_lost:
        alive = _agree_survivors(mesh, generation, SystemClock(),
                                 health.mesh_stall_s())
        m = _largest_proper_divisor(old_n, len(alive))
        members = alive[:m]
        topo = _flat_topology(m)
    else:
        m = _largest_proper_divisor(old_n, old_n)
        members = order[:m]
        if (old_topo.mode == "hier" and old_topo.n_hosts > 1
                and m % old_topo.n_hosts == 0):
            topo = MeshTopology("hier", old_topo.n_hosts,
                                m // old_topo.n_hosts, old_topo.simulated)
        else:
            topo = _flat_topology(m)
    if m < 1:
        return None
    if mesh.rank not in members:
        obs.event("mesh.departed", rank=int(mesh.rank), old_devices=old_n,
                  new_devices=m, generation=generation)
        raise MeshDeparted(
            f"rank {mesh.rank} is not a member of the re-formed mesh "
            f"({old_n} -> {m} ranks)", rank=mesh.rank, old_devices=old_n,
            new_devices=m)
    store = _reform_store(mesh) if m > 1 else None
    group = (_new_group(mesh, store, f"g{generation}/world", members)
             if m > 1 else _Group(None, members))
    new = Mesh(group=group, rank=mesh.rank, size=m,
               index=members.index(mesh.rank), device=mesh.device,
               backend=mesh.backend, axis_name=axis_name, topology=topo,
               devices=np.asarray(members, dtype=np.int64), uid=mesh.uid,
               generation=generation, timeout_s=mesh.timeout_s)
    if topo.hierarchical:
        for kind, groups in (("ici", _ici_groups(topo)),
                             ("dcn", _dcn_groups(topo))):
            for i, positions in enumerate(groups):
                sub = [members[p] for p in positions]
                if mesh.rank in sub:
                    setattr(new, kind, _new_group(
                        mesh, store, f"g{generation}/{kind}{i}", sub))
    obs.inc("mesh.reformed")
    obs.event("mesh.reformed", old_devices=old_n, new_devices=m,
              axis_name=axis_name,
              platform="gpu" if mesh.device.type == "cuda" else "cpu",
              topology=topo.mode, hosts=topo.n_hosts,
              per_host=topo.per_host)
    return new


# --- comms accounting -------------------------------------------------------

#: The exchanges already recorded, by (site, payload shape, dtype,
#: topology): see ``_record_exchange``.
_RECORDED: set = set()


def _payload_bytes(x: torch.Tensor) -> int:
    return int(x.numel()) * int(x.element_size())


def _record_exchange(kind: str, per_device_bytes: int, group_size: int,
                     crosses_hosts: bool, n_groups: int = 1) -> None:
    """Analytic byte estimate of one collective: a reduce-scatter or
    all-gather of B per-rank bytes over a group of g moves ~B*(g-1) bytes
    per group (ring schedule); an all-reduce twice that. A group that
    spans hosts counts as cross-host ("dcn"), a within-host group as
    within-host ("ici")."""
    if group_size <= 1:
        return
    per_group = per_device_bytes * (group_size - 1)
    if kind == "psum":
        per_group *= 2
    obs.inc("comms.collectives")
    obs.inc("comms.dcn_bytes" if crosses_hosts else "comms.ici_bytes",
            int(per_group * max(1, n_groups)))


def _first_time(site: str, kind: str, x: torch.Tensor, dim: int,
                topo: MeshTopology, generation: int = 0) -> bool:
    """True the first time this process makes the exchange at ``site`` (a
    name of the call site: one per exchange of a program) on a payload of
    this shape and dtype under this topology, on a mesh of this
    generation (a re-formed mesh's exchanges record anew, as the JAX
    package traces a new program for its new mesh).

    The JAX package records its comms counters when it traces an
    exchange, once per compiled program; a warm dispatch records
    nothing. The port traces nothing, so it records once per distinct
    (site, shape, dtype, dim, topology): a cold run's counters equal the
    JAX package's, and a repeat of the same shapes adds none (each
    collective still runs every time)."""
    key = (site, kind, tuple(x.shape), str(x.dtype), int(dim), topo,
           int(generation))
    if key in _RECORDED:
        return False
    _RECORDED.add(key)
    return True


# --- collectives on one group ------------------------------------------------

def _stage(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return x.cpu() if mesh.stages_on_host else x


def _unstage(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    return x.to(mesh.device) if mesh.stages_on_host else x


def _all_reduce(mesh: Mesh, g: _Group, x: torch.Tensor) -> torch.Tensor:
    y = _stage(mesh, x).clone()
    if g.size > 1:
        g.pg.allreduce([y]).wait()
    return _unstage(mesh, y)


def all_reduce_max(pg, x: torch.Tensor) -> torch.Tensor:
    """``x`` replaced in place by its element-wise MAX over the process
    group ``pg`` (a CPU tensor on a gloo group): the ranks' one degrade
    verdict (``resilience.health.agree_degraded``)."""
    pg.allreduce([x], dist.ReduceOp.MAX).wait()
    return x


def _reduce_scatter(mesh: Mesh, g: _Group, x: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """Sum over the group; member ``m`` keeps block ``m`` of ``dim``."""
    if g.size == 1:
        return x
    blocks = torch.chunk(_stage(mesh, x).movedim(dim, 0), g.size, dim=0)
    # Chunk i of the input goes to the member of torch group rank i.
    by_group_rank = [None] * g.size
    for m, blk in enumerate(blocks):
        by_group_rank[g.perm[m]] = blk
    inp = torch.cat(by_group_rank, dim=0).contiguous()
    out = torch.empty((inp.shape[0] // g.size,) + tuple(inp.shape[1:]),
                      dtype=inp.dtype, device=inp.device)
    g.pg._reduce_scatter_base(out, inp).wait()
    return _unstage(mesh, out.movedim(0, dim))


def _all_gather(mesh: Mesh, g: _Group, x: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Concatenates the members' blocks along ``dim`` in member order."""
    if g.size == 1:
        return x
    inp = _stage(mesh, x).movedim(dim, 0).contiguous()
    out = torch.empty((g.size * inp.shape[0],) + tuple(inp.shape[1:]),
                      dtype=inp.dtype, device=inp.device)
    g.pg._allgather_base(out, inp).wait()
    chunks = torch.chunk(out, g.size, dim=0)
    ordered = torch.cat([chunks[g.perm[m]] for m in range(g.size)], dim=0)
    return _unstage(mesh, ordered.movedim(0, dim))


# --- the exchange policy ----------------------------------------------------

def combine_shards(x: torch.Tensor, mesh: Mesh, dim: int, replicate: bool,
                   site: str = "combine") -> torch.Tensor:
    """The one cross-rank exchange policy (``combine_shards`` of the JAX
    package): an owner-block ``reduce_scatter`` along ``dim`` when each
    rank keeps only its owned partition block, a replicating
    ``all_reduce`` when every rank needs the whole sum (the stream's
    batches, pass-B tiles and the sketch on a multi-process mesh).

    Under a hierarchical topology the exchange runs in two fixed stages:
    within each host (ici) first, then across hosts (dcn) on blocks
    ``per_host`` times smaller. The payloads are exact integers, so hier
    and flat land on the same bits. A replicating payload that the
    per-host split cannot tile keeps the flat all-reduce. ``site`` names
    the call site for the comms counters (see ``_first_time``)."""
    topo = mesh.topology
    rec = _first_time(site, "psum" if replicate else "scatter", x, dim,
                      topo, mesh.generation)
    if not topo.hierarchical:
        if rec:
            _record_exchange("psum" if replicate else "reduce_scatter",
                             _payload_bytes(x), topo.n_devices,
                             topo.multi_host)
        if replicate:
            return _all_reduce(mesh, mesh.group, x)
        return _reduce_scatter(mesh, mesh.group, x, dim)
    H, k = topo.n_hosts, topo.per_host
    size = int(x.shape[dim])
    bytes_in = _payload_bytes(x)
    if replicate:
        if size % k:
            if rec:
                _record_exchange("psum", bytes_in, topo.n_devices, True)
            return _all_reduce(mesh, mesh.group, x)
        # reduce-scatter within the host, all-reduce of the block across
        # hosts, all-gather within the host.
        if rec:
            _record_exchange("reduce_scatter", bytes_in, k, False,
                             n_groups=H)
            _record_exchange("psum", bytes_in // k, H, True, n_groups=k)
            _record_exchange("all_gather", bytes_in // k, k, False,
                             n_groups=H)
        y = _reduce_scatter(mesh, mesh.ici, x, dim)
        y = _all_reduce(mesh, mesh.dcn, y)
        return _all_gather(mesh, mesh.ici, y, dim)
    if rec:
        _record_exchange("reduce_scatter", bytes_in, k, False, n_groups=H)
        _record_exchange("reduce_scatter", bytes_in // k, H, True,
                         n_groups=k)
    y = _reduce_scatter(mesh, mesh.ici, x, dim)
    return _reduce_scatter(mesh, mesh.dcn, y, dim)


def gather_blocks(x: torch.Tensor, mesh: Mesh, dim: int = 0,
                  site: Optional[str] = "gather") -> torch.Tensor:
    """The all-gather of every position's block along ``dim``, in position
    order: the dual of the owner-block scatter (the walk's per-level base
    fetch, the sweep's output replication). Under ``hier`` the blocks
    cross hosts first, then fan out within each host; the concatenation
    order is position order in both stages, so the result is the flat
    gather's. ``site`` names the call site for the comms counters; None
    keeps the exchange out of them: the gather of the owner blocks before
    the host release, which the JAX package makes as a host fetch, not as
    a collective."""
    topo = mesh.topology
    rec = site is not None and _first_time(site, "gather", x, dim, topo,
                                           mesh.generation)
    if not topo.hierarchical:
        if rec:
            _record_exchange("all_gather", _payload_bytes(x),
                             topo.n_devices, topo.multi_host)
        return _all_gather(mesh, mesh.group, x, dim)
    H, k = topo.n_hosts, topo.per_host
    bytes_in = _payload_bytes(x)
    if rec:
        _record_exchange("all_gather", bytes_in, H, True, n_groups=k)
        _record_exchange("all_gather", bytes_in * H, k, False, n_groups=H)
    y = _all_gather(mesh, mesh.dcn, x, dim)
    return _all_gather(mesh, mesh.ici, y, dim)


def scatter_to_owner(x: torch.Tensor, mesh: Mesh, dim: int = 0,
                     site: str = "scatter") -> torch.Tensor:
    """Owner-block reduce-scatter along ``dim``: ``combine_shards`` with
    ``replicate=False``."""
    return combine_shards(x, mesh, dim, False, site)


# --- the sharded fused aggregation ------------------------------------------

def owned_rows(pid: np.ndarray, mesh: Mesh) -> np.ndarray:
    """The indices of this rank's rows, ascending: the JAX package's
    stable sort by shard keeps each shard's rows in input order, so a
    row's index here is its shard-local index there (the position the
    tie-break bits are keyed by)."""
    return np.flatnonzero(shard_of_rows(pid, mesh.size) == mesh.index)


def sharded_fused_aggregate(mesh: Mesh, config, num_partitions: int,
                            pid: np.ndarray, pk: np.ndarray, values,
                            noise_scales, keep_table, sel_threshold,
                            sel_scale, sel_min_count, sel_rows_per_uid, key,
                            fx_bits: int = 7):
    """The fused device path on the mesh. ``pid``/``pk``/``values`` are the
    WHOLE encoded dataset (every rank holds it); this rank takes its own
    rows, bounds them under the per-position bounding key, reduces them
    over the global partition axis (rounded up to a multiple of the mesh
    size) and hands every owner its block; selection and the walk run on
    the owned block. Returns ``(keep_pk [P], columns)`` gathered back to
    the whole axis on every rank, on the rank's device."""
    from pipelinedp_tpu_torch import torch_engine as te
    from pipelinedp_tpu_torch.ops import prng
    n_dev = mesh.size
    P = -(-int(num_partitions) // n_dev) * n_dev
    P_own = P // n_dev
    rows = owned_rows(pid, mesh)
    device = mesh.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)

    pid_d = put(pid)
    pk_d = put(pk)
    values_d = put(values) if values is not None else None
    # The single device's three-way split; only the bounding stream folds
    # in the position.
    # lint: disable=rng-purity(root split seam, pure in the run seed)
    k_bound_g, k_sel, k_noise = prng.split(key, 3)
    # lint: disable=rng-purity(per-shard bound key: fold of the shard index)
    k_bound = prng.fold_in(k_bound_g, mesh.index)
    part, part_nseg, qrows = te._partials(config, P, pid_d, pk_d, values_d,
                                          k_bound, fx_bits)
    part = {name: scatter_to_owner(col, mesh, 0, f"fused.{name}")
            for name, col in sorted(part.items())}
    part_nseg = scatter_to_owner(part_nseg, mesh, 0, "fused.nseg")
    keep_own, out_own = te._selection_and_metrics(
        config, P_own, part, part_nseg, keep_table, sel_threshold,
        sel_scale, sel_min_count, sel_rows_per_uid, k_sel, k_noise=k_noise,
        noise_scales=noise_scales, qrows=qrows, mesh=mesh)
    return gather_owned(mesh, keep_own, out_own)


def gather_owned(mesh: Mesh, keep_own: torch.Tensor, out_own: Dict):
    """The owner blocks back on every rank: the rank-1 columns ride one
    int32 stack (float32 columns bitcast into it), the rank-2 VECTOR_SUM
    column its own gather. Left out of the comms counters (the JAX
    package fetches them to the host, no collective)."""
    flat = sorted(k for k, v in out_own.items() if v.dim() == 1)
    stack = torch.stack([keep_own.to(torch.int32)] + [
        out_own[k] if out_own[k].dtype == torch.int32 else
        out_own[k].contiguous().view(torch.int32) for k in flat])
    full = gather_blocks(stack, mesh, dim=1, site=None)
    out = {}
    for i, k in enumerate(flat):
        col = full[1 + i]
        out[k] = (col if out_own[k].dtype == torch.int32 else
                  col.contiguous().view(out_own[k].dtype))
    for k, v in out_own.items():
        if v.dim() != 1:
            out[k] = gather_blocks(v, mesh, dim=0, site=None)
    return full[0] > 0, out
