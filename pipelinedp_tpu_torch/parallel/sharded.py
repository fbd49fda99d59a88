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
"""

from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pipelinedp_tpu_torch import obs

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
    orders the chunks of a torch collective."""

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
    as the JAX package's mesh does)."""
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
    hostnames: List[Optional[str]] = [None] * world_size
    dist.all_gather_object(hostnames, socket.gethostname())
    order, topo = _build_topology(ranks, hostnames)
    rank = dist.get_rank()
    mesh = Mesh(group=_Group(group, order), rank=rank, size=world_size,
                index=order.index(rank), device=device, backend=backend,
                axis_name=axis_name, topology=topo,
                devices=np.asarray(order, dtype=np.int64))
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
                topo: MeshTopology) -> bool:
    """True the first time this process makes the exchange at ``site`` (a
    name of the call site: one per exchange of a program) on a payload of
    this shape and dtype under this topology.

    The JAX package records its comms counters when it traces an
    exchange, once per compiled program; a warm dispatch records
    nothing. The port traces nothing, so it records once per distinct
    (site, shape, dtype, dim, topology): a cold run's counters equal the
    JAX package's, and a repeat of the same shapes adds none (each
    collective still runs every time)."""
    key = (site, kind, tuple(x.shape), str(x.dtype), int(dim), topo)
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
        dist.all_reduce(y, group=g.pg)
    return _unstage(mesh, y)


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
    dist.reduce_scatter_tensor(out, inp, group=g.pg)
    return _unstage(mesh, out.movedim(0, dim))


def _all_gather(mesh: Mesh, g: _Group, x: torch.Tensor,
                dim: int) -> torch.Tensor:
    """Concatenates the members' blocks along ``dim`` in member order."""
    if g.size == 1:
        return x
    inp = _stage(mesh, x).movedim(dim, 0).contiguous()
    out = torch.empty((g.size * inp.shape[0],) + tuple(inp.shape[1:]),
                      dtype=inp.dtype, device=inp.device)
    dist.all_gather_into_tensor(out, inp, group=g.pg)
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
                      topo)
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
    rec = site is not None and _first_time(site, "gather", x, dim, topo)
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

def shard_of_rows(pid: np.ndarray, n_dev: int) -> np.ndarray:
    """Each row's mesh position: ``fmix32(pid) % n_dev`` (hashed before
    the modulo, so id families sharing low bits spread over the ranks).
    The single-batch path and the stream's cells both take it here."""
    from pipelinedp_tpu_torch.streaming import _fmix32
    return (_fmix32(pid.astype(np.uint32)) % np.uint32(n_dev)).astype(
        np.int64)


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
    k_bound_g, k_sel, k_noise = prng.split(key, 3)
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
