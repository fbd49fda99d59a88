"""The fused aggregation path in PyTorch: the counterpart of
``pipelinedp_tpu/jax_engine.py``.

The module keeps ``jax_engine``'s structure and names, so each function
here has its twin there, and its output is held bit for bit against that
twin in ``tests/test_torch_engine.py``::

    host:   extract + integer-encode (pid, pk, value); calibrate selection
    device: sort by (pid, hash(pid, pk, salt), tie-break)
            → Linf / L0 (or total-cap) bounding in row space
            → fixed-point int32 lanes → one [N, C] segment sum per pk
              (the hand-written CUDA kernel K1, ``ops/kernels/segsum.py``)
            → VECTOR_SUM: fixed-point coordinate lanes → one
              [N, n_lanes * D] segment sum per pk (kernel K2, same module)
            → batched partition selection over the pk axis
            → PERCENTILE: the quantile-tree walk over every partition at
              once (``_percentile_values``): a [P, 256] mid histogram
              (K1) serves the top two levels, [Pb, Q, 256] subtree-leaf
              histograms (kernel K3, ``ops/kernels/hist.py``) the bottom
              two
            → compaction of the kept partitions
    host:   float64 scalar release through ``dp_computations`` (the same
            mechanisms and the same ``np.random.default_rng(rng_seed)``
            draws as the JAX package), vector noise drawn on ``device``
            (``ops/vector_noise.py``), decode, MetricsTuple rows

The random streams are JAX's threefry streams, reproduced in
``ops/prng.py``: the same ``rng_seed`` gives the same bounding samples,
the same keep decisions, the same vector noise and the same quantile-tree
node noise as ``JaxBackend(rng_seed=...)``. The float32 arithmetic of the
walk follows XLA's CPU code op for op: sums and scans over the 16
children are sequential float32 adds, and the three multiply-adds XLA
contracts into one FMA go through ``prng.fma32``.

The port runs COUNT, PRIVACY_ID_COUNT, SUM, MEAN, VARIANCE and
PERCENTILE with per-value bounds, SUM with per-partition sum bounds
(``min_sum_per_partition`` / ``max_sum_per_partition``: each (pid, pk)
segment's float32 total, added in row order by kernel K4,
``ops/kernels/segtotal.py``, is clipped and contributed once), and
VECTOR_SUM, in (l0, linf), total-cap (not VECTOR_SUM) or
bounds-already-enforced mode, with public or private partitions, on one
device. A table of more rows than one batch streams through
``streaming.py`` (in two passes for PERCENTILE), the aggregations and
``select_partitions`` alike.

One function builds every subtree histogram of the walk,
``_subtree_counts_multi`` (K3 on the card), single-batch and streamed.
The JAX package's single-batch walk builds the same integers with XLA
scatters instead (``_build_sub_hist``'s prefix-sum row compaction, its
``_MAX_WALK_BLOCKS`` bound and the per-level-scatter fallback), for
reasons of the TPU: its Pallas binner must fit a 4 MB VMEM envelope and
its walk's block count bounds an XLA program's size. Neither holds for a
CUDA kernel launched from a host loop, so none of the three is ported:
past ``PIPELINEDP_TPU_SUBHIST_CAP`` the port walks partition blocks in a
host loop. The values do not depend on which path builds the integers.

VECTOR_SUM accumulates under the JAX package's
``vector_accumulator`` switch: ``fx`` (fixed-point lanes, bit-identical to
the JAX package) or ``f32`` (a float32 ``index_add_``, the default, equal
to the JAX package's float32 ``segment_sum`` up to the order of the
additions). The JAX package's ``segsum_wide_d_block`` knob, a VMEM tile
hint of its TPU kernel, is not ported: the CUDA kernel picks its own
tiling. Everything runs on ``device``: a CUDA device (the default of
``TorchBackend``) or the CPU when the caller asks for it, as the tests do.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import dp_computations, native, obs
from pipelinedp_tpu_torch import plan as plan_mod
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams,
                                                   MechanismType, NoiseKind,
                                                   NormKind,
                                                   PartitionSelectionStrategy)
from pipelinedp_tpu_torch.combiners import _create_named_tuple_instance
from pipelinedp_tpu_torch.obs import costs
from pipelinedp_tpu_torch.ops import counter_rng
from pipelinedp_tpu_torch.ops import noise as noise_ops
from pipelinedp_tpu_torch.ops import partition_selection as ps_ops
from pipelinedp_tpu_torch.ops import prng
from pipelinedp_tpu_torch.ops import quantile_tree
from pipelinedp_tpu_torch.ops import segment as seg_ops
from pipelinedp_tpu_torch.ops import vector_noise
from pipelinedp_tpu_torch.ops.kernels import hist, segsum, segtotal

#: VECTOR_SUM's accumulator, "f32" or "fx": the module seam of the
#: ``vector_accumulator`` knob (``plan/knobs.py``). The knob is not dp-safe
#: (the two release different floats), so a plan never sets it.
_VECTOR_ACCUMULATOR = "f32"


def _vector_accumulator() -> str:
    """The ``vector_accumulator`` knob: the environment, then the seam,
    then "f32"; an unknown value resolves to "f32"."""
    return str(plan_mod.knob_value("vector_accumulator"))


def _pad_pow2(n: int, minimum: int = 8) -> int:
    return max(minimum, 1 << (n - 1).bit_length())


def _pad_rows(n: int) -> int:
    """``jax_engine._pad_rows``: the next multiple of 8192 rows. The port
    pads no rows (``put_on_device``); the serve fusion layer uses this
    edge only to bucket requests as the JAX package does."""
    return max(8192, -(-n // 8192) * 8192)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as JAX's weak typing rounds a Python
    float that meets a float32 array."""
    return float(np.float32(v))


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    """Static configuration derived from AggregateParams."""
    metrics: Tuple[str, ...]  # subset of the fused metric names, in order
    noise_kind: NoiseKind
    linf: Optional[int]
    l0: int
    per_partition_bounds: bool  # SUM clips the per-(pid,pk) sum, not rows
    min_value: Optional[float]
    max_value: Optional[float]
    min_sum_per_partition: Optional[float]
    max_sum_per_partition: Optional[float]
    selection: Optional[PartitionSelectionStrategy]  # None = public
    bounds_already_enforced: bool
    percentiles: Tuple[float, ...] = ()  # PERCENTILE(p) parameters, in order
    # Total-cap bounding: M rows per privacy unit across ALL partitions
    # (l0/linf are None in this mode).
    max_contributions: Optional[int] = None
    vector_size: Optional[int] = None
    vector_norm_kind: Optional[NormKind] = None
    vector_max_norm: Optional[float] = None
    # VECTOR_SUM's accumulator, "f32" or "fx" (see _vector_accumulator);
    # resolved in from_params only when params.vector_size is set.
    vector_accumulator: str = "f32"

    @property
    def selection_l0(self) -> int:
        """L0 for partition selection: a unit touches at most this many
        partitions in either bounding mode."""
        return (self.max_contributions if self.max_contributions is not None
                else self.l0)

    @property
    def needs_values(self) -> bool:
        return bool(set(self.metrics) & _VALUE_METRICS
                    ) or self.per_partition_bounds

    @staticmethod
    def from_params(params: AggregateParams, public: bool) -> "FusedConfig":
        # Every PERCENTILE(p) folds into one "PERCENTILE" metric; the
        # parameters keep their order in ``percentiles``.
        names = []
        percentiles = []
        for m in params.metrics:
            if m.is_percentile:
                percentiles.append(float(m.parameter))
                if "PERCENTILE" not in names:
                    names.append("PERCENTILE")
            else:
                names.append(m.name)
        return FusedConfig(
            metrics=tuple(names),
            percentiles=tuple(percentiles),
            noise_kind=params.noise_kind,
            linf=params.max_contributions_per_partition,
            l0=params.max_partitions_contributed,
            max_contributions=params.max_contributions,
            per_partition_bounds=params.bounds_per_partition_are_set,
            min_value=params.min_value,
            max_value=params.max_value,
            min_sum_per_partition=params.min_sum_per_partition,
            max_sum_per_partition=params.max_sum_per_partition,
            selection=(None if public else
                       params.partition_selection_strategy),
            bounds_already_enforced=(
                params.contribution_bounds_already_enforced),
            vector_size=params.vector_size,
            vector_norm_kind=params.vector_norm_kind,
            vector_max_norm=params.vector_max_norm,
            vector_accumulator=(_vector_accumulator() if params.vector_size
                                else "f32"),
        )


FUSABLE_METRICS = {"COUNT", "PRIVACY_ID_COUNT", "SUM", "MEAN", "VARIANCE",
                   "VECTOR_SUM", "PERCENTILE"}
_VALUE_METRICS = {"SUM", "MEAN", "VARIANCE", "VECTOR_SUM", "PERCENTILE"}


def params_are_fusable(params: AggregateParams) -> bool:
    """``jax_engine.params_are_fusable``: whether the JAX package runs
    these params on its fused plane. A percentile needs real tree bounds,
    and a range so small that ``n_leaves / range`` overflows float32 goes
    to the host path, which computes the leaf in float64 (``_qrows``
    folds that constant into one float32)."""
    if params.custom_combiners:
        return False
    for m in params.metrics:
        if m.is_percentile:
            if (params.min_value is None or
                    not params.min_value < params.max_value):
                return False
            n_leaves = (quantile_tree.DEFAULT_BRANCHING_FACTOR**
                        quantile_tree.DEFAULT_TREE_HEIGHT)
            inv = n_leaves / (float(params.max_value) -
                              float(params.min_value))
            if inv > float(np.finfo(np.float32).max):
                return False
        elif m.name not in FUSABLE_METRICS:
            return False
    return True


# ---------------------------------------------------------------------------
# Host-side encoding
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ArrayDataset:
    """Columnar input: NumPy columns ``privacy_ids`` [N] (or None when
    contribution bounds are already enforced), ``partition_keys`` [N] and
    ``values`` [N] (or [N, D] for VECTOR_SUM). The integer encoding and
    the device copies are cached on the dataset, so the columns are
    treated as immutable once the first aggregation runs — call
    ``invalidate_cache()`` after mutating them in place."""
    privacy_ids: Optional[np.ndarray]
    partition_keys: np.ndarray
    values: Optional[np.ndarray] = None

    def __len__(self):
        return len(self.partition_keys)

    def invalidate_cache(self) -> None:
        """Drops cached encodings/device buffers (after in-place edits)."""
        self.__dict__.pop("_encode_cache", None)

    def _cached_encode(self, key, build):
        cache = self.__dict__.setdefault("_encode_cache", {})
        if key not in cache:
            cache[key] = build()
        return cache[key]

    def to_rows(self):
        """Row-tuple view ``(pid, pk, value)`` for the host path (a zero
        pid or value where the column is None)."""
        n = len(self.partition_keys)
        pids = (self.privacy_ids if self.privacy_ids is not None else
                np.zeros(n, np.int64))
        vals = (self.values if self.values is not None else
                np.zeros(n, np.float64))
        return list(zip(pids.tolist(), self.partition_keys.tolist(),
                        vals.tolist()))


@dataclasses.dataclass
class EncodedData:
    """Integer-encoded rows + the pk vocabulary for decoding."""
    pid: np.ndarray  # int32 [N]
    pk: np.ndarray  # int32 [N]
    values: np.ndarray  # f32 [N], or [N, D] for VECTOR_SUM
    pk_vocab: List[Any]  # dense pk index -> original key
    n_rows: int


def _int_factorize(arr: np.ndarray):
    """Sort-free factorization for integer keys with a manageable range:
    O(n + range) via a presence table. Returns (uniq values ascending,
    int32 inverse) or None when the range is too wide for a table."""
    if arr.dtype.kind not in "iu" or arr.size == 0:
        return None
    mn = int(arr.min())
    mx = int(arr.max())
    span = mx - mn + 1
    if span > max(4 * arr.size, 1 << 22):
        return None
    # Unsigned subtraction is exact (arr >= mn), signed fits int64.
    if arr.dtype.kind == "u":
        offs = (arr - np.asarray(mn, arr.dtype)).astype(np.int64)
    else:
        offs = arr.astype(np.int64) - mn
    present = np.zeros(span, dtype=bool)
    present[offs] = True
    uniq_off = np.flatnonzero(present)
    lookup = np.empty(span, dtype=np.int32)
    lookup[uniq_off] = np.arange(len(uniq_off), dtype=np.int32)
    uniq = uniq_off.astype(arr.dtype) + np.asarray(mn, arr.dtype)
    return uniq, lookup[offs]


def _unique_inverse(arr: np.ndarray):
    """``np.unique(arr, return_inverse=True)`` with an int32 inverse.
    Integer keys take the native hash factorizer (``native/encode.cc``:
    O(N + U log U) against the sort's O(N log N)) when ``g++`` can build
    it; its result is ``np.unique``'s bit for bit, so the fallback to the
    sort returns the same ids."""
    if arr.dtype.kind in "iu" and native.encode_available():
        try:
            uniq, inv = native.factorize_i64(arr)
        except (ValueError, native.NativeUnavailableError):
            pass  # uint64 above int64 max, or no memory: the sort decides
        else:
            return uniq.astype(arr.dtype), inv
    uniq, inv = np.unique(arr, return_inverse=True)
    return uniq, inv.astype(np.int32)


def _pid_ids(pid_arr: np.ndarray) -> np.ndarray:
    """int32 ids for privacy units: any injective mapping works, so
    in-range integer ids pass through. PAD_ID (int32 max) stays reserved,
    as in the JAX package."""
    if (pid_arr.dtype.kind in "iu" and pid_arr.size and
            pid_arr.min() >= 0 and pid_arr.max() < np.iinfo(np.int32).max):
        return pid_arr.astype(np.int32)
    fac = _int_factorize(pid_arr)
    if fac is not None:
        return fac[1]
    return _unique_inverse(pid_arr)[1]


def array_dataset_to_rows(ds: ArrayDataset, data_extractors,
                          require_pid: bool = True):
    """Columnar input on the host path: row tuples with positional
    extractors, shared by ``DPEngine._aggregate`` and the histogram graph.
    Caller-supplied extractors are kept when a partition extractor is
    set."""
    import operator

    from pipelinedp_tpu_torch.dp_engine import DataExtractors

    if ds.privacy_ids is None and require_pid:
        raise ValueError(
            "ArrayDataset.privacy_ids must be set unless "
            "contribution_bounds_already_enforced is True.")
    rows = ds.to_rows()
    if data_extractors.partition_extractor is None:
        data_extractors = DataExtractors(
            privacy_id_extractor=(None if not require_pid else
                                  operator.itemgetter(0)),
            partition_extractor=operator.itemgetter(1),
            value_extractor=operator.itemgetter(2))
    return rows, data_extractors


def _encode_arrays(ds: ArrayDataset, public_partitions: Optional[Sequence],
                   require_pid: bool = True,
                   vector_size: Optional[int] = None) -> EncodedData:
    """Vectorized encode of columnar input (no per-row Python); values
    come out [N, vector_size] when ``vector_size`` is set."""
    pk_arr = np.asarray(ds.partition_keys)
    n = pk_arr.shape[0]
    if ds.privacy_ids is None and require_pid:
        raise ValueError(
            "ArrayDataset.privacy_ids must be set unless "
            "contribution_bounds_already_enforced is True — without them "
            "all rows would be attributed to one privacy unit and almost "
            "all data silently dropped by contribution bounding.")
    pid_arr = (np.asarray(ds.privacy_ids) if ds.privacy_ids is not None
               else np.zeros(n, np.int64))
    with obs.span("encode.values", cat="encode"):
        values = (np.asarray(ds.values, dtype=np.float32)
                  if ds.values is not None else np.zeros(n, np.float32))
    with obs.span("encode.pk", cat="encode"):
        if public_partitions is not None:
            vocab = np.asarray(list(public_partitions))
            sorter = np.argsort(vocab, kind="stable")
            pos = np.searchsorted(vocab, pk_arr, sorter=sorter)
            pos = np.clip(pos, 0, len(vocab) - 1)
            candidate = sorter[pos]
            mask = vocab[candidate] == pk_arr
            pk_idx = candidate[mask].astype(np.int32)
            pid_arr = pid_arr[mask]
            values = values[mask]
            pk_vocab = list(vocab.tolist())
        else:
            fac = _int_factorize(pk_arr)
            if fac is not None:
                uniq, pk_idx = fac
            else:
                uniq, pk_idx = _unique_inverse(pk_arr)
            pk_vocab = list(uniq.tolist())
    with obs.span("encode.pid", cat="encode"):
        pid = _pid_ids(pid_arr)
    if vector_size:
        values = values.reshape(len(values), vector_size)
    return EncodedData(pid=pid, pk=pk_idx, values=values,
                       pk_vocab=pk_vocab, n_rows=len(pk_idx))


def _itemgetter_index(fn) -> Optional[int]:
    """The index a plain single-item ``operator.itemgetter`` selects, or
    None for any other callable."""
    if type(fn) is not operator.itemgetter:
        return None

    class _Probe:
        def __init__(self):
            self.indices = []

        def __getitem__(self, i):
            self.indices.append(i)
            return i

    probe = _Probe()
    try:
        result = fn(probe)
    except Exception:
        return None
    if len(probe.indices) == 1 and result == probe.indices[0]:
        return probe.indices[0]
    return None


def _rows_to_arrays(rows, data_extractors,
                    require_pid: bool) -> Optional[ArrayDataset]:
    """Numeric tuple rows with ``operator.itemgetter`` extractors become
    columns and take the vectorized encode, as in the JAX package (the
    two encodes order the pk vocabulary differently, and the order decides
    which partition draws which host noise). Returns None when the rows
    or extractors do not qualify."""
    if not isinstance(rows, (list, tuple)) or not rows:
        return None
    if not isinstance(rows[0], (tuple, list)):
        return None
    i_pid = _itemgetter_index(data_extractors.privacy_id_extractor)
    i_pk = _itemgetter_index(data_extractors.partition_extractor)
    i_val = _itemgetter_index(data_extractors.value_extractor)
    if i_pk is None or (require_pid and i_pid is None):
        return None
    if data_extractors.value_extractor is not None and i_val is None:
        return None

    def col(i, sample):
        try:
            arr = np.asarray([r[i] for r in sample])
        except (IndexError, ValueError, TypeError):
            return None
        if arr.dtype == object or arr.dtype.kind not in "iuf":
            return None
        return arr

    for i in (i_pk, i_pid, i_val):
        if i is not None and col(i, rows[:256]) is None:
            return None
    cols = {}
    for name, i in (("pk", i_pk), ("pid", i_pid), ("val", i_val)):
        if i is None:
            cols[name] = None
            continue
        cols[name] = col(i, rows)
        if cols[name] is None or (name != "val" and cols[name].ndim != 1):
            return None
    return ArrayDataset(privacy_ids=cols["pid"], partition_keys=cols["pk"],
                        values=cols["val"])


def encode(rows, data_extractors, public_partitions: Optional[Sequence] = None,
           require_pid: bool = True,
           vector_size: Optional[int] = None) -> EncodedData:
    """Extract + integer-encode on host. With public partitions the pk
    vocabulary IS the public list — non-public rows are dropped and missing
    public partitions appear as all-zero accumulator rows. With
    ``vector_size`` the values are float32 [N, vector_size]."""
    if isinstance(rows, ArrayDataset):
        if public_partitions is None:
            return rows._cached_encode(
                ("encode", vector_size, require_pid),
                lambda: _encode_arrays(rows, None, require_pid, vector_size))
        return _encode_arrays(rows, public_partitions, require_pid,
                              vector_size)
    bridged = _rows_to_arrays(rows, data_extractors, require_pid)
    if bridged is not None:
        return _encode_arrays(bridged, public_partitions, require_pid,
                              vector_size)
    pid_ex = data_extractors.privacy_id_extractor
    pk_ex = data_extractors.partition_extractor
    val_ex = data_extractors.value_extractor
    if pid_ex is None and require_pid:
        raise ValueError(
            "privacy_id_extractor must be set unless "
            "contribution_bounds_already_enforced is True.")
    pids, pks, vals = [], [], []
    for row in rows:
        pids.append(pid_ex(row) if pid_ex else 0)
        pks.append(pk_ex(row))
        vals.append(val_ex(row) if val_ex else 0.0)
    if public_partitions is not None:
        pk_vocab = list(public_partitions)
        pk_index = {k: i for i, k in enumerate(pk_vocab)}
        keep = [i for i, k in enumerate(pks) if k in pk_index]
        pids = [pids[i] for i in keep]
        vals = [vals[i] for i in keep]
        pk_idx = np.fromiter((pk_index[pks[i]] for i in keep),
                             dtype=np.int32, count=len(keep))
    else:
        pk_vocab = sorted(set(pks), key=repr)
        pk_index = {k: i for i, k in enumerate(pk_vocab)}
        pk_idx = np.fromiter((pk_index[k] for k in pks), dtype=np.int32,
                             count=len(pks))
    uniq_pids = {p: i for i, p in enumerate(dict.fromkeys(pids))}
    pid_idx = np.fromiter((uniq_pids[p] for p in pids), dtype=np.int32,
                          count=len(pids))
    values = np.asarray(vals, dtype=np.float32)
    if vector_size:
        values = values.reshape(len(vals), vector_size)
    return EncodedData(pid=pid_idx, pk=pk_idx, values=values,
                       pk_vocab=pk_vocab, n_rows=len(pid_idx))


def put_on_device(encoded: EncodedData, device: torch.device,
                  with_values: bool = True):
    """The encoded columns on ``device``: (pid, pk) int32 [N] and, when
    asked, values float32 [N] or [N, D]. The copies are cached on the
    EncodedData per device, so repeated aggregations of one dataset move
    the columns once.

    Unlike the JAX package's ``pad_and_put``, the row axis is not padded:
    PyTorch compiles nothing per shape, and every row-space quantity of
    the bounding is a function of the real rows alone (the tie-break bits
    are keyed by row position, padding rows sort last), so the padding
    could not change a result."""
    cache = encoded.__dict__.setdefault("_device_cache", {})
    key = str(device)
    if ("ids", key) not in cache:
        cache[("ids", key)] = (
            torch.from_numpy(np.ascontiguousarray(encoded.pid)).to(device),
            torch.from_numpy(np.ascontiguousarray(encoded.pk)).to(device))
    pid, pk = cache[("ids", key)]
    values = None
    if with_values:
        if ("values", key) not in cache:
            cache[("values", key)] = torch.from_numpy(
                np.ascontiguousarray(encoded.values)).to(device)
        values = cache[("values", key)]
    return pid, pk, values


# ---------------------------------------------------------------------------
# The device path
# ---------------------------------------------------------------------------


@costs.instrumented(phase="engine")
def _fused_body(config: FusedConfig, num_partitions: int, pid, pk, values,
                noise_scales, keep_table, sel_threshold, sel_scale,
                sel_min_count, sel_rows_per_uid, key, fx_bits: int):
    """``jax_engine._fused_kernel_body``: the one root split into the
    bounding, selection and noise streams, then bounding, reduction,
    selection and the percentile walk."""
    # lint: disable=rng-purity(root split seam, pure in the run seed)
    k_bound, k_sel, k_noise = prng.split(key, 3)
    part, part_nseg, qrows = _partials(config, num_partitions, pid, pk,
                                       values, k_bound, fx_bits)
    return _selection_and_metrics(
        config, num_partitions, part, part_nseg, keep_table, sel_threshold,
        sel_scale, sel_min_count, sel_rows_per_uid, k_sel, k_noise=k_noise,
        noise_scales=noise_scales, qrows=qrows)


def _lexsort_pid_hpk_tie(pid: torch.Tensor, hpk: torch.Tensor,
                         tie: torch.Tensor,
                         req: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jnp.lexsort((tie, hpk, pid))``: the permutation that orders rows
    by pid, then hpk, then tie, ties by position. Two stable sorts, last
    key first: (hpk, tie) packed into one int64 — hpk shifted into the
    signed range, since unsigned order must survive in int64 — then pid.
    A fused batch (``fused_aggregate_batch``) passes each row's request
    index ``req`` as the most significant key: the second sort then takes
    ``req << 32 | (pid + 2^31)``, one int64, so the batch sorts as often
    as one request does."""
    inner = ((hpk - 2**31) << 32) | tie
    order = torch.sort(inner, stable=True).indices
    outer = pid[order]
    if req is not None:
        outer = (req[order] << 32) | (outer + 2**31)
    by_pid = torch.sort(outer, stable=True).indices
    return order[by_pid]


def _partials(config: FusedConfig, num_partitions: int, pid, pk, values,
              key, fx_bits: int = 7):
    """Contribution bounding + per-pk accumulator partials
    (``jax_engine._partials``). ``pid``/``pk`` int32 [N], ``values``
    float32 [N] or [N, D] (or None when no metric reads values), all on
    one device. Returns (columns dict of int32 [P], plus VECTOR_SUM's
    [P, W] column; the privacy-id-count column; the percentile row view
    ``_qrows`` of the bounded rows, or None without percentiles)."""
    with obs.span("engine.bound", cat="engine"):
        b = _bound_rows(config, pid, pk, values, key)
    with obs.span("engine.reduce", cat="engine"):
        part, nseg = _reduce_per_pk(config, b.spk, b.masked, b.keep_row,
                                    num_partitions, seg_marker=b.seg_marker,
                                    fx_bits=fx_bits, contrib=b.contrib)
    if config.bounds_already_enforced:
        # Without pids every row counts as its own privacy unit.
        nseg = part["count"]
    qrows = None
    if config.percentiles:
        with obs.span("engine.walk", cat="engine"):
            qrows = _qrows(config, b.spk, b.svalues, b.keep_row)
    return part, nseg, qrows


def _bounded_qrows(config: FusedConfig, pid, pk, values, key):
    """The percentile row view alone, for the streamed pass B: the same
    bounding as ``_partials`` under the same key, without the reduction."""
    b = _bound_rows(config, pid, pk, values, key)
    return _qrows(config, b.spk, b.svalues, b.keep_row)


class Bounded(NamedTuple):
    """The bounded rows, each [N] (values [N] or [N, D]) in the bounding's
    sorted row order: pk; the clipped values zeroed outside the kept rows
    (or None); the kept-row mask; the kept-segment marker (None without
    privacy ids); the first row of each (pid, pk) segment (None without
    privacy ids); the unclipped values (or None); for the
    per-partition-sum-bounds SUM, each contributing segment's clipped
    float32 total on its marker row, zero elsewhere (or None); and in a
    fused batch each row's request index (None for one request)."""
    spk: torch.Tensor
    masked: Optional[torch.Tensor]
    keep_row: torch.Tensor
    seg_marker: Optional[torch.Tensor]
    new_seg: Optional[torch.Tensor]
    svalues: Optional[torch.Tensor]
    contrib: Optional[torch.Tensor]
    sreq: Optional[torch.Tensor] = None


def _clip_sum(config: FusedConfig, x):
    """``jnp.clip(x, min_sum, max_sum)``: the Python-float bounds meet a
    float32 array, so they round to float32 first."""
    return torch.clamp(x, _f32(config.min_sum_per_partition),
                       _f32(config.max_sum_per_partition))


class _Streams(NamedTuple):
    """One request's bounding streams over its rows: the segment hash
    ``hpk``, the row tie-breaks and the total-cap sample bits (a
    zero-argument function: they are drawn after the sort has freed
    ``hpk`` and the tie-breaks, so the three never sit in memory
    together)."""
    hpk: torch.Tensor
    tiebreak: torch.Tensor
    tie_m: Any


def _bounding_streams(pid, pk, key) -> _Streams:
    """The bounding streams of one request under its bounding key: the
    tie-breaks keyed by row position, the per-run salt of the segment
    hash, and the total-cap sample bits."""
    n = pid.shape[0]
    device = pid.device
    # lint: disable=rng-purity(bounding streams split from k_bound, pure in the run seed)
    k_tie, k_salt, k_m = prng.split(key, 3)
    # lint: disable=rng-purity(per-run salt from the bounding stream)
    salt = int(prng.bits(k_salt, ()))
    # lint: disable=rng-purity(bounding tie-break bits, keyed by k_bound)
    tiebreak = counter_rng.row_bits(k_tie, n, device)
    # Sampling priority of segment (pid, pk): an independent uniform
    # permutation of each pid's partitions. For fixed (pid, salt),
    # pk -> hpk is injective, so (pid, hpk) identifies the segment.
    hpk = seg_ops.fmix32(seg_ops.fmix32(pid.to(torch.int64) ^ salt)
                         ^ pk.to(torch.int64))
    return _Streams(hpk, tiebreak,
                    # lint: disable=rng-purity(total-cap sample bits, keyed by k_bound)
                    lambda: counter_rng.row_bits(k_m, n, device))


def _bound_rows(config: FusedConfig, pid, pk, values, key) -> Bounded:
    """Contribution bounding in row space (``jax_engine._partials`` up to
    the reduction); see ``Bounded``."""
    if config.bounds_already_enforced:
        return _bound_enforced(config, pk, values)
    return _bound_sorted(config, pid, pk, values,
                         _bounding_streams(pid, pk, key))


def _bound_enforced(config: FusedConfig, pk, values, req=None) -> Bounded:
    """No privacy ids: every row is its own "segment"; no sampling."""
    row_keep = torch.ones(pk.shape[0], dtype=torch.bool, device=pk.device)
    masked = _clip_values(config, values) if config.needs_values else None
    contrib = None
    if config.per_partition_bounds:
        # One row = one segment: the per-segment sum clip is a row clip,
        # and the clipped row is also the masked value.
        masked = contrib = _clip_sum(config, masked)
    return Bounded(pk, masked, row_keep, None, None, values, contrib, req)


def _bound_sorted(config: FusedConfig, pid, pk, values, streams: _Streams,
                  req=None) -> Bounded:
    """The bounding proper: one sort by (pid, hpk, tie), then Linf/L0 (or
    total-cap) sampling in row space. ``req`` (int64 [N], a fused batch's
    request index of each row) is the most significant sort key, and
    every run boundary also breaks where it changes, so no run crosses
    from one request into the next."""
    n = pid.shape[0]
    device = pid.device
    big_pid = pid.to(torch.int64)
    sort_idx = _lexsort_pid_hpk_tie(big_pid, streams.hpk, streams.tiebreak,
                                    req)
    tie_m = streams.tie_m
    del streams  # the only reference: frees hpk and the tie-breaks
    spid = big_pid[sort_idx]
    spk = pk[sort_idx]
    svalues = values[sort_idx] if config.needs_values else None
    idx = torch.arange(n, device=device)

    new_pid = (idx == 0) | (spid != torch.roll(spid, 1))
    sreq = None
    if req is not None:
        sreq = req[sort_idx]
        new_pid = new_pid | (sreq != torch.roll(sreq, 1))
    new_seg = new_pid | (spk != torch.roll(spk, 1))
    if config.max_contributions is not None:
        # Total-cap mode: a uniform without-replacement sample of M rows
        # per privacy unit, ranked by an independent random key
        # (``lexsort((tie_m, pid))``: pid < 2^31, so pid << 32 | tie_m is
        # one int64 key), carried back through the permutations. A fused
        # batch puts the request first with one more stable sort: the
        # three keys need 66 bits.
        order_m = torch.sort((big_pid << 32) | tie_m(),
                             stable=True).indices
        if req is not None:
            order_m = order_m[torch.sort(req[order_m], stable=True).indices]
        mpid = big_pid[order_m]
        new_pid_m = (idx == 0) | (mpid != torch.roll(mpid, 1))
        if req is not None:
            mreq = req[order_m]
            new_pid_m = new_pid_m | (mreq != torch.roll(mreq, 1))
        keep_sorted = (seg_ops.rank_in_run(new_pid_m) <
                       config.max_contributions)
        keep_m = torch.zeros(n, dtype=torch.bool, device=device)
        keep_m[order_m] = keep_sorted
        keep_row = keep_m[sort_idx]
        # The first KEPT row of each segment marks the (pid, pk) pair.
        wk = torch.cumsum(keep_row.to(torch.int64), dim=0)
        seg_start = seg_ops.run_starts(new_seg)
        kept_before_seg = wk[seg_start] - keep_row[seg_start].to(torch.int64)
        seg_marker = keep_row & (wk == kept_before_seg + 1)
    else:
        # Linf: the first linf (randomly ordered) rows per segment.
        linf_cap = config.linf if config.linf is not None else n
        row_keep = seg_ops.rank_in_run(new_seg) < linf_cap
        # L0: the segment's ordinal within its pid must be < l0.
        keep_l0 = seg_ops.run_ordinal_in_group(new_seg, new_pid) < config.l0
        keep_row = row_keep & keep_l0
        seg_marker = new_seg & keep_l0

    masked = None
    contrib = None
    if config.needs_values:
        clipped = _clip_values(config, svalues)
        masked = torch.where(_expand(keep_row, clipped), clipped, 0.0)
    if config.per_partition_bounds:
        # Clip each (pid, pk) segment's float32 SUM, contributed once per
        # segment, on its marker row. The totals must add each segment's
        # rows in order, as the reference's scatter does: kernel K4.
        tot = segtotal.segment_totals(masked.contiguous(), new_seg)
        contrib = torch.where(seg_marker, _clip_sum(config, tot), 0.0)
    return Bounded(spk, masked, keep_row, seg_marker, new_seg, svalues,
                   contrib, sreq)


# Fixed-point value accumulation: quantization grid (2^23 steps over the
# clip bound) split into integer lanes whose int32 segment sums stay
# exact. The lane width adapts to the row count: a lane of ``bits`` bits
# accumulates up to 2^31 / (2^bits - 1) rows exactly.
_FX_STEPS = 1 << 23
_FX_OFFSET = 1 << 23
_FX_PAYLOAD_BITS = 24  # offset-shifted u fits 24 bits (u <= 2^24 - 1)
_LANE_SUM_CAP = 1 << 31


def _fx_max_rows() -> int:
    """Largest row count the narrowest (4-bit) lane plan sums exactly."""
    return (_LANE_SUM_CAP - 1) // 15


def _fx_plan(n_rows_total: int) -> Tuple[int, int]:
    """(lane_bits, n_lanes) for a pipeline with ``n_rows_total`` rows."""
    bits = 12
    while bits > 4 and n_rows_total * ((1 << bits) - 1) >= _LANE_SUM_CAP:
        bits -= 1
    if n_rows_total * ((1 << bits) - 1) >= _LANE_SUM_CAP:
        raise NotImplementedError(
            f"fixed-point value lanes support up to 2^27 rows per batch "
            f"(got {n_rows_total})")
    return bits, -(-_FX_PAYLOAD_BITS // bits)


@dataclasses.dataclass(frozen=True)
class _FxSpec:
    """One fixed-point accumulated value column."""
    name: str
    bound: float  # |y| <= bound
    signed: bool  # signed columns ship offset by _FX_OFFSET
    count_col: str  # column holding the number of contributing entries

    @property
    def scale(self) -> float:
        return (_FX_STEPS - 1) / self.bound if self.bound > 0 else 1.0


def _fixedpoint_layout(config: FusedConfig) -> List[_FxSpec]:
    """The value columns accumulated in fixed point; static in the config,
    so device and host release agree on the encoding."""
    names = set(config.metrics)
    if "VECTOR_SUM" in names or not (names & {"SUM", "MEAN", "VARIANCE"}):
        return []
    if config.per_partition_bounds:
        bound = max(abs(config.min_sum_per_partition),
                    abs(config.max_sum_per_partition))
        return [_FxSpec("sum", bound, True, "privacy_id_count_raw")]
    r = (config.max_value - config.min_value) / 2.0
    specs = [_FxSpec("nsum", r, True, "count")]
    if "VARIANCE" in names:
        specs.append(_FxSpec("nsumsq", r * r, False, "count"))
    return specs


def _vector_fx(config: FusedConfig) -> bool:
    """Whether VECTOR_SUM accumulates in fixed-point coordinate lanes."""
    return ("VECTOR_SUM" in config.metrics
            and config.vector_accumulator == "fx")


def _vector_fx_scale(config: FusedConfig) -> float:
    """Quantization scale of the vector coordinate grid: 2^23 - 1 steps
    over the norm clip bound. The quantizer's clamp is also a per-row
    coordinate clamp at +-vector_max_norm, before aggregation; the release
    still norm-clips the per-partition sum at the same bound."""
    bound = float(config.vector_max_norm or 0.0)
    return (_FX_STEPS - 1) / bound if bound > 0 else 1.0


def _expand(mask, like):
    """Broadcasts a [N] mask against [N] or [N, D] data."""
    return mask[:, None] if like.dim() == 2 else mask


def _clip_values(config: FusedConfig, values):
    # Vectors are norm-clipped on the per-partition sum at release; only
    # per-value bounds clip row-wise here.
    if (config.vector_size or config.per_partition_bounds or
            config.min_value is None):
        return values
    return torch.clamp(values, _f32(config.min_value),
                       _f32(config.max_value))


def _lane_stack(config: FusedConfig, masked, keep_row, seg_marker=None,
                fx_bits: int = 7, contrib=None,
                capacity_rows: Optional[int] = None):
    """The int32 [N, C] stack that ``_reduce_per_pk`` reduces, and the
    names of its value lanes: the kept-row count, the segment marker (when
    given) and the fixed-point lanes of each value column; the
    per-partition-bounds ``sum`` column quantizes ``contrib`` on the
    marker rows. The value arithmetic is float32, as in the JAX package:
    ``y * scale`` rounds ``scale`` to float32 first (JAX's weak typing),
    and ``torch.round`` rounds half to even like ``jnp.round``.
    ``capacity_rows`` bounds the rows of any one partition (a fused
    batch's largest member; all rows by default): lanes of ``fx_bits``
    bits must sum that many rows exactly."""
    int_cols = [keep_row.to(torch.int32)]
    lane_names: List[str] = []
    if seg_marker is not None:
        int_cols.append(seg_marker.to(torch.int32))
    n_lanes = -(-_FX_PAYLOAD_BITS // fx_bits)
    layout = _fixedpoint_layout(config)
    rows = keep_row.shape[0] if capacity_rows is None else capacity_rows
    if (layout or _vector_fx(config)) and max(rows, 1) * (
            (1 << fx_bits) - 1) >= _LANE_SUM_CAP:
        raise NotImplementedError(
            f"{rows} rows overflow {fx_bits}-bit fixed-point "
            "lanes; pass a smaller fx_bits (see _fx_plan)")
    if any(spec.name != "sum" for spec in layout):
        middle = _f32(dp_computations.compute_middle(config.min_value,
                                                     config.max_value))
        centred = masked - middle
    for spec in layout:
        mask = keep_row
        if spec.name == "sum":  # per-partition-bound mode
            y = contrib
            if seg_marker is not None:
                mask = seg_marker
        elif spec.name == "nsum":
            y = centred
        else:  # nsumsq. A product with no add after it: no FMA to match.
            y = centred * centred
        # Clamp after rounding: float32 rounding of y * scale at the clip
        # boundary can land one step past +-(2^23 - 1).
        q = torch.clamp(torch.round(y * _f32(spec.scale)),
                        -(_FX_STEPS - 1), _FX_STEPS - 1).to(torch.int32)
        u = torch.where(mask, q + (_FX_OFFSET if spec.signed else 0), 0)
        for k in range(n_lanes):
            int_cols.append((u >> (k * fx_bits)) & ((1 << fx_bits) - 1))
            lane_names.append(f"{spec.name}_fx{k}")
    return torch.stack(int_cols, dim=1).contiguous(), lane_names


def _vector_lanes(config: FusedConfig, masked, keep_row, fx_bits: int):
    """VECTOR_SUM's fixed-point coordinate lanes, int32 [N, n_lanes * D]
    lane-major: each coordinate quantized to the 2^23-step grid over the
    norm clip bound (float32 ``masked * scale`` with ``scale`` rounded to
    float32, half-to-even ``torch.round``, as in the JAX package), clamped,
    offset into 24 bits and split into ``n_lanes`` planes of ``fx_bits``
    bits, concatenated plane by plane."""
    n_lanes = -(-_FX_PAYLOAD_BITS // fx_bits)
    q = torch.clamp(torch.round(masked * _f32(_vector_fx_scale(config))),
                    -(_FX_STEPS - 1), _FX_STEPS - 1).to(torch.int32)
    u = torch.where(keep_row[:, None], q + _FX_OFFSET, 0)
    return torch.cat([(u >> (k * fx_bits)) & ((1 << fx_bits) - 1)
                      for k in range(n_lanes)], dim=1).contiguous()


def _reduce_per_pk(config: FusedConfig, pk_safe, masked, keep_row, P,
                   seg_marker=None, fx_bits: int = 7, contrib=None,
                   capacity_rows: Optional[int] = None):
    """Per-pk accumulator columns straight from row space, as (columns
    dict, privacy-id-count column or None), all int32 [P]: the lane stack
    reduced by ONE ``segment_sum_lanes`` call (kernel K1 on the card).
    VECTOR_SUM adds its [P, W] column: under ``fx`` the coordinate lanes
    reduced by ONE ``segment_sum_wide`` call (kernel K2), exact int32;
    under ``f32`` a float32 ``index_add_``, the counterpart of the JAX
    package's float32 ``jax.ops.segment_sum``, which adds in another
    order."""
    stack, lane_names = _lane_stack(config, masked, keep_row, seg_marker,
                                    fx_bits, contrib, capacity_rows)
    pk32 = pk_safe.to(torch.int32).contiguous()
    stacked = segsum.segment_sum_lanes(stack, pk32, P)
    part = {"count": stacked[:, 0]}
    col = 1
    nseg = None
    if seg_marker is not None:
        nseg = stacked[:, col]
        col += 1
    for i, name in enumerate(lane_names):
        part[name] = stacked[:, col + i]
    if "VECTOR_SUM" in config.metrics:
        if _vector_fx(config):
            part["vector_sum"] = segsum.segment_sum_wide(
                _vector_lanes(config, masked, keep_row, fx_bits), pk32, P)
        else:
            part["vector_sum"] = torch.zeros(
                P, masked.shape[1], dtype=torch.float32,
                device=masked.device).index_add_(0, pk32.long(), masked)
    return part, nseg


def _fold_fx_steps(config: FusedConfig, part64, fx_bits: int) -> None:
    """Reassembles the lane columns into exact float64 step totals
    (mutates ``part64``): steps = sum of lanes * 2^(bits*k) - entries *
    offset. Every term is an integer below 2^53, so the result is exact."""
    n_lanes = -(-_FX_PAYLOAD_BITS // fx_bits)
    for spec in _fixedpoint_layout(config):
        total = np.zeros_like(part64[spec.count_col], dtype=np.float64)
        for k in range(n_lanes):
            total += part64.pop(f"{spec.name}_fx{k}").astype(
                np.float64) * float(1 << (k * fx_bits))
        if spec.signed:
            total -= part64[spec.count_col].astype(np.float64) * _FX_OFFSET
        part64[spec.name] = total


def _fold_vector_fx_steps(config: FusedConfig, lanes, count,
                          fx_bits: int) -> np.ndarray:
    """Reassembles the [n, n_lanes * D] vector lane sums into exact
    float64 step totals [n, D]: the sum of the lane planes * 2^(bits * k)
    minus count * offset; every term is an integer below 2^53."""
    n_lanes = -(-_FX_PAYLOAD_BITS // fx_bits)
    D = int(config.vector_size)
    lanes = np.asarray(lanes)
    total = np.zeros((lanes.shape[0], D), dtype=np.float64)
    for k in range(n_lanes):
        total += lanes[:, k * D:(k + 1) * D].astype(
            np.float64) * float(1 << (k * fx_bits))
    total -= np.asarray(count).astype(np.float64)[:, None] * _FX_OFFSET
    return total


def _fold_fixedpoint(config: FusedConfig, part64, fx_bits: int) -> None:
    """Reassembles the lane columns into float64 values (mutates
    ``part64``): value = steps / scale, for the scalar columns and for
    VECTOR_SUM's coordinates."""
    _fold_fx_steps(config, part64, fx_bits)
    for spec in _fixedpoint_layout(config):
        part64[spec.name] = part64[spec.name] / spec.scale
    if _vector_fx(config) and "vector_sum" in part64:
        part64["vector_sum"] = _fold_vector_fx_steps(
            config, part64["vector_sum"], part64["count"],
            fx_bits) / _vector_fx_scale(config)


def _selection_and_metrics(config: FusedConfig, num_partitions: int, part,
                           part_nseg, keep_table, sel_threshold, sel_scale,
                           sel_min_count, sel_rows_per_uid, k_sel,
                           k_noise=None, noise_scales=None, qrows=None,
                           mesh=None):
    """Batched partition selection over the whole [P] axis, then the
    percentile walk (``jax_engine._selection_and_metrics``). Returns
    (keep_pk bool [P], accumulator columns, with one float32 [P] column
    per percentile). The thresholds arrive as float32 values, as the JAX
    package passes them; the walk's noise scale is the last entry of
    ``noise_scales`` and its key a constant fold of ``k_noise``.

    On a ``mesh`` the partition axis is sharded: ``part``/``part_nseg``
    are this rank's owned block of ``num_partitions`` partitions out of
    ``num_partitions * mesh.size``. The selection draws cover the global
    axis and this rank keeps its block's slice, and the walk runs on the
    owned block, so the keep decisions and the walk equal one device's."""
    with obs.span("engine.select", cat="engine"):
        keep_pk, out = _selection(config, num_partitions, part, part_nseg,
                                  keep_table, sel_threshold, sel_scale,
                                  sel_min_count, sel_rows_per_uid, k_sel,
                                  mesh)
    if config.percentiles:
        P = num_partitions
        stream = _WalkRows.solo(_tree_key(k_noise), _walk_scale(noise_scales),
                                P, 0 if mesh is None else mesh.index * P,
                                part_nseg.device)
        if mesh is None:
            with obs.span("engine.walk", cat="engine"):
                vals = _percentile_values(config, P, qrows, stream)
        else:
            vals = _percentile_values_owned(config, P, qrows, stream, mesh)
        for qi, name in enumerate(_percentile_field_names(
                config.percentiles)):
            out[name] = vals[:, qi]
    return keep_pk, out


def _tree_key(k_noise):
    """The walk's node-noise key: a constant fold of the noise stream,
    independent of the selection stream."""
    # lint: disable=rng-purity(tree key: constant fold of the noise stream)
    return prng.fold_in(k_noise, 0x7ee)


def _walk_scale(noise_scales) -> float:
    """The walk's noise scale: the last entry of ``noise_scales``."""
    return float(np.asarray(noise_scales)[-1])


def _selection(config: FusedConfig, num_partitions: int, part, part_nseg,
               keep_table, sel_threshold, sel_scale, sel_min_count,
               sel_rows_per_uid, k_sel, mesh=None):
    """The selection half of ``_selection_and_metrics``: (keep_pk bool
    [P], the accumulator columns and the privacy-id count), no walk."""
    P = num_partitions
    device = part_nseg.device
    offset = 0 if mesh is None else mesh.index * P
    P_total = P if mesh is None else P * mesh.size

    def owned(draw):
        """A [P_total] draw, sliced to this rank's block."""
        full = draw((P_total,))
        return full if mesh is None else full[offset:offset + P]

    if config.selection is None:
        keep_pk = torch.ones(P, dtype=torch.bool, device=device)
    else:
        # Without privacy ids one row is not one user: the conservative
        # user-count estimate is ceil(rows / max_rows_per_privacy_id).
        est_users = torch.ceil(part_nseg.to(torch.float32) /
                               _f32(sel_rows_per_uid))
        if config.selection == (
                PartitionSelectionStrategy.TRUNCATED_GEOMETRIC):
            table = torch.as_tensor(np.asarray(keep_table, np.float32),
                                    device=device)
            idx = torch.clamp(est_users.to(torch.int64), 0,
                              table.shape[0] - 1)
            # lint: disable=rng-purity(selection draw keyed by k_sel, the JAX package's stream)
            keep_pk = owned(lambda shape: prng.uniform(
                k_sel, shape, device=device)) < table[idx]
        else:
            if config.selection == (
                    PartitionSelectionStrategy.LAPLACE_THRESHOLDING):
                # lint: disable=rng-purity(selection noise keyed by k_sel, the JAX package's stream)
                noise = owned(lambda shape: prng.laplace(
                    k_sel, shape, device=device))
            else:
                # lint: disable=rng-purity(selection noise keyed by k_sel, the JAX package's stream)
                noise = owned(lambda shape: prng.normal(
                    k_sel, shape, device=device))
            # XLA contracts est + noise * scale into one FMA; fma32 keeps
            # that single rounding, so a draw at the threshold decides the
            # same way.
            noisy = prng.fma32(noise, _f32(sel_scale), est_users)
            keep_pk = (noisy >= _f32(sel_threshold)) & (
                est_users >= _f32(sel_min_count))  # pre-threshold floor
        keep_pk = keep_pk & (part_nseg > 0)
    out = dict(part)
    out["privacy_id_count_raw"] = part_nseg
    return keep_pk, out


# ---------------------------------------------------------------------------
# The percentile walk
# ---------------------------------------------------------------------------

#: Byte cap of one [Pb, Q, span] int32 subtree histogram: the module seam
#: of the ``subhist_byte_cap`` knob (``plan/knobs.py``). Above it the
#: single-batch walk walks partition blocks in a host loop, and the
#: streamed pass B tiles the (quantile x partition) grid; every blocking
#: is bit-identical.
_SUBHIST_BYTE_CAP = 600 << 20


def _subhist_byte_cap() -> int:
    """The ``subhist_byte_cap`` knob: the environment, then the seam, then
    a plan file, then the default."""
    return int(plan_mod.knob_value("subhist_byte_cap"))


def _qrows(config: FusedConfig, pk, values, kept):
    """Percentile row view: (pk, leaf index, kept mask) per row, in the
    caller's row order (``jax_engine._qrows``). The leaf is one float32
    subtract, then one float32 multiply by the host-folded constant
    ``float32(n_leaves / range)``, truncated to int32: neither step is an
    FMA pattern, so pass A and pass B of a stream map every row to the
    same leaf."""
    b, height, _, _ = quantile_tree.tree_constants()
    n_leaves = b**height
    lower, upper = float(config.min_value), float(config.max_value)
    inv_range = np.float32(n_leaves / (upper - lower))
    assert np.isfinite(inv_range), (
        f"fused percentile range [{lower}, {upper}] has no finite float32 "
        "leaf constant — params_are_fusable should have rejected it")
    v = torch.clamp(values, _f32(lower), _f32(upper))
    leaf = torch.clamp_max(((v - _f32(lower)) * float(inv_range)).to(
        torch.int32), n_leaves - 1)
    return torch.where(kept, pk, 0), leaf, kept


def _percentile_field_names(percentiles) -> List[str]:
    """``percentile_50``, ``percentile_99_9``: the names of the JAX
    package's ``_percentile_field_names``."""
    names = []
    for p in percentiles:
        int_p = int(round(p))
        text = str(int_p) if int_p == p else str(p).replace(".", "_")
        names.append(f"percentile_{text}")
    return names


def _node_noise(noise_kind: NoiseKind, key, node_ids, pk_index=None):
    """One unit draw per (partition, tree node), a pure function of the
    two indices (``jax_engine._node_noise``): ``node_ids`` int [P, Q, b],
    ``pk_index`` the global partition of each row of ``node_ids``
    (default ``arange(P)``). The walk's draws at scale 1."""
    stream = _WalkRows.solo(key, 1.0, node_ids.shape[0],
                            device=node_ids.device)
    if pk_index is not None:
        stream = stream._replace(pk_index=pk_index)
    draw, factor = _scaled_node_noise(noise_kind, stream, node_ids)
    return draw * factor


class _WalkRows(NamedTuple):
    """The node-noise stream of a walk, one entry per walk row: the tree
    key words, int64 [R, 2]; the walk scale rounded to float32, [R]; and
    the partition that keys the row's draws, [R]. A single request's walk
    has one key and scale for every row (``solo``); in a fused batch, row
    ``b * P + p`` carries member ``b``'s key and scale and its
    member-local partition ``p``."""
    words: torch.Tensor
    scale: torch.Tensor
    pk_index: torch.Tensor

    @classmethod
    def solo(cls, key, scale: float, P: int, p_offset: int = 0,
             device=None) -> "_WalkRows":
        """``P`` rows under one key and scale, keyed by the partitions
        ``p_offset + arange(P)``."""
        return cls(key.to(device=device, dtype=torch.int64).expand(P, 2),
                   torch.full((P,), _f32(scale), dtype=torch.float32,
                              device=device),
                   p_offset + torch.arange(P, device=device))

    def rows(self, sl: slice) -> "_WalkRows":
        return _WalkRows(self.words[sl], self.scale[sl], self.pk_index[sl])


def _scaled_node_noise(noise_kind: NoiseKind, stream: _WalkRows, node_ids):
    """``(draw, factor)`` whose float32 product is the walk's noise
    ``_node_noise * scale`` as XLA computes it, each row of ``node_ids``
    under its own key, scale and partition from ``stream``: a Laplace
    draw times ``scale``, and for a Gaussian ``erf_inv`` times
    ``float32(sqrt(2) * scale)``, since XLA folds the constant ``sqrt(2)``
    of the draw into the scale (a float32 product of two float32 values
    is the correctly rounded one, as XLA's constant fold gives it)."""
    shape = (-1,) + (1,) * (node_ids.dim() - 1)
    x0 = stream.pk_index.to(torch.int64).reshape(shape).expand(
        node_ids.shape)
    # lint: disable=rng-purity(node noise keyed by its tree key and its node and partition counters, the JAX walk's stream)
    bits, _ = prng.threefry2x32(stream.words[:, 0].reshape(shape),
                                stream.words[:, 1].reshape(shape), x0,
                                node_ids.to(torch.int64))
    factor = stream.scale.reshape(shape)
    if noise_kind == NoiseKind.LAPLACE:
        return counter_rng.laplace_from_bits(bits), factor
    return (counter_rng.erfinv_from_bits(bits),
            factor * counter_rng.SQRT2_F32)


def _halves_sum(x):
    """The sum over the last axis (a power of two long) as a tree of
    halves, ``x[:h] + x[h:]`` until one is left: the order of XLA's CPU
    code for a vectorised row reduction of 16 float32 lanes."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _walk_step(noisy, lo, hi, target, leaf_lo, done, b, w, scan=None,
               halves_total=False, rank_fma=False):
    """One level of the descent (``jax_engine._walk_step``): pick the child
    whose cumulative noisy count crosses the rank target and re-normalise
    the target into it. ``lo + child * width`` is one FMA, as XLA
    contracts it.

    The rest follows XLA's CPU code for the program it runs in. Alone,
    ``_walk_step`` scans and sums the ``b`` children with sequential
    float32 adds (``torch.cumsum`` and ``torch.sum`` add in other orders)
    and rounds ``target * total - cum`` twice. Inside the walk's program
    (see ``_walk_level``) XLA sums the children as a tree of halves
    (``halves_total``), may take the running sum and the total over a
    second copy of the counts (``scan``), and may contract the rank's
    numerator into one FMA (``rank_fma``)."""
    scan = noisy if scan is None else scan
    incl = [scan[..., 0]]
    for c in range(1, b):
        incl.append(incl[-1] + scan[..., c])
    total = _halves_sum(scan) if halves_total else incl[-1]
    incl = torch.stack(incl, dim=-1)
    rank = target * total
    ge = incl >= rank[..., None]
    child = torch.where(ge.any(-1), ge.to(torch.int32).argmax(-1), b - 1)
    c = torch.gather(noisy, -1, child[..., None])[..., 0]
    cum = torch.gather(incl, -1, child[..., None])[..., 0] - c
    width = (hi - lo) / float(b)
    new_lo = prng.fma32(child.to(torch.float32), width, lo)
    numer = prng.fma32(target, total, -cum) if rank_fma else rank - cum
    new_target = torch.where(
        c <= 0, 0.0,
        torch.clamp(numer / torch.clamp_min(c, _f32(1e-30)), 0.0, 1.0))
    stop = done | (total <= 0)
    lo = torch.where(stop, lo, new_lo)
    hi = torch.where(stop, hi, new_lo + width)
    target = torch.where(stop, target, new_target)
    leaf_lo = torch.where(stop, leaf_lo,
                          leaf_lo + (child * w).to(torch.int32))
    return lo, hi, target, leaf_lo, stop


def _walk_level(noise_kind, stream, raw, base, level_offset, lo, hi,
                target, leaf_lo, done, b, w):
    """One walk level from its raw child counts (``jax_engine.
    _walk_level``): node-id-keyed noise, ``max(raw + noise * scale, 0)``,
    then the descent step. At the root every quantile shares base 0, so
    one draw per (partition, child) is broadcast over Q.

    The float32 arithmetic is XLA's CPU code for the walk's program, as
    measured against it (``tests/test_torch_percentile.py``): the total of
    the children is a tree of halves at every level, and the noisy counts
    are one FMA, except at the root, where XLA contracts the rank's
    numerator ``target * total - cum`` instead and, when the counts are
    broadcast over more than one quantile, recomputes them unfused (two
    roundings) for the running sum and the total."""
    node_ids = (level_offset + base)[..., None] + torch.arange(
        b, dtype=torch.int32, device=base.device)
    root = level_offset == 0
    if root:
        draw, factor = _scaled_node_noise(noise_kind, stream,
                                          node_ids[:, :1, :])
        draw = draw.expand(node_ids.shape)
    else:
        draw, factor = _scaled_node_noise(noise_kind, stream, node_ids)
    noisy = torch.clamp_min(prng.fma32(draw, factor, raw), 0.0)
    # With one quantile there is no broadcast over Q, and XLA's root
    # takes its running sum and total over the fused counts too.
    scan = (torch.clamp_min(raw + draw * factor, 0.0)
            if root and node_ids.shape[1] > 1 else None)
    return _walk_step(noisy, lo, hi, target, leaf_lo, done, b, w, scan=scan,
                      halves_total=True, rank_fma=root)


def _monotone_in_q(vals, quantiles):
    """Monotone in q, like the host post-processing step: a running
    maximum over the quantiles in ascending order."""
    order = np.argsort(quantiles, kind="stable")
    fwd = torch.as_tensor(order, device=vals.device)
    back = torch.as_tensor(np.argsort(order), device=vals.device)
    return torch.cummax(vals[:, fwd], dim=1).values[:, back]


def _mid_level_counts(mid, base, w, bucket_w, b):
    """Child counts [P, Q, b] float32 of width-``w`` walk nodes
    (``w >= bucket_w``) from the [P, n_mid] mid histogram: children are
    contiguous groups of ``w / bucket_w`` buckets. Integer sums and a
    gather only."""
    P, n_mid = mid.shape
    g = w // bucket_w
    lvl = mid if g == 1 else mid.reshape(P, n_mid // g, g).sum(-1)
    idx = base[..., None] + torch.arange(b, device=base.device)
    return torch.gather(lvl, 1, idx.reshape(P, -1).long()).reshape(
        idx.shape).to(torch.float32)


def _sub_level_counts(sub, sub_start, leaf_lo, w, b):
    """Child counts [P, Q, b] float32 of width-``w`` nodes from the
    [P, Q, span] subtree leaf histograms: children occupy the ``w``-leaf
    groups ``off + c``, ``off`` the node's group offset in the subtree."""
    P, Q, span = sub.shape
    g = sub if w == 1 else sub.reshape(P, Q, span // w, w).sum(-1)
    off = (leaf_lo - sub_start) // w
    idx = off[..., None] + torch.arange(b, device=off.device)
    return torch.gather(g, 2, idx.long()).to(torch.float32)


def _mid_histogram(P: int, qrows):
    """The [P, n_mid] int32 mid-level histogram: the kept rows counted by
    (partition, leaf bucket of width ``bucket_w``), one column over
    ``P * n_mid`` segments through ``segment_sum_lanes`` (K1 on the card).
    Additive across the batches of a stream."""
    _, _, n_mid, bucket_w = quantile_tree.tree_constants()
    assert P * n_mid < _LANE_SUM_CAP, f"{P * n_mid} segments pass int32"
    qpk, leaf, kept = qrows
    key = qpk * n_mid + torch.clamp_max(leaf // bucket_w, n_mid - 1)
    return segsum.segment_sum_lanes(
        kept.to(torch.int32)[:, None].contiguous(),
        key.to(torch.int32).contiguous(), P * n_mid).reshape(P, n_mid)


def _subtree_counts_multi(qpk, leaf, kept, sub_starts, p_offsets, Pb: int,
                          span: int, out=None):
    """Every tile's subtree-leaf counts from one pass over the rows
    (``jax_engine._subtree_counts_multi``): ``sub_starts`` [T, Pb, Qc],
    ``p_offsets`` [T] int32, output [T, Pb, Qc, span] int32, added into
    ``out`` when given. Every subtree histogram of the port, single-batch
    and streamed, is made here: K3 on the card."""
    return hist.subtree_counts_multi(
        qpk.contiguous(), leaf.contiguous(), kept.contiguous(),
        sub_starts.to(torch.int32).contiguous(),
        p_offsets.to(torch.int32).contiguous(), Pb, span, out=out)


def _walk_top(config: FusedConfig, P: int, mid, stream):
    """The levels the mid histogram serves (node width >= bucket_w: levels
    0 and 1), from the root state, with the node noise of ``stream``
    (``_WalkRows``, one row a partition). Returns (lo, hi, target, leaf_lo, done)
    [P, Q] (``streaming._walk_top_kernel`` of the JAX package, which is
    also the top of its single-batch walk)."""
    b, height, _, bucket_w = quantile_tree.tree_constants()
    quantiles = np.asarray([p / 100.0 for p in config.percentiles],
                           np.float32)
    Q = quantiles.shape[0]
    device = mid.device
    lo = torch.full((P, Q), _f32(config.min_value), dtype=torch.float32,
                    device=device)
    hi = torch.full((P, Q), _f32(config.max_value), dtype=torch.float32,
                    device=device)
    target = torch.as_tensor(quantiles, device=device).expand(P, Q)
    leaf_lo = torch.zeros((P, Q), dtype=torch.int32, device=device)
    done = torch.zeros((P, Q), dtype=torch.bool, device=device)
    level_offset = 0
    for level in range(min(2, height)):
        w = b**(height - 1 - level)
        base = leaf_lo // w
        raw = _mid_level_counts(mid, base, w, bucket_w, b)
        lo, hi, target, leaf_lo, done = _walk_level(
            config.noise_kind, stream, raw, base, level_offset, lo, hi,
            target, leaf_lo, done, b, w)
        level_offset += b**(level + 1)
    return lo, hi, target, leaf_lo, done


def _walk_bottom(config: FusedConfig, P: int, sub, sub_start, lo, hi,
                 target, leaf_lo, done, stream):
    """Finishes the walk of a block of ``P`` partitions from its
    [P, Qc, span] subtree histograms (``streaming._walk_bottom_kernel`` of
    the JAX package). ``stream`` holds the block's rows of the walk's
    ``_WalkRows``, so node noise keeps each row's own key and partition
    and any blocking walks alike. Returns the [P, Qc] float32 values
    ``lo + (hi - lo) * target``, one FMA."""
    b, height, _, _ = quantile_tree.tree_constants()
    level_offset = sum(b**(level + 1) for level in range(min(2, height)))
    for level in range(min(2, height), height):
        w = b**(height - 1 - level)
        base = leaf_lo // w
        raw = _sub_level_counts(sub, sub_start, leaf_lo, w, b)
        lo, hi, target, leaf_lo, done = _walk_level(
            config.noise_kind, stream, raw, base, level_offset, lo, hi,
            target, leaf_lo, done, b, w)
        level_offset += b**(level + 1)
    return prng.fma32(hi - lo, target, lo)


def _walk_blocks(P: int, Q: int, span: int) -> int:
    """Partitions per block of the single-batch bottom walk: all of them
    when the [P, Q, span] int32 histogram fits the byte cap, else the
    largest power of two that fits (at least one)."""
    cap = _subhist_byte_cap()
    if P * Q * span * 4 <= cap:
        return P
    return min(P, 1 << max(0, (cap // (Q * span * 4)).bit_length() - 1))


def _percentile_values(config: FusedConfig, P: int, qrows, stream):
    """The batched quantile-tree descent over every partition at once
    (``jax_engine._percentile_values``): the top two levels from the mid
    histogram, the bottom two from subtree-leaf histograms built by
    ``_subtree_counts_multi``, one partition block at a time (one block
    when the histogram fits the byte cap). ``stream`` is the walk's
    ``_WalkRows`` over the ``P`` partitions. Returns [P, Q] float32."""
    qpk, leaf, kept = qrows
    _, _, _, span = quantile_tree.tree_constants()
    quantiles = np.asarray([p / 100.0 for p in config.percentiles],
                           np.float32)
    Q = quantiles.shape[0]
    mid = _mid_histogram(P, qrows)
    lo, hi, target, leaf_lo, done = _walk_top(config, P, mid, stream)
    del mid
    blk = _walk_blocks(P, Q, span)
    if blk == P:
        obs.inc("walk.path_subhist")
        obs.event("walk.path", path="subhist", scope="run", P=int(P),
                  Q=int(Q), span=int(span))
    else:
        obs.inc("walk.path_partition_block_chunked")
        obs.event("walk.path", path="partition_block_chunked",
                  scope="run", blk=int(blk), P=int(P))
    offset = torch.zeros(1, dtype=torch.int32, device=qpk.device)
    outs = []
    for p0 in range(0, P, blk):
        Pb = min(blk, P - p0)
        psl = slice(p0, p0 + Pb)
        ss = leaf_lo[psl]
        sub = _subtree_counts_multi(qpk, leaf, kept, ss[None],
                                    offset + p0, Pb, span)[0]
        outs.append(_walk_bottom(config, Pb, sub, ss, lo[psl], hi[psl],
                                 target[psl], ss, done[psl],
                                 stream.rows(psl)))
        del sub
    return _monotone_in_q(torch.cat(outs, dim=0), quantiles)


def _walk_members(P: int) -> int:
    """Members of a fused batch that one quantile walk takes: as many as
    keep the mid histogram's ``members * P * n_mid`` segment ids within
    int32 (at least one)."""
    _, _, n_mid, _ = quantile_tree.tree_constants()
    return max(1, (_LANE_SUM_CAP - 1) // (P * n_mid))


def _percentile_values_batch(config: FusedConfig, B: int, P: int, qrows,
                             scales: Sequence[float], tree_keys):
    """The quantile walk of every member of a fused batch at once:
    ``qrows`` keys the rows by the flat partition ``b * P + p``, so the
    batch walks ``B * P`` partitions with one mid histogram (one K1
    launch over ``B * P * n_mid`` segments) and one subtree histogram (one
    K3 launch when it fits the byte cap; else the same partition blocks
    as any walk of ``B * P`` partitions). A batch whose segment ids would
    pass int32 walks in runs of ``_walk_members(P)`` members, each over
    its own members' rows. Member ``b``'s node noise is keyed by its own
    tree key ``tree_keys[b]`` and its member-local partition, at its own
    scale ``scales[b]``, whatever the blocking, so its rows are its solo
    walk bit for bit. Returns [B, P, Q] float32."""
    device = qrows[0].device
    rows = torch.arange(B * P, device=device)
    member = rows // P
    stream = _WalkRows(
        torch.stack(list(tree_keys)).to(device)[member],
        torch.tensor([_f32(s) for s in scales], dtype=torch.float32,
                     device=device)[member],
        rows % P)
    per = _walk_members(P)
    if per >= B:
        vals = _percentile_values(config, B * P, qrows, stream)
        return vals.reshape(B, P, vals.shape[1])
    qpk, leaf, kept = qrows
    outs = []
    for b0 in range(0, B, per):
        r0, r1 = b0 * P, min(B, b0 + per) * P
        inside = kept & (qpk >= r0) & (qpk < r1)
        outs.append(_percentile_values(
            config, r1 - r0, (torch.where(inside, qpk - r0, 0), leaf, inside),
            stream.rows(slice(r0, r1))))
    return torch.cat(outs).reshape(B, P, outs[0].shape[1])


def _percentile_values_owned(config: FusedConfig, P_own: int, qrows,
                             stream, mesh):
    """The quantile descent with the partition axis sharded over the mesh
    (``jax_engine._percentile_values_owned``): each rank walks its owned
    block of ``P_own`` partitions (global partition ``mesh.index * P_own +
    i``). Per level: gather the owned walk bases ([P_own, Q] int32: any
    rank's rows may fall in any partition's walk), count the children of
    this rank's rows over the global axis in ONE ``segment_sum_lanes``
    call (K1 on the card, as the single-device walk counts its mid
    histogram), and hand each owner its block of the [P, Q, b] counts.
    ``stream`` keys node noise by the global partition, so the walk equals
    one device's bit for bit."""
    from pipelinedp_tpu_torch.parallel import sharded as psh
    qpk, leaf, kept = qrows
    b, height, _, _ = quantile_tree.tree_constants()
    quantiles = np.asarray([p / 100.0 for p in config.percentiles],
                           np.float32)
    Q = quantiles.shape[0]
    P = P_own * mesh.size
    device = qpk.device
    lo = torch.full((P_own, Q), _f32(config.min_value), dtype=torch.float32,
                    device=device)
    hi = torch.full((P_own, Q), _f32(config.max_value), dtype=torch.float32,
                    device=device)
    target = torch.as_tensor(quantiles, device=device).expand(P_own, Q)
    leaf_lo = torch.zeros((P_own, Q), dtype=torch.int32, device=device)
    done = torch.zeros((P_own, Q), dtype=torch.bool, device=device)
    # Row r's count of quantile q lands in segment (qpk * Q + q) * b + slot.
    row_q = qpk.to(torch.int64)[:, None] * Q + torch.arange(Q, device=device)
    level_offset = 0
    for level in range(height):
        w = b**(height - 1 - level)
        base_own = leaf_lo // w
        base = psh.gather_blocks(base_own, mesh, 0,
                                 f"walk.base{level}")  # [P, Q]
        slot = (leaf // w)[:, None] - base[qpk.long()]  # [N, Q]
        ok = kept[:, None] & (slot >= 0) & (slot < b)
        seg = row_q * b + torch.clamp(slot, 0, b - 1)
        counts = segsum.segment_sum_lanes(
            ok.to(torch.int32).reshape(-1, 1).contiguous(),
            seg.to(torch.int32).reshape(-1).contiguous(),
            P * Q * b).reshape(P, Q, b)
        raw = psh.scatter_to_owner(counts, mesh, 0,
                                   f"walk.counts{level}").to(torch.float32)
        lo, hi, target, leaf_lo, done = _walk_level(
            config.noise_kind, stream, raw, base_own, level_offset, lo, hi,
            target, leaf_lo, done, b, w)
        level_offset += b**(level + 1)
    return _monotone_in_q(prng.fma32(hi - lo, target, lo), quantiles)


@costs.instrumented(phase="fetch")
def _compact_fetch(keep_pk, cols, num_partitions: int, cap: int):
    """Output compaction on the device: a stable sort puts the kept
    partitions first (ascending pk index); the first ``cap`` of every
    column are packed into one int32 block [2 + len(cols), cap] = [meta;
    kept indices; columns...]. The sort must stay stable on the card, or
    the kept indices would lose their ascending order."""
    keep = keep_pk[:num_partitions].to(torch.int32)
    order = torch.argsort(1 - keep, stable=True)
    sel = order[:cap]
    meta = torch.zeros(sel.shape[0], dtype=torch.int32, device=keep.device)
    meta[0] = keep.sum()
    gathered = [c[:num_partitions][sel] for c in cols]
    return torch.stack([meta, sel.to(torch.int32)] + gathered)


# ---------------------------------------------------------------------------
# Host release
# ---------------------------------------------------------------------------


def _release_noise_params(config: FusedConfig,
                          spec) -> dp_computations.ScalarNoiseParams:
    return dp_computations.ScalarNoiseParams(
        eps=spec.eps, delta=spec.delta,
        min_value=config.min_value, max_value=config.max_value,
        min_sum_per_partition=config.min_sum_per_partition,
        max_sum_per_partition=config.max_sum_per_partition,
        max_partitions_contributed=config.l0,
        max_contributions_per_partition=config.linf,
        noise_kind=config.noise_kind,
        max_contributions=config.max_contributions)


def _host_release(config: FusedConfig, specs, part, nseg,
                  rng: Optional[np.random.Generator],
                  rng_seed: Optional[int] = None, pk_index=None,
                  device="cpu"):
    """The scalar DP release, on the host in float64: the
    ``dp_computations.compute_dp_*`` mechanisms, vectorized over the
    released partitions, in the JAX package's order of draws.

    VECTOR_SUM is norm-clipped here in float64; its per-coordinate noise
    is drawn on ``device`` by ``ops/vector_noise.py``, keyed by the engine
    seed ``rng_seed`` and by ``pk_index``, the global vocab index of each
    released row, so a partition draws the same noise in every layout.
    With secure host noise on and no ``rng``, every metric, VECTOR_SUM
    too, is released by the native samplers on the host instead."""
    names = set(config.metrics)
    out = {}
    if "VARIANCE" in names or "MEAN" in names:
        snp = _release_noise_params(config, specs["mean_var"])
        nsum = part["nsum"]
        if "VARIANCE" in names:
            dp_count, dp_sum, dp_mean, dp_var = (
                dp_computations.compute_dp_var(part["count"], nsum,
                                               part["nsumsq"], snp, rng))
            out["variance"] = dp_var
        else:
            dp_count, dp_sum, dp_mean = dp_computations.compute_dp_mean(
                part["count"], nsum, snp, rng)
        if "MEAN" in names:
            out["mean"] = dp_mean
        if "COUNT" in names:
            out["count"] = dp_count
        if "SUM" in names:
            out["sum"] = dp_sum
    else:
        if "COUNT" in names:
            out["count"] = dp_computations.compute_dp_count(
                part["count"], _release_noise_params(config,
                                                     specs["count"]), rng)
        if "SUM" in names:
            if config.per_partition_bounds:
                raw_sum = part["sum"]
                if config.selection is None:
                    # Every public partition receives one empty
                    # accumulator, whose clipped sum is clip(0, min_sum,
                    # max_sum), as in the JAX package.
                    raw_sum = raw_sum + float(
                        np.clip(0.0, config.min_sum_per_partition,
                                config.max_sum_per_partition))
            else:
                # sum(x) = sum(x - mid) + count * mid, exactly, in float64.
                middle = dp_computations.compute_middle(config.min_value,
                                                        config.max_value)
                raw_sum = part["nsum"] + part["count"].astype(
                    np.float64) * middle
            out["sum"] = dp_computations.compute_dp_sum(
                raw_sum, _release_noise_params(config, specs["sum"]), rng)
    if "PRIVACY_ID_COUNT" in names:
        out["privacy_id_count"] = dp_computations.compute_dp_privacy_id_count(
            nseg, _release_noise_params(config, specs["privacy_id_count"]),
            rng)
    if "VECTOR_SUM" in names:
        spec = specs["vector_sum"]
        noise_params = dp_computations.AdditiveVectorNoiseParams(
            eps_per_coordinate=spec.eps / config.vector_size,
            delta_per_coordinate=spec.delta / config.vector_size,
            max_norm=config.vector_max_norm,
            l0_sensitivity=config.l0,
            linf_sensitivity=config.linf,
            norm_kind=config.vector_norm_kind,
            noise_kind=config.noise_kind)
        if noise_ops.secure_host_noise_enabled() and rng is None:
            # Hardened release: the snapping and discrete mechanisms run
            # on the host, in the same batched call the generic combiner
            # makes.
            out["vector_sum"] = dp_computations.add_noise_vector(
                part["vector_sum"], noise_params, rng)
        else:
            clipped = dp_computations._clip_vector(
                np.asarray(part["vector_sum"], dtype=np.float64),
                config.vector_max_norm, config.vector_norm_kind)
            out["vector_sum"] = vector_noise.add_vector_noise(
                clipped, noise_params, rng_seed, pk_index, device)
    return out


def selection_inputs(config: FusedConfig, eps: float, delta: float,
                     pre_threshold: Optional[int]):
    """(keep_table, threshold, scale, min_count) for the selection stage."""
    if config.selection is None:
        return np.zeros(2, np.float32), 0.0, 1.0, 0.0
    strategy = ps_ops.create_partition_selection_strategy(
        config.selection, eps, delta, config.selection_l0, pre_threshold)
    if isinstance(strategy, ps_ops.TruncatedGeometricPartitionStrategy):
        # probabilities() folds in pre-thresholding; materialize the
        # effective table over [0, saturation + pre_threshold].
        size = strategy.keep_table.size + (pre_threshold or 0)
        table = strategy.probabilities(np.arange(size)).astype(np.float32)
        return table, 0.0, 1.0, 0.0
    thr = strategy.threshold
    min_count = 0.0
    if pre_threshold is not None:
        # noisy(n - pre + 1) >= T  <=>  noisy(n) >= T + pre - 1.
        thr = thr + pre_threshold - 1
        min_count = float(pre_threshold)
    if isinstance(strategy, ps_ops.LaplaceThresholdingPartitionStrategy):
        return np.zeros(2, np.float32), thr, strategy.noise_scale, min_count
    return np.zeros(2, np.float32), thr, strategy.noise_stddev, min_count


def _metric_field_order(config: FusedConfig) -> List[str]:
    """MetricsTuple field order of the JAX package (VARIANCE > MEAN fold
    count/sum; then privacy_id_count)."""
    names = set(config.metrics)
    fields = []
    if "VARIANCE" in names:
        fields.append("variance")
        fields += [f for f in ("count", "sum", "mean")
                   if f.upper() in names]
    elif "MEAN" in names:
        fields.append("mean")
        fields += [f for f in ("count", "sum") if f.upper() in names]
    else:
        fields += [f for f in ("count", "sum") if f.upper() in names]
    if "PRIVACY_ID_COUNT" in names:
        fields.append("privacy_id_count")
    if "VECTOR_SUM" in names:
        fields.append("vector_sum")
    fields.extend(_percentile_field_names(config.percentiles))
    return fields


def _noise_scales(config: FusedConfig, specs: Dict[str, Any]) -> np.ndarray:
    """The device's noise-scale inputs (``jax_engine._noise_scales``):
    empty without percentiles, else the tree's per-level node-noise scale
    as the last entry, float32. The budget splits evenly over the tree's
    levels."""
    if not config.percentiles:
        return np.zeros(0, dtype=np.float32)
    l0, linf = dp_computations.count_sensitivity_pair(
        config.l0, config.linf, config.max_contributions)
    spec = specs["percentile"]
    height = quantile_tree.DEFAULT_TREE_HEIGHT
    eps_l = spec.eps / height
    if config.noise_kind == NoiseKind.LAPLACE:
        scale = noise_ops.laplace_scale(
            eps_l, dp_computations.compute_l1_sensitivity(l0, linf))
    else:
        scale = noise_ops.gaussian_sigma(
            eps_l, spec.delta / height,
            dp_computations.compute_l2_sensitivity(l0, linf))
    return np.asarray([scale], dtype=np.float32)


def request_budgets(config: FusedConfig, params: AggregateParams,
                    budget_accountant) -> Dict[str, Any]:
    """Requests exactly the budgets the JAX package's fused plane requests:
    one mechanism per metric group, with the aggregation's weight."""
    mechanism_type = params.noise_kind.convert_to_mechanism_type()
    names = set(config.metrics)
    specs: Dict[str, Any] = {}

    def request(metric: str, internal_splits: int = 1):
        return budget_accountant.request_budget(
            mechanism_type, weight=params.budget_weight,
            internal_splits=internal_splits, metric=metric)

    if "VARIANCE" in names:
        specs["mean_var"] = request("variance", internal_splits=3)
    elif "MEAN" in names:
        specs["mean_var"] = request("mean", internal_splits=2)
    else:
        if "COUNT" in names:
            specs["count"] = request("count")
        if "SUM" in names:
            specs["sum"] = request("sum")
    if "PRIVACY_ID_COUNT" in names:
        specs["privacy_id_count"] = request("privacy_id_count")
    if "VECTOR_SUM" in names:
        specs["vector_sum"] = request(
            "vector_sum", internal_splits=int(config.vector_size))
    if config.percentiles:
        # One budget for all percentiles, requested last.
        specs["percentile"] = request(
            "percentile", internal_splits=quantile_tree.DEFAULT_TREE_HEIGHT)
    return specs


# Kept partitions fetched through the packed compact block; beyond this
# the full fetch runs instead (as in the JAX package: the choice decides
# which rows draw host noise, so it is part of the bit-identity contract).
_COMPACT_FETCH_CAP = 8192


def _assemble_output(config: FusedConfig, vocab, metric_arrays, rel_sel,
                     vocab_idx):
    """Released metric columns -> [(partition_key, MetricsTuple)]; a
    rank-2 column (VECTOR_SUM) gives each tuple a float64 [D] array."""
    fields = tuple(_metric_field_order(config))
    columns = []
    for f in fields:
        arr = metric_arrays[f]
        columns.append(arr[rel_sel].tolist() if arr.ndim == 1 else
                       list(arr[rel_sel, :]))
    return [
        (vocab[i], _create_named_tuple_instance("MetricsTuple", fields,
                                                vals))
        for i, vals in zip(np.asarray(vocab_idx).tolist(), zip(*columns))
    ]


def _record_selection_audit(strategy, pre: int, post: int,
                            path: str) -> None:
    """The selection seam's audit counters: pre- and post-selection
    partition counts and one structured event per selection, behind the
    run report's ``privacy.partition_selection`` section. Gated on
    ``PIPELINEDP_TPU_AUDIT``; host bookkeeping only — released values are
    bit-identical on or off."""
    if not obs.audit.audit_enabled():
        return
    obs.inc("selection.partitions_pre", int(pre))
    obs.inc("selection.partitions_post", int(post))
    obs.event("selection.applied", strategy=str(strategy.value),
              pre=int(pre), post=int(post), path=path)


def _audit_expected_errors(config: FusedConfig, specs, metric_arrays,
                           rel_sel) -> None:
    """Per-metric expected relative error into the audit registry: the
    calibrated noise stddev (where the standard predictors apply) against
    the mean |released aggregate|. Never raises."""
    if not obs.audit.audit_enabled():
        return
    try:
        names = set(config.metrics)
        stds: Dict[str, float] = {}
        if "VARIANCE" in names or "MEAN" in names:
            # The combiner splits the granted budget evenly into its
            # count / normalized-sum (/ sum-of-squares) sub-mechanisms;
            # predict the count leg's noise at that per-sub share.
            spec = specs["mean_var"]
            k = 3 if "VARIANCE" in names else 2
            sub = dataclasses.replace(
                _release_noise_params(config, spec),
                eps=spec.eps / k, delta=(spec.delta or 0.0) / k)
            stds["count"] = dp_computations.compute_dp_count_noise_std(sub)
        else:
            if "COUNT" in names:
                stds["count"] = dp_computations.compute_dp_count_noise_std(
                    _release_noise_params(config, specs["count"]))
            if "SUM" in names:
                stds["sum"] = dp_computations.compute_dp_sum_noise_std(
                    _release_noise_params(config, specs["sum"]))
        if "PRIVACY_ID_COUNT" in names:
            snp = _release_noise_params(config, specs["privacy_id_count"])
            l0, linf = snp.pid_count_sensitivities()
            stds["privacy_id_count"] = dp_computations._noise_std(
                snp.eps, snp.delta, l0, linf, snp.noise_kind)
        for field in _metric_field_order(config):
            arr = metric_arrays.get(field)
            if arr is None:
                continue
            arr = np.asarray(arr)
            if arr.ndim != 1:
                continue  # vector metrics: no scalar scale
            released = arr[rel_sel] if len(rel_sel) else arr[:0]
            scale = (float(np.mean(np.abs(released)))
                     if released.size else None)
            std = stds.get(field)
            rec = {"metric": field, "noise_stddev": std,
                   "aggregate_scale": scale,
                   "partitions": int(released.size)}
            if std is not None and scale:
                rec["expected_relative_error"] = float(std / scale)
            obs.audit.record_metric_error(rec)
    except Exception:
        pass  # an error estimate must never take the release down


def _maybe_append_run_ledger(name: str = "engine.aggregate",
                             mesh=None) -> None:
    """A traced run persists its run report into the durable ledger store
    (when a store directory resolves — ``obs.store.ledger_dir``). Each
    append carries only this request's delta; ``mesh`` keys the
    fingerprint on the mesh shape the request ran on."""
    if not obs.trace_enabled():
        return
    obs.store.maybe_append_run_report(name, mesh=mesh)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_seed(rng_seed: Optional[int]) -> int:
    """The seed protocol: the engine's seed, or a fresh one per run."""
    return (rng_seed if rng_seed is not None else
            # lint: disable=rng-purity(seed protocol: a run without rng_seed draws its seed from the seeded host generator)
            int(noise_ops._host_rng.integers(0, 2**31 - 1)))


def _run_fused(config: FusedConfig, encoded: EncodedData, scales,
               keep_table, thr, s_scale, min_count, rows_per_uid, rng_seed,
               device, mesh=None):
    """The seed protocol and the device path: returns (keep_pk [P_pad],
    accumulator columns, fx_bits). On a ``mesh`` the path runs sharded
    (``parallel.sharded_fused_aggregate``) and every rank gets the whole
    axis back; the lane plan comes from the GLOBAL row count, since the
    ranks' lane sums add."""
    P_pad = _pad_pow2(len(encoded.pk_vocab))
    # lint: disable=rng-purity(seed protocol root key, pure in rng_seed)
    key = prng.PRNGKey(_run_seed(rng_seed))
    if _fixedpoint_layout(config) or _vector_fx(config):
        fx_bits, _ = _fx_plan(max(encoded.n_rows, 1))
    else:
        fx_bits = 12
    if mesh is not None:
        from pipelinedp_tpu_torch.parallel import sharded
        with obs.span("engine.sharded_fused_aggregate", cat="engine"):
            keep_pk, raw = sharded.sharded_fused_aggregate(
                mesh, config, P_pad, encoded.pid, encoded.pk,
                encoded.values if config.needs_values else None, scales,
                keep_table, thr, s_scale, min_count, rows_per_uid, key,
                fx_bits)
        return keep_pk, raw, fx_bits
    with obs.span("engine.put", cat="engine"):
        pid, pk, values = put_on_device(encoded, device,
                                        with_values=config.needs_values)
    keep_pk, raw = _fused_body(config, P_pad, pid, pk, values, scales,
                               keep_table, thr, s_scale, min_count,
                               rows_per_uid, key, fx_bits)
    return keep_pk, raw, fx_bits


def fused_fx_bits(config: FusedConfig, padded_rows: int) -> int:
    """``jax_engine.fused_fx_bits``: the fixed-point lane width of a fused
    bucket, sized from the bucket's row edge, a bound on every member's
    rows. A solo request sizes from its own rows and may pick wider lanes;
    both are exact integer decompositions of the same quantized values,
    so the folded float64 release is bit-identical either way."""
    if _fixedpoint_layout(config) or _vector_fx(config):
        return _fx_plan(max(int(padded_rows), 1))[0]
    return 12


@dataclasses.dataclass
class FusionPrep:
    """One request's host-side preparation for a fused batch
    (``jax_engine.FusionPrep``): exactly the inputs a solo run would feed
    the device path. Built only by ``LazyFusedResult.prepare_fused``
    (after ``compute_budgets()``); consumed by ``serve/fusion.py``, which
    hands a group of them to ``fused_aggregate_batch``."""
    lazy: "LazyFusedResult"
    encoded: EncodedData
    P: int
    P_pad: int
    scales: np.ndarray
    keep_table: np.ndarray
    thr: float
    s_scale: float
    min_count: float
    rows_per_uid: float
    key: torch.Tensor

    def stack_signature(self) -> Tuple:
        """The JAX package's rule for which members of a bucket batch
        together: its stacked program needs equal keep-table and
        noise-scale shapes. The port's batch takes any mix, but splits a
        bucket's batch by the same rule, so its batches, events and
        counters are the JAX package's."""
        return (self.scales.shape, self.keep_table.shape,
                int(np.asarray(self.encoded.values).ndim))


@costs.instrumented(phase="serve_fused")
def _fused_batch_body(config: FusedConfig, num_partitions: int, pid, pk,
                      values, sizes: Tuple[int, ...], preps, fx_bits: int):
    """The device path of a fused batch of requests: ``pid``/``pk``/
    ``values`` are the members' rows concatenated (member ``b`` holds
    ``sizes[b]`` rows, unpadded). Each member keeps its own root split,
    bounding streams, selection and noise keys; the bounding sorts all
    rows once by (request, pid, hpk, tie) with every run breaking at a
    request boundary, K4 runs once on the flat rows, and the reduction
    offsets each member's partitions by ``b * num_partitions``, so ONE
    ``segment_sum_lanes`` call (K1) reduces the whole batch (and one
    ``segment_sum_wide`` call, K2, its fixed-point VECTOR_SUM). With
    percentiles the bounded rows, keyed by the same flat partition, feed
    one quantile walk of the whole batch (``_percentile_values_batch``:
    one more K1 launch and one K3 launch). K1 to K3 give exact int32
    counts per segment and each member's walk draws its own noise, so
    each member's columns are its solo columns bit for bit. Returns (keep
    [B, P], columns [B, P] or [B, P, W])."""
    P = num_partitions
    device = pk.device
    # lint: disable=rng-purity(root split seam, pure in each request's key)
    roots = [prng.split(prep.key, 3) for prep in preps]
    req = torch.repeat_interleave(
        torch.arange(len(sizes), device=device),
        torch.as_tensor(sizes, device=device))
    if config.bounds_already_enforced:
        b = _bound_enforced(config, pk, values, req)
    else:
        starts = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        parts = [_bounding_streams(pid[lo:hi], pk[lo:hi], k[0])
                 for lo, hi, k in zip(starts, starts[1:], roots)]
        tie_ms = [s.tie_m for s in parts]
        streams = _Streams(torch.cat([s.hpk for s in parts]),
                           torch.cat([s.tiebreak for s in parts]),
                           lambda: torch.cat([f() for f in tie_ms]))
        del parts
        b = _bound_sorted(config, pid, pk, values, streams, req)
        del streams
    flat_pk = (b.spk.to(torch.int64) + b.sreq * P).to(torch.int32)
    part, nseg = _reduce_per_pk(config, flat_pk, b.masked, b.keep_row,
                                len(sizes) * P, seg_marker=b.seg_marker,
                                fx_bits=fx_bits, contrib=b.contrib,
                                capacity_rows=max(sizes))
    qrows = (_qrows(config, flat_pk, b.svalues, b.keep_row)
             if config.percentiles else None)
    del b, flat_pk
    if config.bounds_already_enforced:
        nseg = part["count"]
    keeps, outs = [], []
    for i, (prep, (_, k_sel, _)) in enumerate(zip(preps, roots)):
        rows = slice(i * P, (i + 1) * P)
        keep_i, out_i = _selection(
            config, P, {k: v[rows] for k, v in part.items()}, nseg[rows],
            prep.keep_table, prep.thr, prep.s_scale, prep.min_count,
            prep.rows_per_uid, k_sel)
        keeps.append(keep_i)
        outs.append(out_i)
    cols = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
    if config.percentiles:
        vals = _percentile_values_batch(
            config, len(preps), P, qrows,
            [_walk_scale(prep.scales) for prep in preps],
            [_tree_key(k_noise) for _, _, k_noise in roots])
        for qi, name in enumerate(_percentile_field_names(
                config.percentiles)):
            cols[name] = vals[:, :, qi]
    return torch.stack(keeps), cols


def fused_aggregate_batch(config: FusedConfig, num_partitions: int,
                          preps: Sequence[FusionPrep], fx_bits: int,
                          device) -> Tuple[np.ndarray, Dict[str, Any]]:
    """The port's ``jax_engine.fused_aggregate_batch_kernel``: one device
    path for a whole group of prepared requests of one bucket, fetched to
    the host once. Returns (keep [B, P] bool, columns [B, P] or
    [B, P, W]) as host arrays; member ``b``'s slice is what its solo run
    computes (``LazyFusedResult.finish_from_fused`` releases it).

    The members' rows run concatenated through ``_fused_batch_body``:
    one K1 launch for the batch, and with PERCENTILE one more K1 launch
    and one K3 launch for the quantile walk of every member."""
    device = torch.device(device)
    with obs.span("engine.fused_aggregate_batch", cat="engine"):
        cols = [put_on_device(prep.encoded, device,
                              with_values=config.needs_values)
                for prep in preps]
        pid = torch.cat([c[0] for c in cols])
        pk = torch.cat([c[1] for c in cols])
        values = (torch.cat([c[2] for c in cols])
                  if config.needs_values else None)
        del cols
        keep, raw = _fused_batch_body(
            config, num_partitions, pid, pk, values,
            tuple(int(prep.encoded.n_rows) for prep in preps), preps,
            fx_bits)
        # The [B, P] columns ride one packed int32 block (float columns
        # bitcast into it), as the solo fetch does; [B, P, W] columns
        # follow one each.
        flat = sorted(k for k, v in raw.items() if v.dim() == 2)
        block = torch.stack([keep.to(torch.int32)] + [
            raw[k] if raw[k].dtype == torch.int32 else
            raw[k].contiguous().view(torch.int32) for k in flat]).cpu().numpy()
        raw_h = {k: (block[1 + i] if raw[k].dtype == torch.int32 else
                     block[1 + i].view(np.float32))
                 for i, k in enumerate(flat)}
        for k, v in raw.items():
            if v.dim() != 2:
                raw_h[k] = v.cpu().numpy()
        _sync(device)
    return block[0] > 0, raw_h


class LazyFusedResult:
    """Iterable of (partition_key, MetricsTuple); runs the device path on
    first iteration — after ``compute_budgets()``, honoring the two-phase
    protocol. Iterating again reuses the cached result.

    ``timings`` holds ``host_encode_s``, ``device_s`` (ends with a
    synchronise on the card) and ``host_decode_s`` of the last run. A
    streamed run adds the JAX package's stream keys: ``stream_batches``;
    pass A's ``stream_executor`` ("serial" or "overlapped"),
    ``stream_t_stage``, ``stream_t_device`` (waiting for batch outputs),
    ``stream_t_fold``, ``stream_t_total`` (the loop's wall),
    ``stream_overlap_frac``, ``stream_stage_s`` (both passes) and
    ``stream_fold_wait_s``; with a checkpoint store
    ``stream_resumed_from`` and ``stream_checkpoint_saves``; with
    percentiles ``stream_pass_b`` (the pass-B source: ``"device_cache"``,
    ``"hybrid"`` or ``"reship"``), ``stream_pass_b_sweeps``,
    ``stream_pass_b_tiles``, ``stream_pass_b_tiles_per_sweep``,
    ``stream_pass_b_cached_batches``, ``stream_pass_b_reshipped_bytes``
    and ``stream_pass_b_sweep_s``.

    On a ``mesh`` (``parallel.make_mesh``) the device path runs sharded on
    the mesh's device, and every rank returns the same release."""

    def __init__(self, rows, params: AggregateParams, config: FusedConfig,
                 data_extractors, public_partitions, specs,
                 selection_spec, rng_seed: Optional[int], device,
                 stream: Optional[Dict[str, Any]] = None, mesh=None):
        self._rows = rows
        self._params = params
        self._config = config
        self._extractors = data_extractors
        self._public = public_partitions
        self._specs = specs
        self._selection_spec = selection_spec
        self._rng_seed = rng_seed
        self._mesh = mesh
        self._device = (mesh.device if mesh is not None
                        else torch.device(device))
        self._stream = dict(stream or {})
        self._cache = None
        #: Serve-fusion seam: the encoding a fusion offer already built
        #: for exactly these rows; ``_execute`` takes it instead of
        #: encoding again, so a fused request that runs solo after all
        #: (a window of one, an unfusable prep) encodes its rows once.
        self._encoded_hint: Optional[EncodedData] = None
        self.timings: Optional[Dict[str, float]] = None

    def __iter__(self):
        # Deferred to the first next(): iter() at graph-construction time
        # must not run the device path before compute_budgets().
        if self._cache is None:
            self._cache = self._execute()
        yield from self._cache

    def rebind_rows(self, rows) -> None:
        """Sketch-first seam (``sketch/engine.py``): phase 2 of the
        two-phase unbounded-key path replaces the full input with the
        candidate-filtered rows before first iteration. Budgets were
        registered against the original graph build, which is the
        two-phase protocol's contract (specs are lazy; only the rows
        narrow). Every run encodes its rows from scratch and decides then
        whether to stream, so nothing of the old rows survives the swap.
        Refuses after execution: the cache would already embody the old
        rows."""
        if self._cache is not None:
            raise RuntimeError(
                "cannot rebind rows after the fused result executed")
        self._rows = rows
        self._encoded_hint = None
        self.timings = None

    def _execute(self):
        config = self._config
        # The timing fields are views over the run tracer's "engine.*"
        # span totals, as in the JAX package.
        tr = obs.run_tracer()
        with tr.span("engine.encode", cat="engine"):
            encoded = (self._encoded_hint if self._encoded_hint is not None
                       else self._encode())
        self.timings = {"host_encode_s": tr.total("engine.encode"),
                        "device_s": 0.0, "host_decode_s": 0.0}
        P = len(encoded.pk_vocab)
        if P == 0:
            return []
        scales, keep_table, thr, s_scale, min_count, rows_per_uid = (
            self._device_inputs())

        from pipelinedp_tpu_torch import streaming
        if streaming.should_stream(config, encoded.n_rows, self._mesh):
            return self._execute_streamed(encoded, scales, keep_table, thr,
                                          s_scale, min_count, rows_per_uid,
                                          tr)
        # The planner's resolution for this single-batch request (a
        # streamed request resolves inside the stream): the plan.applied
        # events exist for every request, and mid-request knob reads
        # bucket at this request's shape.
        plan_mod.resolve(
            shape={"rows": int(encoded.n_rows), "partitions": int(P),
                   "quantiles": len(config.percentiles or ())})
        with tr.span("engine.device", cat="engine", path="single_batch"):
            fetched, fx_bits, compact, kept_idx = self._run_device(
                encoded, scales, keep_table, thr, s_scale, min_count,
                rows_per_uid)
        self.timings["device_s"] = tr.total("engine.device")
        if config.selection is not None:
            # Every vocab entry is a populated partition: P is the
            # pre-selection count, the kept index set the post one.
            _record_selection_audit(config.selection, P, len(kept_idx),
                                    "single_batch")

        # Only materialize kept partitions. In compact mode the released
        # arrays already hold only kept rows.
        if self._public is not None:
            rel_sel = vocab_idx = np.arange(P)
        elif compact:
            rel_sel = np.arange(len(kept_idx))
            vocab_idx = kept_idx
        else:
            rel_sel = vocab_idx = kept_idx
        return self._finish_release(encoded, fetched, fx_bits, rel_sel,
                                    vocab_idx)

    def _encode(self) -> EncodedData:
        config = self._config
        return encode(self._rows, self._extractors, self._public,
                      require_pid=not config.bounds_already_enforced,
                      vector_size=config.vector_size)

    def _device_inputs(self):
        """(noise scales, keep table, threshold, selection scale, min
        count, rows per unit): the device path's inputs besides the rows
        and the key."""
        config = self._config
        params = self._params
        scales = _noise_scales(config, self._specs)
        # Without privacy ids the selection user-count estimate divides by
        # the max rows one user may own.
        if config.bounds_already_enforced:
            rows_per_uid = float(params.max_contributions or
                                 params.max_contributions_per_partition)
        else:
            rows_per_uid = 1.0
        if self._selection_spec is not None:
            keep_table, thr, s_scale, min_count = selection_inputs(
                config, self._selection_spec.eps,
                self._selection_spec.delta, params.pre_threshold)
        else:
            keep_table, thr, s_scale, min_count = selection_inputs(
                config, 1.0, 1e-9, None)
        return scales, keep_table, thr, s_scale, min_count, rows_per_uid

    # --- serve-fusion seams (phase 1 / phase 2 of a fused execution) ---

    def prepare_fused(self, encoded: Optional[EncodedData] = None
                      ) -> Optional[FusionPrep]:
        """Serve-fusion seam, phase 1 (``jax_engine.LazyFusedResult.
        prepare_fused``): the host-side preparation a solo run does before
        the device path — encode, noise scales, selection inputs, the
        request's PRNG key — without running it. Runs after
        ``compute_budgets()``, like iteration. An unseeded request draws
        its seed here, at the JAX package's point of the host sequence.
        Returns None when the request cannot join a fused batch (a mesh,
        an empty vocabulary, or so many rows that it streams): the fusion
        layer then runs it solo, visibly."""
        config = self._config
        if self._mesh is not None:
            return None
        tr = obs.run_tracer()
        with tr.span("engine.encode", cat="engine"):
            if encoded is None:
                encoded = self._encode()
        P = len(encoded.pk_vocab)
        if P == 0:
            return None
        from pipelinedp_tpu_torch import streaming
        if streaming.should_stream(config, encoded.n_rows):
            return None
        self.timings = {"host_encode_s": tr.total("engine.encode"),
                        "device_s": 0.0, "host_decode_s": 0.0,
                        "fused": True}
        scales, keep_table, thr, s_scale, min_count, rows_per_uid = (
            self._device_inputs())
        return FusionPrep(
            lazy=self, encoded=encoded, P=P, P_pad=_pad_pow2(P),
            scales=np.asarray(scales), keep_table=np.asarray(keep_table),
            thr=float(thr), s_scale=float(s_scale),
            min_count=float(min_count), rows_per_uid=float(rows_per_uid),
            # lint: disable=rng-purity(seed protocol root key, pure in rng_seed)
            key=prng.PRNGKey(_run_seed(self._rng_seed)))

    def finish_from_fused(self, prep: FusionPrep, keep_np, raw_np,
                          fx_bits: int):
        """Serve-fusion seam, phase 2 (``jax_engine.LazyFusedResult.
        finish_from_fused``): release THIS request from its slice of the
        batch's host arrays. The compact-vs-full release choice is the
        solo fetch's, made here on the host: it decides which rows
        consume a seeded host rng's draws, so it is part of the
        bit-identity contract. Installs the result as the lazy cache."""
        config = self._config
        P = prep.P
        keep = np.asarray(keep_np)[:P]
        kept_idx = np.flatnonzero(keep > 0)
        if self._public is not None:
            fetched = {k: np.asarray(v)[:P] for k, v in raw_np.items()}
            rel_sel = vocab_idx = np.arange(P)
        elif len(kept_idx) <= min(P, _COMPACT_FETCH_CAP):
            # The solo path's packed compact fetch: release ONLY the kept
            # rows, in ascending pk order.
            fetched = {k: np.asarray(v)[:P][kept_idx]
                       for k, v in raw_np.items()}
            rel_sel = np.arange(len(kept_idx))
            vocab_idx = kept_idx
        else:
            fetched = {k: np.asarray(v)[:P] for k, v in raw_np.items()}
            rel_sel = vocab_idx = kept_idx
        if config.selection is not None:
            _record_selection_audit(config.selection, P, len(kept_idx),
                                    "fused_batch")
        out = self._finish_release(prep.encoded, fetched, fx_bits, rel_sel,
                                   vocab_idx)
        self._cache = out
        return out

    def _run_device(self, encoded: EncodedData, scales, keep_table, thr,
                    s_scale, min_count, rows_per_uid):
        """The single-batch device path and its fetch, ended by a
        synchronise on the card. Returns ``(fetched host columns, fx_bits,
        compact, kept vocab indices)``."""
        config = self._config
        P = len(encoded.pk_vocab)
        keep_pk, raw, fx_bits = _run_fused(
            config, encoded, scales, keep_table, thr, s_scale, min_count,
            rows_per_uid, self._rng_seed, self._device, self._mesh)
        with obs.span("engine.fetch", cat="engine"):
            # The rank-1 columns are [P_pad] and ride one packed int32 block,
            # the float32 percentile columns bitcast into it; the rank-2
            # VECTOR_SUM column is gathered by the kept indices.
            flat = sorted(k for k, v in raw.items() if v.dim() == 1)
            cols = [raw[name] if raw[name].dtype == torch.int32 else
                    raw[name].contiguous().view(torch.int32) for name in flat]
            compact = self._public is None
            if compact:
                cap = min(P, _COMPACT_FETCH_CAP)
                packed = _compact_fetch(keep_pk, cols, P, cap).cpu().numpy()
                n_keep = int(packed[0, 0])
                if n_keep > cap:  # too many kept: fetch everything
                    stacked = torch.stack(
                        [keep_pk.to(torch.int32)] + cols)[:, :P].cpu().numpy()
                    kept_idx = np.flatnonzero(stacked[0] > 0)
                    compact = False
                else:
                    stacked = packed[1:, :n_keep]
                    kept_idx = stacked[0]
            else:
                stacked = torch.stack(
                    [keep_pk.to(torch.int32)] + cols)[:, :P].cpu().numpy()
                kept_idx = np.flatnonzero(stacked[0] > 0)
            fetched = {name: (stacked[1 + i] if raw[name].dtype == torch.int32
                              else stacked[1 + i].view(np.float32))
                       for i, name in enumerate(flat)}
            for name, arr in raw.items():
                if arr.dim() != 1:
                    if compact:
                        rows = torch.from_numpy(kept_idx.astype(np.int64))
                        fetched[name] = arr[rows.to(arr.device)].cpu().numpy()
                    else:
                        fetched[name] = arr[:P].cpu().numpy()
            _sync(self._device)
        return fetched, fx_bits, compact, kept_idx

    def _finish_release(self, encoded: EncodedData, fetched, fx_bits: int,
                        rel_sel, vocab_idx):
        """The float64 release tail: integer columns stay integral (the
        release dispatches on dtype, as the host combiners do)."""
        config = self._config
        tr = obs.run_tracer()
        with tr.span("engine.release", cat="engine"):
            part64 = {k: (v.astype(np.int64) if v.dtype.kind in "iu" else
                          v.astype(np.float64)) for k, v in fetched.items()}
            _fold_fixedpoint(config, part64, fx_bits)
            # lint: disable=rng-purity(host-release rng seeded by the engine seed)
            rng = (np.random.default_rng(self._rng_seed)
                   if self._rng_seed is not None else None)
            # The vector noise is keyed by the global vocab index of each
            # released row: ``vocab_idx`` when the released rows are the
            # kept set (compact or public), arange in the full fetch,
            # which releases every vocab row in order.
            n_rel_rows = len(part64["count"])
            row_vocab = (np.asarray(vocab_idx)
                         if len(vocab_idx) == n_rel_rows
                         else np.arange(n_rel_rows))
            metric_arrays = _host_release(config, self._specs, part64,
                                          part64["privacy_id_count_raw"],
                                          rng, rng_seed=self._rng_seed,
                                          pk_index=row_vocab,
                                          device=self._device)
            # The walk released the percentiles on the device, in float32.
            for name in _percentile_field_names(config.percentiles):
                metric_arrays[name] = fetched[name]
            out = _assemble_output(config, encoded.pk_vocab, metric_arrays,
                                   rel_sel, vocab_idx)
        self.timings["host_decode_s"] = tr.total("engine.release")
        _audit_expected_errors(config, self._specs, metric_arrays, rel_sel)
        _maybe_append_run_ledger(mesh=self._mesh)
        return out

    def _execute_streamed(self, encoded: EncodedData, scales, keep_table,
                          thr, s_scale, min_count, rows_per_uid, tr):
        """More rows than one batch: ``streaming.stream_partials_and_select``
        folds the batches' partials on the host and walks the percentiles
        in two passes; the release covers only the kept partitions, in
        ascending pk order (the host-noise draw order of the single-batch
        compact fetch)."""
        from pipelinedp_tpu_torch import streaming
        config = self._config
        P = len(encoded.pk_vocab)
        with tr.span("engine.device", cat="engine", path="streamed"):
            keep, part64, stats = streaming.stream_partials_and_select(
                config, encoded, scales, keep_table, thr, s_scale,
                min_count, rows_per_uid, self._rng_seed, self._device,
                mesh=self._mesh, **self._stream)
            _sync(self._device)
        self.timings["device_s"] = tr.total("engine.device")
        self.timings["stream_batches"] = stats["n_batches"]
        if "resumed_from_batch" in stats:
            self.timings["stream_resumed_from"] = stats["resumed_from_batch"]
            self.timings["stream_checkpoint_saves"] = stats[
                "checkpoint_saves"]
        # The elastic recovery trail: a run that survived a lost rank says
        # so, and at which dispatch, with each reshard's time to recover.
        if stats.get("mesh_reshards"):
            self.timings["stream_mesh_reshards"] = stats["mesh_reshards"]
            self.timings["stream_reshard_history"] = stats["reshard_history"]
        if stats.get("recover_s"):
            self.timings["stream_recover_s"] = stats["recover_s"]
            self.timings["stream_reform_s"] = stats["reform_s"]
        for k in ("stage_s", "fold_wait_s", "t_stage", "t_fold", "t_device",
                  "t_total", "overlap_frac", "executor"):
            self.timings[f"stream_{k}"] = stats[k]
        if config.percentiles:
            self.timings["stream_pass_b"] = stats["pass_b_source"]
            for k in ("pass_b_sweeps", "pass_b_tiles",
                      "pass_b_tiles_per_sweep", "pass_b_cached_batches",
                      "pass_b_reshipped_bytes", "pass_b_sweep_s"):
                self.timings[f"stream_{k}"] = stats[k]

        with tr.span("engine.release", cat="engine"):
            part64 = {k: v[:P] for k, v in part64.items()}
            if self._public is not None:
                rel_sel = vocab_idx = np.arange(P)
            else:
                kept_idx = np.flatnonzero(keep[:P])
                part64 = {k: v[kept_idx] for k, v in part64.items()}
                rel_sel = np.arange(len(kept_idx))
                vocab_idx = kept_idx
            # lint: disable=rng-purity(host-release rng seeded by the engine seed)
            rng = (np.random.default_rng(self._rng_seed)
                   if self._rng_seed is not None else None)
            metric_arrays = _host_release(config, self._specs, part64,
                                          part64["privacy_id_count_raw"],
                                          rng, rng_seed=self._rng_seed,
                                          pk_index=vocab_idx,
                                          device=self._device)
            for qi, name in enumerate(_percentile_field_names(
                    config.percentiles)):
                metric_arrays[name] = stats["percentile_values"][
                    :P, qi][vocab_idx]
            out = _assemble_output(config, encoded.pk_vocab, metric_arrays,
                                   rel_sel, vocab_idx)
        self.timings["host_decode_s"] = tr.total("engine.release")
        _audit_expected_errors(config, self._specs, metric_arrays, rel_sel)
        _maybe_append_run_ledger(mesh=self._mesh)
        return out


class LazySelectResult:
    """Iterable of kept partition keys; runs the device path with an empty
    metric set — only bounding + selection — on first iteration."""

    def __init__(self, rows, params, data_extractors, spec, rng_seed,
                 device, mesh=None):
        self._rows = rows
        self._params = params
        self._extractors = data_extractors
        self._spec = spec
        self._rng_seed = rng_seed
        self._mesh = mesh
        self._device = (mesh.device if mesh is not None
                        else torch.device(device))
        self._cache = None

    def __iter__(self):
        if self._cache is None:
            self._cache = self._execute()
        yield from self._cache

    def _execute(self):
        params = self._params
        config = FusedConfig(
            metrics=(), noise_kind=NoiseKind.LAPLACE, linf=None,
            l0=params.max_partitions_contributed,
            per_partition_bounds=False, min_value=None, max_value=None,
            min_sum_per_partition=None, max_sum_per_partition=None,
            selection=params.partition_selection_strategy,
            bounds_already_enforced=False)
        encoded = encode(self._rows, self._extractors, None)
        P = len(encoded.pk_vocab)
        if P == 0:
            return []
        keep_table, thr, s_scale, min_count = selection_inputs(
            config, self._spec.eps, self._spec.delta, params.pre_threshold)
        from pipelinedp_tpu_torch import streaming
        if streaming.should_stream(config, encoded.n_rows, self._mesh):
            # The stream with no metrics: only its keep vector is read,
            # and the kept keys go out in ascending vocabulary order.
            keep, _, _ = streaming.stream_partials_and_select(
                config, encoded, np.zeros(1, np.float32), keep_table, thr,
                s_scale, min_count, 1.0, self._rng_seed, self._device,
                mesh=self._mesh)
            out = [encoded.pk_vocab[i] for i in np.flatnonzero(keep[:P])]
            _maybe_append_run_ledger("engine.select_partitions",
                                     mesh=self._mesh)
            return out
        keep_pk, _, _ = _run_fused(config, encoded, _noise_scales(config, {}),
                                   keep_table, thr, s_scale, min_count, 1.0,
                                   self._rng_seed, self._device, self._mesh)
        vocab = encoded.pk_vocab
        cap = min(P, _COMPACT_FETCH_CAP)
        packed = _compact_fetch(keep_pk, (), P, cap).cpu().numpy()
        n_keep = int(packed[0, 0])
        if n_keep > cap:
            keep_np = keep_pk[:P].cpu().numpy()
            out = [vocab[i] for i in np.flatnonzero(keep_np)]
        else:
            out = [vocab[i] for i in packed[1, :n_keep].tolist()]
        _record_selection_audit(config.selection, P, len(out),
                                "select_partitions")
        _maybe_append_run_ledger("engine.select_partitions", mesh=self._mesh)
        return out


def build_fused_select_partitions(col, params, data_extractors,
                                  budget_accountant, report_gen,
                                  rng_seed=None, device="cuda",
                                  mesh=None) -> LazySelectResult:
    """Fused ``select_partitions``: the L0 bound over distinct (pid, pk)
    pairs and the batched selection are the aggregation path with no
    metrics requested."""
    spec = budget_accountant.request_budget(
        mechanism_type=MechanismType.GENERIC, metric="partition_selection")
    strategy = params.partition_selection_strategy
    report_gen.add_stage(
        f"Cross-partition contribution bounding: for each privacy_id "
        f"randomly select max(actual_partition_contributed, "
        f"{params.max_partitions_contributed}) partitions (fused on "
        "device).")
    report_gen.add_stage(
        lambda: f"Private Partition selection: using {strategy.value} "
        f"method with (eps={spec.eps}, delta={spec.delta}) — batched over "
        "all partitions")
    return LazySelectResult(col, params, data_extractors, spec, rng_seed,
                            device, mesh)


def build_fused_aggregation(col, params: AggregateParams, data_extractors,
                            public_partitions, budget_accountant,
                            report_gen, rng_seed=None, device="cuda",
                            stream=None, mesh=None) -> LazyFusedResult:
    """Engine entry point of the fused path: requests budgets (the same
    requests, in the same order, as the JAX package), registers report
    stages, returns the lazy result. ``stream`` holds the keyword options
    of ``streaming.stream_partials_and_select`` (``checkpoint``,
    ``executor``, ``cache_bytes``); ``mesh`` runs the path on a mesh."""
    public = public_partitions is not None
    config = FusedConfig.from_params(params, public)
    specs = request_budgets(config, params, budget_accountant)
    selection_spec = None
    if not public:
        selection_spec = budget_accountant.request_budget(
            mechanism_type=MechanismType.GENERIC,
            metric="partition_selection")

    if not config.bounds_already_enforced:
        if config.max_contributions is not None:
            report_gen.add_stage(
                f"User contribution bounding: randomly selected not more "
                f"than {config.max_contributions} contributions (fused on "
                "device).")
        else:
            report_gen.add_stage(
                f"Per-partition contribution bounding: for each privacy_id "
                f"and each partition, randomly select "
                f"max(actual_contributions_per_partition, {config.linf}) "
                f"contributions (fused on device).")
            report_gen.add_stage(
                f"Cross-partition contribution bounding: for each "
                f"privacy_id randomly select "
                f"max(actual_partition_contributed, {config.l0}) "
                "partitions (fused on device).")
    if public:
        report_gen.add_stage(
            "Public partition selection: dropped non public partitions; "
            "missing public partitions added as empty (dense pk axis).")
    else:
        strategy = params.partition_selection_strategy
        report_gen.add_stage(
            lambda: f"Private Partition selection: using {strategy.value} "
            f"method with (eps={selection_spec.eps}, "
            f"delta={selection_spec.delta}) — batched over all partitions")
    report_gen.add_stage(
        lambda: "Computed metrics "
        f"{sorted(set(m.lower() for m in config.metrics))} in one fused "
        "device pass")
    return LazyFusedResult(col, params, config, data_extractors,
                           public_partitions, specs, selection_spec,
                           rng_seed, device, stream, mesh)
