"""Two-phase sketch-first DP aggregation: the unbounded-key path.

A port of ``pipelinedp_tpu/sketch/engine.py``. Every other path of the
engine takes a dense, integer-encoded partition axis up front; here the
key space is **discovered**, not given.

Phase 1 — device counting sketch + DP candidate selection:

1. Extract (privacy_id, key) columns; factorize keys on the HOST into
   a distinct-key table (host memory scales with distinct keys; the
   DEVICE never sees a dense key axis — its world is the fixed
   ``[depth, width]`` bucket grid).
2. Bound per-user contribution **before** the sketch: each user keeps
   at most ``L0`` distinct keys, chosen by a deterministic seeded
   tie-break (a pure function of (hash_seed, user, key) — row-order
   and batch-membership invariant), and each kept (user, key) pair
   counts once. One user therefore moves the bucket-mass vector by at
   most ``L0`` in L1.
3. Stream the bounded pairs' bucket ids through the ingest ring
   (``ingest.BackgroundStager`` stages chunk b+1 while the device
   bins chunk b) into the binner (``sketch/device.py``).
4. Select buckets: add Laplace noise at scale ``L0/eps`` to the row-0
   bucket masses via the counter-based generator (one draw per bucket,
   pure in (seed, bucket id)). Releasing this whole noisy vector is
   ``eps``-DP (public axis, L1 sensitivity ``L0``); keeping the
   buckets whose noisy mass clears the Laplace-thresholding bound and
   capping at the ``candidate_cap`` largest are post-processing. The
   budget is drawn through a dedicated ``NaiveBudgetAccountant``.
5. Candidates: the observed distinct keys whose row-0 bucket was
   selected, as a host-side key→candidate-id table
   (``hashing.build_candidate_table`` — phase-2 input, NOT a release).

Phase 2 — the exact dense path over candidates only: rows are filtered
to candidate keys and handed to the already-built
``torch_engine.LazyFusedResult`` (budgets were registered on the
engine's accountant at graph-build time, honoring the two-phase
protocol), which runs **private partition selection + noise exactly as
a dense run** over the restricted axis.

Privacy argument: the composed release is (phase-1 bucket set) ∘
(phase-2 standard DP aggregation conditioned on it). Phase 1 is
(eps, delta)-DP by the noisy-vector argument above. Given a FIXED
selected-bucket set B, "rows whose key hashes into B" is a
data-independent per-row filter, and the cap lives on the *buckets
inside the DP mechanism*, so phase 2 is exactly the dense engine's
guarantee on the filtered dataset. Total cost = sketch budget + engine
budget.

Parity (PARITY row 37): with every populated bucket selected (generous
phase-1 budget, threshold below 1, cap ≥ populated buckets), the
filtered rows ARE the input rows, and phase 2 is bit-for-bit the dense
path under the same engine accountant and seed.

Phase timings are views over the run tracer's ``sketch.*`` spans, and a
run leaves the JAX package's events, counters and audit records.

On a mesh each chunk pads to a multiple of ``n * ROW_BLOCK`` rows, the
rank at position ``d`` bins the ``d``-th slice, and one replicating
all-reduce gives every rank the chunk's sketch (the JAX package's
multi-process branch); the counts are exact integers, so the mesh equals
one device bit for bit. Phase 2 runs the fused path on the mesh.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.sketch import device as sketch_device
from pipelinedp_tpu_torch.sketch import hashing
from pipelinedp_tpu_torch.sketch.params import SketchParams

#: fold_in tag of the phase-1 selection noise stream — distinct from
#: every stream the fused path derives from the same root key.
_SELECT_STREAM_TAG = 0x5EC7


def _extract_columns(col, data_extractors
                     ) -> Tuple[np.ndarray, np.ndarray,
                                Optional[np.ndarray]]:
    """(privacy_ids, partition_keys, values|None) as host arrays, from
    an ArrayDataset or extractor-driven rows. Privacy ids are required
    — phase-1 bounding is per privacy unit."""
    from pipelinedp_tpu_torch.torch_engine import ArrayDataset

    if isinstance(col, ArrayDataset):
        if col.privacy_ids is None:
            raise ValueError(
                "sketch-first needs privacy ids: phase-1 contribution "
                "bounding is per privacy unit")
        return (np.asarray(col.privacy_ids),
                np.asarray(col.partition_keys),
                (np.asarray(col.values)
                 if col.values is not None else None))
    pid_ex = data_extractors.privacy_id_extractor
    pk_ex = data_extractors.partition_extractor
    val_ex = data_extractors.value_extractor
    if pid_ex is None:
        raise ValueError(
            "sketch-first needs privacy ids: set a privacy_id_extractor")
    pids, pks, vals = [], [], []
    for row in col:
        pids.append(pid_ex(row))
        pks.append(pk_ex(row))
        vals.append(val_ex(row) if val_ex else 0.0)
    return (np.asarray(pids), np.asarray(pks),
            np.asarray(vals, dtype=np.float64))


def _factorize_keys(pk_arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(distinct keys, int inverse) — the host key table. Integer keys
    of a manageable range take the presence-table factorizer, the rest
    ``np.unique``: ascending order either way, matching phase 2's
    encode."""
    from pipelinedp_tpu_torch import torch_engine as te

    fac = te._int_factorize(pk_arr)
    if fac is not None:
        return fac
    return te._unique_inverse(pk_arr)


#: Seed tweak separating the privacy-id hash stream from the key
#: hash stream (both derive from SketchParams.hash_seed).
_PID_HASH_SALT = 0x71D5A17


def bound_pairs(pid_arr: np.ndarray, key_inv: np.ndarray,
                key_hashes: np.ndarray, l0: int,
                hash_seed: int) -> np.ndarray:
    """Per-user bounded distinct (user, key) pairs, BEFORE the sketch.

    Returns the key indices (into the distinct-key table) of the kept
    pairs: each (user, key) pair appears once, and each user keeps at
    most ``l0`` keys — the ones with the smallest deterministic
    tie-break ``mix64(key_hash ^ mix64(content_hash(pid) ^ seed))``.

    The user identity in both the dedup and the tie-break salt is the
    CONTENT hash of the privacy id (``hashing.stable_hash64``), never
    a dataset-relative factorized rank: a rank shifts when another
    user is added or removed, which would reshuffle every later
    user's kept-key sample and void the L1 ≤ l0 sensitivity bound
    the Laplace scale is calibrated against. With content-derived
    salts, one user's presence changes ONLY that user's ≤ l0 pairs —
    for any pid dtype — and the kept set is invariant to row order,
    (user, key) duplication and batch membership.
    """
    with np.errstate(over="ignore"):
        seed64 = np.uint64(hash_seed & ((1 << 64) - 1))
        pid_hash = hashing.stable_hash64(pid_arr,
                                         seed=hash_seed ^ _PID_HASH_SALT)
    k_all = key_inv.astype(np.int64)
    # Dedup (user, key) pairs on (content hash, key idx). A 64-bit
    # pid-hash collision merges two users (≈ n^2 / 2^64 — negligible,
    # and it only ever REMOVES pairs: conservative).
    order0 = np.lexsort((k_all, pid_hash))
    ph = pid_hash[order0]
    kv = k_all[order0]
    if len(ph) == 0:
        return np.zeros(0, np.int64)
    first_pair = np.r_[True, (ph[1:] != ph[:-1]) | (kv[1:] != kv[:-1])]
    p_u = ph[first_pair]
    k_u = kv[first_pair]
    with np.errstate(over="ignore"):
        user_salt = hashing.mix64(p_u ^ seed64)
        tb = hashing.mix64(key_hashes[k_u] ^ user_salt)
    order = np.lexsort((tb, p_u))
    sorted_p = p_u[order]
    new_group = np.r_[True, sorted_p[1:] != sorted_p[:-1]]
    first = np.flatnonzero(new_group)
    group_start = np.repeat(first, np.diff(np.r_[first, len(sorted_p)]))
    rank = np.arange(len(sorted_p)) - group_start
    return k_u[order][rank < l0]


def _stage_chunk(chunk: np.ndarray, device: torch.device, copy_stream):
    """(device tensor, ready event or None) of one padded host chunk: on
    the card the chunk is pinned and copied ``non_blocking`` on a side
    stream, and an event recorded after the copy orders it before the
    binner reads it."""
    host = torch.from_numpy(chunk)
    if device.type != "cuda":
        return host.to(device), None
    host = host.pin_memory()
    with torch.cuda.device(device), torch.cuda.stream(copy_stream):
        dev = host.to(device, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(copy_stream)
    return dev, ready


def _accumulate_stream(pair_buckets: np.ndarray, width: int,
                       backend: str, chunk_rows: int,
                       device: torch.device, tr, mesh=None
                       ) -> Tuple[np.ndarray, int, str]:
    """Stream the bounded pairs' bucket ids through the ingest ring into
    the device sketch: the stager copies chunk b+1 to the device while
    the dispatch thread bins chunk b. Returns ([depth, width] int64 host
    counts, chunks, the device the binner ran on); ``tr`` times each
    chunk's staging and binning. Exact for any chunking (integer sum).
    On a ``mesh`` each rank stages and bins its slice of every chunk and
    the ranks' sketches are summed (see the module docstring)."""
    from pipelinedp_tpu_torch import ingest
    from pipelinedp_tpu_torch.resilience import faults

    depth = pair_buckets.shape[0]
    n = pair_buckets.shape[1]
    total = np.zeros((depth, width), np.int64)
    n_chunks = max(1, -(-n // chunk_rows))
    copy_stream = (torch.cuda.Stream(device) if device.type == "cuda"
                   else None)
    binned_on = str(device)
    n_dev = mesh.size if mesh is not None else 1
    if n_dev > 1:
        from pipelinedp_tpu_torch.parallel import sharded as psh
        obs.event("sketch.sharded", devices=n_dev,
                  topology=mesh.topology.mode)

    def gen_factory(cancelled):
        def gen():
            for b in range(n_chunks):
                if cancelled.is_set():
                    return
                lo = b * chunk_rows
                hi = min(n, lo + chunk_rows)
                with tr.span("sketch.stage", cat="sketch", batch=b):
                    chunk = sketch_device.pad_chunk(
                        np.ascontiguousarray(pair_buckets[:, lo:hi]),
                        n_shards=n_dev)
                    if n_dev > 1:
                        part = chunk.shape[1] // n_dev
                        chunk = np.ascontiguousarray(
                            chunk[:, mesh.index * part:
                                  (mesh.index + 1) * part])
                    dev, ready = _stage_chunk(chunk, device, copy_stream)
                yield b, dev, ready
        return gen()

    with ingest.BackgroundStager(gen_factory, name="sketch-stager") as st:
        for b, dev, ready in st.items():
            faults.check_sketch_chunk(b)
            with tr.span("sketch.accumulate", cat="sketch", batch=b):
                if ready is not None:
                    compute = torch.cuda.current_stream(device)
                    compute.wait_event(ready)
                    dev.record_stream(compute)
                with obs.device_annotation("pdp.sketch_chunk"):
                    out = sketch_device.sketch_chunk(dev, width, backend)
                    if n_dev > 1:
                        out = psh.combine_shards(out, mesh, 1, True,
                                                 "sketch.chunk")
                binned_on = str(out.device)
                sketch_device.accumulate_chunk(total, out)
    return total, n_chunks, binned_on


def select_buckets(counts_row0: np.ndarray, spec, l0: int, cap: int,
                   threshold: Optional[float], sel_key, device="cpu"
                   ) -> Tuple[np.ndarray, float, float]:
    """DP bucket selection over the row-0 sketch masses.

    Releases (internally) the noisy-mass vector ``counts + Lap(l0 /
    spec.eps)`` — one counter-keyed draw per bucket, on ``device`` —
    then keeps the buckets clearing the threshold, capped at the ``cap``
    largest by noisy mass (deterministic stable order). The float32 unit
    draw is widened to float64 on the host before it is scaled, as in
    the JAX package. Returns (keep mask [width] bool, threshold, noise
    scale).
    """
    from pipelinedp_tpu_torch.ops import counter_rng
    from pipelinedp_tpu_torch.ops import partition_selection as ps_ops

    width = len(counts_row0)
    scale = l0 / spec.eps
    if threshold is None:
        if spec.delta and spec.delta > 0:
            threshold = ps_ops.LaplaceThresholdingPartitionStrategy(
                spec.eps, spec.delta, l0).threshold
        else:
            threshold = 1.0
    idx = torch.arange(width, dtype=torch.int64, device=device)
    unit = counter_rng.laplace(sel_key, idx, torch.zeros_like(idx))
    noisy = (counts_row0.astype(np.float64) +
             unit.cpu().numpy().astype(np.float64) * scale)
    keep = noisy >= threshold
    n_keep = int(keep.sum())
    if n_keep > cap:
        kept_idx = np.flatnonzero(keep)
        order = np.argsort(-noisy[kept_idx], kind="stable")
        winners = kept_idx[order[:cap]]
        keep = np.zeros(width, dtype=bool)
        keep[winners] = True
    return keep, float(threshold), float(scale)


def count_min_estimate(counts: np.ndarray,
                       buckets_of_key: np.ndarray) -> np.ndarray:
    """Count-min mass estimates for keys: min over depth rows of their
    bucket masses (diagnostic only — never released; collisions only
    inflate, so the min over independent rows tightens the estimate)."""
    depth = counts.shape[0]
    est = counts[0][buckets_of_key[0]]
    for d in range(1, depth):
        est = np.minimum(est, counts[d][buckets_of_key[d]])
    return est


class LazySketchFirstResult:
    """Iterable of (partition_key, MetricsTuple): phase 1 (sketch + DP
    candidate selection) runs on first iteration — after
    ``compute_budgets()``, like every lazy result — then phase 2 is
    the inner dense ``LazyFusedResult`` over the candidate-filtered
    rows. Iterating again reuses the cached output.

    ``timings`` holds ``sketch_hash_s``, ``sketch_bound_s``,
    ``sketch_accumulate_s`` (dispatching the chunks until their counts
    reach the host), ``sketch_select_s``, ``sketch_chunks`` and
    ``sketch_candidates``, merged with the inner result's timings.
    ``binner_device`` names the device the binner ran on."""

    def __init__(self, col, params, sketch_params: SketchParams,
                 data_extractors, inner, rng_seed: Optional[int],
                 device="cpu", mesh=None):
        self._col = col
        self._mesh = mesh
        self._params = params
        self._sketch = sketch_params
        self._extractors = data_extractors
        self._inner = inner
        self._rng_seed = rng_seed
        self._device = (mesh.device if mesh is not None
                        else torch.device(device))
        self._cache: Optional[List] = None
        #: Host-side key→candidate-id encoding table of the last run —
        #: phase-2 INPUT, not a DP release: do not publish it.
        self._candidate_table: Optional[Dict[Any, int]] = None
        self.timings: Optional[Dict[str, float]] = None
        self.binner_device: Optional[str] = None

    def __iter__(self):
        if self._cache is None:
            self._cache = self._execute()
        yield from self._cache

    def _execute(self) -> List:
        from pipelinedp_tpu_torch.aggregate_params import MechanismType
        from pipelinedp_tpu_torch.budget_accounting import \
            NaiveBudgetAccountant
        from pipelinedp_tpu_torch.ops import noise as noise_ops
        from pipelinedp_tpu_torch.ops import prng
        from pipelinedp_tpu_torch.torch_engine import ArrayDataset

        from pipelinedp_tpu_torch.obs import audit as obs_audit

        sp = self._sketch
        tr = obs.run_tracer()
        obs.monitor.maybe_start()
        width = sp.resolved_width()
        depth = sp.resolved_depth()
        cap = sp.resolved_candidate_cap()
        backend = sp.resolved_backend()
        l0 = sp.resolved_l0(self._params)

        with tr.span("sketch.extract", cat="sketch"):
            pid_arr, pk_arr, values_arr = _extract_columns(
                self._col, self._extractors)
        with tr.span("sketch.hash", cat="sketch"):
            uniq_keys, key_inv = _factorize_keys(pk_arr)
            key_hashes = hashing.stable_hash64(uniq_keys, sp.hash_seed)
            buckets_of_key = hashing.bucket_ids(key_hashes, width, depth,
                                                sp.hash_seed)
        with tr.span("sketch.bound", cat="sketch"):
            kept_keys = bound_pairs(pid_arr, key_inv, key_hashes, l0,
                                    sp.hash_seed)
            pair_buckets = np.ascontiguousarray(
                buckets_of_key[:, kept_keys])
        counts, n_chunks, self.binner_device = _accumulate_stream(
            pair_buckets, width, backend, sp.chunk_rows, self._device, tr,
            self._mesh)

        with tr.span("sketch.select", cat="sketch"):
            # Phase 1's own books: a dedicated accountant for the bucket
            # selection, beside the engine's accountant of phase 2; its
            # audit record reaches the registry like the engine's.
            acc = NaiveBudgetAccountant(total_epsilon=sp.eps,
                                        total_delta=sp.delta)
            spec = acc.request_budget(
                mechanism_type=MechanismType.GENERIC,
                metric="sketch_candidate_selection")
            acc.compute_budgets()
            seed = (self._rng_seed if self._rng_seed is not None else
                    int(noise_ops._host_rng.integers(0, 2**31 - 1)))
            sel_key = prng.fold_in(prng.PRNGKey(seed), _SELECT_STREAM_TAG)
            keep_mask, threshold, noise_scale = select_buckets(
                counts[0], spec, l0, cap, sp.threshold, sel_key,
                self._device)

        with tr.span("sketch.candidates", cat="sketch"):
            key_selected = keep_mask[buckets_of_key[0]]
            candidates, table = hashing.build_candidate_table(
                uniq_keys, key_selected)
            self._candidate_table = table
            row_mask = key_selected[key_inv]

        populated = int((counts[0] > 0).sum())
        obs.inc("sketch.runs")
        obs.event("sketch.selected",
                  buckets_populated=populated,
                  buckets_selected=int(keep_mask.sum()),
                  candidates=len(candidates),
                  universe_keys=int(len(uniq_keys)))
        if obs_audit.audit_enabled():
            # The count-min mass of the candidate keys only, and only when
            # the record is captured: the gather is audit-tier work.
            cand_est = count_min_estimate(
                counts, buckets_of_key[:, key_selected])
            obs_audit.record_sketch({
                "width": width, "depth": depth, "candidate_cap": cap,
                "backend": backend, "l0": l0,
                "eps": spec.eps, "delta": spec.delta,
                "noise_scale": noise_scale, "threshold": threshold,
                "hash_seed_fixed": sp.hash_seed != hashing.DEFAULT_SEED,
                "pairs_sketched": int(pair_buckets.shape[1]),
                "chunks": int(n_chunks),
                "buckets_populated": populated,
                "buckets_selected": int(keep_mask.sum()),
                "universe_keys": int(len(uniq_keys)),
                "candidates": len(candidates),
                "candidate_mass_estimate_max": (int(cand_est.max())
                                                if len(cand_est) else 0),
            })

        self.timings = {
            "sketch_hash_s": tr.total("sketch.hash"),
            "sketch_bound_s": tr.total("sketch.bound"),
            "sketch_accumulate_s": tr.total("sketch.accumulate"),
            "sketch_select_s": tr.total("sketch.select"),
            "sketch_chunks": n_chunks,
            "sketch_candidates": len(candidates),
        }
        if not candidates:
            # Nothing cleared DP selection: release nothing. The inner
            # result stays unexecuted (its registered budget was spent
            # by the accountant split regardless — conservative).
            obs.event("sketch.empty_selection")
            return []

        # Phase 2: the exact dense path over ONLY the candidates. The
        # filtered columns re-encode from scratch inside the inner
        # result, so the factorization (and with it every noise
        # assignment) is exactly what a dense run over these rows
        # would compute — the parity contract's foundation.
        filtered = ArrayDataset(
            privacy_ids=pid_arr[row_mask],
            partition_keys=pk_arr[row_mask],
            values=(values_arr[row_mask]
                    if values_arr is not None else None))
        self._inner.rebind_rows(filtered)
        out = list(self._inner)
        if self._inner.timings:
            self.timings.update(self._inner.timings)
        return out


def build_sketch_first_aggregation(col, params, data_extractors,
                                   sketch_params: SketchParams,
                                   budget_accountant, report_gen,
                                   rng_seed=None, device="cuda",
                                   stream=None,
                                   mesh=None) -> LazySketchFirstResult:
    """Engine entry for the sketch-first path: registers the phase-2
    budgets on the ENGINE accountant now (graph-build time — the
    two-phase protocol), records the report stages, and returns the
    lazy two-phase result. Phase 1 draws its own (eps, delta) from a
    dedicated accountant at execution time."""
    from pipelinedp_tpu_torch import torch_engine

    report_gen.add_stage(
        f"Sketch phase: per-user bounded (≤ "
        f"{sketch_params.max_buckets_contributed or 'L0'} distinct "
        f"keys) counting sketch over hashed keys; DP bucket selection "
        f"(Laplace, sketch budget eps={sketch_params.eps}, "
        f"delta={sketch_params.delta}) chooses candidate buckets; the "
        "exact dense pass below runs over candidate keys only.")
    inner = torch_engine.build_fused_aggregation(
        col, params, data_extractors, None, budget_accountant,
        report_gen, rng_seed=rng_seed, device=device, stream=stream,
        mesh=mesh)
    return LazySketchFirstResult(col, params, sketch_params,
                                 data_extractors, inner,
                                 rng_seed=rng_seed, device=device, mesh=mesh)
