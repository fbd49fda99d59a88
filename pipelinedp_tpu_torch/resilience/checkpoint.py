"""Budget-safe checkpoint and resume of the streamed aggregation and of
the utility-analysis sweep.

The stream's per-batch state is a pure monoid fold: integer count
accumulators (int64), folded fixed-point value columns (float64, each fold
exact), VECTOR_SUM's coordinate totals (float64) and, for percentiles, the
additive [P, 256] mid histogram (int32). Every random draw downstream of
the fold (the bounding keys ``fold_in(k_bound, b)``, the selection key,
the node noise) is a pure function of the run seed, so persisting
``(next_batch, accumulators)`` after a fold lets a killed run resume bit
for bit: the same noise draws, the same kept partitions, one charge to the
privacy budget. Resuming therefore requires the fingerprint of the run
that wrote the checkpoint: resuming another (config, data, seed) would
replay the wrong keys, and silently starting again would draw noise twice.

The utility-analysis sweep (``analysis/torch_sweep.py``) uses the same
store for its completed-chunk prefix: each configuration's outputs are a
pure function of (data, config), so ``(next chunk, the prefix's [C]
fields)`` resumes a killed sweep bit for bit (``sweep_fingerprint``). It
writes a ``.sweep`` sibling of the backend's checkpoint path, so it never
meets a stream's checkpoint.

The store is one ``.npz`` file written atomically (a temporary file, then
``os.replace``), so a kill during a write leaves the previous checkpoint
whole.

The format is the port's own, modelled on
``pipelinedp_tpu/resilience/checkpoint.py``: the fingerprint hashes the
port's ``FusedConfig``. A checkpoint written by the port is resumed by
the port; the port makes no promise to resume a file written by the JAX
package, and refuses one with ``CheckpointMismatch``. The fingerprint
binds the mesh size, so a checkpoint of another mesh shape is refused,
with one exception: every save carries the original run's batch
assignment (``assign``), and a stream resumed on a smaller mesh whose size
divides the saved one adopts it (the same batches, row order and keys,
each batch's cells regrouped onto the survivors) once the saved shape's
own fingerprint verifies. The saves also carry the run's elastic
reshards (``reshards``), the recovery trail of its run report. The JSON
meta uses the JAX package's field names.

On a mesh every rank folds the same accumulators and reads the one
store; only the rank at position 0 writes and clears it. Every rank reads
before its first collective and the first save follows one, so no rank
reads a file that another is writing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
from typing import Dict, Optional

import numpy as np


class CheckpointMismatch(Exception):
    """The checkpoint on disk was written by a different (config, data,
    seed) run: resuming it would replay the wrong noise keys."""


#: Arrays up to this many elements are digested whole; larger ones by
#: head, a strided sample and tail, with dtype and shape.
_FULL_DIGEST_ELEMS = 1 << 22


def _digest_array(h, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr)
    h.update(str((arr.dtype.str, arr.shape)).encode())
    if arr.size <= _FULL_DIGEST_ELEMS:
        h.update(arr.data)
        return
    flat = arr.reshape(-1)
    k = _FULL_DIGEST_ELEMS // 4
    h.update(np.ascontiguousarray(flat[:k]).data)
    h.update(np.ascontiguousarray(flat[::max(1, arr.size // k)]).data)
    h.update(np.ascontiguousarray(flat[-k:]).data)


def data_digest(encoded) -> str:
    """Content identity of the encoded table (pid, pk, values and the pk
    vocabulary), so that a checkpoint never resumes onto other data of the
    same row count. Arrays above about 4M elements are digested by head,
    sample and tail, which keeps the cost to milliseconds."""
    h = hashlib.blake2b(digest_size=16)
    for arr in (encoded.pid, encoded.pk, encoded.values):
        if arr is None:
            h.update(b"none")
        else:
            _digest_array(h, np.asarray(arr))
    h.update(repr(list(encoded.pk_vocab[:1000])).encode())
    return h.hexdigest()


def run_fingerprint(config, n_rows: int, n_batches: int, seed: int,
                    num_partitions: int, fx_bits: int,
                    data: str = "", n_dev: int = 1) -> str:
    """Identity of one streamed run: everything that decides the batch
    assignment (the mesh size included), the per-batch arithmetic and the
    noise keys, plus the ``data_digest``."""
    blob = json.dumps({
        "config": repr(config),
        "n_rows": int(n_rows),
        "n_batches": int(n_batches),
        "seed": int(seed),
        "num_partitions": int(num_partitions),
        "n_dev": int(n_dev),
        "fx_bits": int(fx_bits),
        "data": data,
        # The val: columns hold exact fixed-point step totals; the scale
        # division happens at release.
        "fold": "pipelinedp_tpu_torch-fx-steps-v1",
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def sweep_fingerprint(spec_repr: str, n_configs: int, chunk: int,
                      num_partitions: int, data: str = "",
                      arrays=(), n_dev: int = 1) -> str:
    """Identity of one utility-analysis sweep (``analysis/torch_sweep.py``):
    everything that decides the chunk boundaries and each chunk's
    arithmetic (the static spec, the chunking, the per-config parameter
    vectors, digested) and the ``data_digest``. Each configuration's
    outputs are a pure function of (data, config), so a resumed prefix and
    the recomputed rest equal the unbroken run bit for bit."""
    h = hashlib.blake2b(digest_size=16)
    for arr in arrays:
        _digest_array(h, np.asarray(arr))
    blob = json.dumps({
        "kind": "pipelinedp_tpu_torch-analysis-sweep-v1",
        "spec": spec_repr,
        "n_configs": int(n_configs),
        "chunk": int(chunk),
        "num_partitions": int(num_partitions),
        "n_dev": int(n_dev),
        "vectors": h.hexdigest(),
        "data": data,
    }, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


@dataclasses.dataclass
class StreamCheckpoint:
    fingerprint: str
    #: the first batch index not yet folded into the accumulators.
    next_batch: int
    #: host accumulator arrays, keyed ``acc:<name>``, ``val:<name>``,
    #: ``vec`` and ``mid`` (all numpy; device state is fetched first).
    arrays: Dict[str, np.ndarray]
    #: the ORIGINAL run's batch assignment, ``{"n_batches", "n_dev",
    #: "num_partitions", "fx_bits"}``, kept as it was across elastic
    #: reshards so that a run resumed on a smaller mesh adopts it (the
    #: same batch order and ``fold_in(k_bound, b)`` keys) instead of
    #: refusing the shape-changed fingerprint. None on a save without it,
    #: which never resumes elastically.
    assign: Optional[Dict] = None
    #: the run's ``mesh.reshard`` records, in order (``old_devices``,
    #: ``new_devices``, ``reason``, ``chunk``, ``detail``).
    reshards: list = dataclasses.field(default_factory=list)


class CheckpointStore:
    """File-backed checkpoint: one atomic ``.npz`` per streamed run."""

    def __init__(self, path: str):
        self.path = str(path)
        #: how the last load or save went, for tests and logs.
        self.last_event: str = ""

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def save(self, ckpt: StreamCheckpoint) -> None:
        payload = dict(ckpt.arrays)
        meta = {"fingerprint": ckpt.fingerprint,
                "next_batch": int(ckpt.next_batch)}
        if ckpt.assign is not None:
            meta["assign"] = {k: int(v) for k, v in ckpt.assign.items()}
        if ckpt.reshards:
            meta["reshards"] = list(ckpt.reshards)
        payload["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                            dtype=np.uint8)
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.last_event = f"saved next_batch={ckpt.next_batch}"
        from pipelinedp_tpu_torch import obs
        obs.inc("checkpoint.saves")

    def load(self) -> Optional[StreamCheckpoint]:
        if not self.exists():
            self.last_event = "no checkpoint"
            return None
        with np.load(self.path) as z:
            meta = json.loads(bytes(z["__meta__"]).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}
        self.last_event = f"loaded next_batch={meta['next_batch']}"
        return StreamCheckpoint(fingerprint=meta["fingerprint"],
                                next_batch=int(meta["next_batch"]),
                                arrays=arrays, assign=meta.get("assign"),
                                reshards=list(meta.get("reshards", [])))

    def load_for(self, fingerprint: str) -> Optional[StreamCheckpoint]:
        """Load and check against the current run's fingerprint. A
        mismatch raises rather than restarting: a silent restart would
        draw noise again and spend the budget twice."""
        from pipelinedp_tpu_torch import obs
        ckpt = self.load()
        if ckpt is None:
            return None
        if ckpt.fingerprint != fingerprint:
            obs.inc("checkpoint.mismatch_refusals")
            obs.event("checkpoint.mismatch_refusal", path=self.path,
                      found=ckpt.fingerprint[:16],
                      expected=fingerprint[:16])
            raise CheckpointMismatch(
                f"checkpoint at {self.path} was written by a different "
                "run (config/data/seed fingerprint mismatch); refusing "
                "to resume — delete it explicitly to start fresh")
        obs.inc("checkpoint.resumes")
        obs.event("checkpoint.resumed", path=self.path,
                  next_batch=int(ckpt.next_batch))
        return ckpt

    def clear(self) -> None:
        if self.exists():
            os.unlink(self.path)
        self.last_event = "cleared"


def as_store(checkpoint) -> Optional[CheckpointStore]:
    """A ``CheckpointStore``, from a store or a path (None stays None)."""
    if checkpoint is None:
        return None
    if isinstance(checkpoint, CheckpointStore):
        return checkpoint
    return CheckpointStore(checkpoint)


def atomic_write_json(path: str, payload) -> None:
    """Replace ``path`` with ``payload`` as JSON, durably: the document is
    written and fsync'd under a temporary name before one atomic
    ``os.replace``, so a reader, or a kill at any instant, sees the old
    document or the new one, never a torn mix."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".json.tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            f.write(json.dumps(payload, sort_keys=True, default=repr))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_json(path: str):
    """An ``atomic_write_json`` document, or None when there is no file.
    A corrupt document raises: under the atomic-replace protocol a torn
    file means something else wrote it."""
    if not os.path.exists(path):
        return None
    with open(path, encoding="utf-8") as f:
        return json.loads(f.read())
