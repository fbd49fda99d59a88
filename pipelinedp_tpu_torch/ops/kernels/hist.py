"""The quantile walk's subtree-leaf histograms: a CUDA kernel and its plain
PyTorch version.

``subtree_counts_multi(qpk, leaf, kept, sub_starts, p_offsets, Pb, span)``
(K3) bins one batch's rows into every packed ``[T, Pb, Qc, span]`` tile::

    out[t, p, q, s] = #{r : kept[r], qpk[r] - p_offsets[t] == p,
                            leaf[r] - sub_starts[t, p, q] == s}

It replaces the Pallas kernel ``pipelinedp_tpu/ops/kernels/hist.py::
hist_bin_multi`` and with it the per-tile scatters of
``jax_engine._subtree_counts_multi``; the CUDA source, its design and its
bound on the H100 are in ``csrc/hist_bin.cu``. Rows out of a tile's
partition block, rows whose leaf lies outside ``[0, span)`` of their walk
start and rows not kept count nowhere; the starts need not be
span-aligned. The relative indices are int32, the output index int64.

Dispatch is by the device of the tensors and nothing else: a CUDA tensor
launches the kernel (or raises), a CPU tensor takes the plain version.
There is no envelope, no fallback and no row-block knob: the TPU kernel's
4 MB VMEM envelope (``dispatch.hist_envelope``) has no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from pipelinedp_tpu_torch.obs import costs

#: Kernel launches since the last reset (the CPU path never counts).
LAUNCHES: Dict[str, int] = {"subtree_counts_multi": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def subtree_counts_multi_plain(qpk: torch.Tensor, leaf: torch.Tensor,
                               kept: torch.Tensor, sub_starts: torch.Tensor,
                               p_offsets: torch.Tensor, Pb: int,
                               span: int) -> torch.Tensor:
    """The plain version, ``jax_engine._subtree_counts`` per tile: for each
    (t, q) one int64 ``index_add_`` over the flat bin index of the rows in
    range, cast back to int32."""
    T, _, Qc = sub_starts.shape
    out = torch.zeros(T, Pb, Qc, span, dtype=torch.int32, device=qpk.device)
    for t in range(T):
        rel_pk = qpk - p_offsets[t]
        in_blk = kept & (rel_pk >= 0) & (rel_pk < Pb)
        pk_b = torch.clamp(rel_pk, 0, Pb - 1).long()
        for q in range(Qc):
            rel = leaf - sub_starts[t, :, q][pk_b]
            ok = in_blk & (rel >= 0) & (rel < span)
            seg = pk_b * span + torch.clamp(rel, 0, span - 1).long()
            counts = torch.zeros(Pb * span, dtype=torch.int64,
                                 device=qpk.device)
            counts.index_add_(0, seg, ok.to(torch.int64))
            out[t, :, q, :] = counts.view(Pb, span).to(torch.int32)
    return out


def _check(qpk, leaf, kept, sub_starts, p_offsets, Pb: int, span: int,
           out: Optional[torch.Tensor]) -> None:
    for name, x in (("qpk", qpk), ("leaf", leaf), ("sub_starts", sub_starts),
                    ("p_offsets", p_offsets)):
        if x.dtype != torch.int32:
            raise TypeError(f"subtree_counts_multi takes int32 {name}, got "
                            f"{x.dtype}")
    if kept.dtype != torch.bool:
        raise TypeError(f"subtree_counts_multi takes bool kept, got "
                        f"{kept.dtype}")
    n = qpk.shape[0]
    if (qpk.dim() != 1 or leaf.shape != (n,) or kept.shape != (n,) or
            sub_starts.dim() != 3 or sub_starts.shape[1] != Pb or
            p_offsets.shape != (sub_starts.shape[0],)):
        raise ValueError(
            "subtree_counts_multi takes qpk, leaf, kept [N], sub_starts "
            f"[T, Pb={Pb}, Qc] and p_offsets [T], got {tuple(qpk.shape)}, "
            f"{tuple(leaf.shape)}, {tuple(kept.shape)}, "
            f"{tuple(sub_starts.shape)} and {tuple(p_offsets.shape)}")
    T, _, Qc = sub_starts.shape
    if min(T, int(Pb), Qc, int(span)) < 1:
        raise ValueError(f"subtree_counts_multi needs T, Pb, Qc, span >= 1, "
                         f"got {T}, {Pb}, {Qc}, {span}")
    tensors = [qpk, leaf, kept, sub_starts, p_offsets]
    if out is not None:
        if out.dtype != torch.int32 or out.shape != (T, Pb, Qc, span):
            raise ValueError(f"out must be int32 {(T, Pb, Qc, span)}, got "
                             f"{out.dtype} {tuple(out.shape)}")
        tensors.append(out)
    if any(x.device != qpk.device for x in tensors):
        raise ValueError("subtree_counts_multi takes tensors on one device")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("subtree_counts_multi takes contiguous tensors")
    if qpk.device.type not in ("cpu", "cuda"):
        raise ValueError(f"subtree_counts_multi runs on cuda or cpu, not "
                         f"{qpk.device}")


def subtree_counts_multi(qpk: torch.Tensor, leaf: torch.Tensor,
                         kept: torch.Tensor, sub_starts: torch.Tensor,
                         p_offsets: torch.Tensor, Pb: int, span: int,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The ``[T, Pb, Qc, span]`` int32 subtree-leaf counts: ``qpk``,
    ``leaf`` int32 ``[N]``, ``kept`` bool ``[N]``, ``sub_starts`` int32
    ``[T, Pb, Qc]``, ``p_offsets`` int32 ``[T]``, all contiguous on one
    device. With ``out`` the counts are added into it (a streamed sweep
    accumulates its batches there) and ``out`` is returned."""
    _check(qpk, leaf, kept, sub_starts, p_offsets, Pb, span, out)
    with costs.kernel_launch(
            "subtree_counts_multi",
            (qpk, leaf, kept, sub_starts, p_offsets, Pb, span),
            lambda: work(qpk, leaf, kept, sub_starts, p_offsets, Pb, span)):
        return _subtree_counts_multi(qpk, leaf, kept, sub_starts,
                                     p_offsets, Pb, span, out)


def work(qpk: torch.Tensor, leaf: torch.Tensor, kept: torch.Tensor,
         sub_starts: torch.Tensor, p_offsets: torch.Tensor, Pb: int,
         span: int) -> costs.Work:
    """The least work of one K3 call on these inputs, the counts of its
    bound in the cost table and in ``chip_smoke.py``. Every kept flag is
    read, ``qpk`` and ``leaf`` only at kept rows (the 32-byte sectors
    those rows touch, in each), the starts and offsets once, and the
    counts written once. Operations: one int32 add per in-range (row,
    tile, quantile)."""
    T, _, Qc = sub_starts.shape
    adds = 0
    for t in range(T):
        rel_pk = qpk - p_offsets[t]
        in_blk = kept & (rel_pk >= 0) & (rel_pk < Pb)
        pk_b = torch.clamp(rel_pk, 0, Pb - 1).long()
        for q in range(Qc):
            rel = leaf - sub_starts[t, :, q][pk_b]
            adds += int((in_blk & (rel >= 0) & (rel < span)).sum())
    sectors = int(torch.unique(kept.nonzero().squeeze(1) // 8).numel())
    return costs.Work(
        ops=adds,
        bytes=qpk.shape[0] + 2 * 32 * sectors + 4 * sub_starts.numel() +
        4 * T + 4 * T * int(Pb) * Qc * int(span))


def _subtree_counts_multi(qpk, leaf, kept, sub_starts, p_offsets, Pb, span,
                          out):
    if qpk.device.type == "cpu":
        counts = subtree_counts_multi_plain(qpk, leaf, kept, sub_starts,
                                            p_offsets, Pb, span)
        return counts if out is None else out.add_(counts)
    from pipelinedp_tpu_torch.ops.kernels import _build
    fn = _build.load("hist_bin").hist_bin_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    T, _, Qc = sub_starts.shape
    # The launch is asynchronous on PyTorch's current stream, so the
    # caching allocator hands the inputs' memory only to work queued after
    # the kernel, even when the caller drops them right away.
    with torch.cuda.device(qpk.device):
        if out is None:
            out = torch.zeros(T, int(Pb), Qc, int(span), dtype=torch.int32,
                              device=qpk.device)
        stream = torch.cuda.current_stream(qpk.device).cuda_stream
        err = fn(qpk.data_ptr(), leaf.data_ptr(), kept.data_ptr(),
                 sub_starts.data_ptr(), p_offsets.data_ptr(), out.data_ptr(),
                 qpk.shape[0], T, int(Pb), Qc, int(span), stream)
    if err != 0:
        raise RuntimeError(f"hist_bin launch failed: CUDA error {err}")
    LAUNCHES["subtree_counts_multi"] += 1
    return out
