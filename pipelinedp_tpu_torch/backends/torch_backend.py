"""TorchBackend — the execution plane of the port on a CUDA device.

Modelled on ``pipelinedp_tpu/backends/jax_backend.py``: a marker that
tells ``DPEngine`` to lower fusable aggregations to the fused device path
(``torch_engine``), plus the options that path reads. It has no mesh, no
checkpoint, no ingest executor, no pass-B cache, no health probe and no
compile cache (later slices).
"""

from __future__ import annotations

from typing import Optional

import torch


class TorchBackend:
    """Runs the fused aggregation path on ``device``.

    Attributes:
      device: the torch device of the device path: ``"cuda"`` (the
        default, the current CUDA device) or ``"cuda:<i>"``, or ``"cpu"``
        when the caller asks for the CPU, as the tests do.
      rng_seed: optional fixed seed for reproducible runs. The same seed
        gives the same result as ``JaxBackend(rng_seed=...)`` of the JAX
        package.
    """

    supports_fused_aggregation = True

    def __init__(self, device="cuda", rng_seed: Optional[int] = None,
                 mesh=None, checkpoint=None,
                 ingest_executor: Optional[bool] = None,
                 stream_cache: Optional[int] = None):
        # The JAX backend's streaming options that this port does not have
        # yet. Asking for one raises; leaving them unset runs the serial
        # stream, which releases the same values (the executor and the
        # pass-B cache select bit-identical paths in the JAX package).
        for asked, what in (
                (mesh is not None, "a mesh (multi-GPU is ROADMAP step 8; "
                 "streaming on a mesh, ROADMAP step 7)"),
                (checkpoint is not None,
                 "checkpoint and resume of a stream (ROADMAP step 7)"),
                (bool(ingest_executor),
                 "the overlapped ingest executor (ROADMAP step 7)"),
                (bool(stream_cache),
                 "the pass-B device prefix cache (ROADMAP step 7)")):
            if asked:
                raise NotImplementedError(
                    f"{what} is not ported to pipelinedp_tpu_torch yet")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend(device='cuda') needs a CUDA device and "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run the device path on the CPU")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"TorchBackend runs on cuda or cpu, not "
                             f"{device}")
        self.device = device
        self.rng_seed = rng_seed

    def annotate(self, col, stage_name: str = None, **kwargs):
        """No annotators in this slice: returns ``col`` unchanged."""
        return col
