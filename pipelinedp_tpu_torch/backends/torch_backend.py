"""TorchBackend — the execution plane of the port on a CUDA device.

Modelled on ``pipelinedp_tpu/backends/jax_backend.py``: a
``LocalBackend`` that tells ``DPEngine`` to lower fusable aggregations to
the fused device path (``torch_engine``), plus the options that path
reads, the streaming ones included. Everything the fused path does not
take (custom combiners, a percentile range too small for its float32 leaf
constant, the host analysis graphs, a user's own ``map``) runs on the
host generators it inherits, exactly where ``JaxBackend`` runs them. It
has no mesh (multi-GPU is ROADMAP step 5), no health probe and no compile
cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from pipelinedp_tpu_torch.pipeline_backend import LocalBackend


class TorchBackend(LocalBackend):
    """Runs the fused aggregation path on ``device``, and the host path
    of ``LocalBackend`` for the rest.

    Attributes:
      device: the torch device of the device path: ``"cuda"`` (the
        default, the current CUDA device) or ``"cuda:<i>"``, or ``"cpu"``
        when the caller asks for the CPU, as the tests do.
      rng_seed: optional fixed seed for reproducible runs. The same seed
        gives the same result as ``JaxBackend(rng_seed=...)`` of the JAX
        package.
      checkpoint: a ``resilience.CheckpointStore`` or a path: a streamed
        aggregation saves its folded prefix there and a killed run
        resumes from it bit for bit (needs ``rng_seed``).
      ingest_executor: True or False selects the overlapped or the serial
        stream; None (the default) follows the ``ingest_executor`` knob
        (``PIPELINEDP_TPU_INGEST_EXECUTOR``, on unless 0).
      stream_cache: the pass-B device cache's budget in bytes; None (the
        default) follows ``PIPELINEDP_TPU_STREAM_CACHE`` (4 GiB unless
        set); 0 re-ships every batch.
    """

    supports_fused_aggregation = True

    def __init__(self, device="cuda", rng_seed: Optional[int] = None,
                 mesh=None, checkpoint=None,
                 ingest_executor: Optional[bool] = None,
                 stream_cache: Optional[int] = None):
        if mesh is not None:
            raise NotImplementedError(
                "a mesh is not ported to pipelinedp_tpu_torch yet "
                "(multi-GPU, and streaming on a mesh, are ROADMAP step 5)")
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
        self.checkpoint = checkpoint
        self.ingest_executor = ingest_executor
        self.stream_cache = stream_cache
        from pipelinedp_tpu_torch import obs
        # seed_fixed, never the seed itself: run reports are meant to be
        # shared, and noise draws are pure functions of the seed.
        obs.event("backend.created", degraded=False, mesh_devices=0,
                  seed_fixed=rng_seed is not None,
                  checkpoint=bool(checkpoint), device=str(device))
