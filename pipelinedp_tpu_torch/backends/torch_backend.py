"""TorchBackend — the execution plane of the port on a CUDA device.

Modelled on ``pipelinedp_tpu/backends/jax_backend.py``: a
``LocalBackend`` that tells ``DPEngine`` to lower fusable aggregations to
the fused device path (``torch_engine``), plus the options that path
reads, the streaming ones included. Everything the fused path does not
take (custom combiners, a percentile range too small for its float32 leaf
constant, the host analysis graphs, a user's own ``map``) runs on the
host generators it inherits, exactly where ``JaxBackend`` runs them. On
a mesh (``parallel.make_mesh``) the device path runs sharded over the
mesh's ranks. ``health_policy`` probes the card first (bounded retry and
backoff) and degrades to the CPU when the runtime is wedged: flagged on
``backend.degraded``, never silent. It has no compile cache.
"""

from __future__ import annotations

import dataclasses
import os
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
      mesh: a ``parallel.Mesh``: the fused path, the stream, the sweep and
        sketch-first run sharded over its ranks, on the mesh's device
        (``device`` is then the mesh's). Every rank builds the same
        backend and runs the same calls.
      health_policy: a ``resilience.RetryPolicy`` (or True for the
        default one): probe the card in a killable subprocess before the
        first kernel (``health.ensure_device_or_degrade``, with ``clock``
        and ``probe_timeout_s``) and, when every attempt fails, degrade to
        the CPU. None (the default) probes nothing: a missing card raises.
        With a mesh of several ranks (gloo), the ranks agree on one
        verdict (``health.agree_degraded``): one rank's failed probe
        degrades them all. An NCCL mesh cannot agree over a wedged card;
        make it with ``health.resilient_make_mesh`` instead.
      degraded: True when this process was steered off its card (by this
        backend's probe, a peer's on the same mesh, or an earlier one:
        ``health.DEGRADED_ENV`` is set). The device path then runs on the
        CPU without a mesh, and results must carry the flag.
      health: the probe's ``resilience.health.HealthReport``, or None when
        no ``health_policy`` was given.
    """

    supports_fused_aggregation = True

    def __init__(self, device="cuda", rng_seed: Optional[int] = None,
                 mesh=None, checkpoint=None,
                 ingest_executor: Optional[bool] = None,
                 stream_cache: Optional[int] = None, health_policy=None,
                 clock=None, probe_timeout_s: Optional[float] = None):
        from pipelinedp_tpu_torch.resilience import health as health_mod
        # An earlier degrade in this process steered every later backend
        # off the card: the flag says so even without a probe of its own.
        self.degraded = bool(os.environ.get(health_mod.DEGRADED_ENV))
        self.health = None
        if mesh is not None:
            from pipelinedp_tpu_torch.parallel import sharded
            mesh = sharded.require_mesh(mesh)
        several = mesh is not None and mesh.size > 1
        if health_policy is not None:
            if several and mesh.backend != "gloo":
                raise ValueError(
                    "health_policy on a multi-rank mesh agrees the verdict "
                    "over gloo; an NCCL mesh cannot agree over a wedged "
                    "card: make it with health.resilient_make_mesh")
            self.health = health_mod.ensure_device_or_degrade(
                policy=None if health_policy is True else health_policy,
                clock=clock, timeout_s=probe_timeout_s,
                device=(mesh.device if mesh is not None else
                        torch.device(device)).type)
            self.degraded = self.health.degraded
            if several:
                self._agree_with_peers(mesh.group.pg)
        if self.degraded:
            # A wedged card's mesh is unusable: the CPU fallback runs on
            # one device. Never silent: ``degraded`` says so.
            mesh = None
            device = "cpu"
        if mesh is not None:
            device = mesh.device
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
        self.mesh = mesh
        self.rng_seed = rng_seed
        self.checkpoint = checkpoint
        self.ingest_executor = ingest_executor
        self.stream_cache = stream_cache
        from pipelinedp_tpu_torch import obs
        # seed_fixed, never the seed itself: run reports are meant to be
        # shared, and noise draws are pure functions of the seed.
        obs.event("backend.created", degraded=self.degraded,
                  mesh_devices=mesh.size if mesh is not None else 0,
                  seed_fixed=rng_seed is not None,
                  checkpoint=bool(checkpoint), device=str(device))

    def _agree_with_peers(self, pg) -> None:
        """One degrade verdict for every rank of the mesh's group ``pg``:
        a rank whose own probe passed degrades too when a peer's failed,
        flagged and recorded as its own failed probe would be."""
        from pipelinedp_tpu_torch import obs
        from pipelinedp_tpu_torch.resilience import health as health_mod
        if not health_mod.agree_degraded(self.degraded, pg) or self.degraded:
            return
        os.environ[health_mod.DEGRADED_ENV] = "1"
        obs.inc("health.degradations")
        obs.event("health.degraded", target="cpu_platform",
                  attempts=self.health.attempts,
                  detail=health_mod.PEER_DEGRADED)
        self.health = dataclasses.replace(
            self.health, degraded=True, detail=health_mod.PEER_DEGRADED)
        self.degraded = True
