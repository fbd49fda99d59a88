"""Device health: the flag a degraded runtime leaves for the process.

``DEGRADED_ENV`` is the JAX package's ``resilience.health.DEGRADED_ENV``.
Set, it says the runtime came up degraded, and the resident service
(``serve/service.py``) then refuses every submit with the structured
``"degraded"`` reason before any budget reserve. The device-health probe
with its CPU degrade, ``MeshSupervisor`` and ``collective_failure_to_loss``
are ROADMAP step 5b.
"""

#: Set when degradation steered this process off its accelerator.
DEGRADED_ENV = "PIPELINEDP_TPU_DEGRADED"
