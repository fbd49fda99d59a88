"""Host ms of a call outside the port's ``engine.encode`` and
``engine.device`` spans: DPEngine, the accountant, the plan and the
release tail."""
from benchmark.core.readers import host_other_ms as read  # noqa: F401
