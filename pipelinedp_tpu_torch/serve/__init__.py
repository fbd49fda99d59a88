"""pipelinedp_tpu_torch.serve — the resident multi-tenant DP service.

A thin package over the existing engine: durable per-tenant budget
ledgers (``budget_ledger``), admission control + bounded queue + warm
engine reuse (``service``). In-process API first::

    from pipelinedp_tpu_torch import serve

    svc = serve.Service("/var/pdp", tenants={"acme": (4.0, 1e-6)})
    # device="cuda" by default; serve.Service(..., device="cpu") on a host
    out = svc.submit(serve.ServeRequest(
        tenant="acme", params=params, dataset=ds,
        epsilon=0.5, delta=1e-8))
    if out.ok:
        dict(out.results)
    else:
        out.reason, out.detail   # "overdraw" / "queue_full" / ...

Batch mode never imports this package (``tests/test_torch_serve.py``
scans the port for it); the serve path runs the batch engine's own code,
so serve-on/off is DP-bit-identical (PARITY row 34). The port of
``pipelinedp_tpu/serve``, with the JAX package's exports.
"""

from pipelinedp_tpu_torch.serve.budget_ledger import (BudgetLease,
                                                      LedgerError, Overdraw,
                                                      TenantBudgetLedger,
                                                      TenantMismatch,
                                                      UnknownTenant,
                                                      tenant_slug)
from pipelinedp_tpu_torch.serve.service import (REFUSAL_REASONS, Refusal,
                                                Service, ServeRequest,
                                                ServeResponse,
                                                params_signature)

__all__ = [
    "BudgetLease", "LedgerError", "Overdraw", "TenantBudgetLedger",
    "TenantMismatch", "UnknownTenant", "tenant_slug",
    "REFUSAL_REASONS", "Refusal", "Service", "ServeRequest",
    "ServeResponse", "params_signature",
]
