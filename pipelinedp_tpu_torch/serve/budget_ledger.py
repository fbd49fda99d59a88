"""Durable per-tenant privacy-budget ledgers for the resident service.

The batch path's two-phase ``BudgetAccountant`` is per-engine and
in-memory: its total (eps, delta) is born and dies with one process.
A resident multi-tenant service needs the OTHER half of the story —
how much of a tenant's lifetime budget is left across requests and
restarts. This module is that half:

* one JSON document per tenant (``budget-<slug>.json``), written with
  the checkpoint store's atomic discipline (tmp + fsync +
  ``os.replace`` via ``resilience.checkpoint.atomic_write_json``) so a
  kill at any instant leaves a consistent ledger;
* **two-phase debits**: ``reserve()`` durably records the request's
  (eps, delta) BEFORE any compute runs and refuses (raises
  :class:`Overdraw`) when the tenant's remaining budget cannot cover
  it; ``commit()`` marks the spend final after the release;
  ``release()`` refunds a reserve whose request failed cleanly before
  any DP output existed. A reserve that is neither committed nor
  released — the kill-mid-request window — STAYS SPENT on replay:
  noise may already have been drawn, and the conservative direction
  for privacy is to count it;
* **exactly-once** under concurrency and restarts: debits key on the
  request id — a second ``reserve()`` for the same id returns the
  existing lease instead of double-debiting, and per-tenant locks
  serialize the read-modify-write so two racing requests can never
  both fit into one remaining slice. The dedup lease exists for
  RESTART REPLAY (a retry of a request the dead process never
  finished); while the original is still live in-process, the serve
  layer refuses the duplicate at admission — handing the retry a
  lease there would let one charge release two noisy views.

The per-request accountant then simply takes the leased (eps, delta)
as its totals — the accountant by construction distributes exactly
what it was given, so ledger arithmetic and accountant arithmetic
agree to the float.

The port of ``pipelinedp_tpu/serve/budget_ledger.py``: the same
document, the same two-phase debits, written through the port's own
``resilience.checkpoint.atomic_write_json``. Budget-ledger writes are
confined to this package (plus ``budget_accounting.py``), as
``tests/test_torch_serve.py`` checks with an ``ast`` scan of the port.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
from typing import Any, Dict, Optional

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch.budget_accounting import Budget
from pipelinedp_tpu_torch.resilience.checkpoint import (atomic_write_json,
                                                        read_json)

SCHEMA_VERSION = 1

#: Absolute slack for float comparisons on eps/delta sums: a tenant
#: whose debits sum to its total via a different addition order must
#: not be refused over the last ulp, and a genuine overdraw is never
#: this small in practice.
EPS_TOL = 1e-9
DELTA_TOL = 1e-15


class LedgerError(Exception):
    """Base class for budget-ledger failures."""


class UnknownTenant(LedgerError):
    """The tenant has no ledger in this directory."""


class TenantMismatch(LedgerError):
    """``open_tenant`` was asked to create a tenant whose durable
    ledger already exists with DIFFERENT totals — silently adopting
    either side would rewrite a privacy guarantee."""


class DuplicateRequest(LedgerError):
    """``reserve()`` was asked to re-reserve a request id whose debit
    is already COMMITTED — its DP output was released; running the
    request again would release a second noisy view of the data while
    charging the budget once."""


class Overdraw(LedgerError):
    """The request's (eps, delta) demand exceeds the tenant's
    remaining budget; carries the shortfall so the refusal can name
    it."""

    def __init__(self, tenant: str, request_id: str, requested: Budget,
                 remaining: Budget):
        self.tenant = tenant
        self.request_id = request_id
        self.requested = requested
        self.remaining = remaining
        self.shortfall = Budget(
            max(0.0, requested.epsilon - remaining.epsilon),
            max(0.0, requested.delta - remaining.delta))
        super().__init__(
            f"tenant '{tenant}' request '{request_id}' would overdraw "
            f"the budget ledger: requested {requested}, remaining "
            f"{remaining}, shortfall {self.shortfall}")


@dataclasses.dataclass(frozen=True)
class BudgetLease:
    """One granted reserve: the (eps, delta) a request may spend."""
    tenant: str
    request_id: str
    epsilon: float
    delta: float
    #: "reserved" on a fresh grant; the prior state when ``reserve``
    #: deduplicated an id it had already seen (exactly-once).
    state: str = "reserved"
    #: True when this lease dedups onto a debit reserved BEFORE this
    #: reserve call (restart replay). A replayed lease must NEVER be
    #: refunded on a clean failure: the ORIGINAL attempt may already
    #: have drawn noise before the process died, so the conservative
    #: direction is to leave the debit spent.
    replayed: bool = False


def tenant_slug(tenant: str) -> str:
    """Filesystem-safe, collision-resistant file stem for a tenant
    name (the name itself may hold any unicode)."""
    safe = "".join(c if (c.isalnum() or c in "-_") else "-"
                   for c in str(tenant))[:48]
    digest = hashlib.sha256(str(tenant).encode("utf-8")).hexdigest()[:8]
    return f"{safe}-{digest}"


class TenantBudgetLedger:
    """All tenants' durable budget ledgers under one directory.

    Thread-safe within a process (one lock per tenant). Cross-process
    writers must not share a directory concurrently — the intended
    deployment is one resident service process owning its ledger
    directory, with restarts (not concurrent peers) reading it back.
    """

    def __init__(self, directory: str):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._lock = threading.Lock()
        self._tenant_locks: Dict[str, threading.Lock] = {}
        #: Write-through cache of each tenant's document; disk is the
        #: source of truth on first touch (restart replay).
        self._states: Dict[str, Dict[str, Any]] = {}

    # --- plumbing ---

    def path_for(self, tenant: str) -> str:
        return os.path.join(self.directory,
                            f"budget-{tenant_slug(tenant)}.json")

    def _tenant_lock(self, tenant: str) -> threading.Lock:
        with self._lock:
            lock = self._tenant_locks.get(tenant)
            if lock is None:
                lock = threading.Lock()
                self._tenant_locks[tenant] = lock
            return lock

    def _load(self, tenant: str) -> Optional[Dict[str, Any]]:
        """The tenant's document (cache, else disk replay); None when
        the tenant was never opened here. Caller holds the lock."""
        state = self._states.get(tenant)
        if state is None:
            state = read_json(self.path_for(tenant))
            if state is not None:
                self._states[tenant] = state
        return state

    def _write(self, tenant: str, state: Dict[str, Any]) -> None:
        """Durably write ``state``, then install it as the cached
        document. Callers pass a NEW doc (never the cached one mutated
        in place), so a failed write — disk full, I/O error — leaves
        the cache on the last durable doc and memory never diverges
        from disk."""
        atomic_write_json(self.path_for(tenant), state)
        self._states[tenant] = state

    @staticmethod
    def _spent(state: Dict[str, Any]) -> Budget:
        """Sum of all debits that count as spent: reserved AND
        committed (a reserve whose request may have drawn noise is
        spent until explicitly released)."""
        eps = delta = 0.0
        for d in state["debits"].values():
            if d["state"] in ("reserved", "committed"):
                eps += float(d["epsilon"])
                delta += float(d["delta"])
        return Budget(eps, delta)

    # --- public API ---

    def open_tenant(self, tenant: str, total_epsilon: float,
                    total_delta: float) -> Budget:
        """Create (or re-open after restart) a tenant's ledger and
        return its remaining budget. Idempotent for matching totals;
        raises :class:`TenantMismatch` when a durable ledger already
        records different ones."""
        input_validators.validate_epsilon_delta(total_epsilon, total_delta,
                                               "TenantBudgetLedger")
        with self._tenant_lock(tenant):
            state = self._load(tenant)
            if state is None:
                state = {"schema_version": SCHEMA_VERSION,
                         "tenant": str(tenant),
                         "total_epsilon": float(total_epsilon),
                         "total_delta": float(total_delta),
                         "debits": {}}
                self._write(tenant, state)
                from pipelinedp_tpu_torch import obs
                obs.inc("serve.tenants_opened")
                obs.event("serve.tenant_opened", tenant=str(tenant),
                          path=self.path_for(tenant))
            elif (state["total_epsilon"] != float(total_epsilon) or
                  state["total_delta"] != float(total_delta)):
                raise TenantMismatch(
                    f"tenant '{tenant}' ledger at "
                    f"{self.path_for(tenant)} records totals "
                    f"(eps={state['total_epsilon']}, "
                    f"delta={state['total_delta']}), not "
                    f"(eps={total_epsilon}, delta={total_delta}) — "
                    "refusing to adopt either silently")
            return self._remaining_locked(state)

    def _remaining_locked(self, state: Dict[str, Any]) -> Budget:
        spent = self._spent(state)
        return Budget(state["total_epsilon"] - spent.epsilon,
                      state["total_delta"] - spent.delta)

    def has_tenant(self, tenant: str) -> bool:
        """Whether the tenant has a ledger here (cache or disk). An
        advisory, lock-free check: refusal bookkeeping uses it so
        garbage tenant names never grow books directories — or even
        per-tenant lock entries here."""
        return tenant in self._states or os.path.isfile(
            self.path_for(tenant))

    def remaining(self, tenant: str) -> Budget:
        """The tenant's remaining (eps, delta) — totals minus every
        reserved/committed debit, replayed from disk if needed."""
        with self._tenant_lock(tenant):
            state = self._load(tenant)
            if state is None:
                raise UnknownTenant(f"tenant '{tenant}' has no ledger "
                                    f"under {self.directory}")
            return self._remaining_locked(state)

    def debits(self, tenant: str) -> Dict[str, Dict[str, Any]]:
        """Snapshot of the tenant's per-request debit map."""
        with self._tenant_lock(tenant):
            state = self._load(tenant)
            if state is None:
                raise UnknownTenant(f"tenant '{tenant}' has no ledger "
                                    f"under {self.directory}")
            return {k: dict(v) for k, v in state["debits"].items()}

    def overview(self) -> Dict[str, Dict[str, Any]]:
        """Per-tenant budget overview across every tenant this process
        has loaded (the write-through cache is exactly that set —
        restart replay loads a tenant on first touch): totals,
        remaining (eps, delta), committed spend, and reserves still in
        flight. Read-only — the material behind the heartbeat's
        ``tenants`` section and the ``/metrics`` per-tenant gauges."""
        with self._lock:
            tenants = sorted(self._states)
        out: Dict[str, Dict[str, Any]] = {}
        for tenant in tenants:
            with self._tenant_lock(tenant):
                state = self._load(tenant)
                if state is None:
                    continue
                reserved_n = 0
                reserved_eps = reserved_delta = 0.0
                committed_eps = committed_delta = 0.0
                for d in state["debits"].values():
                    if d["state"] == "reserved":
                        reserved_n += 1
                        reserved_eps += float(d["epsilon"])
                        reserved_delta += float(d["delta"])
                    elif d["state"] == "committed":
                        committed_eps += float(d["epsilon"])
                        committed_delta += float(d["delta"])
                remaining = self._remaining_locked(state)
                out[tenant] = {
                    "total_epsilon": float(state["total_epsilon"]),
                    "total_delta": float(state["total_delta"]),
                    "remaining_epsilon": remaining.epsilon,
                    "remaining_delta": remaining.delta,
                    "committed_epsilon": committed_eps,
                    "committed_delta": committed_delta,
                    "reserves_in_flight": reserved_n,
                    "reserved_epsilon": reserved_eps,
                    "reserved_delta": reserved_delta,
                }
        return out

    def reserve(self, tenant: str, request_id: str, epsilon: float,
                delta: float) -> BudgetLease:
        """Durably debit (eps, delta) for ``request_id`` BEFORE any
        compute runs. Exactly-once: an id already debited returns its
        existing lease unchanged. Raises :class:`Overdraw` (with the
        shortfall) without writing anything when the remaining budget
        cannot cover the demand."""
        from pipelinedp_tpu_torch import obs
        if not (epsilon > 0):
            raise ValueError(f"request epsilon must be positive, got "
                             f"{epsilon}")
        if delta < 0:
            raise ValueError(f"request delta must be >= 0, got {delta}")
        with self._tenant_lock(tenant):
            state = self._load(tenant)
            if state is None:
                raise UnknownTenant(f"tenant '{tenant}' has no ledger "
                                    f"under {self.directory}")
            existing = state["debits"].get(str(request_id))
            if existing is not None and existing["state"] == "reserved":
                # Exactly-once restart replay: the debit already
                # happened before a restart (or kill) took the request
                # down mid-compute; hand back the same lease. The
                # serve layer refuses an id whose original is still
                # live IN-PROCESS before ever reaching here. A retry
                # that wants bit-identical replay must carry a fixed
                # rng_seed — the same discipline the checkpoint store
                # documents.
                if (float(existing["epsilon"]) != float(epsilon) or
                        float(existing["delta"]) != float(delta)):
                    # A replay must carry the ORIGINAL demand: handing
                    # the old lease to a retry that asked for different
                    # amounts would silently run it under amounts the
                    # caller never requested.
                    raise LedgerError(
                        f"tenant '{tenant}' request '{request_id}' is "
                        f"already reserved at (eps="
                        f"{existing['epsilon']}, delta="
                        f"{existing['delta']}); a replay retry must "
                        f"carry those amounts, not (eps={epsilon}, "
                        f"delta={delta}) — use a fresh request id for "
                        "a different demand")
                obs.inc("serve.budget_reserve_dedups")
                return BudgetLease(tenant=str(tenant),
                                   request_id=str(request_id),
                                   epsilon=float(existing["epsilon"]),
                                   delta=float(existing["delta"]),
                                   state=str(existing["state"]),
                                   replayed=True)
            if existing is not None and existing["state"] == "committed":
                # The id's output was already RELEASED: re-running it
                # would publish a second noisy view on one charge.
                obs.inc("serve.budget_duplicate_refusals")
                raise DuplicateRequest(
                    f"tenant '{tenant}' request '{request_id}' is "
                    "already committed — its DP output was released; "
                    "a re-run needs a fresh request id (and fresh "
                    "budget)")
            # A "released" debit was refunded (clean pre-release
            # failure): a retry is a fresh debit — fall through to the
            # overdraw check and overwrite it with the new amounts.
            remaining = self._remaining_locked(state)
            if (epsilon > remaining.epsilon + EPS_TOL or
                    delta > remaining.delta + DELTA_TOL):
                obs.inc("serve.budget_overdraw_refusals")
                obs.event("serve.budget_overdraw", tenant=str(tenant),
                          request_id=str(request_id),
                          requested_eps=float(epsilon),
                          requested_delta=float(delta),
                          remaining_eps=remaining.epsilon,
                          remaining_delta=remaining.delta)
                raise Overdraw(str(tenant), str(request_id),
                               Budget(float(epsilon), float(delta)),
                               remaining)
            # Copy-on-write: mutate a fresh doc so a failed durable
            # write leaves the cached doc untouched (see _write).
            debits = {k: dict(v) for k, v in state["debits"].items()}
            debits[str(request_id)] = {
                "epsilon": float(epsilon), "delta": float(delta),
                "state": "reserved"}
            self._write(tenant, dict(state, debits=debits))
            obs.inc("serve.budget_reserves")
            return BudgetLease(tenant=str(tenant),
                               request_id=str(request_id),
                               epsilon=float(epsilon),
                               delta=float(delta))

    def _transition(self, tenant: str, request_id: str,
                    new_state: str) -> None:
        with self._tenant_lock(tenant):
            state = self._load(tenant)
            if state is None:
                raise UnknownTenant(f"tenant '{tenant}' has no ledger "
                                    f"under {self.directory}")
            debit = state["debits"].get(str(request_id))
            if debit is None:
                raise LedgerError(
                    f"tenant '{tenant}' has no debit for request "
                    f"'{request_id}'")
            if debit["state"] == new_state:
                return  # idempotent replay
            if debit["state"] != "reserved":
                raise LedgerError(
                    f"debit '{request_id}' is {debit['state']}, cannot "
                    f"move to {new_state} (only a reserve can)")
            # Copy-on-write: mutate a fresh doc so a failed durable
            # write leaves the cached doc untouched (see _write).
            debits = {k: dict(v) for k, v in state["debits"].items()}
            debits[str(request_id)]["state"] = new_state
            self._write(tenant, dict(state, debits=debits))

    def commit(self, tenant: str, request_id: str) -> None:
        """Mark a reserve final — the request's DP output was released."""
        self._transition(tenant, request_id, "committed")
        from pipelinedp_tpu_torch import obs
        obs.inc("serve.budget_commits")

    def release(self, tenant: str, request_id: str) -> None:
        """Refund a reserve whose request failed CLEANLY before any DP
        output (or noise) existed. Never call this on a kill path —
        a request that may have drawn noise stays spent — nor for a
        lease ``reserve()`` handed back with ``replayed=True``: the
        pre-restart attempt may have drawn noise before dying."""
        self._transition(tenant, request_id, "released")
        from pipelinedp_tpu_torch import obs
        obs.inc("serve.budget_releases")
