"""The port's resident multi-tenant service (``pipelinedp_tpu_torch/serve``)
on the CPU.

Every case of ``tests/test_serve.py`` with a counterpart, on
``Service(device="cpu")``: the durable budget ledger, admission control
and its structured refusals, the warm registry, PARITY row 34 (the serve
path bit-identical to the direct ``DPEngine`` path), the concurrent
overdraw and the kill-and-restart replay, the books and the heartbeat,
tune requests and degraded mode. The ``noserve`` lint becomes an ``ast``
scan of the port. The cross-package cases run the same tenants, requests
and seeds through the JAX package's ``serve.Service`` and the port's and
hold the released values, kept sets, ledger ``remaining``, books
entries, audit records and ``serve.*`` counters to each other.
"""

import ast
import json
import os
import threading

import numpy as np
import pytest

import pipelinedp_tpu_torch as pdp
from pipelinedp_tpu_torch import obs, serve
from pipelinedp_tpu_torch.backends import TorchBackend
from pipelinedp_tpu_torch.obs import monitor as obs_monitor
from pipelinedp_tpu_torch.resilience import faults
from pipelinedp_tpu_torch.resilience.clock import FakeClock
from pipelinedp_tpu_torch.serve.budget_ledger import (DuplicateRequest,
                                                      Overdraw,
                                                      TenantBudgetLedger,
                                                      TenantMismatch)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "pipelinedp_tpu_torch")
BIG_EPS = 1e6


def Service(*args, **kwargs):
    """``serve.Service`` on the CPU (its default device is the card)."""
    kwargs.setdefault("device", "cpu")
    return serve.Service(*args, **kwargs)


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    """Fresh obs state, isolated ledger dir, heartbeat off — and a
    zero-orphan-thread assertion over EVERY test in this file (the
    ingest-executor drain discipline, applied to pdp-serve-*)."""
    monkeypatch.setenv("PIPELINEDP_TPU_LEDGER_DIR",
                       str(tmp_path / "obs_ledger"))
    monkeypatch.delenv(obs_monitor.ENV_VAR, raising=False)
    obs.reset()
    yield
    obs_monitor.stop()
    obs.reset()
    orphans = [t.name for t in threading.enumerate()
               if t.name.startswith("pdp-serve") and t.is_alive()]
    assert not orphans, f"orphan serve threads: {orphans}"


def make_ds(seed=0, n=6_000, users=1_500, parts=10):
    rng = np.random.default_rng(seed)
    return pdp.ArrayDataset(privacy_ids=rng.integers(0, users, n),
                            partition_keys=rng.integers(0, parts, n),
                            values=rng.uniform(0.0, 10.0, n))


def count_params(parts=10):
    return pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM],
        max_partitions_contributed=parts,
        max_contributions_per_partition=20,
        min_value=0.0, max_value=10.0)


def request(tenant, ds, eps=1.0, delta=1e-8, seed=7, rid=None,
            params=None):
    return serve.ServeRequest(tenant=tenant,
                              params=params or count_params(),
                              dataset=ds, epsilon=eps, delta=delta,
                              rng_seed=seed, request_id=rid)


# ---------------------------------------------------------------------
# durable budget ledger
# ---------------------------------------------------------------------


class TestBudgetLedger:

    def test_reserve_commit_remaining_and_restart_replay(self, tmp_path):
        led = TenantBudgetLedger(str(tmp_path))
        rem = led.open_tenant("acme", 4.0, 1e-6)
        assert rem.epsilon == 4.0 and rem.delta == 1e-6
        lease = led.reserve("acme", "r1", 1.5, 2e-7)
        assert lease.state == "reserved"
        led.commit("acme", "r1")
        rem = led.remaining("acme")
        assert rem.epsilon == pytest.approx(2.5)
        assert rem.delta == pytest.approx(8e-7)
        # Kill-and-restart: a fresh instance over the same directory
        # replays to the same remaining (eps, delta).
        led2 = TenantBudgetLedger(str(tmp_path))
        rem2 = led2.remaining("acme")
        assert rem2.epsilon == pytest.approx(rem.epsilon)
        assert rem2.delta == pytest.approx(rem.delta)
        assert led2.debits("acme")["r1"]["state"] == "committed"

    def test_reserve_is_exactly_once_per_request_id(self, tmp_path):
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 2.0, 0.0)
        led.reserve("t", "r1", 1.5, 0.0)
        # Same id again: the SAME lease comes back, no second debit —
        # even though a fresh 1.5 would overdraw the remaining 0.5.
        again = led.reserve("t", "r1", 1.5, 0.0)
        assert again.epsilon == 1.5 and again.state == "reserved"
        assert led.remaining("t").epsilon == pytest.approx(0.5)

    def test_replay_retry_must_match_reserved_amounts(self, tmp_path):
        """The restart-replay dedup hands back the original lease ONLY
        to a retry carrying the original (eps, delta) — a different
        demand under the same id must not silently run at amounts the
        caller never asked for."""
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 2.0, 0.0)
        led.reserve("t", "r1", 1.5, 0.0)
        with pytest.raises(serve.LedgerError, match="must carry"):
            led.reserve("t", "r1", 0.5, 0.0)
        # The refused mismatch touched nothing.
        assert led.debits("t")["r1"]["epsilon"] == 1.5
        assert led.remaining("t").epsilon == pytest.approx(0.5)

    def test_committed_id_refuses_re_reserve(self, tmp_path):
        """A committed debit's output was RELEASED: re-running the id
        would publish a second noisy view on one charge — refused."""
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 5.0, 0.0)
        led.reserve("t", "r1", 1.0, 0.0)
        led.commit("t", "r1")
        with pytest.raises(DuplicateRequest):
            led.reserve("t", "r1", 1.0, 0.0)
        assert led.remaining("t").epsilon == pytest.approx(4.0)

    def test_released_id_may_retry_as_fresh_debit(self, tmp_path):
        """A released debit was refunded (clean pre-release failure):
        the retry is a fresh debit at the NEW amounts, overdraw-checked
        like any other."""
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 2.0, 0.0)
        led.reserve("t", "r1", 1.5, 0.0)
        led.release("t", "r1")
        lease = led.reserve("t", "r1", 1.0, 0.0)
        assert lease.epsilon == 1.0 and lease.state == "reserved"
        assert led.remaining("t").epsilon == pytest.approx(1.0)
        assert len(led.debits("t")) == 1

    def test_overdraw_refused_without_writing(self, tmp_path):
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 1.0, 1e-8)
        before = open(led.path_for("t"), "rb").read()
        with pytest.raises(Overdraw) as ei:
            led.reserve("t", "r1", 3.0, 0.0)
        assert ei.value.shortfall.epsilon == pytest.approx(2.0)
        assert "shortfall" in str(ei.value)
        assert open(led.path_for("t"), "rb").read() == before
        assert led.remaining("t").epsilon == pytest.approx(1.0)

    def test_reserved_but_uncommitted_stays_spent_on_replay(
            self, tmp_path):
        """The kill-mid-request window: a reserve with no commit and
        no release must count as SPENT after restart (noise may have
        been drawn) — the DP-conservative direction."""
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 2.0, 0.0)
        led.reserve("t", "dead", 1.5, 0.0)
        led2 = TenantBudgetLedger(str(tmp_path))
        assert led2.remaining("t").epsilon == pytest.approx(0.5)
        assert led2.debits("t")["dead"]["state"] == "reserved"

    def test_release_refunds_clean_failures(self, tmp_path):
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 2.0, 0.0)
        led.reserve("t", "r1", 1.5, 0.0)
        led.release("t", "r1")
        assert led.remaining("t").epsilon == pytest.approx(2.0)
        # A committed debit can never be released back.
        led.reserve("t", "r2", 1.0, 0.0)
        led.commit("t", "r2")
        with pytest.raises(serve.LedgerError):
            led.release("t", "r2")

    def test_totals_mismatch_refused(self, tmp_path):
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 2.0, 0.0)
        led.open_tenant("t", 2.0, 0.0)  # idempotent re-open
        with pytest.raises(TenantMismatch):
            TenantBudgetLedger(str(tmp_path)).open_tenant("t", 3.0, 0.0)

    def test_failed_durable_write_leaves_cache_on_disk_state(
            self, tmp_path, monkeypatch):
        """A durable-write failure (disk full, I/O error) must not
        leave the in-memory cache ahead of disk: the exception
        propagates AND the cached doc stays on the last durable state,
        so memory and disk never diverge for the rest of the process."""
        from pipelinedp_tpu_torch.serve import budget_ledger as bl
        led = TenantBudgetLedger(str(tmp_path))
        led.open_tenant("t", 2.0, 0.0)
        led.reserve("t", "r1", 0.5, 0.0)
        real_write = bl.atomic_write_json

        def full_disk(path, doc):
            raise OSError("disk full")

        monkeypatch.setattr(bl, "atomic_write_json", full_disk)
        with pytest.raises(OSError):
            led.reserve("t", "r2", 0.5, 0.0)
        with pytest.raises(OSError):
            led.commit("t", "r1")
        # In-memory state is exactly the last durable state...
        assert led.remaining("t").epsilon == pytest.approx(1.5)
        assert "r2" not in led.debits("t")
        assert led.debits("t")["r1"]["state"] == "reserved"
        # ...and a disk replay agrees with it to the byte.
        monkeypatch.setattr(bl, "atomic_write_json", real_write)
        assert TenantBudgetLedger(str(tmp_path)).debits(
            "t") == led.debits("t")
        # The healed ledger proceeds normally.
        led.commit("t", "r1")
        assert led.remaining("t").epsilon == pytest.approx(1.5)


# ---------------------------------------------------------------------
# the resident service
# ---------------------------------------------------------------------


class TestServiceAcceptance:

    def test_three_tenants_interleaved_warm_no_new_compiles(
            self, tmp_path, monkeypatch):
        """>= 3 tenants' requests interleave through one resident
        service; each tenant's SECOND same-signature request is a warm
        registry hit and — with the cost table watching every
        instrumented phase and kernel — records no new program: the
        same shapes reuse every entry."""
        monkeypatch.setenv("PIPELINEDP_TPU_COSTS", "1")
        tenants = {f"t{i}": (10.0, 1e-6) for i in range(3)}
        ds = make_ds()
        with Service(str(tmp_path / "svc"),
                     tenants=tenants) as svc:
            first = {}
            for tenant in tenants:  # round 1: cold registry builds
                ds.invalidate_cache()
                out = svc.submit(request(tenant, ds, eps=1.0))
                assert out.ok, out
                assert out.warm is False
                first[tenant] = dict(out.results)
            captured = obs.ledger().snapshot()["counters"].get(
                "cost.programs_captured", 0)
            for tenant in tenants:  # round 2: warm, zero new programs
                ds.invalidate_cache()
                out = svc.submit(request(tenant, ds, eps=1.0))
                assert out.ok, out
                assert out.warm is True
                # Same seed + same data -> the warm program replays
                # the identical release.
                assert dict(out.results) == first[tenant]
                assert out.remaining.epsilon == pytest.approx(8.0)
            after = obs.ledger().snapshot()["counters"].get(
                "cost.programs_captured", 0)
            assert after == captured, (
                "second same-signature requests recorded new cost-table "
                "programs")

    def test_overdraw_refused_before_any_compute(self, tmp_path):
        ds = make_ds()
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (1.0, 1e-8)}) as svc:
            out = svc.submit(request("t", ds, eps=5.0))
            assert not out.ok
            assert out.reason == "overdraw"
            assert "shortfall" in out.detail
            assert out.remaining.epsilon == pytest.approx(1.0)
            counters = obs.ledger().snapshot()["counters"]
            # Nothing ran: no engine was ever built for the request.
            assert counters.get("serve.cold_builds", 0) == 0
            assert counters.get("serve.requests_admitted", 0) == 0
            # And the durable ledger still holds the full budget.
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                1.0)

    def test_serve_path_bit_identical_to_direct_engine(self, tmp_path):
        """PARITY row 34: same params, data and seed through the
        resident service and through a hand-built DPEngine release
        bit-identical outputs — twice, so the WARM program is also in
        scope."""
        ds = make_ds(seed=3)
        params = count_params()
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (10.0, 1e-6)}) as svc:
            served = []
            for _ in range(2):
                ds.invalidate_cache()
                out = svc.submit(request("t", ds, eps=0.8, delta=1e-8,
                                         seed=11, params=params))
                assert out.ok, out
                served.append(dict(out.results))
        acc = pdp.NaiveBudgetAccountant(total_epsilon=0.8,
                                        total_delta=1e-8)
        engine = pdp.DPEngine(acc, TorchBackend("cpu", rng_seed=11))
        ds.invalidate_cache()
        res = engine.aggregate(ds, params, pdp.DataExtractors())
        acc.compute_budgets()
        direct = dict(res)
        assert served[0] == direct
        assert served[1] == direct

    def test_malformed_refusals(self, tmp_path):
        ds = make_ds()
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            not_a_request = svc.submit({"tenant": "t"})
            assert not not_a_request.ok
            assert not_a_request.reason == "malformed"
            assert "ServeRequest" in not_a_request.detail
            bad_params = svc.submit(serve.ServeRequest(
                tenant="t", params="not-params", dataset=ds,
                epsilon=1.0))
            assert bad_params.reason == "malformed"
            empty = svc.submit(request("t", pdp.ArrayDataset(
                privacy_ids=np.array([], dtype=np.int64),
                partition_keys=np.array([], dtype=np.int64),
                values=np.array([]))))
            assert empty.reason == "malformed"
            unknown = svc.submit(request("ghost", ds))
            assert unknown.reason == "malformed"
            # Refusals naming unknown tenants never grow per-tenant
            # state in a resident process: no books dir, no in-flight
            # slot, no ledger lock entry.
            assert not os.path.exists(svc.books_dir("ghost"))
            assert "ghost" not in svc._inflight
            assert "ghost" not in svc.budgets._tenant_locks
            nonpos = svc.submit(request("t", ds, eps=0.0))
            assert nonpos.reason == "malformed"
            # None of it burned budget.
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                5.0)

    def test_duplicate_request_id_refused_after_success(self, tmp_path):
        """Resubmitting a SERVED request id is a structured
        'duplicate' refusal — never a silent second release."""
        ds = make_ds(n=800, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            first = svc.submit(request("t", ds, eps=1.0, rid="dup"))
            assert first.ok
            again = svc.submit(request("t", ds, eps=1.0, rid="dup"))
            assert not again.ok and again.reason == "duplicate"
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                4.0)

    def test_duplicate_request_id_refused_while_in_flight(
            self, tmp_path, monkeypatch):
        """A retry of an id whose ORIGINAL IS STILL RUNNING (a client
        re-sending a slow request) is refused at admission — without
        this, both copies would execute against the ledger's one
        reserved debit and release two noisy views on one charge. The
        ledger's reserved-dedup lease is for restart replay only."""
        gate = threading.Event()
        started = threading.Event()
        real_execute = serve.Service._execute

        def gated_execute(self, pending):
            started.set()
            gate.wait(timeout=30)
            real_execute(self, pending)

        monkeypatch.setattr(serve.Service, "_execute", gated_execute)
        ds = make_ds(n=800, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)},
                     workers=1) as svc:
            outs = {}

            def bg():
                outs["first"] = svc.submit(
                    request("t", ds, eps=1.0, rid="dup"))

            t1 = threading.Thread(target=bg)
            t1.start()
            assert started.wait(timeout=30)
            retry = svc.submit(request("t", ds, eps=1.0, rid="dup"))
            assert not retry.ok and retry.reason == "duplicate"
            assert "in flight" in retry.detail
            gate.set()
            t1.join(timeout=120)
            assert outs["first"].ok
            # Exactly one debit, one charge, one released output.
            debits = svc.budgets.debits("t")
            assert list(debits) == ["dup"]
            assert debits["dup"]["state"] == "committed"
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                4.0)

    def test_same_request_id_across_tenants_never_collides(
            self, tmp_path, monkeypatch):
        """The in-flight guard is scoped per tenant, like the ledger's
        debits: tenant b reusing tenant a's request id (both clients
        numbering their own requests) must be admitted, not refused as
        a duplicate of a's still-running request."""
        gate = threading.Event()
        started = threading.Event()
        real_execute = serve.Service._execute

        def gated_execute(self, pending):
            if pending.request.tenant == "a":
                started.set()
                gate.wait(timeout=30)
            real_execute(self, pending)

        monkeypatch.setattr(serve.Service, "_execute", gated_execute)
        ds = make_ds(n=800, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"a": (5.0, 1e-6),
                              "b": (5.0, 1e-6)},
                     workers=2) as svc:
            outs = {}
            t1 = threading.Thread(
                target=lambda: outs.setdefault("a", svc.submit(
                    request("a", ds, eps=1.0, rid="same"))))
            t1.start()
            assert started.wait(timeout=30)
            got_b = svc.submit(request("b", ds, eps=1.0, rid="same"))
            assert got_b.ok, got_b
            gate.set()
            t1.join(timeout=120)
            assert outs["a"].ok
            assert svc.budgets.debits("a")["same"]["state"] == "committed"
            assert svc.budgets.debits("b")["same"]["state"] == "committed"

    def test_replayed_lease_never_refunded_on_clean_failure(
            self, tmp_path):
        """A restart replay whose retry fails CLEANLY must leave the
        debit SPENT: the pre-restart attempt may have drawn noise
        before dying, so refunding would be the unsafe direction —
        unlike a fresh reserve, which a clean failure refunds."""
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            # The restart-replay state: a reserved debit with no live
            # request, then a retry whose rows no extractor can pull
            # apart (fails inside the engine, before any DP output).
            svc.budgets.reserve("t", "replay", 1.0, 1e-8)
            out = svc.submit(request("t", [1, 2, 3], eps=1.0,
                                     rid="replay"))
            assert not out.ok and out.reason == "error"
            assert svc.budgets.debits("t")["replay"][
                "state"] == "reserved"
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                4.0)

    def test_clean_failure_heals_engine_for_stale_entry_holders(
            self, tmp_path, monkeypatch):
        """A failure AFTER the accountant registered mechanisms (but
        before finalize) must leave the warm engine rebindable before
        the entry lock releases: a same-signature waiter that fetched
        the entry before the failure dropped it from the registry is
        served on a fresh accountant, not refused over leftovers."""
        ds = make_ds(n=500, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            ok = svc.submit(request("t", ds, eps=1.0))
            assert ok.ok
            (entry,) = list(svc._registry.values())
            real = pdp.NaiveBudgetAccountant.compute_budgets

            def boom(self):
                raise RuntimeError("post-registration failure")

            monkeypatch.setattr(pdp.NaiveBudgetAccountant,
                                "compute_budgets", boom)
            ds.invalidate_cache()
            bad = svc.submit(request("t", ds, eps=1.0))
            assert not bad.ok and bad.reason == "error"
            monkeypatch.setattr(pdp.NaiveBudgetAccountant,
                                "compute_budgets", real)
            # The stale entry's engine rebinds cleanly — the failure
            # path cleared its half-run accountant under the lock.
            entry.engine.rebind_budget_accountant(
                pdp.NaiveBudgetAccountant(total_epsilon=1.0,
                                          total_delta=0.0))
            # And the failed FRESH reserve was refunded.
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                4.0)

    def test_replay_with_mismatched_amounts_refused(self, tmp_path):
        """A restart replay must carry the reserved debit's original
        (eps, delta): a different demand under the same id is refused
        as malformed instead of silently running at the old amounts;
        the matching retry dedupes onto the debit and serves."""
        ds = make_ds(n=800, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            # The restart-replay state: a reserved debit with no live
            # request (the previous process died mid-compute).
            svc.budgets.reserve("t", "replay", 1.0, 1e-9)
            bad = svc.submit(request("t", ds, eps=0.5, delta=1e-9,
                                     rid="replay"))
            assert not bad.ok and bad.reason == "malformed"
            assert "must carry" in bad.detail
            good = svc.submit(request("t", ds, eps=1.0, delta=1e-9,
                                      rid="replay"))
            assert good.ok
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                4.0)
            assert svc.budgets.debits("t")["replay"][
                "state"] == "committed"

    def test_non_string_request_id_never_ghosts_the_live_set(
            self, tmp_path):
        """A non-string request_id is normalized to str at admission,
        so the worker's teardown key matches and the id never sticks
        in the live set refusing later submits as phantom duplicates."""
        ds = make_ds(n=800, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            first = svc.submit(request("t", ds, eps=1.0, rid=7))
            assert first.ok and first.request_id == "7"
            assert not svc._live
            # The committed id refuses a re-run (ledger, not a ghost).
            again = svc.submit(request("t", ds, eps=1.0, rid=7))
            assert not again.ok and again.reason == "duplicate"
            assert "committed" in again.detail
            # A FALSY id like 0 is a real id, not "absent": its second
            # submit must hit the same exactly-once refusal, never a
            # fresh generated id (which would charge twice and release
            # two noisy views of one logical request).
            ds.invalidate_cache()
            zero = svc.submit(request("t", ds, eps=1.0, rid=0))
            assert zero.ok and zero.request_id == "0"
            zero_again = svc.submit(request("t", ds, eps=1.0, rid=0))
            assert not zero_again.ok and zero_again.reason == "duplicate"

    def test_slot_and_live_id_freed_before_submit_returns(
            self, tmp_path):
        """finish() runs the worker's teardown BEFORE unblocking the
        submitter: the moment submit() returns, an immediate same-id
        retry of a cleanly-failed (refunded) request is admitted, and
        the in-flight slot is free — no racing the worker's cleanup."""
        ds = make_ds(n=800, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)},
                     max_inflight_per_tenant=1) as svc:
            failed = svc.submit(request("t", [1, 2, 3], eps=1.0,
                                        rid="retry-me"))
            assert not failed.ok and failed.reason == "error"
            # Immediately: slot free, id free, fresh debit admitted.
            assert svc._inflight.get("t", 0) == 0
            assert not svc._live
            retried = svc.submit(request("t", ds, eps=1.0,
                                         rid="retry-me"))
            assert retried.ok, retried
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                4.0)

    def test_engine_error_releases_the_reserve(self, tmp_path):
        """A request that fails CLEANLY inside the engine (no DP
        output ever existed) refunds its reserve and comes back as a
        structured 'error' refusal."""
        # Rows that no extractor can pull apart: AggregateParams
        # validation passes at admission, but the engine's own checks
        # reject the request once the worker runs it.
        broken_rows = [1, 2, 3]
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            out = svc.submit(request("t", broken_rows, eps=1.0))
            assert not out.ok and out.reason == "error"
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                5.0)
            assert svc.budgets.debits("t")[out.request_id][
                "state"] == "released"

    def test_queue_full_and_tenant_busy_backpressure(self, tmp_path,
                                                     monkeypatch):
        """Admission control under load: a gated worker holds the one
        queue slot + the in-flight cap, and further submits come back
        as structured queue_full / tenant_busy refusals — budget
        untouched."""
        gate = threading.Event()
        started = threading.Event()
        real_execute = serve.Service._execute

        def gated_execute(self, pending):
            started.set()
            gate.wait(timeout=30)
            real_execute(self, pending)

        monkeypatch.setattr(serve.Service, "_execute", gated_execute)
        ds = make_ds(n=800, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"a": (50.0, 1e-5),
                              "b": (50.0, 1e-5),
                              "c": (50.0, 1e-5)},
                     max_queue=1, max_inflight_per_tenant=1,
                     workers=1) as svc:
            outs = {}

            def bg(name, req):
                outs[name] = svc.submit(req)

            t1 = threading.Thread(target=bg, args=(
                "first", request("a", ds, eps=1.0)))
            t1.start()
            assert started.wait(timeout=30)
            # Worker busy with tenant a; same tenant again -> the
            # per-tenant in-flight cap refuses first.
            busy = svc.submit(request("a", ds, eps=1.0))
            assert busy.reason == "tenant_busy"
            # Another tenant fills the one queue slot...
            t2 = threading.Thread(target=bg, args=(
                "second", request("b", ds, eps=1.0)))
            t2.start()
            deadline = [svc._q.full()]
            for _ in range(500):
                if deadline[-1]:
                    break
                threading.Event().wait(0.01)
                deadline.append(svc._q.full())
            assert deadline[-1], "queued request never landed"
            # ...so a THIRD tenant sees pure queue-full backpressure
            # (its own in-flight count is zero).
            full = svc.submit(request("c", ds, eps=1.0))
            assert full.reason == "queue_full"
            gate.set()
            t1.join(timeout=60)
            t2.join(timeout=60)
            assert outs["first"].ok and outs["second"].ok
            # Refused requests burned nothing; served ones debited.
            assert svc.budgets.remaining("a").epsilon == pytest.approx(
                49.0)
            assert svc.budgets.remaining("b").epsilon == pytest.approx(
                49.0)
            assert svc.budgets.remaining("c").epsilon == pytest.approx(
                50.0)

    def test_shutdown_refusal_after_close(self, tmp_path):
        svc = Service(str(tmp_path / "svc"),
                      tenants={"t": (5.0, 1e-6)})
        ds = make_ds(n=500, parts=4)
        first = svc.submit(request("t", ds, eps=1.0))
        assert first.ok
        svc.close()
        out = svc.submit(request("t", ds, eps=1.0))
        assert not out.ok and out.reason == "shutdown"
        svc.close()  # idempotent


# ---------------------------------------------------------------------
# concurrent overdraw + kill-and-restart (satellite 3)
# ---------------------------------------------------------------------


class TestConcurrentOverdraw:

    def test_racing_submits_exactly_one_debit_and_restart_replay(
            self, tmp_path):
        """Two threads race submit() against one tenant whose budget
        covers only ONE request: exactly one succeeds, the refusal
        names the shortfall, and after a kill-and-restart the durable
        ledger replays to exactly one debit."""
        ds = make_ds(n=1_000, parts=4)
        ledger_dir = str(tmp_path / "svc")
        with Service(ledger_dir,
                     tenants={"t": (1.0, 1e-7)},
                     workers=2) as svc:
            barrier = threading.Barrier(2)
            outs = [None, None]

            def racer(i):
                req = request("t", ds, eps=0.8, delta=1e-8,
                              rid=f"race-{i}")
                barrier.wait(timeout=30)
                outs[i] = svc.submit(req)

            threads = [threading.Thread(target=racer, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            oks = [o for o in outs if o.ok]
            refusals = [o for o in outs if not o.ok]
            assert len(oks) == 1 and len(refusals) == 1
            assert refusals[0].reason == "overdraw"
            assert "shortfall" in refusals[0].detail
            assert refusals[0].remaining.epsilon <= 0.2 + 1e-9
        # Kill-and-restart: the durable per-tenant ledger replays to
        # the SAME remaining (eps, delta), with exactly one debit.
        led = TenantBudgetLedger(os.path.join(ledger_dir, "budgets"))
        debits = led.debits("t")
        assert len(debits) == 1
        (debit,) = debits.values()
        assert debit["state"] == "committed"
        assert led.remaining("t").epsilon == pytest.approx(0.2)
        # And a restarted SERVICE over the same books agrees.
        with Service(ledger_dir,
                     tenants={"t": (1.0, 1e-7)}) as svc2:
            again = svc2.submit(request("t", ds, eps=0.8, delta=1e-8))
            assert not again.ok and again.reason == "overdraw"

    def test_kill_mid_request_leaves_reserve_spent(self, tmp_path):
        """The faults seam kills request 0 between reserve and commit
        (the process-death window): the caller sees the crash, the
        reserve is neither committed nor released, and a restarted
        service counts it as spent."""
        ds = make_ds(n=1_000, parts=4)
        ledger_dir = str(tmp_path / "svc")
        with faults.injected_faults(
                faults.FaultPlan(fail_serve_requests=(0,))):
            with Service(ledger_dir,
                         tenants={"t": (1.0, 0.0)}) as svc:
                with pytest.raises(faults.ServeKill):
                    svc.submit(request("t", ds, eps=0.8, delta=0.0,
                                       rid="killed"))
        led = TenantBudgetLedger(os.path.join(ledger_dir, "budgets"))
        assert led.debits("t")["killed"]["state"] == "reserved"
        assert led.remaining("t").epsilon == pytest.approx(0.2)
        # Restarted service: the dead request's budget stays spent, so
        # a same-size follow-up is refused...
        with Service(ledger_dir, tenants={"t": (1.0, 0.0)}) as s2:
            out = s2.submit(request("t", ds, eps=0.8, delta=0.0))
            assert not out.ok and out.reason == "overdraw"
            # ...and a RETRY of the killed id dedupes onto the
            # existing debit instead of double-spending.
            lease = s2.budgets.reserve("t", "killed", 0.8, 0.0)
            assert lease.epsilon == 0.8
            assert len(s2.budgets.debits("t")) == 1


# ---------------------------------------------------------------------
# per-tenant books + live-request heartbeat
# ---------------------------------------------------------------------


class TestBooksAndHeartbeat:

    def test_books_appended_under_each_tenant(self, tmp_path):
        ds = make_ds(n=1_000, parts=4)
        with Service(str(tmp_path / "svc"),
                     tenants={"a": (5.0, 1e-6),
                              "b": (5.0, 1e-6)}) as svc:
            ra = svc.submit(request("a", ds, eps=1.0))
            ds.invalidate_cache()
            rb = svc.submit(request("b", ds, eps=1.0))
            refused = svc.submit(request("a", ds, eps=99.0))
            assert ra.ok and rb.ok and refused.reason == "overdraw"
            for tenant, resp in (("a", ra), ("b", rb)):
                path = os.path.join(svc.books_dir(tenant),
                                    "run_ledger.jsonl")
                entries = [json.loads(line) for line in
                           open(path, encoding="utf-8")]
                served = [e for e in entries
                          if e["name"] == "serve.request"]
                assert len(served) == 1
                book = served[0]["payload"]["serve"]
                assert book["tenant"] == tenant
                assert book["request_id"] == resp.request_id
                assert book["audit"]["books"]["tenant"] == tenant
                assert book["remaining_epsilon"] == pytest.approx(4.0)
            refusals = [json.loads(line) for line in
                        open(os.path.join(svc.books_dir("a"),
                                          "run_ledger.jsonl"),
                             encoding="utf-8")
                        if json.loads(line)["name"] == "serve.refusal"]
            assert refusals and refusals[0]["payload"]["serve"][
                "reason"] == "overdraw"

    def test_books_store_built_once_per_tenant_under_concurrency(
            self, tmp_path, monkeypatch):
        """Concurrent appends for one tenant must share a single
        LedgerStore instance (the store's one-lock-per-file contract):
        a slowed constructor + a thread barrier would race the old
        unguarded creation into duplicate stores."""
        from pipelinedp_tpu_torch.obs import store as obs_store
        builds = []
        real_store = obs_store.LedgerStore

        class SlowStore(real_store):
            def __init__(self, *a, **k):
                builds.append(threading.current_thread().name)
                threading.Event().wait(0.05)
                super().__init__(*a, **k)

        monkeypatch.setattr(obs_store, "LedgerStore", SlowStore)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            n = 6
            barrier = threading.Barrier(n)

            def append(i):
                barrier.wait(timeout=30)
                svc._append_books("t", "serve.test", {"i": i})

            threads = [threading.Thread(target=append, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert len(builds) == 1, builds
            assert len(svc._books_stores) == 1
            path = os.path.join(svc.books_dir("t"), "run_ledger.jsonl")
            entries = [json.loads(line) for line in
                       open(path, encoding="utf-8")
                       if json.loads(line)["name"] == "serve.test"]
            assert len(entries) == n

    def test_heartbeat_snapshots_all_live_requests_one_document(
            self, tmp_path):
        """The monitor satellite: a resident process's heartbeat names
        EVERY live request (tenant + phase) in one document, at a
        run-namespaced path — no per-request clobbering."""
        clk = FakeClock()
        mon = obs_monitor.Monitor(
            clock=clk, interval_s=1.0, stall_s=60.0,
            heartbeat_path=str(tmp_path / "hb.json"),
            run_name="svc").start_inline()
        try:
            obs_monitor.register_request("r1", tenant="a",
                                         phase="queued")
            obs_monitor.register_request("r2", tenant="b",
                                         phase="running")
            obs_monitor.update_request("r1", phase="running")
            hb = mon.poll_once()
            reqs = {r["request_id"]: r for r in hb["requests"]}
            assert set(reqs) == {"r1", "r2"}
            assert reqs["r1"]["tenant"] == "a"
            assert reqs["r1"]["phase"] == "running"
            on_disk = json.load(open(mon.heartbeat_path,
                                     encoding="utf-8"))
            assert len(on_disk["requests"]) == 2
            obs_monitor.unregister_request("r1")
            obs_monitor.unregister_request("r2")
            hb = mon.poll_once()
            assert "requests" not in hb
        finally:
            obs_monitor.reset_requests()
            from pipelinedp_tpu_torch.obs.tracer import ACTIVITY
            ACTIVITY.reset(enabled=False)

    def test_heartbeat_path_namespaced_by_run(self, monkeypatch,
                                              tmp_path):
        monkeypatch.setenv("PIPELINEDP_TPU_LEDGER_DIR",
                           str(tmp_path / "led"))
        monkeypatch.delenv(obs_monitor.ENV_VAR, raising=False)
        dest = obs_monitor.heartbeat_destination(run="bench-7")
        assert dest.endswith(os.path.join("led",
                                          "heartbeat-bench-7.json"))
        # Unsafe characters in a run name never escape the directory.
        weird = obs_monitor.heartbeat_destination(run="a/../b c")
        assert os.path.dirname(weird) == str(tmp_path / "led")
        # Explicit env paths still win verbatim.
        monkeypatch.setenv(obs_monitor.ENV_VAR,
                           str(tmp_path / "x.json"))
        assert obs_monitor.heartbeat_destination(
            run="r") == str(tmp_path / "x.json")
        mon = obs_monitor.Monitor(clock=FakeClock(), run_name="r7")
        assert mon.heartbeat_path == str(tmp_path / "x.json")
        monkeypatch.delenv(obs_monitor.ENV_VAR)
        mon = obs_monitor.Monitor(clock=FakeClock(), run_name="r7")
        assert mon.heartbeat_path.endswith("heartbeat-r7.json")


# ---------------------------------------------------------------------
# tune requests: the utility-analysis megasweep behind the serve door
# ---------------------------------------------------------------------


def tune_request(tenant, ds, eps=1.0, delta=1e-8, rid=None, parts=6):
    params = pdp.AggregateParams(metrics=[pdp.Metrics.COUNT],
                                 max_partitions_contributed=parts,
                                 max_contributions_per_partition=4)
    return serve.ServeRequest(tenant=tenant, params=params, dataset=ds,
                              epsilon=eps, delta=delta, rng_seed=7,
                              request_id=rid, kind="tune")


class TestTuneRequests:
    """``kind="tune"`` serve requests: admitted through the same
    admission control as aggregates (quota'd, structurally refused,
    books-stamped) but debiting ZERO (ε, δ) — utility analysis releases
    error estimates of hypothetical mechanisms, never private data."""

    def test_tune_served_zero_budget_debited_books_stamped(
            self, tmp_path):
        ds = make_ds(n=2_000, parts=6)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            out = svc.submit(tune_request("t", ds, eps=1.0, rid="tu1"))
            assert out.ok, out
            assert out.audit["kind"] == "tune"
            assert out.audit["budget_debited"] is False
            assert out.audit["candidates"] > 1
            assert "max_partitions_contributed" in out.audit["best"]
            (label, tune_result), = out.results
            assert label == "tune"
            assert tune_result.index_best == out.audit["index_best"]
            # The balance is untouched — in the response AND on disk.
            assert out.remaining.epsilon == pytest.approx(5.0)
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                5.0)
            assert svc.budgets.remaining("t").delta == pytest.approx(
                1e-6)
            # Books: stamped like any request, with kind="tune" and
            # zero (eps, delta).
            path = os.path.join(svc.books_dir("t"), "run_ledger.jsonl")
            entries = [json.loads(line) for line in
                       open(path, encoding="utf-8")]
            served = [e for e in entries if e["name"] == "serve.request"]
            assert len(served) == 1
            book = served[0]["payload"]["serve"]
            assert book["kind"] == "tune"
            assert book["epsilon"] == 0.0 and book["delta"] == 0.0
            assert book["audit"]["budget_debited"] is False
            assert book["audit"]["simulated_epsilon"] == 1.0

    def test_tune_second_same_signature_warm_zero_new_compiles(
            self, tmp_path, monkeypatch):
        """The second same-signature tune is a warm registry hit and —
        with the cost table watching — records no new program (the
        warm backend's sweep reuses every entry)."""
        monkeypatch.setenv("PIPELINEDP_TPU_COSTS", "1")
        ds = make_ds(n=2_000, parts=6)
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            ds.invalidate_cache()
            first = svc.submit(tune_request("t", ds, rid="tu-a"))
            assert first.ok and first.warm is False
            captured = obs.ledger().snapshot()["counters"].get(
                "cost.programs_captured", 0)
            ds.invalidate_cache()
            second = svc.submit(tune_request("t", ds, rid="tu-b"))
            assert second.ok and second.warm is True
            assert second.audit["index_best"] == first.audit[
                "index_best"]
            after = obs.ledger().snapshot()["counters"].get(
                "cost.programs_captured", 0)
            assert after == captured, (
                "second same-signature tune recorded new cost-table "
                "programs")

    def test_tune_refusals_structural_and_free(self, tmp_path):
        ds = make_ds(n=2_000, parts=6)
        with Service(str(tmp_path / "svc")) as svc:
            svc.register_tenant("t", 5.0, 1e-6,
                                max_rows_per_request=100)
            # Unknown kinds are malformed before any compute.
            bogus = svc.submit(serve.ServeRequest(
                tenant="t", params=count_params(), dataset=ds,
                epsilon=1.0, kind="optimize"))
            assert not bogus.ok and bogus.reason == "malformed"
            assert "kind" in bogus.detail
            # Tune analyzes exactly one metric.
            multi = tune_request("t", ds)
            multi.params = count_params()  # COUNT + SUM
            multi.kind = "tune"
            out = svc.submit(multi)
            assert not out.ok and out.reason == "malformed"
            assert "one metric" in out.detail
            # Unknown tenants never grow state, tune or not.
            ghost = svc.submit(tune_request("ghost", ds))
            assert ghost.reason == "malformed"
            assert not os.path.exists(svc.books_dir("ghost"))
            # Tunes ride the same per-tenant row quota.
            quota = svc.submit(tune_request("t", ds))
            assert not quota.ok and quota.reason == "quota"
            assert "row quota" in quota.detail
            # None of it burned budget.
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                5.0)


# ---------------------------------------------------------------------
# the noserve lint, as an ast scan of the port
# ---------------------------------------------------------------------


def _port_trees():
    for root, _, names in os.walk(PORT_DIR):
        for name in sorted(names):
            if name.endswith(".py"):
                path = os.path.join(root, name)
                with open(path) as f:
                    yield (os.path.relpath(path, PORT_DIR),
                           ast.parse(f.read(), filename=path))


def _imported_modules(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.module:
        return [node.module] + [f"{node.module}.{a.name}"
                                for a in node.names]
    return []


def _called_name(node):
    func = node.func
    return (func.attr if isinstance(func, ast.Attribute) else
            func.id if isinstance(func, ast.Name) else None)


class TestNoServeLint:
    """The JAX package's ``noserve`` rule and its ``fusion-masking``
    dispatch confinement, over the port's files (ROADMAP step 7b's lint
    module takes them over)."""

    @pytest.mark.parametrize("half", ["imports", "ledger", "dispatch"])
    def test_serve_confinement(self, half):
        """No serve import outside serve/ (the service depends on the
        engine, never the reverse); ``TenantBudgetLedger`` constructed
        only in serve/ and ``budget_accounting.py``; the batched device
        path dispatched only from ``serve/fusion.py`` (and defined in
        ``torch_engine.py``)."""
        bad = []
        for rel, tree in _port_trees():
            in_serve = rel.startswith("serve" + os.sep)
            for node in ast.walk(tree):
                if half == "imports" and not in_serve:
                    if any(m == "pipelinedp_tpu_torch.serve" or
                           m.startswith("pipelinedp_tpu_torch.serve.")
                           for m in _imported_modules(node)):
                        bad.append((rel, node.lineno))
                if not isinstance(node, ast.Call):
                    continue
                name = _called_name(node)
                if (half == "ledger" and name == "TenantBudgetLedger"
                        and not in_serve
                        and rel != "budget_accounting.py"):
                    bad.append((rel, node.lineno))
                if (half == "dispatch" and name == "fused_aggregate_batch"
                        and rel != os.path.join("serve", "fusion.py")):
                    bad.append((rel, node.lineno))
        assert bad == []


# ---------------------------------------------------------------------
# degraded mode: structured refusal before any reserve
# ---------------------------------------------------------------------


class TestDegradedMode:

    def test_degraded_refuses_before_reserve_and_clears(self, tmp_path):
        """A degraded service refuses EVERY submit with the structured
        "degraded" reason BEFORE any budget reserve — the ledger still
        holds the full budget afterwards — and clear_degraded()
        restores normal admission."""
        ds = make_ds()
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            svc.set_degraded("mesh lost its last participant")
            out = svc.submit(request("t", ds, eps=1.0))
            assert not out.ok
            assert out.reason == "degraded"
            assert "participant" in out.detail
            counters = obs.ledger().snapshot()["counters"]
            assert counters.get("serve.requests_admitted", 0) == 0
            assert counters.get("serve.refusals.degraded", 0) == 1
            # No reserve ever hit the durable ledger.
            assert svc.budgets.remaining("t").epsilon == pytest.approx(
                5.0)
            # The heartbeat says WHY traffic is bouncing.
            health = obs_monitor.serve_health_snapshot()
            assert health == {"state": "degraded",
                              "detail": "mesh lost its last participant"}
            mon = obs_monitor.Monitor(clock=FakeClock(), run_name="dg")
            hb = mon.poll_once()
            assert hb["serve"]["health"]["state"] == "degraded"
            svc.clear_degraded()
            assert obs_monitor.serve_health_snapshot() == {"state": "ok"}
            ok = svc.submit(request("t", ds, eps=1.0))
            assert ok.ok, ok
        events = [e["name"] for e in obs.ledger().snapshot()["events"]]
        assert "serve.degraded" in events
        assert "serve.degraded_cleared" in events

    def test_degraded_env_arms_at_construction(self, tmp_path,
                                               monkeypatch):
        """A process that came up degraded (resilience.health set
        PIPELINEDP_TPU_DEGRADED) starts its service refusing."""
        from pipelinedp_tpu_torch.resilience.health import DEGRADED_ENV
        monkeypatch.setenv(DEGRADED_ENV, "1")
        ds = make_ds()
        with Service(str(tmp_path / "svc"),
                     tenants={"t": (5.0, 1e-6)}) as svc:
            out = svc.submit(request("t", ds, eps=1.0))
            assert out.reason == "degraded"
            assert DEGRADED_ENV in out.detail


# ---------------------------------------------------------------------
# cross-package: the JAX package's Service and the port's
# ---------------------------------------------------------------------


def _books(svc, tenant):
    """The tenant's books entries, without the per-run wall time and
    trace id."""
    path = os.path.join(svc.books_dir(tenant), "run_ledger.jsonl")
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            entry = json.loads(line)
            payload = dict(entry["payload"]["serve"])
            payload.pop("wall_s", None)
            payload.pop("trace_id", None)
            out.append((entry["name"], payload))
    return out


def _serve_counters(ledger):
    return {k: v for k, v in ledger.snapshot()["counters"].items()
            if k.startswith("serve.")}


def _as_plain(results):
    """(key, {field: value}) pairs of a response's results: MetricsTuple
    classes differ between the packages, their fields and values must
    not."""
    return {k: {f: (np.asarray(getattr(v, f)).tolist()
                    if np.ndim(getattr(v, f)) else getattr(v, f))
                for f in v._fields} for k, v in results}


def cross_package_requests(mod, kind):
    """Three tenants' requests of one params kind, in a fixed order, one
    of them an overdraw; built from the module ``mod`` (either package)
    on the same seed-made data."""
    rng = np.random.default_rng(17)
    n = 3_000
    ds = mod.ArrayDataset(privacy_ids=rng.integers(0, 150, n),
                          partition_keys=rng.integers(0, 12, n),
                          values=rng.uniform(0.0, 10.0, n))
    common = dict(noise_kind=mod.NoiseKind.LAPLACE,
                  max_partitions_contributed=3,
                  max_contributions_per_partition=2)
    if kind == "count_sum":
        params = mod.AggregateParams(
            metrics=[mod.Metrics.COUNT, mod.Metrics.SUM],
            min_value=0.0, max_value=10.0, **common)
    elif kind == "mean_var_pid":
        params = mod.AggregateParams(
            metrics=[mod.Metrics.MEAN, mod.Metrics.VARIANCE,
                     mod.Metrics.PRIVACY_ID_COUNT],
            min_value=0.0, max_value=10.0, **common)
    else:
        params = mod.AggregateParams(
            metrics=[mod.Metrics.COUNT, mod.Metrics.PERCENTILE(50)],
            min_value=0.0, max_value=10.0, **common)
    reqs = []
    for i, tenant in enumerate(["a", "b", "c", "a", "b"]):
        reqs.append(mod.serve.ServeRequest(
            tenant=tenant, params=params, dataset=ds,
            epsilon=500.0 if i == 3 else 20.0, delta=1e-6,
            rng_seed=100 + i, request_id=f"x{i}"))
    return reqs


def run_both_services(tmp_path, kind, **service_kwargs):
    """The same tenants and requests through both packages' services,
    submitted in order; returns {package: (outs, remaining, books,
    counters)}."""
    import pipelinedp_tpu as jpdp
    from pipelinedp_tpu import obs as jobs
    from pipelinedp_tpu import serve as jserve
    tenants = {"a": (100.0, 1e-4), "b": (100.0, 1e-4),
               "c": (100.0, 1e-4)}
    got = {}
    for name, mod, o, make in (
            ("jax", jpdp, jobs, jserve.Service),
            ("port", pdp, obs, Service)):
        o.reset()
        reqs = cross_package_requests(mod, kind)
        with make(str(tmp_path / name), tenants=tenants,
                  **service_kwargs) as svc:
            outs = [svc.submit(r) for r in reqs]
            remaining = {t: svc.budgets.remaining(t) for t in tenants}
            books = {t: _books(svc, t) for t in tenants}
        got[name] = (outs, remaining, books, _serve_counters(o.ledger()))
    return got


class TestCrossPackageService:
    """The JAX package's ``serve.Service`` and the port's, fusion off."""

    @pytest.mark.parametrize("kind", ["count_sum", "mean_var_pid",
                                      "percentile"])
    def test_same_releases_ledger_books_and_counters(self, tmp_path,
                                                     kind):
        got = run_both_services(tmp_path, kind)
        (j_outs, j_rem, j_books, j_ctr) = got["jax"]
        (p_outs, p_rem, p_books, p_ctr) = got["port"]
        for i, (j, p) in enumerate(zip(j_outs, p_outs)):
            assert j.ok == p.ok, i
            if not j.ok:
                assert (j.reason, j.detail) == (p.reason, p.detail)
                continue
            assert len(j.results) > 0
            assert _as_plain(j.results) == _as_plain(p.results), i
            assert j.audit == p.audit, i
            assert (j.remaining.epsilon, j.remaining.delta) == (
                p.remaining.epsilon, p.remaining.delta)
            assert j.signature == p.signature
        assert {t: (r.epsilon, r.delta) for t, r in j_rem.items()} == {
            t: (r.epsilon, r.delta) for t, r in p_rem.items()}
        assert j_books == p_books
        assert j_ctr == p_ctr
