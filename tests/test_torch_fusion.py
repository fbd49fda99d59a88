"""Shape-bucketed request fusion in the port (``pipelinedp_tpu_torch/serve/
fusion.py``) on the CPU.

The cases of ``tests/test_fusion.py`` with a counterpart, on
``Service(device="cpu")``: fused against solo bit for bit — released
values AND kept sets — across a bucket boundary, with the same budget
debits, audit records and books; the bucket key's vector fields;
kill-mid-batch; warm buckets; quotas; the heartbeat's bucket occupancy.
The port pads no rows, so the JAX package's padding-invariance cases
become cross-package ones: its kernel at every bucket edge against the
port's unpadded device path. Added here: the JAX package's fusing
``Service`` against the port's, field for field; fused against solo for a
VECTOR_SUM (``fx``) bucket and a per-partition-SUM bucket; and one K1
call per fused batch of scalar requests.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

import pipelinedp_tpu_torch as pdp
from pipelinedp_tpu_torch import obs, serve
from pipelinedp_tpu_torch import torch_engine as te
from pipelinedp_tpu_torch.dp_engine import DataExtractors
from pipelinedp_tpu_torch.obs import monitor as obs_monitor
from pipelinedp_tpu_torch.ops.kernels import segsum
from pipelinedp_tpu_torch.resilience import faults
from pipelinedp_tpu_torch.resilience.clock import FakeClock
from pipelinedp_tpu_torch.serve import fusion
from pipelinedp_tpu_torch.serve.budget_ledger import TenantBudgetLedger

BIG_EPS = 1e6


def Service(*args, **kwargs):
    """``serve.Service`` on the CPU (its default device is the card)."""
    kwargs.setdefault("device", "cpu")
    return serve.Service(*args, **kwargs)


@pytest.fixture(autouse=True)
def fresh_state(monkeypatch, tmp_path):
    monkeypatch.setenv("PIPELINEDP_TPU_LEDGER_DIR",
                       str(tmp_path / "obs_ledger"))
    monkeypatch.delenv(obs_monitor.ENV_VAR, raising=False)
    monkeypatch.delenv("PIPELINEDP_TPU_SERVE_FUSION", raising=False)
    obs.reset()
    yield
    obs_monitor.stop()
    obs.reset()
    orphans = [t.name for t in threading.enumerate()
               if (t.name.startswith("pdp-serve")
                   and t.is_alive())]
    assert not orphans, f"orphan serve threads: {orphans}"


def make_ds(seed, n, users=None, parts=30):
    """Data that EXERCISES contribution bounding: ~20 rows per user
    against (l0=3, linf=2) caps, so the bounding subsamples truncate
    hard (the regime where the padding-invariant tie-breaks are
    load-bearing, not vacuously equal) while partitions still carry
    enough users that private selection KEEPS a real subset — the
    parity assertions below must compare non-empty kept sets."""
    rng = np.random.default_rng(seed)
    users = users or max(n // 20, 10)
    return pdp.ArrayDataset(
        privacy_ids=rng.integers(0, users, n),
        partition_keys=rng.integers(0, parts, n),
        values=rng.uniform(0.0, 10.0, n))


def fusable_params():
    return pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM, pdp.Metrics.MEAN,
                 pdp.Metrics.VARIANCE, pdp.Metrics.PERCENTILE(50)],
        noise_kind=pdp.NoiseKind.LAPLACE,
        max_partitions_contributed=3,
        max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0)


def req(tenant, ds, seed, rid, params=None, eps=4.0):
    return serve.ServeRequest(tenant=tenant,
                              params=params or fusable_params(),
                              dataset=ds, epsilon=eps, delta=1e-8,
                              rng_seed=seed, request_id=rid)


def submit_concurrently(svc, requests):
    """Submit all requests from parallel threads (the concurrent-
    tenant model); returns outcomes in request order — a response,
    a refusal, or the raised exception."""
    outs = [None] * len(requests)

    def one(i):
        try:
            outs[i] = svc.submit(requests[i])
        except BaseException as e:  # noqa: BLE001 — surfaced to the test
            outs[i] = e

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(requests))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return outs


def assert_results_bit_identical(a, b, ctx=""):
    ka, kb = dict(a), dict(b)
    assert set(ka) == set(kb), f"{ctx}: kept sets differ"
    for k in ka:
        assert ka[k]._fields == kb[k]._fields, (ctx, k)
        for f in ka[k]._fields:
            va, vb = getattr(ka[k], f), getattr(kb[k], f)
            assert va == vb, (f"{ctx}: partition {k} metric {f}: "
                              f"{va!r} != {vb!r}")


# ---------------------------------------------------------------------
# PARITY row 35: fused vs solo, across a bucket boundary
# ---------------------------------------------------------------------


class TestFusedSoloParity:

    # 7000 and 8000 rows both bucket at the 8192 pow2 edge (two
    # different pad masks inside ONE batched program); 9000 rows
    # crosses the boundary into the 16384 bucket.
    SIZES = (7_000, 8_000, 9_000)

    def _run(self, state_dir, fusion_on):
        tenants = {f"t{i}": (BIG_EPS, 1e-3) for i in range(3)}
        datasets = [make_ds(40 + i, n) for i, n in enumerate(self.SIZES)]
        requests = [req(f"t{i}", datasets[i], seed=70 + i, rid=f"r{i}")
                    for i in range(3)]
        with Service(str(state_dir), tenants=tenants, workers=2,
                     fusion=fusion_on, fuse_window_ms=250,
                     fuse_max_batch=2) as svc:
            outs = submit_concurrently(svc, requests)
            debits = {t: svc.budgets.debits(t) for t in tenants}
        return outs, debits

    def test_fused_vs_solo_bit_identical_across_bucket_boundary(
            self, tmp_path):
        solo, solo_debits = self._run(tmp_path / "solo", False)
        obs.reset()
        fused, fused_debits = self._run(tmp_path / "fused", True)
        counters = obs.ledger().snapshot()["counters"]
        # The two same-bucket requests really fused; the third crossed
        # the boundary and ran alone.
        assert counters.get("serve.fusion_offered") == 3
        assert counters.get("serve.fused_batches") == 1
        assert counters.get("serve.fused_requests") == 2
        for i in range(3):
            assert solo[i].ok, solo[i]
            assert fused[i].ok, fused[i]
            # The comparison must not be vacuous: selection kept a
            # real, PARTIAL subset (empty kept sets would "agree"
            # about nothing; a full keep would never witness a
            # selection divergence).
            n_kept = len(dict(solo[i].results))
            assert 0 < n_kept < 30, (i, n_kept)
            # Released values AND kept sets, bit for bit.
            assert_results_bit_identical(solo[i].results,
                                         fused[i].results,
                                         ctx=f"request {i}")
            # Audit records unchanged in count and content.
            assert solo[i].audit == fused[i].audit, i
            assert solo[i].remaining == fused[i].remaining, i
        # Budget debits unchanged in count and content.
        for t in solo_debits:
            strip = lambda d: {k: (v["epsilon"], v["delta"], v["state"])
                               for k, v in d.items()}
            assert strip(solo_debits[t]) == strip(fused_debits[t]), t

    def test_books_audit_records_match_solo(self, tmp_path):
        """The per-tenant books carry one serve.request entry per
        request in BOTH modes, with identical embedded audit records
        (the fused entry is additionally stamped fused: true)."""
        import json
        import os

        from pipelinedp_tpu_torch.serve.budget_ledger import tenant_slug

        def books_entries(state_dir, tenant):
            path = os.path.join(str(state_dir), "books",
                                tenant_slug(tenant),
                                "run_ledger.jsonl")
            out = []
            with open(path, encoding="utf-8") as fh:
                for line in fh:
                    entry = json.loads(line)
                    if entry.get("name") == "serve.request":
                        out.append(entry["payload"]["serve"])
            return out

        self._run(tmp_path / "solo", False)
        self._run(tmp_path / "fused", True)
        for i in range(2):  # the two requests that fused
            solo_b = books_entries(tmp_path / "solo", f"t{i}")
            fused_b = books_entries(tmp_path / "fused", f"t{i}")
            assert len(solo_b) == len(fused_b) == 1
            assert solo_b[0]["audit"] == fused_b[0]["audit"]
            assert fused_b[0].get("fused") is True
            assert "fused" not in solo_b[0]


# ---------------------------------------------------------------------
# padding invariance: the JAX package's buckets against the unpadded port
# ---------------------------------------------------------------------


def _jax_kernel_at(encoded_j, config_j, rows_pad, P_pad, keep_table, thr,
                   s_scale, min_count, scales, seed, fx_bits):
    """The JAX package's solo kernel on one request padded to
    ``rows_pad`` rows (its bucket edge), as host arrays."""
    import jax
    import jax.numpy as jnp
    from pipelinedp_tpu import jax_engine as je
    from pipelinedp_tpu.serve import fusion as jfusion
    pid, pk, values, valid = jfusion.pad_request_to_bucket(
        encoded_j, rows_pad, config_j.needs_values)
    keep, raw = je.fused_aggregate_kernel(
        config_j, P_pad, jnp.asarray(pid), jnp.asarray(pk),
        jnp.asarray(values), jnp.asarray(valid), jnp.asarray(scales),
        jnp.asarray(keep_table), jnp.float32(thr), jnp.float32(s_scale),
        jnp.float32(min_count), jnp.float32(1.0),
        jax.random.PRNGKey(seed), fx_bits=fx_bits)
    return np.asarray(keep), {k: np.asarray(v) for k, v in raw.items()}


def _jax_params(p):
    """The JAX package's ``AggregateParams`` with the field values of the
    port's ``p`` (``convert.params_from_reference`` the other way)."""
    import dataclasses

    from pipelinedp_tpu import aggregate_params as jap
    enums = {"noise_kind": jap.NoiseKind, "vector_norm_kind": jap.NormKind,
             "partition_selection_strategy":
             jap.PartitionSelectionStrategy}
    kwargs = {}
    for f in dataclasses.fields(jap.AggregateParams):
        if not hasattr(p, f.name):
            continue
        v = getattr(p, f.name)
        if f.name in enums and v is not None:
            v = enums[f.name][v.name]
        elif f.name == "metrics":
            v = [jap.Metric(m.name, m.parameter) for m in v]
        kwargs[f.name] = v
    return jap.AggregateParams(**kwargs)


def _port_body(encoded, config, P_pad, keep_table, thr, s_scale, min_count,
               scales, seed, fx_bits):
    from pipelinedp_tpu_torch.ops import prng
    pid, pk, values = te.put_on_device(encoded, torch.device("cpu"),
                                       with_values=config.needs_values)
    keep, raw = te._fused_body(config, P_pad, pid, pk, values, scales,
                               keep_table, thr, s_scale, min_count, 1.0,
                               prng.PRNGKey(seed), fx_bits)
    return keep.numpy(), {k: v.numpy() for k, v in raw.items()}


def _assert_same_arrays(want, got, ctx):
    np.testing.assert_array_equal(want[0], got[0], err_msg=ctx)
    assert set(want[1]) == set(got[1]), ctx
    for k in want[1]:
        w, g = np.asarray(want[1][k]), np.asarray(got[1][k])
        assert w.dtype == g.dtype, (ctx, k)
        np.testing.assert_array_equal(
            w.view(np.int32) if w.dtype == np.float32 else w,
            g.view(np.int32) if g.dtype == np.float32 else g,
            err_msg=f"{ctx}:{k}")


class TestPaddingInvariance:

    def test_solo_kernel_bit_identical_under_larger_row_padding(self):
        """The property every bucket stands on, across the packages: the
        JAX package's kernel on a request padded to each bucket edge
        (8192, 16384, 32768 rows) gives the keep vector and accumulator
        columns the port's unpadded device path gives."""
        import pipelinedp_tpu as jpdp
        from pipelinedp_tpu import jax_engine as je
        ds = make_ds(7, 7_000)
        params = fusable_params()
        config = te.FusedConfig.from_params(params, public=False)
        config_j = je.FusedConfig.from_params(_jax_params(params),
                                              public=False)
        encoded = te.encode(ds, DataExtractors())
        encoded_j = je.encode(
            je.ArrayDataset(ds.privacy_ids, ds.partition_keys, ds.values),
            jpdp.DataExtractors(), None, None)
        P_pad = te._pad_pow2(len(encoded.pk_vocab))
        keep_table, thr, s_scale, min_count = te.selection_inputs(
            config, 1.0, 1e-8, None)
        scales = np.asarray([0.9], np.float32)
        got = _port_body(encoded, config, P_pad, keep_table, thr, s_scale,
                         min_count, scales, 11, 12)
        for rows_pad in (8_192, 16_384, 32_768):
            want = _jax_kernel_at(encoded_j, config_j, rows_pad, P_pad,
                                  keep_table, thr, s_scale, min_count,
                                  scales, 11, 12)
            _assert_same_arrays(want, got, f"rows_pad={rows_pad}")

    def test_row_bits_are_length_invariant(self):
        from pipelinedp_tpu_torch.ops import counter_rng, prng
        key = prng.PRNGKey(3)
        short = counter_rng.row_bits(key, 1_000, torch.device("cpu"))
        long = counter_rng.row_bits(key, 4_096, torch.device("cpu"))
        np.testing.assert_array_equal(short.numpy(), long[:1_000].numpy())

    @pytest.mark.parametrize("accumulator", ["fx", "f32"])
    def test_vector_kernel_bit_identical_under_larger_row_padding(
            self, accumulator):
        """VECTOR_SUM: under ``fx`` the JAX package's kernel at each
        bucket edge gives the port's unpadded int32 lane columns; under
        ``f32`` (whose float32 sums the two packages add in different
        orders) the port's batch, with a second member's rows beside the
        request's, gives the request's solo columns bit for bit."""
        import operator

        import pipelinedp_tpu as jpdp
        from pipelinedp_tpu import jax_engine as je
        from pipelinedp_tpu import plan as jplan
        from pipelinedp_tpu_torch import plan as plan_mod
        from pipelinedp_tpu_torch.ops import prng
        D = 32
        rng = np.random.default_rng(23)
        n = 7_000
        users = n // 20
        data = [(int(rng.integers(0, users)), int(rng.integers(0, 30)),
                 rng.uniform(-1.0, 1.0, D)) for _ in range(n)]
        params = pdp.AggregateParams(
            metrics=[pdp.Metrics.VECTOR_SUM],
            noise_kind=pdp.NoiseKind.LAPLACE,
            max_partitions_contributed=3,
            max_contributions_per_partition=2,
            vector_size=D, vector_max_norm=4.0,
            vector_norm_kind=pdp.NormKind.L2)
        with plan_mod.seam_override("vector_accumulator", accumulator):
            config = te.FusedConfig.from_params(params, public=False)
        assert config.vector_accumulator == accumulator
        ext = DataExtractors(
            privacy_id_extractor=operator.itemgetter(0),
            partition_extractor=operator.itemgetter(1),
            value_extractor=operator.itemgetter(2))
        encoded = te.encode(data, ext, None, vector_size=D)
        P_pad = te._pad_pow2(len(encoded.pk_vocab))
        keep_table, thr, s_scale, min_count = te.selection_inputs(
            config, 1.0, 1e-8, None)
        scales = np.asarray([0.9], np.float32)
        fx_bits = te.fused_fx_bits(config, 32_768)
        got = _port_body(encoded, config, P_pad, keep_table, thr, s_scale,
                         min_count, scales, 11, fx_bits)
        assert "vector_sum" in got[1]
        if accumulator == "fx":
            assert got[1]["vector_sum"].dtype == np.int32
            with jplan.seam_override("vector_accumulator", "fx"):
                config_j = je.FusedConfig.from_params(_jax_params(params),
                                                      public=False)
            encoded_j = je.encode(data, jpdp.DataExtractors(
                privacy_id_extractor=operator.itemgetter(0),
                partition_extractor=operator.itemgetter(1),
                value_extractor=operator.itemgetter(2)), D, None)
            for rows_pad in (8_192, 16_384, 32_768):
                want = _jax_kernel_at(encoded_j, config_j, rows_pad, P_pad,
                                      keep_table, thr, s_scale, min_count,
                                      scales, 11, fx_bits)
                _assert_same_arrays(want, got, f"rows_pad={rows_pad}")
            return
        other = te.encode(data[::-1][:3_000], ext, None, vector_size=D)

        def prep(enc, seed):
            return te.FusionPrep(
                lazy=None, encoded=enc, P=len(enc.pk_vocab), P_pad=P_pad,
                scales=scales, keep_table=np.asarray(keep_table),
                thr=float(thr), s_scale=float(s_scale),
                min_count=float(min_count), rows_per_uid=1.0,
                key=prng.PRNGKey(seed))
        keep, raw = te.fused_aggregate_batch(
            config, P_pad, [prep(other, 5), prep(encoded, 11)], fx_bits,
            "cpu")
        _assert_same_arrays(got, (keep[1], {k: v[1] for k, v in
                                            raw.items()}), "batch")


class TestBucketVectorCompatibility:
    """The bucket key carries the vector shape EXPLICITLY — two requests
    differing in D, norm kind or accumulator can never land in one fused
    batch."""

    @staticmethod
    def _encoded(d):
        import operator
        rng = np.random.default_rng(d)
        data = [(u, u % 7, rng.uniform(-1, 1, d)) for u in range(200)]
        ext = DataExtractors(
            privacy_id_extractor=operator.itemgetter(0),
            partition_extractor=operator.itemgetter(1),
            value_extractor=operator.itemgetter(2))
        return te.encode(data, ext, None, vector_size=d)

    @staticmethod
    def _config(d, norm_kind=pdp.NormKind.L2, accumulator="f32"):
        from pipelinedp_tpu_torch import plan as plan_mod
        params = pdp.AggregateParams(
            metrics=[pdp.Metrics.VECTOR_SUM],
            noise_kind=pdp.NoiseKind.LAPLACE,
            max_partitions_contributed=3,
            max_contributions_per_partition=2,
            vector_size=d, vector_max_norm=4.0,
            vector_norm_kind=norm_kind)
        with plan_mod.seam_override("vector_accumulator", accumulator):
            return te.FusedConfig.from_params(params, public=False)

    def test_different_d_never_share_a_bucket(self):
        k64 = fusion.bucket_for(self._config(64), self._encoded(64),
                                8192)
        k256 = fusion.bucket_for(self._config(256), self._encoded(256),
                                 8192)
        assert k64 is not None and k256 is not None
        assert k64.vector_size == 64 and k256.vector_size == 256
        assert k64 != k256

    def test_norm_kind_and_accumulator_split_buckets(self):
        enc = self._encoded(64)
        l2 = fusion.bucket_for(self._config(64), enc, 8192)
        linf = fusion.bucket_for(
            self._config(64, norm_kind=pdp.NormKind.Linf), enc, 8192)
        fx = fusion.bucket_for(
            self._config(64, accumulator="fx"), enc, 8192)
        assert l2.vector_norm_kind == "l2"
        assert linf.vector_norm_kind == "linf"
        assert fx.vector_accumulator == "fx"
        assert len({l2, linf, fx}) == 3

    def test_scalar_requests_keep_empty_vector_fields(self):
        ds = make_ds(9, 2_000)
        config = te.FusedConfig.from_params(fusable_params(),
                                            public=False)
        encoded = te.encode(ds, DataExtractors())
        key = fusion.bucket_for(config, encoded, 8192)
        assert (key.vector_size, key.vector_norm_kind,
                key.vector_accumulator) == (0, "", "")


# ---------------------------------------------------------------------
# kill-mid-batch: every lease resolves exactly once
# ---------------------------------------------------------------------


class TestKillMidBatch:

    def test_killed_member_keeps_reserve_companions_commit(
            self, tmp_path):
        tenants = {f"t{i}": (BIG_EPS, 1e-3) for i in range(3)}
        datasets = [make_ds(50 + i, 7_000) for i in range(3)]
        requests = [req(f"t{i}", datasets[i], seed=80 + i, rid=f"k{i}")
                    for i in range(3)]
        plan = faults.FaultPlan(fail_serve_requests=(1,))
        with faults.injected_faults(plan):
            with Service(str(tmp_path / "svc"), tenants=tenants,
                         workers=2, fusion=True,
                         fuse_window_ms=250,
                         fuse_max_batch=3) as svc:
                outs = submit_concurrently(svc, requests)
        killed = [i for i, o in enumerate(outs)
                  if isinstance(o, faults.ServeKill)]
        served = [i for i, o in enumerate(outs)
                  if not isinstance(o, BaseException) and o.ok]
        assert len(killed) == 1, outs
        assert sorted(killed + served) == [0, 1, 2]
        # Exactly-once lease resolution, read back from the durable
        # ledger: the killed member's reserve STAYS SPENT (noise may
        # have been drawn), each companion committed exactly once.
        led = TenantBudgetLedger(str(tmp_path / "svc" / "budgets"))
        for i in range(3):
            debits = led.debits(f"t{i}")
            assert list(debits) == [f"k{i}"]
            expected = "reserved" if i in killed else "committed"
            assert debits[f"k{i}"]["state"] == expected, (i, debits)


# ---------------------------------------------------------------------
# one warm program per bucket
# ---------------------------------------------------------------------


class TestWarmBucketPrograms:

    def test_second_same_bucket_batch_captures_zero_new_programs(
            self, tmp_path, monkeypatch):
        monkeypatch.setenv("PIPELINEDP_TPU_COSTS", "1")
        tenants = {f"t{i}": (BIG_EPS, 1e-3) for i in range(2)}
        datasets = [make_ds(60 + i, 7_000) for i in range(2)]
        with Service(str(tmp_path / "svc"), tenants=tenants,
                     workers=2, fusion=True, fuse_window_ms=250,
                     fuse_max_batch=2) as svc:
            outs = submit_concurrently(svc, [
                req(f"t{i}", datasets[i], seed=90 + i, rid=f"a{i}")
                for i in range(2)])
            assert all(o.ok for o in outs), outs
            captured = obs.ledger().snapshot()["counters"].get(
                "cost.programs_captured", 0)
            outs = submit_concurrently(svc, [
                req(f"t{i}", datasets[i], seed=95 + i, rid=f"b{i}")
                for i in range(2)])
            assert all(o.ok for o in outs), outs
            after = obs.ledger().snapshot()["counters"]
            assert after.get("cost.programs_captured", 0) == captured, (
                "the second same-bucket batch recorded new cost-table "
                "programs")
            assert after.get("serve.fused_batches") == 2

    def test_single_member_window_runs_solo_program(self, tmp_path):
        """A window that expires with one request takes the solo path
        (bit-identical) instead of a batch of one."""
        with Service(str(tmp_path / "svc"),
                     tenants={"t0": (BIG_EPS, 1e-3)}, workers=2,
                     fusion=True, fuse_window_ms=40,
                     fuse_max_batch=4) as svc:
            out = svc.submit(req("t0", make_ds(3, 6_000), seed=5,
                                 rid="solo1"))
            assert out.ok, out
        counters = obs.ledger().snapshot()["counters"]
        assert counters.get("serve.fusion_offered") == 1
        assert counters.get("serve.fused_batches", 0) == 0

    def test_non_fusable_params_fall_through_to_solo_queue(
            self, tmp_path):
        """Params the fused plane rejects (here: a percentile range
        whose f32 leaf constant overflows) skip the fuser entirely and
        serve through the classic path."""
        params = pdp.AggregateParams(
            metrics=[pdp.Metrics.PERCENTILE(50)],
            noise_kind=pdp.NoiseKind.LAPLACE,
            max_partitions_contributed=3,
            max_contributions_per_partition=2,
            min_value=0.0, max_value=1e-36)
        assert not te.params_are_fusable(params)
        ds = make_ds(9, 600, users=50, parts=5)
        with Service(str(tmp_path / "svc"),
                     tenants={"t0": (BIG_EPS, 1e-3)}, workers=2,
                     fusion=True, fuse_window_ms=40,
                     fuse_max_batch=4) as svc:
            out = svc.submit(req("t0", ds, seed=5, rid="np1",
                                 params=params))
            assert out.ok, out
        counters = obs.ledger().snapshot()["counters"]
        assert counters.get("serve.fusion_offered", 0) == 0
        assert counters.get("serve.requests_served") == 1


# ---------------------------------------------------------------------
# quotas (ROADMAP serve item (b))
# ---------------------------------------------------------------------


class TestQuotas:

    def test_row_quota_refuses_before_any_reserve(self, tmp_path):
        ds = make_ds(1, 6_000)
        with Service(str(tmp_path / "svc"),
                     tenants={"t0": (2.0, 1e-6)},
                     max_rows_per_request=1_000) as svc:
            out = svc.submit(req("t0", ds, seed=1, rid="q1"))
            assert not out.ok
            assert out.reason == "quota"
            assert "row quota" in out.detail and "1000" in out.detail
            # Nothing was reserved, nothing ran.
            assert svc.budgets.remaining("t0").epsilon == (
                pytest.approx(2.0))
            assert svc.budgets.debits("t0") == {}
        assert "quota" in serve.REFUSAL_REASONS

    def test_per_tenant_row_quota_overrides_service_default(
            self, tmp_path):
        ds = make_ds(2, 3_000)
        with Service(str(tmp_path / "svc")) as svc:
            svc.register_tenant("tight", BIG_EPS, 1e-3,
                                max_rows_per_request=100)
            svc.register_tenant("loose", BIG_EPS, 1e-3)
            refused = svc.submit(req("tight", ds, seed=1, rid="r1"))
            assert not refused.ok and refused.reason == "quota"
            served = svc.submit(req("loose", ds, seed=1, rid="r2"))
            assert served.ok, served

    def test_rate_quota_windows_on_the_injectable_clock(self, tmp_path):
        clock = FakeClock()
        ds = make_ds(3, 2_000, users=200, parts=5)
        with Service(str(tmp_path / "svc"),
                     tenants={"t0": (BIG_EPS, 1e-3)},
                     max_reqs_per_s=2, clock=clock) as svc:
            assert svc.submit(req("t0", ds, seed=1, rid="h1")).ok
            assert svc.submit(req("t0", ds, seed=2, rid="h2")).ok
            third = svc.submit(req("t0", ds, seed=3, rid="h3"))
            assert not third.ok and third.reason == "quota"
            assert "rate quota" in third.detail
            # The refusal itself must not consume window slots, and
            # the window slides: one second later the tenant is
            # admitted again.
            clock.sleep(1.01)
            assert svc.submit(req("t0", ds, seed=4, rid="h4")).ok


# ---------------------------------------------------------------------
# heartbeat: live bucket occupancy
# ---------------------------------------------------------------------


class TestHeartbeatOccupancy:

    def test_monitor_embeds_fusion_snapshot_in_serve_section(
            self, tmp_path):
        clock = FakeClock()
        mon = obs_monitor.Monitor(
            clock=clock, interval_s=1.0, stall_s=60.0,
            heartbeat_path=str(tmp_path / "hb.json")).start_inline()
        try:
            obs_monitor.update_fusion(
                {"window_ms": 8, "max_batch": 8, "queued": 3,
                 "buckets": {"abc@r8192p64": {
                     "queued": 3, "rows": 8192, "partitions": 64,
                     "window_remaining_s": 0.004}}})
            hb = mon.poll_once()
            assert hb["serve"]["fusion"]["queued"] == 3
            bucket = hb["serve"]["fusion"]["buckets"]["abc@r8192p64"]
            assert bucket["window_remaining_s"] == 0.004
            obs_monitor.update_fusion(None)
            assert "serve" not in mon.poll_once()
        finally:
            # An inline monitor arms the activity registry, which would
            # otherwise make the global tracer measure in later tests.
            mon.stop()

    def test_live_fuser_pushes_bucket_occupancy(self, tmp_path):
        with Service(str(tmp_path / "svc"),
                     tenants={"t0": (BIG_EPS, 1e-3)}, workers=2,
                     fusion=True, fuse_window_ms=700,
                     fuse_max_batch=4) as svc:
            seen = []

            def submit_one():
                seen.append(svc.submit(
                    req("t0", make_ds(4, 6_000), seed=6, rid="hb1")))

            t = threading.Thread(target=submit_one)
            t.start()
            # The request sits in its bucket for up to the 700ms
            # window; the pushed snapshot must show it queued.
            deadline = 200
            snap = None
            while deadline:
                snap = obs_monitor.fusion_snapshot()
                if snap and snap.get("queued") == 1:
                    break
                deadline -= 1
                t.join(timeout=0.005)
            assert snap and snap.get("queued") == 1, snap
            (label, bucket), = snap["buckets"].items()
            assert bucket["rows"] == 8192 and bucket["queued"] == 1
            assert bucket["window_remaining_s"] > 0
            t.join()
            assert seen[0].ok, seen[0]
        # The closed fuser clears its heartbeat registration.
        assert obs_monitor.fusion_snapshot() is None




# ---------------------------------------------------------------------
# fused == solo for more bucket kinds, and one K1 launch per batch
# ---------------------------------------------------------------------


def scalar_params():
    return pdp.AggregateParams(
        metrics=[pdp.Metrics.COUNT, pdp.Metrics.SUM, pdp.Metrics.MEAN,
                 pdp.Metrics.PRIVACY_ID_COUNT],
        noise_kind=pdp.NoiseKind.LAPLACE,
        max_partitions_contributed=3,
        max_contributions_per_partition=2,
        min_value=0.0, max_value=10.0)


def per_partition_sum_params():
    return pdp.AggregateParams(
        metrics=[pdp.Metrics.SUM, pdp.Metrics.COUNT],
        noise_kind=pdp.NoiseKind.GAUSSIAN,
        max_partitions_contributed=3,
        max_contributions_per_partition=2,
        min_sum_per_partition=0.0, max_sum_per_partition=15.0)


def vector_params(d=8):
    return pdp.AggregateParams(
        metrics=[pdp.Metrics.VECTOR_SUM],
        noise_kind=pdp.NoiseKind.LAPLACE,
        max_partitions_contributed=3,
        max_contributions_per_partition=2,
        vector_size=d, vector_max_norm=4.0,
        vector_norm_kind=pdp.NormKind.L2)


def make_vector_ds(seed, n, d=8, parts=30):
    rng = np.random.default_rng(seed)
    return pdp.ArrayDataset(
        privacy_ids=rng.integers(0, max(n // 20, 10), n),
        partition_keys=rng.integers(0, parts, n),
        values=rng.uniform(-1.0, 1.0, (n, d)))


BUCKET_KINDS = {
    "scalar": (scalar_params, make_ds),
    "per_partition_sum": (per_partition_sum_params, make_ds),
    "vector_fx": (vector_params, make_vector_ds),
}


def run_kind(state_dir, kind, fusion_on, sizes=(7_000, 8_000),
             max_batch=2):
    make_params, make_data = BUCKET_KINDS[kind]
    tenants = {f"t{i}": (BIG_EPS, 1e-3) for i in range(len(sizes))}
    requests = [req(f"t{i}", make_data(40 + i, n), seed=70 + i,
                    rid=f"r{i}", params=make_params())
                for i, n in enumerate(sizes)]
    with Service(str(state_dir), tenants=tenants, workers=2,
                 fusion=fusion_on, fuse_window_ms=250,
                 fuse_max_batch=max_batch) as svc:
        return submit_concurrently(svc, requests)


class TestFusedBucketKinds:

    @pytest.mark.parametrize("kind", sorted(BUCKET_KINDS))
    def test_fused_equals_solo(self, tmp_path, monkeypatch, kind):
        """A scalar bucket, a per-partition-SUM bucket (K4 once on the
        batch's rows) and a VECTOR_SUM bucket under ``fx`` (K2 once):
        each member's release fused is its release solo, bit for bit."""
        monkeypatch.setenv("PIPELINEDP_TPU_VECTOR_ACCUMULATOR", "fx")
        solo = run_kind(tmp_path / "solo", kind, False)
        obs.reset()
        fused = run_kind(tmp_path / "fused", kind, True)
        counters = obs.ledger().snapshot()["counters"]
        assert counters.get("serve.fused_batches") == 1
        assert counters.get("serve.fused_requests") == 2
        for i, (s, f) in enumerate(zip(solo, fused)):
            assert s.ok and f.ok, (s, f)
            assert len(dict(s.results)) > 0
            a, b = dict(s.results), dict(f.results)
            assert set(a) == set(b), i
            for k in a:
                for field in a[k]._fields:
                    np.testing.assert_array_equal(
                        np.asarray(getattr(a[k], field)),
                        np.asarray(getattr(b[k], field)),
                        err_msg=f"{kind} request {i} {k} {field}")
            assert s.audit == f.audit

    @pytest.mark.parametrize("kind", sorted(BUCKET_KINDS))
    def test_one_k1_call_per_fused_batch(self, tmp_path, monkeypatch,
                                         kind):
        """A fused batch of three requests without percentiles reduces
        every member with ONE ``segment_sum_lanes`` call (K1 on the
        card), and the VECTOR_SUM batch its vector lanes with one
        ``segment_sum_wide`` call (K2)."""
        monkeypatch.setenv("PIPELINEDP_TPU_VECTOR_ACCUMULATOR", "fx")
        calls = {"segment_sum_lanes": 0, "segment_sum_wide": 0}
        for name in calls:
            real = getattr(segsum, name)

            def counted(*a, _real=real, _name=name, **k):
                calls[_name] += 1
                return _real(*a, **k)

            monkeypatch.setattr(segsum, name, counted)
        outs = run_kind(tmp_path / "fused", kind, True,
                        sizes=(7_000, 8_000, 6_000), max_batch=3)
        assert all(o.ok for o in outs), outs
        counters = obs.ledger().snapshot()["counters"]
        assert counters.get("serve.fused_batches") == 1
        assert counters.get("serve.fused_requests") == 3
        assert calls["segment_sum_lanes"] == 1
        assert calls["segment_sum_wide"] == (1 if kind == "vector_fx"
                                             else 0)

    @pytest.mark.parametrize("members", [2, 3])
    def test_percentile_batch_walks_once(self, tmp_path, monkeypatch,
                                         members):
        """A fused batch with PERCENTILE walks every member's quantiles
        at once: ``segment_sum_lanes`` (K1 on the card) twice, the lanes
        and the batch's one mid histogram, and ``subtree_counts_multi``
        (K3) once, whatever the number of members."""
        from pipelinedp_tpu_torch.ops.kernels import hist
        calls = {"segment_sum_lanes": 0, "subtree_counts_multi": 0}
        for mod, name in ((segsum, "segment_sum_lanes"),
                          (hist, "subtree_counts_multi")):
            real = getattr(mod, name)

            def counted(*a, _real=real, _name=name, **k):
                calls[_name] += 1
                return _real(*a, **k)

            monkeypatch.setattr(mod, name, counted)
        sizes = (7_000, 8_000, 6_000)[:members]
        datasets = [make_ds(40 + i, n) for i, n in enumerate(sizes)]
        with Service(str(tmp_path / "svc"),
                     tenants={f"t{i}": (BIG_EPS, 1e-3)
                              for i in range(members)},
                     workers=2, fusion=True, fuse_window_ms=250,
                     fuse_max_batch=members) as svc:
            outs = submit_concurrently(svc, [
                req(f"t{i}", datasets[i], seed=70 + i, rid=f"p{i}")
                for i in range(members)])
        assert all(o.ok for o in outs), outs
        counters = obs.ledger().snapshot()["counters"]
        assert counters.get("serve.fused_batches") == 1
        assert counters.get("serve.fused_requests") == members
        assert calls == {"segment_sum_lanes": 2, "subtree_counts_multi": 1}

    def test_failed_walk_refuses_the_batch(self, tmp_path, monkeypatch):
        """A K3 that fails inside a fused percentile batch refuses every
        member with an ``"error"`` refusal and refunds its reserve: no
        member is served another way."""
        from pipelinedp_tpu_torch.ops.kernels import hist
        calls = []

        def broken(*a, **k):
            calls.append(1)
            raise RuntimeError("hist_bin launch failed: CUDA error 700")

        monkeypatch.setattr(hist, "subtree_counts_multi", broken)
        tenants = {f"t{i}": (BIG_EPS, 1e-3) for i in range(2)}
        datasets = [make_ds(40 + i, n) for i, n in enumerate((7_000,
                                                              8_000))]
        with Service(str(tmp_path / "svc"), tenants=tenants, workers=2,
                     fusion=True, fuse_window_ms=250,
                     fuse_max_batch=2) as svc:
            outs = submit_concurrently(svc, [
                req(f"t{i}", datasets[i], seed=70 + i, rid=f"p{i}")
                for i in range(2)])
            remaining = {t: svc.budgets.remaining(t) for t in tenants}
        assert len(calls) == 1
        for o in outs:
            assert not o.ok, o
            assert o.reason == "error" and "hist_bin" in o.detail, o
        for t, (eps, delta) in tenants.items():
            assert (remaining[t].epsilon, remaining[t].delta) == (eps,
                                                                  delta)
        assert obs.ledger().snapshot()["counters"].get(
            "serve.fused_batches") is None


# ---------------------------------------------------------------------
# cross-package: the JAX package's fusing Service and the port's
# ---------------------------------------------------------------------


class TestCrossPackageFusion:

    @pytest.mark.parametrize("kind", ["percentile", "scalar"])
    def test_fused_service_matches_jax(self, tmp_path, kind):
        """Three tenants' requests across a bucket boundary through both
        packages' services with fusion on: the same batches (the
        ``serve.*`` counters), released values and kept sets, audit
        records, ledger ``remaining`` and books entries."""
        import pipelinedp_tpu as jpdp
        from pipelinedp_tpu import obs as jobs
        from pipelinedp_tpu import serve as jserve
        sizes = (7_000, 8_000, 9_000)
        tenants = {f"t{i}": (BIG_EPS, 1e-3) for i in range(3)}
        params = fusable_params() if kind == "percentile" else (
            scalar_params())
        got = {}
        for name, mod, o, make, p in (
                ("jax", jpdp, jobs, jserve.Service, _jax_params(params)),
                ("port", pdp, obs, Service, params)):
            o.reset()
            requests = []
            for i, n in enumerate(sizes):
                rng = np.random.default_rng(40 + i)
                users = max(n // 20, 10)
                ds = mod.ArrayDataset(
                    privacy_ids=rng.integers(0, users, n),
                    partition_keys=rng.integers(0, 30, n),
                    values=rng.uniform(0.0, 10.0, n))
                requests.append(jserve.ServeRequest(
                    tenant=f"t{i}", params=p, dataset=ds, epsilon=4.0,
                    delta=1e-8, rng_seed=70 + i, request_id=f"r{i}")
                    if name == "jax" else req(f"t{i}", ds, seed=70 + i,
                                              rid=f"r{i}", params=p))
            with make(str(tmp_path / name), tenants=tenants, workers=2,
                      fusion=True, fuse_window_ms=250,
                      fuse_max_batch=2) as svc:
                outs = submit_concurrently(svc, requests)
                remaining = {t: svc.budgets.remaining(t) for t in tenants}
                books = {}
                for t in tenants:
                    path = os.path.join(svc.books_dir(t),
                                        "run_ledger.jsonl")
                    with open(path, encoding="utf-8") as fh:
                        books[t] = [
                            {k: v for k, v in json.loads(line)[
                                "payload"]["serve"].items()
                             if k not in ("wall_s", "trace_id")}
                            for line in fh]
            counters = {k: v for k, v in
                        o.ledger().snapshot()["counters"].items()
                        if k.startswith("serve.")}
            got[name] = (outs, remaining, books, counters)
        j, t = got["jax"], got["port"]
        assert j[3] == t[3]
        assert t[3].get("serve.fused_batches") == 1
        for i, (a, b) in enumerate(zip(j[0], t[0])):
            assert a.ok and b.ok, (a, b)
            ra = {k: tuple(v) for k, v in a.results}
            rb = {k: tuple(v) for k, v in b.results}
            assert 0 < len(ra) < 30
            assert ra == rb, i
            assert a.audit == b.audit, i
        assert {k: (v.epsilon, v.delta) for k, v in j[1].items()} == {
            k: (v.epsilon, v.delta) for k, v in t[1].items()}
        assert j[2] == t[2]
