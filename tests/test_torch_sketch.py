"""Sketch-first DP heavy hitters on the port (``pipelinedp_tpu_torch/sketch``)
against the JAX package's (``pipelinedp_tpu/sketch``), on the CPU.

The cases of ``tests/test_sketch.py`` that need no mesh, each also held to
the JAX package, their obs halves included: the ``sketch`` section of the
run report, the phase-1 accountant's audit record and the counters equal
the JAX package's field for field. Bit equality is the rule: the stable
hashes, the bucket ids, ``bound_pairs``' kept pairs, the binner's counts
(both backends, and ``np.bincount``), the selection mask and the released
float64 values are compared exactly, never within a tolerance. The JAX
side runs as its own tests run it (its binner is XLA, no Pallas kernel).
"""

import collections
import threading

import numpy as np
import pytest
import torch

import jax

import pipelinedp_tpu as pdp
from pipelinedp_tpu import obs as jobs
from pipelinedp_tpu.backends import JaxBackend
from pipelinedp_tpu.sketch import SketchParams as JaxSketchParams
from pipelinedp_tpu.sketch import device as jdevice
from pipelinedp_tpu.sketch import engine as jengine
from pipelinedp_tpu.sketch import hashing as jhashing

import pipelinedp_tpu_torch as pdt
from pipelinedp_tpu_torch import obs
from pipelinedp_tpu_torch.ops import prng
from pipelinedp_tpu_torch.resilience import faults
from pipelinedp_tpu_torch.sketch import (SketchParams, bucket_ids,
                                         stable_hash64, stable_hash_any)
from pipelinedp_tpu_torch.sketch import device as sketch_device
from pipelinedp_tpu_torch.sketch import engine as sketch_engine
from pipelinedp_tpu_torch.sketch import hashing
from pipelinedp_tpu_torch.sketch import params as sketch_params_mod

KNOB_ENVS = ("PIPELINEDP_TPU_SKETCH_WIDTH", "PIPELINEDP_TPU_SKETCH_DEPTH",
             "PIPELINEDP_TPU_SKETCH_CANDIDATE_CAP",
             "PIPELINEDP_TPU_SKETCH_BACKEND")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in KNOB_ENVS + ("PIPELINEDP_TPU_STREAM_CHUNK",
                             "PIPELINEDP_TPU_AUDIT",
                             "PIPELINEDP_TPU_PLAN_DIR"):
        monkeypatch.delenv(name, raising=False)
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()


def _params(mod, noise="LAPLACE", l0=3, linf=2):
    return mod.AggregateParams(
        metrics=[mod.Metrics.COUNT, mod.Metrics.SUM],
        noise_kind=getattr(mod.NoiseKind, noise),
        max_partitions_contributed=l0,
        max_contributions_per_partition=linf,
        min_value=0.0, max_value=10.0)


def _columns(n=8000, n_users=600, n_keys=80, seed=1, zipf=1.4):
    rng = np.random.default_rng(seed)
    raw = rng.zipf(zipf, n) % n_keys
    return (rng.integers(0, n_users, n),
            np.char.add("key/", raw.astype("U6")),
            rng.uniform(0.0, 10.0, n))


def _dataset(mod, **kw):
    pid, pk, values = _columns(**kw)
    return mod.ArrayDataset(privacy_ids=pid, partition_keys=pk,
                            values=values)


def _run(mod, backend, ds, params, sketch=None, eps=1.0, delta=1e-6):
    acc = mod.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = mod.DPEngine(acc, backend)
    res = engine.aggregate(ds, params, mod.DataExtractors(),
                           sketch_first=sketch)
    acc.compute_budgets()
    return dict(res), res, engine


def _both(seed, sketch_kw=None, data_kw=None, params_kw=None, eps=1.0,
          keep_all=False):
    """The same sketch-first aggregation on ``JaxBackend`` and on
    ``TorchBackend("cpu")``: ((jax out, jax result), (port out, port
    result))."""
    data_kw = data_kw or {}
    params_kw = params_kw or {}
    sk = (_keep_all_kwargs() if keep_all else {})
    sk.update(sketch_kw or {})
    want, wres, _ = _run(pdp, JaxBackend(rng_seed=seed),
                         _dataset(pdp, **data_kw), _params(pdp, **params_kw),
                         JaxSketchParams(**sk), eps=eps)
    got, gres, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=seed),
                        _dataset(pdt, **data_kw), _params(pdt, **params_kw),
                        SketchParams(**sk), eps=eps)
    return (want, wres), (got, gres)


def _assert_same_release(got, want):
    """Same kept keys; every metric's float64 bits equal."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k]._fields == want[k]._fields
        for x, y in zip(got[k], want[k]):
            assert np.float64(x).tobytes() == np.float64(y).tobytes(), (
                k, got[k], want[k])


def _keep_all_kwargs(**kw):
    """Generous phase-1 budget + sub-unit threshold + cap >= buckets:
    every populated bucket is selected, so the candidate set IS the key
    universe — the PARITY row 37 regime."""
    base = dict(eps=1e6, delta=1e-6, width=2048, depth=2,
                candidate_cap=2048, threshold=0.5)
    base.update(kw)
    return base


def _keep_all_sketch(**kw):
    return SketchParams(**_keep_all_kwargs(**kw))


# ---------------------------------------------------------------------------
# Hashing
# ---------------------------------------------------------------------------


class TestHashing:

    def test_container_invariance_str(self):
        keys = ["alpha", "beta", "a longer key with spaces", "ß∂ƒ©"]
        arr = np.asarray(keys)
        vec = stable_hash64(arr)
        for k, h in zip(keys, vec):
            assert stable_hash_any(k) == int(h)

    def test_container_invariance_bytes_and_int(self):
        barr = np.asarray([b"x", b"yz", b"abc"], dtype="S3")
        for k, h in zip([b"x", b"yz", b"abc"], stable_hash64(barr)):
            assert stable_hash_any(k) == int(h)
        iarr = np.asarray([0, 1, -5, 2**40], dtype=np.int64)
        for k, h in zip(iarr.tolist(), stable_hash64(iarr)):
            assert stable_hash_any(int(k)) == int(h)

    def test_itemsize_invariance(self):
        a = stable_hash64(np.asarray(["a"]))
        b = stable_hash64(np.asarray(["a", "0123456789abcdef"]))
        assert int(a[0]) == int(b[0])

    def test_embedded_nuls_are_content(self):
        assert stable_hash_any("a\x00b") != stable_hash_any("ab")
        assert stable_hash_any(b"\x00a") != stable_hash_any(b"a")
        assert stable_hash_any("a\x00") == stable_hash_any("a")
        arr = np.asarray(["a\x00b", "ab"])
        h = stable_hash64(arr)
        assert int(h[0]) == stable_hash_any("a\x00b")
        assert int(h[0]) != int(h[1])

    def test_seed_changes_everything(self):
        keys = np.asarray([f"k{i}" for i in range(64)])
        assert (stable_hash64(keys, seed=1) !=
                stable_hash64(keys, seed=2)).all()

    def test_distinct_keys_distinct_hashes(self):
        keys = np.asarray([f"url/{i}" for i in range(10_000)])
        assert len(np.unique(stable_hash64(keys))) == 10_000

    def test_bucket_round_trip_collision_prone(self):
        keys = np.asarray([f"q{i}" for i in range(10_000)])
        rows = bucket_ids(stable_hash64(keys), 256, 3)
        assert rows.shape == (3, 10_000)
        assert rows.min() >= 0 and rows.max() < 256
        assert len(np.unique(rows[0])) == 256
        selected = np.zeros(256, bool)
        selected[[3, 17, 200]] = True
        cand, table = hashing.build_candidate_table(keys,
                                                    selected[rows[0]])
        expect = {k for k, b in zip(keys.tolist(), rows[0])
                  if selected[b]}
        assert set(cand) == expect == set(table)
        assert sorted(table.values()) == list(range(len(cand)))
        want = jhashing.build_candidate_table(keys, selected[rows[0]])
        assert (cand, table) == want

    def test_rows_independent(self):
        keys = np.asarray([f"r{i}" for i in range(4096)])
        rows = bucket_ids(stable_hash64(keys), 1024, 2)
        same0 = rows[0][:-1] == rows[0][1:]
        same1 = rows[1][:-1] == rows[1][1:]
        assert not (same0 & same1).any()

    @pytest.mark.parametrize("kind", ["U", "S", "int64", "uint32", "bool",
                                      "object"])
    @pytest.mark.parametrize("seed", [hashing.DEFAULT_SEED, 0, 2**63 + 5])
    def test_hashes_and_buckets_bit_equal_to_jax(self, kind, seed):
        rng = np.random.default_rng(len(kind))
        raw = rng.integers(-2**40, 2**40, 3000)
        keys = {
            "U": np.char.add("url/", raw.astype("U14")),
            "S": np.char.add(b"q\x00", raw.astype("S14")),
            "int64": raw,
            "uint32": (raw & 0xFFFFFFFF).astype(np.uint32),
            "bool": raw > 0,
            "object": np.asarray([("t", int(r)) if r % 3 else f"s{r}"
                                  for r in raw[:300]], dtype=object),
        }[kind]
        got = stable_hash64(keys, seed)
        want = jhashing.stable_hash64(keys, seed)
        assert got.dtype == want.dtype == np.uint64
        assert got.tobytes() == want.tobytes()
        for k in list(keys[:50]):
            assert stable_hash_any(k, seed) == jhashing.stable_hash_any(
                k, seed)
        for width, depth in ((256, 1), (4096, 3), (65536, 2)):
            b = bucket_ids(got, width, depth, seed)
            assert b.tobytes() == jhashing.bucket_ids(want, width, depth,
                                                      seed).tobytes()
        assert hashing.mix64(got).tobytes() == jhashing.mix64(
            want).tobytes()


# ---------------------------------------------------------------------------
# The binner
# ---------------------------------------------------------------------------


class TestDeviceSketch:

    @pytest.mark.parametrize("n", [1, 511, 512, 1300])
    def test_matmul_equals_scatter_and_bincount(self, n):
        rng = np.random.default_rng(n)
        width = 512
        bk = rng.integers(0, width, size=(3, n)).astype(np.int32)
        pad = sketch_device.pad_chunk(bk)
        assert pad.shape[1] % sketch_device.ROW_BLOCK == 0
        assert (pad[:, n:] == -1).all()
        t = torch.from_numpy(pad)
        m = sketch_device.sketch_chunk(t, width, "matmul").numpy()
        x = sketch_device.sketch_chunk(t, width, "xla").numpy()
        assert m.dtype == x.dtype == np.int32
        assert (m == x).all()
        for d in range(3):
            assert (m[d] == np.bincount(bk[d], minlength=width)).all()
        assert m.sum() == 3 * n  # padding (-1) counted nowhere
        want = np.asarray(jdevice.sketch_chunk_program(
            jdevice.pad_chunk(bk), width=width, backend="matmul"))
        assert (m == want).all()
        assert jdevice.pad_chunk(bk).tobytes() == pad.tobytes()

    def test_chunked_accumulation_exact(self):
        rng = np.random.default_rng(7)
        bk = rng.integers(0, 256, size=(2, 5000)).astype(np.int32)
        whole = np.zeros((2, 256), np.int64)
        sketch_device.accumulate_chunk(
            whole, sketch_device.sketch_chunk(
                torch.from_numpy(sketch_device.pad_chunk(bk)), 256,
                "matmul"))
        parts = np.zeros((2, 256), np.int64)
        for lo in range(0, 5000, 700):
            chunk = sketch_device.pad_chunk(
                np.ascontiguousarray(bk[:, lo:lo + 700]))
            sketch_device.accumulate_chunk(
                parts, sketch_device.sketch_chunk(torch.from_numpy(chunk),
                                                  256, "matmul"))
        assert (whole == parts).all()
        assert (whole[1] == np.bincount(bk[1], minlength=256)).all()

    def test_matmul_blocks_stay_exact(self, monkeypatch):
        """Many one-hot blocks (a small factor budget), a wide grid and a
        hot bucket: the same counts as ``np.bincount``."""
        monkeypatch.setattr(sketch_device, "_FACTOR_BYTES", 1 << 20)
        width = 1 << 14
        assert sketch_device.matmul_block_rows(width) == 1024
        rng = np.random.default_rng(3)
        bk = rng.integers(0, width, size=(2, 20_000)).astype(np.int32)
        bk[0, ::3] = 12345
        t = torch.from_numpy(sketch_device.pad_chunk(bk))
        for backend in ("matmul", "xla"):
            got = sketch_device.sketch_chunk(t, width, backend).numpy()
            for d in range(2):
                assert (got[d] == np.bincount(bk[d],
                                              minlength=width)).all()

    def test_block_rows_bound(self):
        # 64 MiB a factor at width 2^16 (256 columns each), and never
        # past 2^24 rows: every partial sum is exact in float32.
        assert sketch_device.matmul_block_rows(1 << 16) == 1 << 16
        assert sketch_device.matmul_block_rows(256) == 1 << 16
        assert sketch_device.matmul_block_rows(1 << 20) == 4096
        assert all(sketch_device.matmul_block_rows(w) <= 1 << 24
                   for w in (256, 1 << 12, 1 << 24))


# ---------------------------------------------------------------------------
# Per-user bounding
# ---------------------------------------------------------------------------


class TestBounding:

    def test_l0_bound_holds(self):
        pid = np.zeros(50, np.int64)
        keys = np.asarray([f"k{i}" for i in range(50)])
        uniq, inv = sketch_engine._factorize_keys(keys)
        h = stable_hash64(uniq)
        kept = sketch_engine.bound_pairs(pid, inv, h, 3, 0)
        assert len(kept) == 3
        want = jengine.bound_pairs(pid, inv, h, 3, 0)
        assert kept.tobytes() == want.tobytes()

    def test_neighbor_sensitivity_bound_string_pids(self):
        rng = np.random.default_rng(11)
        l0 = 3
        pids, keys = [], []
        for u in range(40):
            for k in rng.choice(200, size=10, replace=False):
                pids.append(f"user-{u}")
                keys.append(f"key-{k}")
        pid_arr, key_arr = np.asarray(pids), np.asarray(keys)
        uniq, inv = sketch_engine._factorize_keys(key_arr)
        h = stable_hash64(uniq)

        def kept_multiset(mask):
            kept = sketch_engine.bound_pairs(pid_arr[mask], inv[mask], h,
                                             l0, 0)
            return sorted(kept.tolist())

        full = kept_multiset(np.ones(len(pid_arr), bool))
        for victim in ("user-0", "user-17", "user-39"):
            neighbor = kept_multiset(pid_arr != victim)
            diff = collections.Counter(full) - collections.Counter(neighbor)
            gained = collections.Counter(neighbor) - collections.Counter(
                full)
            assert sum(diff.values()) <= l0, victim
            assert sum(gained.values()) == 0, victim

    def test_row_order_and_duplication_invariant(self):
        rng = np.random.default_rng(5)
        pid = rng.integers(0, 30, 2000)
        keys = np.asarray([f"k{i}" for i in rng.integers(0, 200, 2000)])
        uniq, inv = sketch_engine._factorize_keys(keys)
        h = stable_hash64(uniq)
        kept_a = sketch_engine.bound_pairs(pid, inv, h, 4, 9)
        perm = rng.permutation(2000)
        uniq2, inv2 = sketch_engine._factorize_keys(keys[perm])
        assert (uniq2 == uniq).all()
        kept_b = sketch_engine.bound_pairs(pid[perm], inv2,
                                           stable_hash64(uniq2), 4, 9)
        assert sorted(kept_a.tolist()) == sorted(kept_b.tolist())

    @pytest.mark.parametrize("pid_kind", ["int", "str"])
    @pytest.mark.parametrize("l0", [1, 4])
    def test_bound_pairs_bit_equal_to_jax(self, pid_kind, l0):
        rng = np.random.default_rng(l0)
        pid = rng.integers(0, 300, 6000)
        if pid_kind == "str":
            pid = np.char.add("u", pid.astype("U4"))
        keys = np.char.add("k/", (rng.zipf(1.3, 6000) % 900).astype("U4"))
        uniq, inv = sketch_engine._factorize_keys(keys)
        juniq, jinv = jengine._factorize_keys(keys)
        assert uniq.tobytes() == juniq.tobytes()
        assert inv.astype(np.int64).tobytes() == jinv.astype(
            np.int64).tobytes()
        h = stable_hash64(uniq, 77)
        got = sketch_engine.bound_pairs(pid, inv, h, l0, 77)
        want = jengine.bound_pairs(pid, jinv, h, l0, 77)
        assert got.dtype == want.dtype
        assert got.tobytes() == want.tobytes()

    def test_factorize_integer_keys_bit_equal_to_jax(self):
        keys = np.random.default_rng(2).integers(-50, 5000, 4000)
        got = sketch_engine._factorize_keys(keys)
        want = jengine._factorize_keys(keys)
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1].tobytes() == want[1].tobytes()


# ---------------------------------------------------------------------------
# DP bucket selection
# ---------------------------------------------------------------------------


class TestSelection:

    @pytest.mark.parametrize("seed", [0, 31])
    @pytest.mark.parametrize("cap,threshold", [(4096, None), (17, None),
                                               (64, 0.5)])
    def test_selection_mask_bit_equal_to_jax(self, seed, cap, threshold):
        rng = np.random.default_rng(seed)
        counts = (rng.zipf(1.5, 4096) - 1).astype(np.int64)
        jacc = pdp.NaiveBudgetAccountant(total_epsilon=2.0,
                                         total_delta=1e-7)
        jspec = jacc.request_budget(pdp.MechanismType.GENERIC)
        jacc.compute_budgets()
        jkey = jax.random.fold_in(jax.random.PRNGKey(seed),
                                  jengine._SELECT_STREAM_TAG)
        want = jengine.select_buckets(counts, jspec, 4, cap, threshold,
                                      jkey)
        tacc = pdt.NaiveBudgetAccountant(total_epsilon=2.0,
                                         total_delta=1e-7)
        tspec = tacc.request_budget(pdt.MechanismType.GENERIC)
        tacc.compute_budgets()
        tkey = prng.fold_in(prng.PRNGKey(seed),
                            sketch_engine._SELECT_STREAM_TAG)
        got = sketch_engine.select_buckets(counts, tspec, 4, cap,
                                           threshold, tkey)
        assert got[0].dtype == bool
        assert got[0].tobytes() == want[0].tobytes()
        assert got[1:] == want[1:]
        assert 0 < got[0].sum() <= cap

    def test_count_min_estimate(self):
        counts = np.asarray([[5, 1, 9], [2, 7, 3]], np.int64)
        buckets = np.asarray([[0, 2, 1], [1, 0, 2]])
        got = sketch_engine.count_min_estimate(counts, buckets)
        assert got.tolist() == [5, 2, 1]
        assert got.tolist() == jengine.count_min_estimate(
            counts, buckets).tolist()


# ---------------------------------------------------------------------------
# End to end: the port against the JAX package
# ---------------------------------------------------------------------------


class TestEndToEnd:

    @pytest.mark.parametrize("backend", ["matmul", "xla"])
    @pytest.mark.parametrize("seed", [3, 17])
    def test_release_bit_equal_to_jax(self, seed, backend):
        (want, wres), (got, gres) = _both(
            seed, dict(eps=4.0, delta=1e-7, width=1024, depth=2,
                       candidate_cap=64, backend=backend))
        assert len(got) > 0
        assert (gres.timings["sketch_candidates"] ==
                wres.timings["sketch_candidates"])
        assert gres._candidate_table == wres._candidate_table
        _assert_same_release(got, want)

    def test_recall_on_power_law(self):
        data_kw = dict(n=30_000, n_users=3000, n_keys=2000, seed=3,
                       zipf=1.2)
        (want, _), (out, _) = _both(
            5, dict(eps=30.0, delta=1e-6, width=1 << 14, depth=2,
                    candidate_cap=1 << 14), data_kw=data_kw, eps=30.0)
        _assert_same_release(out, want)
        pid, pk, _ = _columns(**data_kw)
        users_of = collections.defaultdict(set)
        for u, k in zip(pid.tolist(), pk.tolist()):
            users_of[k].add(u)
        top = sorted(users_of, key=lambda k: -len(users_of[k]))[:20]
        recall = sum(1 for k in top if k in out) / 20
        assert recall >= 0.8, (recall, len(out))

    def test_parity_with_dense_single_device(self):
        params = _params(pdt, noise="GAUSSIAN")
        dense, _, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=11),
                           _dataset(pdt), params)
        sketchy, res, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=11),
                               _dataset(pdt), params, _keep_all_sketch())
        assert len(dense) > 0
        _assert_same_release(sketchy, dense)
        assert res.timings["sketch_candidates"] == len(
            np.unique(_columns()[1]))
        (want, _), _ = _both(11, keep_all=True,
                             params_kw=dict(noise="GAUSSIAN"))
        _assert_same_release(sketchy, want)

    @pytest.mark.parametrize("chunk", [None, "1500"])
    def test_parity_with_dense_streamed_phase_two(self, monkeypatch, chunk):
        """Phase 2 re-encodes the filtered rows from scratch: in one
        batch, and past ``PIPELINEDP_TPU_STREAM_CHUNK`` rows streamed, the
        release equals the dense path's on the same rows and seed."""
        if chunk is not None:
            monkeypatch.setenv("PIPELINEDP_TPU_STREAM_CHUNK", chunk)
        params = _params(pdt)
        dense, dres, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=4),
                              _dataset(pdt), params)
        sketchy, sres, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=4),
                                _dataset(pdt), params, _keep_all_sketch())
        assert len(dense) > 0
        _assert_same_release(sketchy, dense)
        assert (sres.timings.get("stream_batches") ==
                dres.timings.get("stream_batches"))
        if chunk is not None:
            assert sres.timings["stream_batches"] > 1

    def test_sketch_backend_parity(self):
        sk = dict(eps=4.0, delta=1e-7, width=1024, depth=2,
                  candidate_cap=64)
        a, _, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=3),
                       _dataset(pdt), _params(pdt),
                       SketchParams(backend="matmul", **sk))
        b, _, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=3),
                       _dataset(pdt), _params(pdt),
                       SketchParams(backend="xla", **sk))
        assert len(a) > 0
        _assert_same_release(a, b)

    def test_report_section(self):
        sk = _keep_all_kwargs()
        _, _, jengine_ = _run(pdp, JaxBackend(rng_seed=7), _dataset(pdp),
                              _params(pdp), JaxSketchParams(**sk))
        out, res, engine = _run(pdt, pdt.TorchBackend("cpu", rng_seed=7),
                                _dataset(pdt), _params(pdt),
                                SketchParams(**sk))
        assert len(out) > 0
        [report] = engine.explain_computations_report()
        [jreport] = jengine_.explain_computations_report()
        stage = [line for line in report.splitlines()
                 if "Sketch phase" in line]
        assert stage and stage == [line for line in jreport.splitlines()
                                   if "Sketch phase" in line]
        assert "eps=1000000.0" in stage[0]
        [structured] = engine.explain_computations_structured()
        assert structured["method"] == "aggregate_sketch_first"
        assert set(res.timings) >= {
            "sketch_hash_s", "sketch_bound_s", "sketch_accumulate_s",
            "sketch_select_s", "sketch_chunks", "sketch_candidates",
            "host_encode_s", "device_s", "host_decode_s"}
        assert res.binner_device == "cpu"

    def test_empty_selection_releases_nothing(self):
        sk = dict(eps=0.5, delta=1e-9, width=1024, depth=1,
                  candidate_cap=16, threshold=1e9)
        (want, wres), (out, res) = _both(1, sk)
        assert out == {} == want
        assert res.timings["sketch_candidates"] == 0
        assert "device_s" not in res.timings
        counters = obs.ledger().snapshot()["counters"]
        assert counters.get("sketch.runs") == 1
        assert (counters.get("sketch.runs") ==
                jobs.ledger().snapshot()["counters"].get("sketch.runs"))
        names = [e["name"] for e in obs.ledger().snapshot()["events"]]
        assert "sketch.empty_selection" in names

    def test_audit_record_and_report_section(self):
        """The run report's ``sketch`` section and the phase-1
        accountant's audit record equal the JAX package's."""
        sk = _keep_all_kwargs()
        jobs.reset()
        _run(pdp, JaxBackend(rng_seed=7), _dataset(pdp), _params(pdp),
             JaxSketchParams(**sk))
        jrep = jobs.build_run_report()
        obs.reset()
        out, _, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=7),
                         _dataset(pdt), _params(pdt), SketchParams(**sk))
        rep = obs.build_run_report()
        assert rep["schema_version"] == 6 and len(out) > 0
        runs = rep["sketch"]["runs"]
        assert len(runs) == 1
        rec = runs[0]
        assert rec["width"] == 2048 and rec["depth"] == 2
        assert rec["buckets_selected"] >= rec["candidates"] > 0
        assert runs == jrep["sketch"]["runs"]
        metrics = [m["metric"] for acc in rep["privacy"]["accountants"]
                   for m in acc["mechanisms"]]
        assert "sketch_candidate_selection" in metrics
        sel = [m for acc in rep["privacy"]["accountants"]
               for m in acc["mechanisms"]
               if m["metric"] == "sketch_candidate_selection"][0]
        assert sel["eps"] == pytest.approx(1e6)
        assert (rep["privacy"]["accountants"] ==
                jrep["privacy"]["accountants"])
        for name in ("sketch.runs", "selection.partitions_pre",
                     "selection.partitions_post"):
            assert rep["counters"][name] == jrep["counters"][name], name
        ev = [{k: v for k, v in e.items() if k != "ts"}
              for e in rep["events"] if e["name"] == "sketch.selected"]
        jev = [{k: v for k, v in e.items() if k != "ts"}
               for e in jrep["events"] if e["name"] == "sketch.selected"]
        assert ev == jev and len(ev) == 1

    def test_candidate_cap_is_a_bucket_cap(self):
        data_kw = dict(n_keys=500, seed=6)
        sk = dict(eps=50.0, delta=1e-6, width=4096, depth=1,
                  candidate_cap=4)
        (want, wres), (out, res) = _both(2, sk, data_kw=data_kw, eps=50.0)
        _assert_same_release(out, want)
        table = res._candidate_table
        assert set(out) <= set(table)
        cand = np.asarray(sorted(table))
        rows = bucket_ids(stable_hash64(cand), 4096, 1)
        assert 0 < len(np.unique(rows[0])) <= 4
        assert len(table) < len(np.unique(_columns(**data_kw)[1]))

    def test_unseeded_run_draws_seeds_in_jax_order(self):
        """With no ``rng_seed`` the selection seed and the phase-2 seed
        come from the host RNG, in the JAX package's order."""
        from pipelinedp_tpu.ops import noise as jnoise
        from pipelinedp_tpu_torch.ops import noise as tnoise
        sk = dict(eps=4.0, delta=1e-7, width=1024, depth=2,
                  candidate_cap=64)
        jnoise.seed_host_rng(5)
        want, _, _ = _run(pdp, JaxBackend(), _dataset(pdp), _params(pdp),
                          JaxSketchParams(**sk))
        tnoise.seed_host_rng(5)
        got, _, _ = _run(pdt, pdt.TorchBackend("cpu"), _dataset(pdt),
                         _params(pdt), SketchParams(**sk))
        assert len(got) > 0
        _assert_same_release(got, want)

    def test_rows_through_extractors(self):
        pid, pk, values = _columns(n=3000)
        rows = list(zip(pid.tolist(), pk.tolist(), values.tolist()))

        def ex(mod):
            return mod.DataExtractors(
                privacy_id_extractor=lambda r: r[0],
                partition_extractor=lambda r: r[1],
                value_extractor=lambda r: r[2])

        sk = _keep_all_kwargs()
        outs = []
        for mod, backend, spc in (
                (pdp, JaxBackend(rng_seed=2), JaxSketchParams),
                (pdt, pdt.TorchBackend("cpu", rng_seed=2), SketchParams)):
            acc = mod.NaiveBudgetAccountant(1.0, 1e-6)
            res = mod.DPEngine(acc, backend).aggregate(
                rows, _params(mod), ex(mod), sketch_first=spc(**sk))
            acc.compute_budgets()
            outs.append(dict(res))
        assert len(outs[1]) > 0
        _assert_same_release(outs[1], outs[0])

    def test_requires_privacy_ids_and_private_selection(self):
        ds = _dataset(pdt)
        acc = pdt.NaiveBudgetAccountant(1.0, 1e-6)
        engine = pdt.DPEngine(acc, pdt.TorchBackend("cpu", rng_seed=0))
        with pytest.raises(ValueError, match="public_partitions"):
            engine.aggregate(ds, _params(pdt), pdt.DataExtractors(),
                             public_partitions=["key/1"],
                             sketch_first=_keep_all_sketch())
        with pytest.raises(TypeError, match="SketchParams"):
            engine.aggregate(ds, _params(pdt), pdt.DataExtractors(),
                             sketch_first={"eps": 1.0})
        with pytest.raises(TypeError, match="SketchParams"):
            engine.aggregate(ds, _params(pdt), pdt.DataExtractors(),
                             sketch_first=JaxSketchParams(eps=1.0,
                                                          delta=0.0))
        with pytest.raises(NotImplementedError, match="fused"):
            pdt.DPEngine(pdt.NaiveBudgetAccountant(1.0, 1e-6),
                         pdt.LocalBackend()).aggregate(
                ds, _params(pdt), pdt.DataExtractors(),
                sketch_first=_keep_all_sketch())
        bounded = pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT], max_contributions=3,
            contribution_bounds_already_enforced=True)
        with pytest.raises(NotImplementedError, match="privacy ids"):
            engine.aggregate(pdt.ArrayDataset(None, ds.partition_keys),
                             bounded, pdt.DataExtractors(),
                             sketch_first=_keep_all_sketch())

        class Custom(pdt.CustomCombiner):
            def create_accumulator(self, values):
                return 0

            def merge_accumulators(self, a, b):
                return a + b

            def compute_metrics(self, acc):
                return acc

            def explain_computation(self):
                return "custom"

            def request_budget(self, budget_accountant):
                pass

        custom = pdt.AggregateParams(
            metrics=None, max_partitions_contributed=1,
            max_contributions_per_partition=1, custom_combiners=[Custom()])
        with pytest.raises(NotImplementedError, match="fused-plane"):
            engine.aggregate(ds, custom, pdt.DataExtractors(),
                             sketch_first=_keep_all_sketch())

    def test_rebind_rows_refused_after_execution(self):
        out, res, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=1),
                           _dataset(pdt), _params(pdt), _keep_all_sketch())
        assert len(out) > 0
        with pytest.raises(RuntimeError, match="rebind rows"):
            res._inner.rebind_rows(_dataset(pdt))


# ---------------------------------------------------------------------------
# Faults
# ---------------------------------------------------------------------------


class TestFaults:

    def test_kill_mid_sketch_drains_to_zero_orphans(self):
        ds = _dataset(pdt, n=20_000, n_users=4000, n_keys=1500)
        # tiny chunks force a multi-chunk stream; the kill lands on
        # chunk 1's dispatch, after chunk 2 may already be staging
        sk = _keep_all_sketch(chunk_rows=512)
        before = {t.name for t in threading.enumerate()
                  if t.name.startswith("pdp-")}
        with faults.injected_faults(
                faults.FaultPlan(fail_sketch_chunks=(1,))):
            with pytest.raises(faults.ChunkFailure, match="sketch"):
                _run(pdt, pdt.TorchBackend("cpu", rng_seed=0), ds,
                     _params(pdt), sk)
        for t in threading.enumerate():
            if (t.name.startswith("pdp-") and t.name not in before
                    and t.is_alive()):
                t.join(timeout=5.0)
                assert not t.is_alive(), f"orphan thread {t.name}"
        # a later run in the same process is healthy, and chunking
        # does not change the release
        out, res, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=0), ds,
                           _params(pdt), sk)
        assert res.timings["sketch_chunks"] > 2
        whole, _, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=0), ds,
                           _params(pdt), _keep_all_sketch())
        assert len(out) > 0
        _assert_same_release(out, whole)
        counters = obs.ledger().snapshot()["counters"]
        assert counters.get("faults.injected", 0) >= 1

    def test_fault_plan_default_has_no_sketch_kill(self):
        assert faults.FaultPlan().fail_sketch_chunks == ()
        faults.check_sketch_chunk(0)
        with faults.injected_faults(faults.FaultPlan(fail_sketch_chunks=(2,))):
            faults.check_sketch_chunk(1)
            with pytest.raises(faults.ChunkFailure, match="sketch chunk 2"):
                faults.check_sketch_chunk(2)


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------


class TestKnobs:

    def test_cold_start_defaults_match_the_jax_registry(self):
        from pipelinedp_tpu.plan import knobs
        sp = SketchParams(eps=1.0, delta=0.0)
        assert sp.resolved_width() == knobs.BY_NAME["sketch_width"].default
        assert sp.resolved_depth() == knobs.BY_NAME["sketch_depth"].default
        assert (sp.resolved_candidate_cap() ==
                knobs.BY_NAME["sketch_candidate_cap"].default)
        assert (sp.resolved_backend() ==
                knobs.BY_NAME["sketch_backend"].default)
        from pipelinedp_tpu_torch.plan import knobs as port_knobs
        for name in ("sketch_width", "sketch_depth", "sketch_candidate_cap",
                     "sketch_backend"):
            port, ref = port_knobs.BY_NAME[name], knobs.BY_NAME[name]
            assert (port.env_var, port.default, port.dp_safe) == (
                ref.env_var, ref.default, ref.dp_safe)
        assert sp.chunk_rows == JaxSketchParams(eps=1.0,
                                                delta=0.0).chunk_rows
        assert sketch_params_mod.WIDTH_MULTIPLE == 256

    def test_sketch_knobs_registered(self):
        from pipelinedp_tpu_torch.plan import knobs
        for name, dp_safe in (("sketch_width", False),
                              ("sketch_depth", False),
                              ("sketch_candidate_cap", False),
                              ("sketch_backend", True)):
            spec = knobs.BY_NAME[name]
            assert spec.dp_safe is dp_safe, name
            assert spec.seam is None  # SketchParams is the injection
            assert spec.doc and spec.unit
        v, src = knobs.resolve_value(knobs.BY_NAME["sketch_backend"],
                                     {"sketch_backend": "xla"})
        assert (v, src) == ("xla", "plan")
        v, src = knobs.resolve_value(knobs.BY_NAME["sketch_width"],
                                     {"sketch_width": 512})
        assert (v, src) == (1 << 16, "default")

    def test_autotune_sweeps_sketch_backend(self):
        from pipelinedp_tpu_torch import plan as plan_mod
        cands = plan_mod.autotune_candidates()
        assert {"sketch_backend": "xla"}.items() <= cands[-1].items()
        assert all("sketch_width" not in c for c in cands)

    def test_plan_file_moves_the_backend_not_the_release(
            self, tmp_path, monkeypatch):
        """A plan file may move the dp-safe ``sketch_backend`` (the
        binner) and nothing of the selection; the release is the same
        bits as the cold start's."""
        from pipelinedp_tpu_torch import plan as plan_mod
        sk = dict(eps=3.0, delta=1e-6, width=1024, depth=2,
                  candidate_cap=64)
        cold, _, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=4),
                          _dataset(pdt), _params(pdt), SketchParams(**sk))
        monkeypatch.setenv(plan_mod.planner.ENV_DIR, str(tmp_path))
        plan_mod.write_plan(plan_mod.build_plan(
            {"default": {"knobs": {"sketch_backend": "xla"}}},
            plan_mod.CostModel(), "cpu", created_by="test"))
        planned, _, _ = _run(pdt, pdt.TorchBackend("cpu", rng_seed=4),
                             _dataset(pdt), _params(pdt),
                             SketchParams(**sk))
        assert SketchParams(**sk).resolved_backend() == "xla"
        _assert_same_release(planned, cold)
        rec = obs.build_run_report()["sketch"]["runs"][-1]
        assert rec["backend"] == "xla"

    def test_env_override_resolves(self, monkeypatch):
        monkeypatch.setenv("PIPELINEDP_TPU_SKETCH_WIDTH", "1000")
        # SketchParams rounds the resolved width to the radix multiple
        assert SketchParams(eps=1.0, delta=0.0).resolved_width() == 1024
        monkeypatch.setenv("PIPELINEDP_TPU_SKETCH_BACKEND", "xla")
        assert SketchParams(eps=1.0, delta=0.0).resolved_backend() == "xla"
        monkeypatch.setenv("PIPELINEDP_TPU_SKETCH_BACKEND", "pallas")
        assert (SketchParams(eps=1.0, delta=0.0).resolved_backend() ==
                "matmul")
        monkeypatch.setenv("PIPELINEDP_TPU_SKETCH_CANDIDATE_CAP", "33")
        assert SketchParams(eps=1.0,
                            delta=0.0).resolved_candidate_cap() == 33

    def test_explicit_params_outrank_env(self, monkeypatch):
        monkeypatch.setenv("PIPELINEDP_TPU_SKETCH_DEPTH", "7")
        assert SketchParams(eps=1.0, delta=0.0,
                            depth=3).resolved_depth() == 3
        assert SketchParams(eps=1.0, delta=0.0).resolved_depth() == 7

    def test_params_validation(self):
        with pytest.raises(ValueError, match="eps"):
            SketchParams(eps=0.0, delta=0.0)
        with pytest.raises(ValueError, match="delta"):
            SketchParams(eps=1.0, delta=1.0)
        with pytest.raises(ValueError, match="width"):
            SketchParams(eps=1.0, delta=0.0, width=-5)
        with pytest.raises(ValueError, match="backend"):
            SketchParams(eps=1.0, delta=0.0, backend="pallas")
        with pytest.raises(ValueError, match="chunk_rows"):
            SketchParams(eps=1.0, delta=0.0, chunk_rows=0)

    def test_resolved_l0(self):
        sp = SketchParams(eps=1.0, delta=0.0)
        assert sp.resolved_l0(_params(pdt, l0=5)) == 5
        assert SketchParams(eps=1.0, delta=0.0,
                            max_buckets_contributed=2).resolved_l0(
                                _params(pdt, l0=5)) == 2


# ---------------------------------------------------------------------------
# The peeker shim
# ---------------------------------------------------------------------------


class TestPeekerShim:

    def test_data_peeker_sketch_routes_through_sketch_peek(self):
        from pipelinedp_tpu_torch import peeker
        rows = [(u, f"p{u % 3}", 1.0) for u in range(30)]
        pk = peeker.DataPeeker(pdt.LocalBackend())
        params = peeker.SampleParams(number_of_sampled_partitions=3,
                                     metrics=[pdt.Metrics.COUNT])
        ex = pdt.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                partition_extractor=lambda r: r[1],
                                value_extractor=lambda r: r[2])
        out = list(pk.sketch(rows, params, ex))
        assert len(out) == 30
        assert all(v == 1 and pcount == 1 for _, v, pcount in out)

    def test_sketch_checks_metrics(self):
        from pipelinedp_tpu_torch import peeker
        from pipelinedp_tpu_torch.sketch import peek
        pk = peeker.DataPeeker(pdt.LocalBackend())
        ex = pdt.DataExtractors(privacy_id_extractor=lambda r: r[0],
                                partition_extractor=lambda r: r[1],
                                value_extractor=lambda r: r[2])
        with pytest.raises(ValueError, match="metrics"):
            pk.sketch([], peeker.SampleParams(1), ex)
        with pytest.raises(ValueError, match="COUNT or SUM"):
            peek.non_private_sketch(
                pdt.LocalBackend(), [],
                peeker.SampleParams(1, metrics=[pdt.Metrics.MEAN]), ex)
