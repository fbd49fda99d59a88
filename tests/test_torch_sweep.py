"""The utility-analysis sweep of the port (``pipelinedp_tpu_torch/analysis``)
against the JAX package's fused sweep (``pipelinedp_tpu/analysis/
jax_sweep.py``) on the CPU, bit for bit.

The same inputs, made from a numpy seed, go through
``perform_utility_analysis`` on ``JaxBackend`` and on
``TorchBackend(device="cpu")``; every field of every ``AggregateMetrics``
(per-metric error metrics and partition-selection metrics) must be
bit-equal, and so must the per-partition rows of ``return_per_partition``
and stage A's per-row outputs. No field is held to a tolerance. The cases
follow ``tests/test_analysis.py``: the fused sweep's cases, per-config sum
bounds, partition sampling, per-partition rows, mixed mechanisms,
pre-aggregated input, the megasweep's walked-vs-batched parity (in the
port, and against the JAX package, with the chunk cap shrunk so the chunk
loop runs), the three keep-probability regimes (sigma = 0, the window,
Gauss-Hermite) under each selection strategy, random configurations, and
the raises that name the ROADMAP step of what is not ported.
"""

import dataclasses
import operator

import numpy as np
import pytest
import torch

import pipelinedp_tpu as pdp
from pipelinedp_tpu import analysis as jan
from pipelinedp_tpu.analysis import jax_sweep
from pipelinedp_tpu.backends import JaxBackend

import pipelinedp_tpu_torch as pt
from pipelinedp_tpu_torch import analysis as tan
from pipelinedp_tpu_torch.analysis import torch_sweep

def _enum(pmod, v):
    """The same enum member in the other package (matched by name)."""
    if isinstance(v, (list, tuple)):
        return [_enum(pmod, x) for x in v]
    for cls in ("NoiseKind", "PartitionSelectionStrategy"):
        if type(v).__name__ == cls:
            return getattr(getattr(pmod, cls), v.name)
    return v


def _options(amod, pmod, metrics=("COUNT",), multi=None, eps=1.0,
             delta=1e-6, sampling=1, pre=False, **params):
    kw = {k: _enum(pmod, v) for k, v in params.items()}
    kw.setdefault("max_partitions_contributed", 3)
    kw.setdefault("max_contributions_per_partition", 2)
    m = None
    if multi:
        m = amod.MultiParameterConfiguration(
            **{k: _enum(pmod, v) for k, v in multi.items()})
    return amod.UtilityAnalysisOptions(
        epsilon=eps, delta=delta,
        aggregate_params=pmod.AggregateParams(
            metrics=[getattr(pmod.Metrics, x) for x in metrics], **kw),
        multi_param_configuration=m, partitions_sampling_prob=sampling,
        pre_aggregated_data=pre)


def _columns(n=4000, users=300, parts=25, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, users, n), rng.integers(0, parts, n),
            rng.uniform(0, 5, n))


def _run(amod, pmod, cols, opts, public=None, pp=False, backend=None):
    ds = pmod.ArrayDataset(*cols) if isinstance(cols, tuple) else cols
    if backend is None:
        backend = (JaxBackend() if pmod is pdp else
                   pt.TorchBackend(device="cpu"))
    ex = pmod.DataExtractors()
    if isinstance(cols, list):
        ex = amod.PreAggregateExtractors(
            partition_extractor=operator.itemgetter(0),
            preaggregate_extractor=operator.itemgetter(1))
    out = amod.perform_utility_analysis(ds, backend, opts, ex,
                                        public_partitions=public,
                                        return_per_partition=pp)
    if pp:
        res, rows = out
        return list(res)[0], dict(rows)
    return list(out)[0], None


def _both(cols, public=None, pp=False, **opt_kw):
    """(JAX result, port result, JAX rows, port rows)."""
    j, jrows = _run(jan, pdp, cols, _options(jan, pdp, **opt_kw), public, pp)
    t, trows = _run(tan, pt, cols, _options(tan, pt, **opt_kw), public, pp)
    return j, t, jrows, trows


def _fields(x):
    if x is None:
        return None
    return {k: (v.name if hasattr(v, "name") else v)
            for k, v in dataclasses.asdict(x).items()
            if k != "input_aggregate_params"}


def _assert_bit_equal(a, b, label=""):
    """Every field bit-equal (floats by their bits, lists elementwise)."""
    assert (a is None) == (b is None), label
    if a is None:
        return
    assert set(a) == set(b), label
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, float) or isinstance(x, list):
            np.testing.assert_array_equal(
                np.asarray(x, np.float64).view(np.uint64),
                np.asarray(y, np.float64).view(np.uint64),
                err_msg=f"{label}.{k}")
        else:
            assert x == y, (label, k, x, y)


def _assert_results_equal(jres, tres):
    assert len(jres) == len(tres)
    for i, (a, b) in enumerate(zip(jres, tres)):
        for f in ("count_metrics", "sum_metrics",
                  "privacy_id_count_metrics",
                  "partition_selection_metrics"):
            _assert_bit_equal(_fields(getattr(a, f)),
                              _fields(getattr(b, f)), f"cfg{i}.{f}")


def _assert_rows_equal(jrows, trows):
    assert [str(k) for k in jrows] == [str(k) for k in trows]
    for k in jrows:
        assert len(jrows[k]) == len(trows[k])
        for a, b in zip(jrows[k], trows[k]):
            if isinstance(a, float):
                assert np.float64(a).view(np.uint64) == np.float64(
                    b).view(np.uint64), (k, a, b)
            else:
                _assert_bit_equal(_fields(a), _fields(b), f"pk {k}")


S = pdp.PartitionSelectionStrategy
N = pdp.NoiseKind


class TestFusedSweep:
    """``tests/test_analysis.py::TestFusedSweep``'s cases, port vs JAX."""

    def test_count_multi_config_truncated_geometric(self):
        j, t, _, _ = _both(_columns(), eps=2.0, multi=dict(
            max_partitions_contributed=[1, 3, 9, 27],
            max_contributions_per_partition=[1, 2, 4, 8]),
            max_partitions_contributed=4)
        assert len(t) == 4
        _assert_results_equal(j, t)

    def test_all_metrics_gaussian(self):
        j, t, _, _ = _both(
            _columns(seed=1), metrics=("COUNT", "SUM", "PRIVACY_ID_COUNT"),
            noise_kind=N.GAUSSIAN, min_sum_per_partition=0.0,
            max_sum_per_partition=20.0)
        _assert_results_equal(j, t)
        assert t[0].sum_metrics is not None

    def test_public_partitions_with_empty(self):
        j, t, _, _ = _both(_columns(parts=10, seed=2),
                           public=list(range(14)), max_partitions_contributed=2)
        assert t[0].partition_selection_metrics is None
        _assert_results_equal(j, t)

    @pytest.mark.parametrize("strategy", [S.LAPLACE_THRESHOLDING,
                                          S.GAUSSIAN_THRESHOLDING])
    def test_thresholding_strategies(self, strategy):
        j, t, _, _ = _both(_columns(seed=3),
                           partition_selection_strategy=strategy)
        _assert_results_equal(j, t)

    def test_chunked_configs_match_jax_and_one_chunk(self, monkeypatch):
        cols = _columns(n=1000, users=100, parts=8)
        kw = dict(multi=dict(max_partitions_contributed=[1, 2, 3, 4, 5],
                             max_contributions_per_partition=[1, 1, 2, 2,
                                                              3]))
        one = _run(tan, pt, cols, _options(tan, pt, **kw))[0]
        monkeypatch.setattr(jax_sweep, "_CHUNK_CAP", 2)
        monkeypatch.setattr(torch_sweep, "_CHUNK_CAP", 2)
        j, t, _, _ = _both(cols, **kw)
        _assert_results_equal(j, t)
        _assert_results_equal(one, t)


class TestEmptyInput:

    @pytest.mark.parametrize("public", [None, [1, 2, 3]])
    def test_empty_dataset(self, public):
        empty = (np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0))
        j, t, _, _ = _both(empty, public=public)
        _assert_results_equal(j, t)


class TestStageA:
    """Stage A's per-row outputs (marker, pk_safe, count_u, sum_u,
    npart_u) on the real rows, port vs ``jax_sweep._preagg_kernel``."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_preagg_matches_jax(self, seed):
        from pipelinedp_tpu.jax_engine import encode, pad_and_put
        pid, pk, v = _columns(n=3000, users=200, parts=30, seed=seed)
        enc = encode(pdp.ArrayDataset(pid, pk, v), pdp.DataExtractors(),
                     None, None)
        jout = jax_sweep._preagg_kernel(*pad_and_put(enc, None))
        from pipelinedp_tpu_torch.torch_engine import encode as tencode
        tenc = tencode(pt.ArrayDataset(pid, pk, v), pt.DataExtractors())
        tout = torch_sweep._preagg_kernel(
            torch.from_numpy(tenc.pid), torch.from_numpy(tenc.pk),
            torch.from_numpy(tenc.values))
        n = len(pid)
        for name, a, b in zip(("marker", "pk_safe", "count_u", "sum_u",
                               "npart_u"), jout, tout):
            a = np.asarray(a)[:n]
            b = b.numpy()
            np.testing.assert_array_equal(a.view(np.uint8) if a.dtype == bool
                                          else a.view(np.uint32),
                                          b.view(np.uint8) if b.dtype == bool
                                          else b.view(np.uint32),
                                          err_msg=name)


class TestFusedSweepMultiSumBounds:

    def test_sum_bound_vectors(self):
        j, t, _, _ = _both(
            _columns(n=3000, users=150, parts=20, seed=11), metrics=("SUM",),
            min_sum_per_partition=0.0, max_sum_per_partition=5.0,
            multi=dict(min_sum_per_partition=[0.0, 0.0, 1.0],
                       max_sum_per_partition=[2.0, 10.0, 60.0]))
        _assert_results_equal(j, t)
        errs = [f.sum_metrics.error_linf_max_expected for f in t]
        assert errs[0] <= errs[1] <= errs[2] <= 0.0


class TestFusedSweepSampling:

    @pytest.mark.parametrize("public", [False, True])
    def test_sampling(self, public):
        cols = _columns(n=3000, users=200, parts=30, seed=9)
        pub = sorted(np.unique(cols[1]).tolist()) if public else None
        j, t, _, _ = _both(cols, public=pub, sampling=0.5)
        _assert_results_equal(j, t)
        if not public:
            assert t[0].partition_selection_metrics.num_partitions < 30


class TestFusedSweepPerPartition:

    def test_rows_private(self):
        j, t, jr, tr = _both(_columns(n=2000, users=150, parts=8, seed=3),
                             pp=True, eps=2.0, multi=dict(
                                 max_partitions_contributed=[1, 3],
                                 max_contributions_per_partition=[2, 4]))
        _assert_results_equal(j, t)
        _assert_rows_equal(jr, tr)

    def test_rows_public_with_empty_partition(self):
        j, t, jr, tr = _both(_columns(n=1500, users=100, parts=6, seed=4),
                             pp=True, public=list(range(8)), eps=1.5,
                             metrics=("COUNT", "SUM"),
                             min_sum_per_partition=0.0,
                             max_sum_per_partition=8.0)
        assert set(tr) == set(range(8))
        _assert_results_equal(j, t)
        _assert_rows_equal(jr, tr)

    def test_byte_cap_raises_host_graph_step(self, monkeypatch):
        """Past the fetch cap both packages rerun the host analysis graph
        on the sweep's backend (the test's name is from when the port
        raised here): results and rows bit for bit under one
        ``seed_host_rng`` seed."""
        from pipelinedp_tpu.ops import noise as jnoise
        from pipelinedp_tpu_torch.ops import noise as tnoise
        monkeypatch.setattr(torch_sweep, "_PP_BYTE_CAP", 64)
        monkeypatch.setattr(jax_sweep, "_PP_BYTE_CAP", 64)
        cols = _columns(n=800, users=80, parts=5, seed=5)
        jnoise.seed_host_rng(9)
        j, jr = _run(jan, pdp, cols, _options(jan, pdp, eps=2.0), pp=True)
        tnoise.seed_host_rng(9)
        t, tr = _run(tan, pt, cols, _options(tan, pt, eps=2.0), pp=True)
        _assert_results_equal(j, t)
        _assert_rows_equal(jr, tr)
        assert len(tr) == 5


class TestFusedSweepMixedMechanisms:

    def test_per_config_mechanism_vectors(self):
        j, t, _, _ = _both(
            _columns(n=3000, users=150, parts=20, seed=7), eps=2.0,
            multi=dict(max_partitions_contributed=[1, 3, 5, 8],
                       max_contributions_per_partition=[2, 2, 1, 3],
                       noise_kind=[N.LAPLACE, N.GAUSSIAN, N.GAUSSIAN,
                                   N.LAPLACE],
                       partition_selection_strategy=[
                           S.TRUNCATED_GEOMETRIC, S.LAPLACE_THRESHOLDING,
                           S.GAUSSIAN_THRESHOLDING,
                           S.TRUNCATED_GEOMETRIC]))
        _assert_results_equal(j, t)


class TestFusedSweepPreAggregated:

    @pytest.mark.parametrize("metric", ["COUNT", "SUM"])
    def test_pre_aggregated_rows(self, metric):
        rng = np.random.default_rng(11)
        rows = [(f"p{rng.integers(0, 12)}",
                 (int(rng.integers(1, 6)), float(rng.uniform(0, 9)),
                  int(rng.integers(1, 5))))
                for _ in range(400)]
        kw = dict(metrics=(metric,), pre=True, eps=1.5,
                  multi=dict(max_partitions_contributed=[1, 2, 6]))
        if metric == "SUM":
            kw.update(min_sum_per_partition=0.0, max_sum_per_partition=6.0)
        j, _ = _run(jan, pdp, rows, _options(jan, pdp, **kw))
        t, _ = _run(tan, pt, rows, _options(tan, pt, **kw))
        assert len(t) == 3
        _assert_results_equal(j, t)


class TestKeepProbabilityRegimes:
    """Data that reaches each regime of ``_keep_probability``: sigma = 0
    (every user's keep probability 0 or 1: the point value), a small
    sigma (the refined-normal window) and sigma * 8 > 64 (Gauss-Hermite),
    under each selection strategy, with the per-partition keep
    probabilities compared too."""

    @staticmethod
    def _regime_columns(regime):
        rng = np.random.default_rng(21)
        if regime == "point":
            return (rng.integers(0, 200, 2000), rng.integers(0, 4, 2000),
                    rng.uniform(0, 5, 2000)), 8
        if regime == "window":
            return _columns(n=3000, users=250, parts=12, seed=22), 4
        # Gauss-Hermite: up to 1500 users a partition at keep prob 1/3.
        U = 1500
        pid = np.repeat(np.arange(U), 10)
        pk = np.tile(np.arange(10), U)
        keep = (np.arange(U)[:, None] % 10 <=
                np.arange(10)[None, :]).reshape(-1)
        return (pid[keep], pk[keep], rng.uniform(0, 5, keep.sum())), 3

    @pytest.mark.parametrize("strategy", list(S))
    @pytest.mark.parametrize("regime", ["point", "window", "gauss_hermite"])
    def test_regime(self, regime, strategy, monkeypatch):
        cols, l0 = self._regime_columns(regime)
        eps = 0.1 if regime == "gauss_hermite" else 1.0
        sigmas = []
        keep_probability = torch_sweep._keep_probability

        def spy(strategy, mu, var, *args):
            sigmas.append(torch.sqrt(var.double()).numpy())
            return keep_probability(strategy, mu, var, *args)

        monkeypatch.setattr(torch_sweep, "_keep_probability", spy)
        j, t, jr, tr = _both(cols, pp=True, eps=eps,
                             partition_selection_strategy=strategy,
                             max_partitions_contributed=l0)
        _assert_results_equal(j, t)
        _assert_rows_equal(jr, tr)
        # The regime is reached by the real partitions' selection moments.
        sigma = sigmas[0][:len(np.unique(cols[1]))]
        if regime == "point":
            assert np.all(sigma < 1e-9)
        elif regime == "window":
            assert np.all((sigma > 0) & (sigma * 8 <= 64))
        else:  # the first partition stays in the window
            assert np.count_nonzero(sigma * 8 > 64) >= len(sigma) - 1
        keep = np.asarray([row[0] for row in tr.values()])
        assert np.any((keep > 0.01) & (keep < 0.99)) or regime == "point"


class TestMegasweepWidthParity:
    """PARITY row 41 in the port: walked (one config a chunk) and
    batched sweeps are bit-identical per config, at widths that leave a
    padded tail too, and equal the JAX package's."""

    GRID = 16

    @staticmethod
    def _cols():
        rng = np.random.default_rng(23)
        n = 12_000
        return (rng.integers(0, 800, n),
                (rng.zipf(1.3, n) % 120).astype(np.int64),
                rng.uniform(0, 10, n))

    @classmethod
    def _opts(cls, amod, pmod):
        side = int(np.sqrt(cls.GRID))
        pairs = [(a, b) for a in range(1, side + 1)
                 for b in range(1, side + 1)]
        return _options(amod, pmod, multi=dict(
            max_partitions_contributed=[p[0] for p in pairs],
            max_contributions_per_partition=[p[1] for p in pairs]),
            max_partitions_contributed=4, noise_kind=N.LAPLACE)

    def test_walked_vs_batched_bit_identical(self, monkeypatch):
        cols = self._cols()
        monkeypatch.delenv(torch_sweep._CONFIG_BATCH_ENV, raising=False)
        ref = _run(tan, pt, cols, self._opts(tan, pt))[0]
        for width in (1, 3, 5, 7, 8):
            monkeypatch.setenv(torch_sweep._CONFIG_BATCH_ENV, str(width))
            got = _run(tan, pt, cols, self._opts(tan, pt))[0]
            _assert_results_equal(ref, got)

    def test_matches_jax_with_the_chunk_loop(self, monkeypatch):
        cols = self._cols()
        monkeypatch.setattr(jax_sweep, "_CHUNK_CAP", 4)
        monkeypatch.setattr(torch_sweep, "_CHUNK_CAP", 4)
        j = _run(jan, pdp, cols, self._opts(jan, pdp))[0]
        t = _run(tan, pt, cols, self._opts(tan, pt))[0]
        _assert_results_equal(j, t)


class TestFuzz:
    """Random configurations (the JAX package's
    ``TestFusedSweepFuzz`` draw), port vs JAX, bit for bit."""

    @pytest.mark.parametrize("seed", range(6))
    def test_random_config(self, seed):
        rng = np.random.default_rng(1000 + seed)
        cols = _columns(n=int(rng.integers(500, 4000)),
                        users=int(rng.integers(30, 400)),
                        parts=int(rng.integers(5, 40)), seed=seed)
        metric = ["COUNT", "PRIVACY_ID_COUNT", "SUM"][int(rng.integers(0,
                                                                       3))]
        kw = dict(metrics=(metric,),
                  noise_kind=N.LAPLACE if rng.random() < 0.5 else N.GAUSSIAN,
                  max_partitions_contributed=int(rng.integers(1, 6)),
                  max_contributions_per_partition=int(rng.integers(1, 4)),
                  partition_selection_strategy=list(S)[int(rng.integers(0,
                                                                        3))])
        if metric == "SUM":
            kw.update(min_sum_per_partition=0.0,
                      max_sum_per_partition=float(rng.uniform(2, 30)))
        n_cfg = int(rng.integers(1, 5))
        if n_cfg > 1:
            kinds = strategies = None
            if rng.random() < 0.4:
                kinds = [list(N)[int(i)] for i in rng.integers(0, 2, n_cfg)]
            if rng.random() < 0.4:
                strategies = [list(S)[int(i)]
                              for i in rng.integers(0, 3, n_cfg)]
            kw["multi"] = dict(
                max_partitions_contributed=sorted(
                    int(x) for x in rng.integers(1, 12, n_cfg)),
                max_contributions_per_partition=[
                    int(x) for x in rng.integers(1, 5, n_cfg)],
                noise_kind=kinds, partition_selection_strategy=strategies)
        kw.update(eps=float(rng.uniform(0.3, 5.0)),
                  delta=float(10.0**-rng.integers(4, 9)),
                  sampling=(1 if rng.random() < 0.5 else
                            float(rng.uniform(0.3, 0.9))))
        public = (sorted(np.unique(cols[1]).tolist())
                  if rng.random() < 0.4 else None)
        j, t, _, _ = _both(cols, public=public, **kw)
        _assert_results_equal(j, t)


class TestNotPorted:
    """What the port once left out, and how it answers now."""

    def test_mesh_raises_step_5(self):
        """The mesh is ported (ROADMAP step 5a; the test's name is from
        when the port raised here, ``tests/test_torch_sweep_mesh.py`` runs
        the sweep on one): a mesh that is no ``parallel.Mesh`` raises by
        name."""
        opts = _options(tan, pt)
        with pytest.raises(TypeError, match="parallel.Mesh"):
            torch_sweep.build_fused_sweep(
                pt.ArrayDataset(*_columns(n=100)), opts, pt.DataExtractors(),
                None, pt.NaiveBudgetAccountant(1.0, 1e-6),
                pt.TorchBackend(device="cpu"), device="cpu", mesh=object())
        with pytest.raises(TypeError, match="parallel.Mesh"):
            pt.TorchBackend(device="cpu", mesh=object())

    def test_host_graph_raises_step_2(self):
        """What the fused sweep does not take runs the host analysis graph
        in both packages (the test's name is from when the port raised
        here), bit for bit under one ``seed_host_rng`` seed: a host
        backend, the host graph on ``TorchBackend``'s host ops,
        ``preaggregate`` and the pre-aggregated histograms; SUM with
        per-value bounds only fails the fused gates and the host graph's
        clip in both."""
        from pipelinedp_tpu.analysis import utility_analysis as jua
        from pipelinedp_tpu.ops import noise as jnoise
        from pipelinedp_tpu_torch.analysis import utility_analysis as tua
        from pipelinedp_tpu_torch.ops import noise as tnoise
        cols = _columns(n=300, users=40, parts=6, seed=8)
        kw = dict(metrics=("COUNT", "PRIVACY_ID_COUNT"), eps=2.0)
        jnoise.seed_host_rng(5)
        j, _ = _run(jan, pdp, cols, _options(jan, pdp, **kw),
                    backend=pdp.LocalBackend())
        tnoise.seed_host_rng(5)
        t, _ = _run(tan, pt, cols, _options(tan, pt, **kw),
                    backend=pt.LocalBackend())
        _assert_results_equal(j, t)
        assert len(t) == 1 and t[0].count_metrics is not None

        out = []
        for ua, pmod, amod, noise, backend in (
                (jua, pdp, jan, jnoise, JaxBackend()),
                (tua, pt, tan, tnoise, pt.TorchBackend(device="cpu"))):
            noise.seed_host_rng(6)
            res = ua._host_analysis(pmod.ArrayDataset(*cols), backend,
                                    _options(amod, pmod, **kw),
                                    pmod.DataExtractors(), None, False)
            out.append(list(res)[0])
        _assert_results_equal(*out)

        bad = {}
        for amod, pmod in ((jan, pdp), (tan, pt)):
            opts = _options(amod, pmod, metrics=("SUM",), min_value=0.0,
                            max_value=1.0)
            backend = (JaxBackend() if pmod is pdp else
                       pt.TorchBackend(device="cpu"))
            with pytest.raises(ValueError) as err:
                _run(amod, pmod, cols, opts, backend=backend)
            bad[pmod] = str(err.value)
        assert bad[pdp] == bad[pt]

        rows = [tuple(r) for r in zip(*(c.tolist() for c in cols))]
        ex = {m: m.DataExtractors(operator.itemgetter(0),
                                  operator.itemgetter(1),
                                  operator.itemgetter(2)) for m in (pdp, pt)}
        pre = {m: sorted(a.preaggregate(rows, m.LocalBackend(), ex[m],
                                        partitions_sampling_prob=0.7),
                         key=repr)
               for a, m in ((jan, pdp), (tan, pt))}
        assert pre[pdp] == pre[pt] and len(pre[pt]) > 0
        pex = operator.itemgetter(0), operator.itemgetter(1)
        hist = {m: list(a.compute_dataset_histograms_on_preaggregated_data(
            pre[m], a.PreAggregateExtractors(*pex),
            JaxBackend() if m is pdp else pt.TorchBackend(device="cpu")))[0]
            for a, m in ((jan, pdp), (tan, pt))}
        for name in ("l0_contributions_histogram",
                     "linf_contributions_histogram",
                     "count_per_partition_histogram",
                     "count_privacy_id_per_partition"):
            a = [(b.lower, b.count, b.sum, b.max)
                 for b in getattr(hist[pdp], name).bins]
            b_ = [(b.lower, b.count, b.sum, b.max)
                  for b in getattr(hist[pt], name).bins]
            assert a == b_ and a, name

    def test_sweep_runs_on_the_backend_device(self):
        res = tan.perform_utility_analysis(
            pt.ArrayDataset(*_columns(n=200)), pt.TorchBackend(device="cpu"),
            _options(tan, pt), pt.DataExtractors())
        assert isinstance(res, torch_sweep.LazySweepResult)
        assert res._device == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                pt.TorchBackend()
