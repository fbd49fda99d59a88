"""The port's AST invariant checker (``pipelinedp_tpu_torch/lint/``), the
port of ``tests/test_lint.py`` for the rules that carry over:

* a bad and a clean fixture for every rule, at port paths: the bad one
  proves the rule fires, the clean one that the blessed location or shape
  passes;
* the registry test: every reference rule but the two about JAX has an
  owner here, and every registered rule has its fixture pair;
* the rule shapes beyond the pair, in the port's forms (qualified stager
  sites, torch draws, ProcessGroup collectives, the kernel build);
* suppression semantics: reasoned suppressions silence and are counted,
  reasonless or unknown-rule ones are findings, docstrings are inert;
* the whole-tree run: zero unsuppressed findings, every suppression
  reasoned and used;
* the CLI, and ``--json`` round-tripped through the port's
  ``obs/store.py``;
* the seeded regressions, in port form: a ``time.sleep`` in
  ``streaming.py``, an atomic write under a lock in
  ``serve/budget_ledger.py``, a raw ``np.random`` draw in
  ``torch_engine.py``.

JAX cases with no counterpart, because their rules are about JAX and are
not carried over (``rules.NOT_CARRIED``): the ``jit-staticness`` and
``nofoldin`` fixture pairs,
``TestRuleShapes::test_jit_staticness_assigned_program_and_knob_read``,
``test_jit_staticness_megasweep_config_constants`` and
``test_jit_staticness_time_read``. ``test_nopallas_call_sites_without_
import`` and ``TestVectorSurfaces``' nopallas cases become
``kernel-build-confinement`` cases.
"""

import json
import os

import pytest

from pipelinedp_tpu_torch import lint
from pipelinedp_tpu_torch.lint import cli, engine
from pipelinedp_tpu_torch.lint import rules as rules_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P = "pipelinedp_tpu_torch/"

CARRIED = {"nosleep", "nostager", "noperf", "noartifacts", "nocost",
           "noknobs", "nopallas", "noserve", "rng-purity",
           "blocking-under-lock", "fusion-masking", "sketch-confinement",
           "socket-confinement", "collective-confinement"}
PORT_IDS = (CARRIED - {"nopallas"}) | {"kernel-build-confinement"}


def findings_for(rule_id, source, rel):
    """Unsuppressed findings of ONE rule over a virtual file."""
    result = engine.lint_source(source, rel,
                                rules=[rules_mod.get(rule_id)])
    return [f for f in result.findings if f.rule == rule_id]


def _real(rel):
    with open(os.path.join(REPO, rel), encoding="utf-8") as f:
        return f.read()


# ---------------------------------------------------------------------
# fixture pairs: (bad_source, bad_rel), (clean_source, clean_rel)
# ---------------------------------------------------------------------

FIXTURES = {
    "nosleep": {
        # The seeded regression: a time.sleep in streaming.py.
        "bad": ("import time\n\n"
                "def wait():\n"
                "    time.sleep(0.5)\n",
                P + "streaming.py"),
        "clean": ("import time\n\n"
                  "def sleep(clock, s):\n"
                  "    time.sleep(s)\n",
                  P + "resilience/clock.py"),
    },
    "nostager": {
        "bad": ("from pipelinedp_tpu_torch.ingest import BackgroundStager\n"
                "\n"
                "def restream(src):\n"
                "    return BackgroundStager(src)\n",
                P + "torch_engine.py"),
        # streaming.py keeps exactly two sites, in the two blessed
        # functions as the walk names them (run_sweep nests in _pass_b).
        "clean": ("def _stream_impl(src):\n"
                  "    return BackgroundStager(src)\n\n"
                  "def _pass_b(src):\n"
                  "    def run_sweep(consume):\n"
                  "        return BackgroundStager(src)\n"
                  "    return run_sweep\n",
                  P + "streaming.py"),
    },
    "noperf": {
        "bad": ("import time\n\n"
                "def t():\n"
                "    return time.perf_counter()\n",
                P + "streaming.py"),
        "clean": ("import time\n\n"
                  "def t():\n"
                  "    return time.perf_counter()\n",
                  P + "obs/costs.py"),
    },
    "noartifacts": {
        "bad": ("import json\n\n"
                "def save(report, fh):\n"
                "    json.dump(report, fh)\n",
                P + "torch_engine.py"),
        "clean": ("import json\n\n"
                  "def save(report, fh):\n"
                  "    json.dump(report, fh)\n",
                  P + "obs/report.py"),
    },
    "nocost": {
        "bad": ("import torch\n\n"
                "def peak():\n"
                "    return torch.cuda.max_memory_allocated()\n",
                P + "streaming.py"),
        "clean": ("import torch\n\n"
                  "def peak():\n"
                  "    return torch.cuda.max_memory_allocated()\n",
                  P + "obs/costs.py"),
    },
    "noknobs": {
        "bad": ("from pipelinedp_tpu_torch import torch_engine as te\n\n"
                "def cap():\n"
                "    return te._SUBHIST_BYTE_CAP\n",
                P + "streaming.py"),
        # The defining module's Store-context assignment IS the seam.
        "clean": ("_Q_CHUNK = 0\n",
                  P + "streaming.py"),
    },
    "kernel-build-confinement": {
        "bad": ("from pipelinedp_tpu_torch.ops.kernels import _build\n\n"
                "def lib():\n"
                "    return _build.load('segsum_lanes')\n",
                P + "torch_engine.py"),
        "clean": ("import ctypes\n"
                  "from pipelinedp_tpu_torch.ops.kernels import _build\n\n"
                  "def lib():\n"
                  "    return _build.load('segsum_lanes')\n",
                  P + "ops/kernels/segsum.py"),
    },
    "noserve": {
        "bad": ("from pipelinedp_tpu_torch.serve import Service\n",
                P + "torch_engine.py"),
        "clean": ("from pipelinedp_tpu_torch.serve.budget_ledger import (\n"
                  "    TenantBudgetLedger)\n\n"
                  "def make(d):\n"
                  "    return TenantBudgetLedger(d)\n",
                  P + "serve/service.py"),
    },
    "rng-purity": {
        # The seeded regression: a raw torch draw in torch_engine.py.
        "bad": ("import torch\n\n"
                "def noise(shape):\n"
                "    return torch.randn(shape)\n",
                P + "torch_engine.py"),
        "clean": ("import torch\n\n"
                  "def noise(shape):\n"
                  "    return torch.randn(shape)\n",
                  P + "ops/noise.py"),
    },
    "blocking-under-lock": {
        # The seeded regression: a durable (fsync'd) write inside a
        # with self._lock: body.
        "bad": ("import threading\n"
                "from pipelinedp_tpu_torch.resilience.checkpoint import (\n"
                "    atomic_write_json)\n\n\n"
                "class Ledger:\n"
                "    def __init__(self):\n"
                "        self._lock = threading.Lock()\n\n"
                "    def write(self, state):\n"
                "        with self._lock:\n"
                "            atomic_write_json('p.json', state)\n",
                P + "serve/budget_ledger.py"),
        "clean": ("import threading\n"
                  "from pipelinedp_tpu_torch.resilience.checkpoint import (\n"
                  "    atomic_write_json)\n\n\n"
                  "class Ledger:\n"
                  "    def __init__(self):\n"
                  "        self._lock = threading.Lock()\n\n"
                  "    def write(self, state):\n"
                  "        with self._lock:\n"
                  "            snap = dict(state)\n"
                  "        atomic_write_json('p.json', snap)\n",
                  P + "serve/budget_ledger.py"),
    },
    "fusion-masking": {
        # A second fusion policy growing outside serve/fusion.py: the
        # batched device path dispatched (or a request padded) elsewhere.
        "bad": ("from pipelinedp_tpu_torch import torch_engine as te\n\n"
                "def run_batch(config, P, members):\n"
                "    return te.fused_aggregate_batch(config, P, members)\n",
                P + "streaming.py"),
        # The blessed seam itself never scans; the clean fixture shows the
        # legal shape elsewhere: consuming fusion RESULTS.
        "clean": ("def summarize(batch_result):\n"
                  "    # mentions fused_aggregate_batch only in prose\n"
                  "    return len(batch_result)\n",
                  P + "serve/service.py"),
    },
    "sketch-confinement": {
        "bad": ("def shard_of(key, n):\n"
                "    return hash(key) % n\n",
                P + "streaming.py"),
        "clean": ("from pipelinedp_tpu_torch.sketch.hashing import (\n"
                  "    stable_hash_any)\n\n\n"
                  "class Metric:\n"
                  "    def __hash__(self):\n"
                  "        return hash((self.name, self.param))\n\n\n"
                  "def shard_of(key, n):\n"
                  "    return stable_hash_any(key) % n\n",
                  P + "streaming.py"),
    },
    "socket-confinement": {
        "bad": ("import socket\n"
                "from http.server import HTTPServer\n\n"
                "def listen(port):\n"
                "    return HTTPServer(('', port), None)\n",
                P + "serve/service.py"),
        "clean": ("import urllib.request\n\n\n"
                  "def scrape(url):\n"
                  "    # docs may mention http.server freely\n"
                  "    with urllib.request.urlopen(url) as r:\n"
                  "        return r.read()\n",
                  P + "serve/service.py"),
    },
    "collective-confinement": {
        # A raw collective outside parallel/sharded.py: invisible to the
        # mesh_topology knob, the byte meter and the parity contract.
        "bad": ("import torch.distributed as dist\n\n"
                "def combine(x):\n"
                "    dist.all_reduce(x)\n"
                "    return x\n",
                P + "streaming.py"),
        # The one blessed seam: sharded.py's helpers call the group's
        # methods.
        "clean": ("def _all_reduce(mesh, g, x):\n"
                  "    g.pg.allreduce([x]).wait()\n"
                  "    return x\n",
                  P + "parallel/sharded.py"),
    },
}


class TestRegistry:

    def test_every_carried_reference_rule_has_an_owner(self):
        from pipelinedp_tpu.lint import rules as jrules
        assert set(rules_mod.reference_rules()) == CARRIED
        assert (set(jrules.rule_ids()) - set(rules_mod.NOT_CARRIED)
                == CARRIED)

    def test_not_carried_rules_are_the_jax_ones(self):
        from pipelinedp_tpu.lint import rules as jrules
        assert set(rules_mod.NOT_CARRIED) == {"jit-staticness", "nofoldin"}
        assert set(rules_mod.NOT_CARRIED) <= set(jrules.rule_ids())
        assert not set(rules_mod.NOT_CARRIED) & set(rules_mod.rule_ids())
        assert rules_mod.reference_rules()["nopallas"] == (
            "kernel-build-confinement")

    def test_registry_is_exactly_the_known_rules(self):
        assert set(rules_mod.rule_ids()) == PORT_IDS

    def test_every_rule_has_a_fixture_pair(self):
        assert set(FIXTURES) == set(rules_mod.rule_ids())
        for rid, pair in FIXTURES.items():
            assert {"bad", "clean"} <= set(pair), rid

    def test_rules_carry_their_prose(self):
        for rule in rules_mod.all_rules():
            assert rule.invariant, rule.id
            assert rule.fix_hint, rule.id


class TestRuleFixtures:

    @pytest.mark.parametrize("rule_id", sorted(FIXTURES))
    def test_bad_fixture_fires(self, rule_id):
        src, rel = FIXTURES[rule_id]["bad"]
        found = findings_for(rule_id, src, rel)
        assert found, f"{rule_id}: bad fixture produced no finding"
        for f in found:
            assert f.rule == rule_id and f.path == rel
            assert f.line >= 1 and f.message

    @pytest.mark.parametrize("rule_id", sorted(FIXTURES))
    def test_clean_fixture_passes(self, rule_id):
        src, rel = FIXTURES[rule_id]["clean"]
        assert findings_for(rule_id, src, rel) == [], rule_id


class TestRuleShapes:
    """Rule behaviours beyond the basic fire/pass pair."""

    def test_nostager_streaming_shape_checks(self):
        three = ("def _stream_impl(s):\n"
                 "    return BackgroundStager(s)\n\n"
                 "def _pass_b(s):\n"
                 "    def run_sweep(c):\n"
                 "        return BackgroundStager(s)\n"
                 "    return run_sweep\n\n"
                 "def pass_b_tile(s):\n"
                 "    return BackgroundStager(s)\n")
        found = findings_for("nostager", three, P + "streaming.py")
        # Site #3 is doubly wrong: unblessed function AND over count.
        assert len(found) >= 2
        assert any("pass_b_tile" in f.message for f in found)

    def test_nostager_reports_the_qualified_function(self):
        """A site directly in ``_pass_b`` (not in its ``run_sweep``) is not
        the blessed one: the walk names nested functions by their
        path."""
        src = ("def _pass_b(s):\n"
               "    return BackgroundStager(s)\n")
        found = findings_for("nostager", src, P + "streaming.py")
        assert len(found) == 1 and "'_pass_b'" in found[0].message
        nested = ("def _stream_impl(s):\n"
                  "    def launch(item):\n"
                  "        return BackgroundStager(s)\n")
        found = findings_for("nostager", nested, P + "streaming.py")
        assert len(found) == 1
        assert "_stream_impl.launch" in found[0].message

    def test_noperf_monitor_rejects_any_time_use(self):
        src = "import time\n\nDEADLINE = time.monotonic\n"
        found = findings_for("noperf", src, P + "obs/monitor.py")
        assert found, "monitor.py touching `time` must be a finding"
        # ... while other obs modules may import time freely.
        assert findings_for("noperf", src, P + "obs/store.py") == []

    def test_noperf_catches_references_and_from_imports(self):
        src = ("import time\n"
               "from time import perf_counter\n\n"
               "CLOCK = time.perf_counter\n")
        found = findings_for("noperf", src, P + "streaming.py")
        assert sorted(f.line for f in found) == [2, 4]

    def test_rng_purity_flags_stdlib_and_numpy_and_from_imports(self):
        src = ("import random\n"
               "import numpy as np\n"
               "from random import sample\n\n"
               "def f():\n"
               "    random.seed()\n"
               "    return np.random.default_rng(0)\n")
        found = findings_for("rng-purity", src, P + "streaming.py")
        msgs = "\n".join(f.message for f in found)
        assert "random.seed" in msgs
        assert "default_rng" in msgs
        assert "from-import" in msgs

    def test_rng_purity_flags_the_ports_generators(self):
        """The port's forms: threefry keys and draws, counter draws, a
        reach into the host generator, torch's draws, a tensor's in-place
        draw and a from-import of a generator's draw member."""
        src = ("import torch\n"
               "from pipelinedp_tpu_torch.ops import counter_rng, prng\n"
               "from pipelinedp_tpu_torch.ops import noise as noise_ops\n"
               "from pipelinedp_tpu_torch.ops.prng import fold_in\n\n"
               "def f(key, x, n):\n"
               "    k = prng.split(key, 3)\n"
               "    b = counter_rng.row_bits(key, n, 'cpu')\n"
               "    u = noise_ops._host_rng.integers(0, 9)\n"
               "    t = torch.rand(n)\n"
               "    x.uniform_()\n"
               "    return k, b, u, t\n")
        found = findings_for("rng-purity", src, P + "streaming.py")
        assert sorted(f.line for f in found) == [4, 7, 8, 9, 10, 11]
        # The import of the module, and its non-rng math, stay free.
        ok = ("from pipelinedp_tpu_torch.ops.prng import xla_log\n"
              "from pipelinedp_tpu_torch.ops import prng\n\n"
              "def g(a, b, c):\n"
              "    return prng.fma32(a, b, c)\n")
        assert findings_for("rng-purity", ok, P + "ops/xla_math.py") == []

    def test_rng_purity_ignores_annotations_and_docstrings(self):
        src = ('"""Mentions torch.rand and fold_in freely."""\n'
               "import numpy as np\n"
               "from typing import Optional\n\n\n"
               "def f(rng: Optional[np.random.Generator] = None):\n"
               "    return rng\n")
        assert findings_for("rng-purity", src, P + "streaming.py") == []

    def test_blocking_under_lock_nested_acquisition(self):
        src = ("import threading\n\n\n"
               "class S:\n"
               "    def __init__(self):\n"
               "        self._admit = threading.Lock()\n"
               "        self._books_lock = threading.Lock()\n\n"
               "    def f(self):\n"
               "        with self._admit:\n"
               "            with self._books_lock:\n"
               "                return 1\n")
        found = findings_for("blocking-under-lock", src,
                             P + "serve/service.py")
        assert len(found) == 1
        assert "nested lock" in found[0].message

    def test_blocking_under_lock_skips_deferred_bodies(self):
        src = ("import threading\n"
               "_lock = threading.Lock()\n\n\n"
               "def f(q):\n"
               "    with _lock:\n"
               "        return lambda: q.get()\n")
        assert findings_for("blocking-under-lock", src,
                            P + "ingest/executor.py") == []

    def test_blocking_under_lock_queue_waits(self):
        src = ("import threading\n"
               "_lock = threading.Lock()\n\n\n"
               "def f(queue, opts):\n"
               "    with _lock:\n"
               "        item = queue.get()\n"
               "        flag = opts.get('x')\n"
               "    return item, flag\n")
        found = findings_for("blocking-under-lock", src,
                             P + "ingest/executor.py")
        # dict-style .get on a non-queue receiver is NOT a finding.
        assert len(found) == 1
        assert ".get()" in found[0].message

    def test_blocking_under_lock_direct_nested_region_counts_once(self):
        src = ("import threading\n"
               "import os\n"
               "_lock = threading.Lock()\n"
               "_io_lock = threading.Lock()\n\n\n"
               "def f(fd):\n"
               "    with _lock:\n"
               "        with _io_lock:\n"
               "            os.fsync(fd)\n")
        found = findings_for("blocking-under-lock", src,
                             P + "ingest/executor.py")
        by_msg = sorted(f.message for f in found)
        assert len(found) == 2, by_msg
        assert "fsync() inside a held lock body" in by_msg[0]
        assert "nested lock" in by_msg[1]

    def test_kernel_build_access_without_import(self):
        """The import ban alone would miss a reach through an already
        imported package (``kernels._build.load``) and a ``ctypes`` load:
        one violation per line, however many node forms match."""
        src = ("from pipelinedp_tpu_torch.ops import kernels\n\n"
               "def k():\n"
               "    return kernels._build.load('segsum_lanes')\n")
        found = findings_for("kernel-build-confinement", src,
                             P + "streaming.py")
        assert [f.line for f in found] == [4]
        src_ct = ("import ctypes\n\n"
                  "def k(path):\n"
                  "    return ctypes.CDLL(path)\n")
        found = findings_for("kernel-build-confinement", src_ct,
                             P + "streaming.py")
        assert [f.line for f in found] == [1, 4]
        # native/ builds and loads its own host libraries.
        assert findings_for("kernel-build-confinement", src_ct,
                            P + "native/__init__.py") == []

    def test_kernel_build_blesses_kernels_not_the_noise_seam(self):
        src = "from pipelinedp_tpu_torch.ops.kernels import _build\n"
        assert findings_for("kernel-build-confinement", src,
                            P + "ops/kernels/segkeyed.py") == []
        assert findings_for("kernel-build-confinement", src,
                            P + "ops/vector_noise.py")

    def test_collective_method_and_module_forms(self):
        src = ("import functools\n"
               "import torch.distributed as dist\n\n"
               "def f(pg, group, x, xs):\n"
               "    pg.allreduce([x]).wait()\n"
               "    group.broadcast([x], 0)\n"
               "    dist.barrier()\n"
               "    pg._allgather_base(x, x)\n"
               "    return functools.reduce(max, xs)\n")
        found = findings_for("collective-confinement", src,
                             P + "resilience/health.py")
        assert sorted(f.line for f in found) == [5, 6, 7, 8]

    def test_noknobs_variable_names_and_the_harness(self):
        src = ("import os\n\n"
               "def chunk():\n"
               "    return os.environ.get('PIPELINEDP_TPU_STREAM_CHUNK')\n")
        assert findings_for("noknobs", src, P + "streaming.py")
        assert findings_for("noknobs", src, P + "plan/knobs.py") == []
        # chip_smoke.py sets knob variables as a user does ...
        assert findings_for("noknobs", src, "chip_smoke.py") == []
        # ... but reads no knob constant.
        seam = ("from pipelinedp_tpu_torch import streaming\n"
                "Q = streaming._Q_CHUNK\n")
        assert findings_for("noknobs", seam, "chip_smoke.py")

    def test_rng_purity_blesses_the_vector_noise_seam(self):
        src = ("from pipelinedp_tpu_torch.ops import prng\n\n"
               "def unit(key, shape):\n"
               "    k = prng.fold_in(key, 0x7EC)\n"
               "    return prng.normal(k, shape)\n")
        assert findings_for("rng-purity", src,
                            P + "ops/vector_noise.py") == []
        # The same draws anywhere else stay findings: the blessing is the
        # file, not the pattern.
        assert findings_for("rng-purity", src, P + "torch_engine.py")
        assert findings_for("rng-purity", src, P + "ops/kernels/segsum.py")

    @pytest.mark.parametrize("rel", [P + "ops/vector_noise.py",
                                     P + "ops/kernels/segsum.py"])
    def test_real_noise_seam_and_kernel_module_are_clean(self, rel):
        result = engine.lint_source(_real(rel), rel)
        assert result.findings == []


class TestSuppressions:

    BAD_SLEEP = ("import time\n\n"
                 "def wait():\n"
                 "    time.sleep(0.5)  "
                 "# lint: disable=nosleep(fixture reason)\n")

    def test_reasoned_suppression_silences_and_is_counted(self):
        result = engine.lint_source(
            self.BAD_SLEEP, P + "streaming.py",
            rules=[rules_mod.get("nosleep")])
        assert result.findings == []
        assert len(result.suppressed) == 1
        sup = result.suppressed[0]
        assert sup.rule == "nosleep" and sup.suppressed
        assert sup.reason == "fixture reason"
        assert result.suppressed_counts() == {"nosleep": 1}
        assert all(s.used for s in result.suppressions)

    def test_own_line_suppression_governs_next_code_line(self):
        src = ("import time\n\n"
               "def wait():\n"
               "    # lint: disable=nosleep(own-line fixture reason)\n"
               "    time.sleep(0.5)\n")
        result = engine.lint_source(src, P + "streaming.py",
                                    rules=[rules_mod.get("nosleep")])
        assert result.findings == []
        assert len(result.suppressed) == 1

    def test_reasonless_suppression_does_not_suppress(self):
        src = ("import time\n\n"
               "def wait():\n"
               "    time.sleep(0.5)  # lint: disable=nosleep\n")
        result = engine.lint_source(src, P + "streaming.py",
                                    rules=[rules_mod.get("nosleep")])
        rules_hit = {f.rule for f in result.findings}
        assert engine.SUPPRESSION_RULE in rules_hit
        assert "nosleep" in rules_hit
        assert result.suppressed == []

    def test_unknown_rule_suppression_is_a_finding(self):
        src = "X = 1  # lint: disable=no-such-rule(typo)\n"
        result = engine.lint_source(src, P + "streaming.py")
        assert any(f.rule == engine.SUPPRESSION_RULE and
                   "unknown rule" in f.message
                   for f in result.findings)
        # A reference rule the port does not carry is unknown here too.
        src = "X = 1  # lint: disable=jit-staticness(not here)\n"
        result = engine.lint_source(src, P + "streaming.py")
        assert any("unknown rule" in f.message for f in result.findings)

    def test_docstring_mention_is_not_a_suppression(self):
        src = ('"""Example: # lint: disable=nosleep(docs)"""\n'
               "import time\n\n"
               "def wait():\n"
               "    time.sleep(0.5)\n")
        result = engine.lint_source(src, P + "streaming.py",
                                    rules=[rules_mod.get("nosleep")])
        assert len(result.findings) == 1
        assert result.suppressions == []

    def test_unused_suppressions_are_reported(self):
        src = "X = 1  # lint: disable=nosleep(nothing here sleeps)\n"
        result = engine.lint_source(src, P + "streaming.py",
                                    rules=[rules_mod.get("nosleep")])
        unused = result.unused_suppressions()
        assert len(unused) == 1 and unused[0].rule == "nosleep"


class TestWholeTree:

    def test_tree_has_zero_unsuppressed_findings(self):
        result = engine.run(root=REPO)
        assert result.findings == [], "\n".join(
            f.format() for f in result.findings)
        assert result.files_scanned > 50

    def test_tree_suppressions_all_carry_reasons_and_are_used(self):
        result = engine.run(root=REPO)
        assert result.suppressed, (
            "the rng and lock audit left reasoned suppressions in the "
            "tree; their disappearance means the audit was reverted")
        for sup in result.suppressions:
            assert sup.used and sup.reason

    def test_scan_scope_is_the_package_and_chip_smoke(self):
        rels = [rel for _, rel in engine.iter_python_files(REPO)]
        assert "chip_smoke.py" in rels
        assert all(r == "chip_smoke.py" or r.startswith(P) for r in rels)
        assert not any(r.startswith("pipelinedp_tpu/") for r in rels)

    def test_check_tree_convenience(self):
        assert lint.check_tree("nosleep", "noserve", root=REPO) == []

    def test_cli_exits_zero_on_the_tree(self, capsys):
        assert cli.main([]) == 0
        out = capsys.readouterr().out
        assert "lint: OK" in out

    def test_cli_single_rule_and_unknown_rule(self, capsys):
        assert cli.main(["--rule", "nosleep"]) == 0
        assert cli.main(["--rule", "bogus"]) == 2
        err = capsys.readouterr().err
        assert "unknown lint rule" in err

    def test_cli_list_names_all_rules(self, capsys):
        assert cli.main(["--list"]) == 0
        out = capsys.readouterr().out
        for rid in list(rules_mod.rule_ids()) + list(rules_mod.NOT_CARRIED):
            assert rid in out


class TestJsonRoundTrip:
    """--json emits the port's obs/store.py envelope; a CI gate can append
    it to a run ledger and diff per-rule counts across runs."""

    def test_document_shape_and_json_round_trip(self):
        result = engine.run(root=REPO)
        doc = cli.findings_document(result, ts=123.0)
        assert doc["name"] == cli.RECORD_NAME
        assert doc["schema_version"] == cli.JSON_SCHEMA_VERSION
        back = json.loads(json.dumps(doc))
        assert back == doc
        payload = back["payload"]
        assert payload["ok"] is True
        assert payload["counts"] == {}
        assert set(payload["rules_run"]) == set(rules_mod.rule_ids())
        for rule, n in payload["suppressed_counts"].items():
            assert rule in rules_mod.rule_ids() and n >= 1

    def test_round_trips_through_the_ledger_store(self, tmp_path):
        from pipelinedp_tpu_torch.obs.store import LedgerStore
        result = engine.run(root=REPO)
        doc = cli.findings_document(result, ts=123.0)
        store = LedgerStore(str(tmp_path))
        store.append(doc["name"], doc["payload"])
        entry = store.entries()[-1]
        assert entry["name"] == cli.RECORD_NAME
        assert entry["payload"]["counts"] == doc["payload"]["counts"]
        assert (entry["payload"]["suppressed_counts"] ==
                doc["payload"]["suppressed_counts"])

    def test_cli_out_of_scope_path_is_loud(self, capsys, tmp_path):
        p = tmp_path / "loose.py"
        p.write_text("import time\ntime.sleep(1)\n")
        assert cli.main([str(p)]) == 2
        out = capsys.readouterr().out
        assert "NOT checked" in out and "nothing was checked" in out

    def test_cli_json_output_parses(self, capsys):
        assert cli.main(["--json", "--rule", "nosleep"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["payload"]["ok"] is True
        assert doc["payload"]["rules_run"] == ["nosleep"]


class TestSeededRegressions:
    """The regressions the port's lint must catch, seeded into the real
    files and driven through the same engine the CLI runs."""

    def test_time_sleep_in_streaming_is_caught(self):
        seeded = (_real(P + "streaming.py") +
                  "\n\ndef _seeded_wait():\n    time.sleep(1)\n")
        found = findings_for("nosleep", seeded, P + "streaming.py")
        assert len(found) == 1

    def test_atomic_write_under_lock_is_caught(self):
        seeded = _real(P + "serve/budget_ledger.py") + (
            "\n\ndef _seeded_write(self, state):\n"
            "    with self._lock:\n"
            "        atomic_write_json('x.json', state)\n")
        found = findings_for("blocking-under-lock", seeded,
                             P + "serve/budget_ledger.py")
        assert len(found) == 1

    def test_raw_numpy_draw_in_engine_is_caught(self):
        seeded = _real(P + "torch_engine.py") + (
            "\n\ndef _seeded_noise(shape):\n"
            "    return np.random.normal(size=shape)\n")
        found = findings_for("rng-purity", seeded, P + "torch_engine.py")
        assert len(found) == 1
