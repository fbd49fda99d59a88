"""The port stands alone: no file of ``pipelinedp_tpu_torch/``, and not
``chip_smoke.py`` or ``tools/segsum_ab.py``, imports ``jax`` or
``pipelinedp_tpu`` (an AST scan, so imports inside functions count too)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "pipelinedp_tpu")

#: The modules of the sketch-first path, the peeker, the fluent APIs, the
#: PLD engine, the native library, the obs and plan planes with the
#: clock and retry policy they use, the resident service, the mesh and its
#: elastic half (the health probe, the stream's assignment module), the
#: chaos campaign and the lint.
NEW_MODULES = ("sketch/__init__.py", "sketch/hashing.py",
               "sketch/params.py", "sketch/device.py", "sketch/engine.py",
               "sketch/peek.py", "peeker/__init__.py",
               "peeker/data_peeker.py", "peeker/non_private_combiners.py",
               "peeker/peeker_engine.py", "private_collection.py",
               "private_spark.py", "beam_backend.py", "private_beam.py",
               "pld.py", "native/__init__.py",
               "obs/__init__.py", "obs/tracer.py", "obs/trace_context.py",
               "obs/audit.py", "obs/metrics.py", "obs/report.py",
               "obs/store.py", "obs/costs.py", "obs/monitor.py",
               "obs/http.py", "plan/__init__.py", "plan/knobs.py",
               "plan/model.py", "plan/planner.py", "resilience/clock.py",
               "resilience/retry.py", "resilience/health.py",
               "serve/__init__.py", "serve/budget_ledger.py",
               "serve/service.py", "serve/fusion.py",
               "parallel/__init__.py", "parallel/sharded.py",
               "parallel/launch.py", "ingest/assign.py",
               "resilience/chaos.py", "lint/__init__.py", "lint/__main__.py",
               "lint/cli.py", "lint/engine.py", "lint/rules/__init__.py",
               "lint/rules/base.py", "lint/rules/confinement.py",
               "lint/rules/locks.py", "lint/rules/rng_purity.py")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "tools", "segsum_ab.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pipelinedp_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_has_files():
    files = _port_files()
    assert os.path.join(REPO, "chip_smoke.py") in files
    for module in ("ops/vector_noise.py", "ops/counter_rng.py",
                   "ops/kernels/segsum.py", "ops/kernels/hist.py",
                   "ops/kernels/segtotal.py", "ops/quantile_tree.py",
                   "streaming.py", "ingest/executor.py",
                   "resilience/checkpoint.py", "resilience/faults.py",
                   "ops/xla_math.py", "ops/kernels/segkeyed.py",
                   "sampling_utils.py", "analysis/torch_sweep.py",
                   "analysis/utility_analysis.py",
                   "analysis/parameter_tuning.py",
                   "analysis/histograms.py", "pipeline_backend.py",
                   "combiners.py", "contribution_bounders.py",
                   "partition_selection.py", "dp_engine.py",
                   "analysis/poisson_binomial.py",
                   "analysis/probability_computations.py",
                   "analysis/contribution_bounders.py",
                   "analysis/combiners.py",
                   "analysis/utility_analysis_engine.py",
                   "analysis/pre_aggregation.py", *NEW_MODULES):
        assert os.path.join(REPO, "pipelinedp_tpu_torch", module) in files
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_imports_alone(module):
    """Each module of the sketch-first path, the peeker, the fluent APIs,
    the PLD engine, the native library and the obs and plan planes
    imports, and pulls in neither
    JAX nor the JAX package: checked in a fresh interpreter, where nothing
    else imported them first. The Beam adapters import under the fake
    ``apache_beam`` of ``tests/fake_beam.py``, as
    ``tests/test_cluster_backends.py`` installs it."""
    import subprocess
    import sys
    name = "pipelinedp_tpu_torch." + module[:-3].replace("/", ".")
    name = name[:-len(".__init__")] if name.endswith(".__init__") else name
    code = (
        "import sys\n"
        "from tests import fake_beam\n"
        "beam = fake_beam.build_fake_beam_module()\n"
        "sys.modules['apache_beam'] = beam\n"
        "import importlib\n"
        f"mod = importlib.import_module({name!r})\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r})\n"
        "assert not bad, bad\n"
        "print(mod.__name__)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [name]
