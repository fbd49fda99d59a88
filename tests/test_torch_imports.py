"""The port stands alone: no file of ``pipelinedp_tpu_torch/``, and not
``chip_smoke.py`` or ``tools/segsum_ab.py``, imports ``jax`` or
``pipelinedp_tpu`` (an AST scan, so imports inside functions count too)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "pipelinedp_tpu")


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
                   "analysis/pre_aggregation.py"):
        assert os.path.join(REPO, "pipelinedp_tpu_torch", module) in files
    assert len(files) > 10


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(BANNED))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
