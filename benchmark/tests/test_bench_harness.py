"""The harness on the CPU: the result line's schema, cells, metrics and
configurations found from files alone, and the import check."""

import json
import os
import subprocess
import sys
import types

import pytest

from benchmark.core import harness, spec
from benchmark.tests.conftest import REPO, TINY, add_cell, run_cpu, traffic

NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$"


def _check_line(result, traced):
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] >= 1 and result["failed"] == 0
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    if traced:
        assert {"busy_s", "window_s"} <= set(dev)
        b = result["breakdown"]
        assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10
    json.loads(json.dumps(result))


def test_result_line_schema_untraced_and_traced(root):
    r0 = run_cpu(root, "tiny.query")
    _check_line(r0, traced=False)
    assert set(r0["metrics"]) == {"query_rows_per_s", "setup_s"}
    assert r0["correct"], r0["checks"]
    r1 = run_cpu(root, "tiny.query", seed=2**33 + 1, traced=True)
    _check_line(r1, traced=True)
    assert {"host_other_ms.query", "device_ms.query"} <= set(r1["metrics"])
    # No device here: nothing to read for the trace's metrics.
    assert "device_idle_share.query" not in r1["metrics"]
    assert r1["correct"], r1["checks"]


def test_a_cell_a_config_and_a_metric_added_as_files_alone(root):
    """A later change adds a cell, its configuration, traffic, limits
    and a per-layer metric as new files and entries."""
    cfg = dict(TINY, name="tiny_b", top_item_ratings=2400)
    add_cell(root, "tinyb.release", cfg, "release_b",
             dict(traffic("release_scalar"), warmup_calls=1),
             {"count_bias": 6.0, "sum_bias": 6.0, "count_spread": 2.0,
              "sum_spread": 2.0, "max_abs_z": 20.0})
    with open(os.path.join(root, "benchmark", "metrics",
                           "calls_done.release.py"), "w") as f:
        f.write("def read(run):\n    return float(len(run.calls))\n")
    bench_path = os.path.join(root, "BENCHMARK.json")
    with open(bench_path) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "calls_done.release", "unit": "calls", "better": "higher",
        "source": "host_clock", "layer": "Entry",
        "moves": "release_rows_per_s", "workloads": ["tinyb.release"]})
    bench["end_to_end"][2]["workloads"].append("tinyb.release")
    with open(bench_path, "w") as f:
        json.dump(bench, f)
    cell = spec.load_cell(root, "tinyb.release")
    assert cell.config["top_item_ratings"] == 2400
    assert [m.name for m in cell.per_layer] == ["calls_done.release"]
    r = run_cpu(root, "tinyb.release", traced=True)
    assert r["metrics"]["calls_done.release"]["value"] == r["attempted"]
    assert r["correct"], r["checks"]


def test_every_name_and_file_of_the_benchmark_is_well_formed():
    import re
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for c in bench["workloads"]:
        assert re.match(NAME, c["name"])
        spec.load_cell(REPO, c["name"])  # every file it names exists
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(NAME, m["name"])
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics",
                                           m["name"] + ".py"))


def test_the_import_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    for name in ("pipelinedp_tpu_torch", "pipelinedp_tpu_torch.x",
                 "jaxtyping", "jax_fake"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    for name in ("jax", "pipelinedp_tpu.ops", "flax.linen", "jaxlib"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == ["flax.linen", "jax", "jaxlib",
                                           "pipelinedp_tpu.ops"]


def test_no_run_imports_jax_or_the_jax_package(root):
    code = ("import sys, time, torch; sys.path.insert(0, %r); "
            "from benchmark.core import harness; "
            "harness.run_cell(%r, 'tiny.sweep', 5, 0.5, True, "
            "torch.device('cpu'), time.perf_counter()); "
            "print(harness.forbidden_modules())") % (REPO, root)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=REPO,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_exits_nonzero_with_no_result_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ml1m.sweep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=REPO)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "ml1m.sweep",
         "--seed", "20262026", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, cwd=REPO, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    _check_line(result, traced=True)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
