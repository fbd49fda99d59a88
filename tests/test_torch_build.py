"""The kernel build and the launch counters under threads
(``pipelinedp_tpu_torch/ops/kernels/_build.py``), on the CPU.

The resident service calls the kernels from several worker threads, so a
kernel's first build may be asked for by many threads at once. With the
compiler and the loader stubbed, eight threads loading one source at once
run the compiler once, all get the one library, and no temporary file is
left; two sources build side by side. Launch counts taken from many
threads at once add up exactly.
"""

import os
import sys
import threading

import pytest

from pipelinedp_tpu_torch.ops.kernels import _build, hist, segkeyed, segsum
from pipelinedp_tpu_torch.ops.kernels import assign, segscan, segtotal


@pytest.fixture
def stub_compiler(tmp_path, monkeypatch):
    """A fake source tree, a compiler that writes its output file slowly
    and counts its runs, and a loader that returns a token per path."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("alpha", "beta"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    runs = []
    lock = threading.Lock()

    class _Proc:
        returncode = 0
        stdout = stderr = ""

    def fake_run(cmd, capture_output, text):
        out = cmd[cmd.index("-o") + 1]
        with lock:
            runs.append(out)
        threading.Event().wait(0.05)  # long enough for the others to queue
        with open(out, "w") as f:
            f.write("lib")
        return _Proc()

    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_build_locks", {})
    return runs, tmp_path / "build"


def _load_from_threads(names):
    barrier = threading.Barrier(len(names))
    got = [None] * len(names)
    errors = []

    def one(i):
        try:
            barrier.wait(timeout=30)
            got[i] = _build.load(names[i])
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(names))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not errors, errors
    return got


def test_one_build_per_source_under_concurrent_loads(stub_compiler):
    runs, build_dir = stub_compiler
    got = _load_from_threads(["alpha"] * 8)
    assert len(runs) == 1
    assert len({id(lib) for lib in got}) == 1
    assert os.listdir(build_dir) == [os.path.basename(got[0][1])]


def test_two_sources_build_side_by_side(stub_compiler):
    runs, build_dir = stub_compiler
    got = _load_from_threads(["alpha", "beta"] * 4)
    assert len(runs) == 2
    assert len({lib for lib in got}) == 2
    assert not [f for f in os.listdir(build_dir) if f.endswith(".tmp")]


@pytest.mark.parametrize("module,name", [
    (segsum, "segment_sum_lanes"), (segtotal, "segment_totals"),
    (segkeyed, "segmented_sums"), (hist, "subtree_counts_multi"),
    (segscan, "bound_linf_l0"), (assign, "group_by_cell")])
def test_launch_counts_add_up_across_threads(module, name):
    before = module.LAUNCHES[name]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads inside the += as well
    try:
        threads = [threading.Thread(target=lambda: [
            _build.count_launch(module.LAUNCHES, name)
            for _ in range(20_000)]) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert module.LAUNCHES[name] == before + 320_000
    module.reset_launches()
    assert module.LAUNCHES[name] == 0
