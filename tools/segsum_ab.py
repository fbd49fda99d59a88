"""Times the segment-sum kernels K1 and K2, the ordered segment-total
kernel K4 and the ordered keyed sum K5 of two checkouts of the port
against each other on one NVIDIA GPU, in turns, on chip_smoke.py's
stacks.

    python3 tools/segsum_ab.py OLD_ROOT NEW_ROOT [--only K1|K2|K4|K5]
        [--out DIR]

Each ROOT is the root of a checkout of this repository (for example one
unpacked from ``git archive <rev>``). Each checkout runs in a process of
its own, in the order old, new, new, old, and builds its own kernels. A
process makes every stack from fixed seeds with this file's
``chip_smoke.py`` (over the checkout's own package), holds the
checkout's wrapper (``segsum.segment_sum_lanes``, ``segment_sum_wide``
or ``segtotal.segment_totals``) bit for bit to the plain version on it,
and times the wrapper: the median of 21 warm runs, CUDA events, the
output's allocation and scratch included. ``--only K1|K2|K4|K5`` keeps one
kernel's stacks. K5 runs only under ``--only K5``: each checkout's K5 on
the count and moment stacks that its own main path builds for config 5's
first chunk of 132 configs (``segkeyed.segmented_sums``, held to the
checkout's plain version), then each checkout's config-5 sweep (10,000
configs) once: its wall and K5's summed device time in it (CUDA events).
It prints one JSON line per stack, with
both checkouts' two times and the ratio of their means, and with
``--out`` writes them to ``DIR/segsum_ab.json``.

``--k4-detail`` (with ``--out``) adds, for K4: each launch's device time
per call on each stack (``torch.profiler``, ten calls), ``nvcc -Xptxas
-v`` and ``cuobjdump -sass`` of each checkout's ``csrc/segtotal.cu``
(``DIR/segtotal_{old,new}.txt``), and the card's dependent float32 add
chain alone (one warp, 2^20 ``__fadd_rn``, ``clock64`` cycles per add):
the floor of an ordered fold.
"""

import argparse
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def stacks(cs, segsum):
    """(name, wrapper, cols, pk, P) at the shapes of chip_smoke.py."""
    import numpy as np
    import torch
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    columns = cs.zipf_columns(cs.FLAGSHIP["rows"], cs.FLAGSHIP["users"],
                              cs.FLAGSHIP["partitions"], cs.FLAGSHIP["seed"])
    stack, spk, P = cs.flagship_stack(columns)
    lanes, wide = segsum.segment_sum_lanes, segsum.segment_sum_wide
    yield "K1 flagship stack", lanes, stack, spk, P
    n, C = stack.shape
    dense = torch.randint(0, 64, (n, C), generator=gen, device=dev,
                          dtype=torch.int32)
    dense[:, :2] = 1
    yield "K1 dense zipf, main-path order", lanes, dense, spk, P
    raw = torch.from_numpy(columns[1].astype(np.int32)).to(dev)
    yield "K1 dense zipf, raw order", lanes, dense, raw, P
    del stack, spk, dense, raw, columns
    rng = np.random.default_rng(29)
    public = list(range(cs.VECTOR_PARTITIONS))
    for d in cs.VECTOR_WIDTHS:
        cols, vpk, P, _ = cs.vector_stack(cs.vector_columns(rng, d), d,
                                          public)
        yield f"K2 VECTOR_SUM D={d}", wide, cols, vpk, P
        yield f"K1 on the VECTOR_SUM D={d} stack", lanes, cols, vpk, P
        del cols, vpk
    n, W, P = cs.VECTOR_ROWS_AT_64, 3 * cs.VECTOR_WIDTHS[0], 65536
    keys = torch.from_numpy(((rng.zipf(1.3, n) - 1) % P).astype(
        np.int32)).to(dev)
    cols = torch.randint(1, 1 << 10, (n, W), generator=gen, device=dev,
                         dtype=torch.int32)
    yield f"K2 dense zipf P={P} D=64", wide, cols, keys, P
    del cols, keys
    c4 = cs.zipf_columns(cs.CONFIG4["rows"], cs.CONFIG4["users"],
                         cs.CONFIG4["partitions"], cs.CONFIG4["seed"])
    qpk, leaf, kept, _, P = cs.config4_stack(c4)
    mkey = (qpk * 256 + torch.clamp_max(leaf // 256, 255)).to(
        torch.int32).contiguous()
    mcol = kept.to(torch.int32)[:, None].contiguous()
    yield "K1 config-4 mid histogram", lanes, mcol, mkey, P * 256


def k4_stacks(cs):
    """(name, values, new_seg): K4's three stacks in chip_smoke.py."""
    import pipelinedp_tpu_torch as pdt
    columns = cs.zipf_columns(cs.FLAGSHIP["rows"], cs.FLAGSHIP["users"],
                              cs.FLAGSHIP["partitions"], cs.FLAGSHIP["seed"])
    _, b, _, _ = cs.bounded_rows(columns, cs.sum_bounds_params(pdt),
                                 cs.FLAGSHIP["seed"])
    yield "K4 flagship per-partition stack", b.masked.contiguous(), b.new_seg
    del b, columns
    yield "K4 hot 2^20-row segment", *cs.hot_stack()
    yield "K4 mid-length stack", *cs.mid_stack()


def k5_records(cs):
    """K5 on config 5's first-chunk stacks as this checkout's main path
    builds them, then this checkout's config-5 sweep (its wall and K5's
    device milliseconds in it)."""
    import pipelinedp_tpu_torch as pdt
    import torch
    from pipelinedp_tpu_torch import analysis as tan
    from pipelinedp_tpu_torch.ops.kernels import segkeyed
    columns = cs.zipf_columns(cs.CONFIG5["rows"], cs.CONFIG5["users"],
                              cs.CONFIG5["partitions"], cs.CONFIG5["seed"])
    count, moments, layout = cs.capture_k5_stacks(columns, 132)
    records = []
    for name, values in (("K5 config-5 count stack", count),
                         ("K5 config-5 moment stack", moments)):
        want = segkeyed.segmented_sums_plain(values, layout)
        got = segkeyed.segmented_sums(values, layout)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            f"K5 wrong on {name}")
        ms = cs.cuda_ms(lambda: segkeyed.segmented_sums(values, layout))
        records.append(dict(stack=name, shape=list(values.shape), ms=ms))
    del count, moments, want, got
    n_cfg, options = cs.sweep_options(tan, pdt, cs.CONFIG5_CONFIGS)
    with cs._kernel_clock() as clock:
        lazy, _, _, wall_s = cs.run_sweep(columns, options, "cuda")
    assert lazy.n_chunks == 76 and lazy.chunk == 132, (lazy.n_chunks,
                                                       lazy.chunk)
    records.append(dict(stack="config 5 wall (10,000 configs)",
                        shape=[cs.CONFIG5["rows"], n_cfg],
                        ms=wall_s * 1e3))
    records.append(dict(stack="config 5 K5 device time (152 launches)",
                        shape=[2 * lazy.n_chunks],
                        ms=clock.ms()["segmented_sums"]))
    return records


def segtotal_detail(root, path):
    """``ptxas -v`` and the SASS of ``root``'s ``csrc/segtotal.cu``."""
    from pipelinedp_tpu_torch.ops.kernels import _build
    nvcc = _build.find_nvcc()
    src = os.path.join(root, "pipelinedp_tpu_torch", "csrc", "segtotal.cu")
    lib = _build.load("segtotal")._name
    ptxas = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                            lib + ".ptxas", src], capture_output=True,
                           text=True)
    sass = subprocess.run([os.path.join(os.path.dirname(nvcc), "cuobjdump"),
                           "-sass", lib], capture_output=True, text=True)
    with open(path, "w") as f:
        f.write(ptxas.stdout + ptxas.stderr + sass.stdout + sass.stderr)


def device_ms(fn, calls=10):
    """Device milliseconds per call of each kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if t:
            kernel = re.search(r"(\w+)\(", e.key)
            name = kernel.group(1) if kernel else e.key
            out[name] = out.get(name, 0.0) + t / calls / 1e3
    return out


CHAIN_CU = r"""
#include <cuda_runtime.h>
__global__ void chain(float* out, long long* cycles, int n, float a, float b) {
  float s = 0.0f;
  const long long t = clock64();
  for (int i = 0; i < n; i += 64) {
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      s = __fadd_rn(s, a);
      s = __fadd_rn(s, b);
    }
  }
  const long long d = clock64() - t;
  if (threadIdx.x == 0) cycles[0] = d;
  out[threadIdx.x] = s;
}
extern "C" int chain_launch(void* out, void* cycles, int n, float a, float b,
                            void* stream) {
  chain<<<1, 32, 0, (cudaStream_t)stream>>>((float*)out, (long long*)cycles,
                                            n, a, b);
  return (int)cudaGetLastError();
}
"""


def add_chain():
    """One warp's chain of 2^20 dependent float32 adds: ms (CUDA events,
    median of 21) and clock64 cycles per add."""
    import ctypes
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from pipelinedp_tpu_torch.ops.kernels import _build
    build = os.path.join(REPO, "build", "add_chain")
    os.makedirs(build, exist_ok=True)
    with open(os.path.join(build, "chain.cu"), "w") as f:
        f.write(CHAIN_CU)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                    os.path.join(build, "chain.so"),
                    os.path.join(build, "chain.cu")], check=True)
    fn = ctypes.CDLL(os.path.join(build, "chain.so")).chain_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    out = torch.empty(32, device="cuda")
    cycles = torch.zeros(1, dtype=torch.int64, device="cuda")
    n = 1 << 20
    stream = torch.cuda.current_stream().cuda_stream
    ms = cs.cuda_ms(lambda: fn(out.data_ptr(), cycles.data_ptr(), n, 1.5,
                               -0.25, stream))
    per_add = int(cycles.item()) / n
    return dict(adds=n, ms=ms, cycles_per_add=per_add,
                sm_mhz=int(cycles.item()) / (ms * 1e3))


def time_checkout(root, only=None, detail=None):
    """Times every stack through ``root``'s wrappers (those whose name
    starts with ``only``, when given); returns the records. With
    ``detail`` (a file path), adds K4's device times per launch and writes
    K4's ptxas report and SASS there."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import torch
    # The checkout's package, not this file's, serves every import below.
    sys.path.insert(0, os.path.abspath(root))
    from pipelinedp_tpu_torch.ops.kernels import segsum
    assert segsum.__file__.startswith(os.path.abspath(root)), segsum.__file__
    # VECTOR_SUM's stacks are the fixed-point lanes, as chip_smoke.py sets.
    os.environ["PIPELINEDP_TPU_VECTOR_ACCUMULATOR"] = "fx"
    if only == "K5":
        return k5_records(cs)
    records = []
    k1k2 = () if only == "K4" else stacks(cs, segsum)
    for name, fn, cols, pk, P in k1k2:
        if only and not name.startswith(only):
            continue
        want = segsum.segment_sum_lanes_plain(cols, pk, P)
        assert torch.equal(fn(cols, pk, P), want), f"{root}: wrong on {name}"
        records.append(dict(stack=name, shape=[P, *cols.shape],
                            ms=cs.cuda_ms(lambda: fn(cols, pk, P))))
        del cols, pk, want
        torch.cuda.empty_cache()
    from pipelinedp_tpu_torch.ops.kernels import segtotal
    for name, values, new_seg in (k4_stacks(cs) if only in (None, "K4")
                                  else ()):
        want = segtotal.segment_totals_plain(values, new_seg)
        got = segtotal.segment_totals(values, new_seg)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            f"{root}: wrong on {name}")
        rec = dict(stack=name, shape=list(values.shape),
                   ms=cs.cuda_ms(lambda: segtotal.segment_totals(values,
                                                                 new_seg)))
        if detail:
            rec["device_ms"] = device_ms(
                lambda: segtotal.segment_totals(values, new_seg))
        records.append(rec)
        del values, new_seg, want, got
        torch.cuda.empty_cache()
    if detail and only in (None, "K4"):
        segtotal_detail(root, detail)
    return records


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old", nargs="?")
    parser.add_argument("new", nargs="?")
    parser.add_argument("--out", default=None)
    parser.add_argument("--only", default=None,
                        choices=["K1", "K2", "K4", "K5"],
                        help="time only that kernel's stacks")
    parser.add_argument("--k4-detail", action="store_true",
                        help="K4's device times per launch, its SASS and "
                        "the card's add chain (needs --out)")
    parser.add_argument("--checkout", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--detail", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.checkout:
        print(json.dumps(time_checkout(args.checkout, args.only,
                                       args.detail)))
        return 0
    if not (args.old and args.new):
        parser.error("needs OLD_ROOT and NEW_ROOT")
    if args.k4_detail and not args.out:
        parser.error("--k4-detail needs --out")
    import torch
    if not torch.cuda.is_available():
        print("segsum_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    times = {}
    for which in ("old", "new", "new", "old"):
        extra = ["--only", args.only] if args.only else []
        if args.k4_detail:
            extra += ["--detail", os.path.join(args.out,
                                               f"segtotal_{which}.txt")]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--checkout",
             getattr(args, which)] + extra, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            return proc.returncode
        for rec in json.loads(proc.stdout.strip().splitlines()[-1]):
            entry = times.setdefault(rec["stack"], dict(
                shape=rec["shape"], ms={"old": [], "new": []}))
            entry["ms"][which].append(rec["ms"])
            if "device_ms" in rec:
                entry.setdefault("device_ms", {"old": [], "new": []})[
                    which].append(rec["device_ms"])
    records = []
    for name, entry in times.items():
        old, new = entry["ms"]["old"], entry["ms"]["new"]
        rec = dict(stack=name, card=card, **entry,
                   old_over_new=sum(old) / len(old) / (sum(new) / len(new)))
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.k4_detail:
        rec = dict(stack="add chain", card=card, **add_chain())
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        with open(os.path.join(args.out, "segsum_ab.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
