"""Times the segment-sum kernels K1 and K2 of two checkouts of the port
against each other on one NVIDIA GPU, in turns, on chip_smoke.py's stacks.

    python3 tools/segsum_ab.py OLD_ROOT NEW_ROOT [--out DIR]

Each ROOT is the root of a checkout of this repository (for example one
unpacked from ``git archive <rev>``). Each checkout runs in a process of
its own, in the order old, new, new, old, and builds its own kernels. A
process makes every stack from fixed seeds with this file's
``chip_smoke.py`` (over the checkout's own package), holds the
checkout's wrapper (``segsum.segment_sum_lanes`` or
``segment_sum_wide``) bit for bit to the plain version on it, and times
the wrapper: the median of 21 warm runs, CUDA events, the output's
allocation and zeroing included. It prints one JSON line per stack, with
both checkouts' two times and the ratio of their means, and with
``--out`` writes them to ``DIR/segsum_ab.json``.
"""

import argparse
import json
import os
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


def time_checkout(root):
    """Times every stack through ``root``'s wrappers; returns the records."""
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import torch
    # The checkout's package, not this file's, serves every import below.
    sys.path.insert(0, os.path.abspath(root))
    from pipelinedp_tpu_torch.ops.kernels import segsum
    assert segsum.__file__.startswith(os.path.abspath(root)), segsum.__file__
    # VECTOR_SUM's stacks are the fixed-point lanes, as chip_smoke.py sets.
    os.environ["PIPELINEDP_TPU_VECTOR_ACCUMULATOR"] = "fx"
    records = []
    for name, fn, cols, pk, P in stacks(cs, segsum):
        want = segsum.segment_sum_lanes_plain(cols, pk, P)
        assert torch.equal(fn(cols, pk, P), want), f"{root}: wrong on {name}"
        records.append(dict(stack=name, shape=[P, *cols.shape],
                            ms=cs.cuda_ms(lambda: fn(cols, pk, P))))
        del cols, pk, want
        torch.cuda.empty_cache()
    return records


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("old", nargs="?")
    parser.add_argument("new", nargs="?")
    parser.add_argument("--out", default=None)
    parser.add_argument("--checkout", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.checkout:
        print(json.dumps(time_checkout(args.checkout)))
        return 0
    if not (args.old and args.new):
        parser.error("needs OLD_ROOT and NEW_ROOT")
    import torch
    if not torch.cuda.is_available():
        print("segsum_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    times = {}
    for which in ("old", "new", "new", "old"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--checkout",
             getattr(args, which)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, sep="\n", file=sys.stderr)
            return proc.returncode
        for rec in json.loads(proc.stdout.strip().splitlines()[-1]):
            entry = times.setdefault(rec["stack"], dict(
                shape=rec["shape"], ms={"old": [], "new": []}))
            entry["ms"][which].append(rec["ms"])
    records = []
    for name, entry in times.items():
        old, new = entry["ms"]["old"], entry["ms"]["new"]
        rec = dict(stack=name, card=card, **entry,
                   old_over_new=sum(old) / len(old) / (sum(new) / len(new)))
        records.append(rec)
        print(json.dumps(rec), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "segsum_ab.json"), "w") as f:
            json.dump(records, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
