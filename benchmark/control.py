"""Reads the control of a cell's output check at the cell's own size:
the reference put in the program's place with one guarantee broken
(the aggregation cells: the L0 bound left out) or in the next precision
below the one stated (the sweep: bfloat16 for float32), judged by the
same comparison as a run. Prints one JSON line per seed; the benchmark's
own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    import torch

    from benchmark.core import spec
    cell = spec.load_cell(ROOT, args.workload)
    runner = spec.load_runner(cell)
    device = torch.device("cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings = runner.control(cell, seed, device)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0,
                          "limits": cell.limits, **readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
