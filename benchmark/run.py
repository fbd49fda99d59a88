"""Runs one cell of ``BENCHMARK.json`` once on the card this process
finds, and prints the result as the last line of standard output:

    python3 benchmark/run.py --workload <cell> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

It exits non-zero, and prints no result, without CUDA or with fewer cards
than the cell asks for, and when the process has loaded JAX or the JAX
package by the time the window has closed. The numbers the output check
compared go to standard error, each beside its limit, as its last lines.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "pipelinedp_tpu_torch")):
        print("no pipelinedp_tpu_torch beside benchmark/: the program under "
              "test must come from this checkout", file=sys.stderr)
        return 2
    import torch

    from benchmark.core import harness, spec
    cell = spec.load_cell(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), torch.device("cuda", 0),
                              T_PROCESS)
    found = harness.forbidden_modules()
    if found:
        print("loaded in the benchmark's process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
