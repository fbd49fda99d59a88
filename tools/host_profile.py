"""Profiles the host path (``LocalBackend``) of one of chip_smoke.py's
phase-25 cells with cProfile. It runs on the CPU only and needs no GPU.

    python3 tools/host_profile.py [--cell config4|flagship] [--rows N]
        [--top K] [--out DIR]

``config4`` (the default) runs BASELINE config 4's P50/90/99 + VARIANCE
through ``DPEngine.aggregate`` on the first ``--rows`` (default 50,000,
the JAX bench's ``LocalBackend`` size) rows of config 4's data, as
phase 25d does; ``flagship`` runs the flagship params on the first
250,000 rows of the flagship's data. The data are chip_smoke.py's, from
its seeds. One warm-up run on 1,000 rows comes first, then the profiled
run.

It prints one JSON object: the host CPU as ``/proc/cpuinfo`` names it,
the wall of the profiled run, the self time of each source file (the
port's modules by their path in the package, builtins by name) as a
share of the profiled time, the cumulative time
of the quantile combiner's methods and of the host ``QuantileTree``'s,
and the top ``--top`` functions by self time. With ``--out`` it also
writes ``DIR/host_profile_<cell>.json`` and the ``pstats`` dump
``DIR/host_profile_<cell>.prof``.
"""

import argparse
import cProfile
import json
import os
import pstats
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The functions whose cumulative time the report names: (file suffix,
# function name).
WATCHED = (
    ("pipelinedp_tpu_torch/combiners.py", "create_accumulator"),
    ("pipelinedp_tpu_torch/combiners.py", "merge_accumulators"),
    ("pipelinedp_tpu_torch/combiners.py", "compute_metrics"),
    ("pipelinedp_tpu_torch/ops/quantile_tree.py", "merge"),
    ("pipelinedp_tpu_torch/ops/quantile_tree.py", "serialize"),
    ("pipelinedp_tpu_torch/ops/quantile_tree.py", "deserialize"),
    ("pipelinedp_tpu_torch/ops/quantile_tree.py", "add_entry"),
    ("pipelinedp_tpu_torch/ops/quantile_tree.py", "compute_quantiles"),
)


def _where(filename: str) -> str:
    """A source file's name in the report: its path from the repository
    root, or the last two parts of any other path; ``~`` (builtins)
    stays."""
    if filename.startswith(REPO + os.sep):
        return os.path.relpath(filename, REPO)
    parts = filename.split(os.sep)
    return os.sep.join(parts[-2:])


def run_cell(cs, pdt, cell, rows):
    """(columns, params) of ``cell``'s first ``rows`` rows."""
    spec, params = ((cs.CONFIG4, cs.config4_params(pdt)) if cell == "config4"
                    else (cs.FLAGSHIP, cs.flagship_params(pdt)))
    columns = cs.zipf_columns(spec["rows"], spec["users"],
                              spec["partitions"], spec["seed"])
    return tuple(c[:rows].copy() for c in columns), params


def aggregate(pdt, columns, params):
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = pdt.DPEngine(acc, pdt.LocalBackend())
    result = engine.aggregate(pdt.ArrayDataset(*columns),
                              pdt.AggregateParams(**params),
                              pdt.DataExtractors())
    acc.compute_budgets()
    return list(result)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cell", choices=("config4", "flagship"),
                        default="config4")
    parser.add_argument("--rows", type=int, default=None,
                        help="rows of the cell's data (default 50,000 for "
                        "config4, 250,000 for flagship)")
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    import pipelinedp_tpu_torch as pdt
    rows = args.rows or (50_000 if args.cell == "config4" else 250_000)
    columns, params = run_cell(cs, pdt, args.cell, rows)
    aggregate(pdt, tuple(c[:1000] for c in columns), params)

    profiler = cProfile.Profile()
    t0 = time.perf_counter()
    profiler.enable()
    released = aggregate(pdt, columns, params)
    profiler.disable()
    wall = time.perf_counter() - t0

    stats = pstats.Stats(profiler)
    total = stats.total_tt
    by_file, watched, funcs = {}, {}, []
    for (filename, line, name), (_, ncalls, tt, ct, _) in \
            stats.stats.items():
        where = _where(filename)
        key = where if where != "~" else name
        by_file[key] = by_file.get(key, 0.0) + tt
        funcs.append(dict(function=f"{where}:{line}({name})",
                          calls=ncalls, self_s=tt, cumulative_s=ct))
        for suffix, fn in WATCHED:
            if filename.endswith(suffix) and name == fn:
                label = f"{suffix.rsplit('/', 1)[1]}:{line}({name})"
                watched[label] = dict(calls=ncalls, cumulative_s=ct,
                                      share=ct / total)
    shares = sorted(((k, v / total) for k, v in by_file.items()),
                    key=lambda kv: -kv[1])
    funcs.sort(key=lambda f: -f["self_s"])
    report = dict(cell=args.cell, rows=rows, partitions=len(released),
                  host_cpu=cs.host_cpu(), host_cores=os.cpu_count(),
                  wall_s=wall, profiled_s=total,
                  self_share_by_file=dict(shares[:args.top]),
                  watched=watched, top_self=funcs[:args.top])
    print(json.dumps(report))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out,
                               f"host_profile_{args.cell}.json"), "w") as f:
            json.dump(report, f, indent=1)
        stats.dump_stats(os.path.join(args.out,
                                      f"host_profile_{args.cell}.prof"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
