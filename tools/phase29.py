"""Phase 29 of ``chip_smoke.py`` alone, on one CUDA card: the card's
name and power limit and the kernel build, then the resident service
((a) latency, (b) fused throughput, (c) the fused scalar burst and (d)
the fused PERCENTILE burst), through ``chip_smoke.py``'s own phase
functions. Run it from the repo's root:

    python3 tools/phase29.py --out chiprun_out/p29

``--only-d`` runs (d) alone. It prints the phases' JSON records as
``chip_smoke.py`` does and, with ``--out``, writes them to
``<out>/p29.json``."""
import json
import os
import shutil
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def main():
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else None
    t0 = time.perf_counter()
    smi, _ = cs.phase_card()
    t1 = time.perf_counter()
    if "--only-d" in sys.argv:
        import pipelinedp_tpu_torch as pdt
        tmp = tempfile.mkdtemp(prefix="phase29_")
        try:
            cs.phase_serve_percentile(pdt, tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    else:
        cs.phase_serve(smi)
    cs.RECORD["phase29_s"] = time.perf_counter() - t1
    cs.RECORD["total_s"] = time.perf_counter() - t0
    cs.log("phase29", seconds=cs.RECORD["phase29_s"],
           total_s=cs.RECORD["total_s"])
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "p29.json"), "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=float)
    print(smi)


if __name__ == "__main__":
    main()
