"""Phase 31 of ``chip_smoke.py`` alone, on one CUDA card: the card's
name and power limit, the kernel build and phase 4 (the flagship, which
phase 31 (a) compares against), then phase 31's health probe, flagged
degrade and elastic mesh runs through ``chip_smoke.py``'s own phase
functions. Run it from the repo's root:

    python3 tools/phase31.py --out chiprun_out/p31

It prints the phases' JSON records as ``chip_smoke.py`` does and, with
``--out``, writes them to ``<out>/p31.json``."""
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def main():
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else None
    t0 = time.perf_counter()
    smi, _ = cs.phase_card()
    columns = cs.zipf_columns(cs.FLAGSHIP["rows"], cs.FLAGSHIP["users"],
                              cs.FLAGSHIP["partitions"], cs.FLAGSHIP["seed"])
    _, rows = cs.phase_flagship(columns)
    t1 = time.perf_counter()
    cs.phase_health_flagship(columns, rows)
    cs.RECORD["health_flagship_s"] = time.perf_counter() - t1
    del columns, rows
    t1 = time.perf_counter()
    started = []
    cs.phase_health(smi, after_probe=lambda: started.append(cs.ElasticPools()))
    cs.phase_elastic(smi, started[0])
    cs.RECORD["phase31_s"] = (time.perf_counter() - t1 +
                              cs.RECORD["health_flagship_s"])
    cs.RECORD["total_s"] = time.perf_counter() - t0
    cs.log("phase31", seconds=cs.RECORD["phase31_s"],
           total_s=cs.RECORD["total_s"])
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "p31.json"), "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=float)
    print(smi)


if __name__ == "__main__":
    main()
