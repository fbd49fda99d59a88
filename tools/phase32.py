"""Phase 32 of ``chip_smoke.py`` alone, on one CUDA card: the card's
name and power limit and the kernel build, then the seeded chaos campaign
(one episode of each scenario) with its clean baselines held to the CPU's,
through ``chip_smoke.py``'s own phase functions. Run it from the repo's
root:

    python3 tools/phase32.py --out chiprun_out/p32

It prints the phases' JSON records as ``chip_smoke.py`` does and, with
``--out``, writes them to ``<out>/p32.json``."""
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
    t1 = time.perf_counter()
    cs.phase_chaos(smi)
    cs.RECORD["phase32_s"] = time.perf_counter() - t1
    cs.RECORD["total_s"] = time.perf_counter() - t0
    cs.log("phase32", seconds=cs.RECORD["phase32_s"],
           total_s=cs.RECORD["total_s"])
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "p32.json"), "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=float)
    print(smi)


if __name__ == "__main__":
    main()
