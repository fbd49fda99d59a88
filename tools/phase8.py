"""Phase 8 of ``chip_smoke.py`` alone, on one CUDA card: the card's name
and power limit and the kernel build, then K3 (``subtree_counts_multi``)
against its plain version on the test shapes, the count pass's edges and
the config-4 and clipped hot-bin stacks, with its timings, through
``chip_smoke.py``'s own phase functions. Run it from the repo's root:

    python3 tools/phase8.py [--out DIR]

It prints the phase's JSON records as ``chip_smoke.py`` does and, with
``--out``, writes them to ``<out>/phase8.json``."""
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
    smi, _ = cs.phase_card()
    columns = cs.zipf_columns(cs.CONFIG4["rows"], cs.CONFIG4["users"],
                              cs.CONFIG4["partitions"], cs.CONFIG4["seed"])
    t0 = time.perf_counter()
    cs.phase_hist_kernel(columns)
    cs.RECORD["phase8_s"] = time.perf_counter() - t0
    cs.log("phase8", seconds=cs.RECORD["phase8_s"])
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "phase8.json"), "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=float)
    print(smi)


if __name__ == "__main__":
    main()
