"""Phase 34 of ``chip_smoke.py`` alone, on one CUDA card: the card's name
and power limit and the kernel build, then K7 (``assign.group_by_cell``,
the stream's batch assignment) against the host's numpy at the Netflix
table's shape and on a small grid, its timings beside its bound, the
copies across the bus, the whole card assignment's host ms, and its
launches per streamed call, through ``chip_smoke.py``'s own phase
functions. Run it from the repo's root:

    python3 tools/phase_assign.py [--out DIR]

It prints the phase's JSON records as ``chip_smoke.py`` does and, with
``--out``, writes them to ``<out>/phase_assign.json``."""
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke as cs  # noqa: E402


def main():
    out = sys.argv[sys.argv.index("--out") + 1] if "--out" in sys.argv \
        else None
    smi, _ = cs.phase_card()
    cs.phase_assign_kernel(smi, per_launch=True)
    if out:
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(out, "phase_assign.json"), "w") as f:
            json.dump(cs.RECORD, f, indent=1, default=float)
    print(smi)


if __name__ == "__main__":
    main()
