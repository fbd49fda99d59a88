#!/usr/bin/env bash
# Phase 31 of chip_smoke.py alone, once per tree and in the order given,
# one process each, on one CUDA card: compares commits on the same card
# within one run. Each tree is an unpacked checkout (`git archive <rev> |
# tar -x -C <dir>`) that holds tools/phase31.py; copy it into an older
# tree that lacks it. Run from the repo's root:
#
#   tools/phase31_ab.sh chiprun_out/ab31 parent=build/ab31/parent \
#       change=build/ab31/change change2=build/ab31/change \
#       parent2=build/ab31/parent
#
# Prints the card's name and power limit, then for each run its wall,
# the tool's last line and phase 31 (c)'s single-device, clean 4-rank and
# killed walls and time to recover; each run's log and records go to
# <out>/<name>.log and <out>/<name>/.
set -e
out=$1
shift
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for pair in "$@"; do
  name=${pair%%=*}
  tree=${pair#*=}
  TIMEFORMAT="$name wall %R s"
  { time python3 "$tree/tools/phase31.py" --out "$out/$name" \
      > "$out/$name.log" 2>&1 ; } 2>&1
  tail -1 "$out/$name.log"
  grep -o '"single_device_s": [0-9.]*\|"clean_4_wall_s": [0-9.]*\|"killed_wall_s": [0-9.]*\|"time_to_recover_s_per_rank": \[\[[0-9.]*\], \[[0-9.]*\]\]' \
    "$out/$name.log" | tr '\n' ' '
  echo
done
