#!/bin/bash
# The wide kernels, parent against change on one card, in one call:
#     bash chip_scripts/compare_wide.sh PARENT_DIR [PROBE_OPTIONS]
# runs chip_scripts/wide_probe.py (this tree's script, the port imported from
# each tree) on PARENT_DIR (a `git archive` of the parent commit inside the
# checkout, in a directory .gitignore lists), here, here again and on
# PARENT_DIR again, each a fresh process (PROBE_OPTIONS, e.g. --quick, passed
# to every run), one JSON line each into chiprun_out/wide_probe.jsonl, and
# prints each shape's times and each build's device time side by side.
parent=${1:?usage: compare_wide.sh PARENT_DIR [PROBE_OPTIONS]}
shift
mkdir -p chiprun_out
rm -f chiprun_out/wide_probe.jsonl
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
rc=0
for tree in parent change change parent; do
  dir=$([ "$tree" = parent ] && echo "$parent" || echo .)
  python3 chip_scripts/wide_probe.py "$dir" "$tree" "$@" > /dev/null || { echo "wide_probe $tree failed"; rc=1; }
done
python3 - <<'PY'
import json

for r in (json.loads(ln) for ln in open("chiprun_out/wide_probe.jsonl")):
    print(r["tree"], r["nvidia_smi"])
    for shape, v in r["shapes"].items():
        ms = {k: [round(x, 5) for x in m] for k, m in v["ms"].items()}
        print(f"  {shape}: exact {v['exact']}, device {v['device_ms']:.5f}, gap {v['gap_ms']:.5f}",
              ms, {k: round(d, 5) for k, d in v["device_ms_by_build"].items()})
PY
exit $rc
