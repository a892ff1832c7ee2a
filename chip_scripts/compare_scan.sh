#!/bin/bash
# The whole-stream scans, parent against change on one card, in one call:
#     bash chip_scripts/compare_scan.sh PARENT_DIR
# runs chip_scripts/scan_ab.py (this tree's script, the port imported from
# each tree) in PARENT_DIR (a `git archive` of the parent commit inside the
# checkout, in a directory .gitignore lists), here, here again and in
# PARENT_DIR again, each a fresh process, one JSON line each into
# chiprun_out/scan_ab.jsonl, and prints each scan's numbers side by side.
parent=${1:?usage: compare_scan.sh PARENT_DIR}
mkdir -p chiprun_out
rm -f chiprun_out/scan_ab.jsonl
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
for tree in parent change change parent; do
  dir=$([ "$tree" = parent ] && echo "$parent" || echo .)
  python3 chip_scripts/scan_ab.py "$dir" "$tree" >> chiprun_out/scan_ab.jsonl \
    || echo "scan_ab $tree rc=$?"
done
python3 - <<'PY'
import json

runs = [json.loads(ln) for ln in open("chiprun_out/scan_ab.jsonl")]
keys = ("ms_per_chunk", "msamples_per_s", "device_ms_per_step", "device_activities_per_step",
        "step_loop_host_us", "c_calls_per_step", "peak_bytes_k40", "checksum_k8")
for name in runs[0]["scans"]:
    print(name, runs[0]["scans"][name]["rates"], runs[0]["scans"][name]["lanes"], "lanes")
    for key in keys:
        print(f"  {key:28s}", [r["tree"][0] + ":" + format(r["scans"][name][key], ".6g")
                                for r in runs])
    if len({r["scans"][name]["checksum_k8"] for r in runs}) != 1:
        print("  CHECKSUMS DIFFER")
print(runs[0]["nvidia_smi"])
PY
