#!/bin/bash
# Parent against change on one card, in one call:
#     bash chip_scripts/compare.sh PARENT_DIR [FARM_PAIRS [FARM_CHECK_PAIRS]]
# runs chip_smoke.py in PARENT_DIR (a `git archive` of the parent commit
# inside the checkout, in a directory .gitignore lists), here, here again
# and in PARENT_DIR again, each log into chiprun_out/{parent1,change1,
# change2,parent2}.log; then the cuda-marked tests here. Then FARM_PAIRS
# (default 0) parent/change pairs of the headline and strided farms
# (chip_smoke.FARM, chip_smoke.STRIDED_FARM), each run a fresh process and
# the order alternating (parent, change, change, parent, ...), and
# FARM_CHECK_PAIRS (default 0) more that first run chip_smoke.check_kernels
# in the process, as chip_smoke.py does before its farms. Each farm runs
# three times in its process: the caller keeps every output, then drops each
# as a consumer does, then drops each with a synchronise after the staging
# (drop_waited: the wait for the upload and the stage, timed), and config
# 5's mixed farm (chip_smoke.MIXED) keeping and dropping. Every farm call is
# split into staging (the host's pass into the pinned input, the upload --
# the host threads' copy and the pieces' uploads where the tree has
# FarmProgram.upload -- and the stage launch's issue), the launch's host
# issue, the launch on the device's clock (CUDA events from the end of
# staging) and the device-to-host copy;
# one JSON line a farm run into chiprun_out/farm_ab.jsonl, and the medians
# printed at the end. Before the farms: the four runs' scan and entry times
# side by side (the scan's kernels alone and each engine's device ms a
# step among them), the host's time to issue config 7's scan in each tree
# (chiprun_out/scan_ab.jsonl) and the batched chunk call's entry times in
# each (chip_scripts/batch_ab.py, chiprun_out/batch_ab.jsonl). Last,
# chip_scripts/farm_probe.py here (the
# pinned copy rates, the farm kernels and the ways a result reaches the
# caller; chiprun_out/farm_probe.log).
parent=${1:?usage: compare.sh PARENT_DIR [FARM_PAIRS [FARM_CHECK_PAIRS]]}
farm_pairs=${2:-0}
farm_check_pairs=${3:-0}
mkdir -p chiprun_out
rm -f chiprun_out/scan_ab.jsonl
nvidia-smi --query-gpu=name,power.limit,clocks.max.sm --format=csv,noheader
run() {  # name dir
  local t0=$SECONDS
  (cd "$2" && python3 chip_smoke.py > "$OLDPWD/chiprun_out/$1.log" 2>&1)
  local rc=$?
  echo "$1 rc=$rc seconds=$(( SECONDS - t0 ))"
}
run parent1 "$parent"
run change1 .
run change2 .
run parent2 "$parent"
t0=$SECONDS
JAX_PLATFORMS=cpu python3 -m pytest tests/test_torch_resample_ops.py tests/test_torch_strided_wide.py \
  tests/test_torch_scan.py tests/test_torch_tiled_kernel.py tests/test_torch_strided_wide_kernel.py \
  tests/test_torch_general_kernel.py tests/test_torch_scan_program.py \
  tests/test_torch_scan_inplace.py tests/test_torch_farm_program.py tests/test_torch_farm_stage_ring.py \
  tests/test_torch_batch_kernel.py tests/test_torch_cuda_farm_host_path.py -q -m cuda \
  -p no:cacheprovider \
  > chiprun_out/cuda_tests.log 2>&1
echo "cuda tests rc=$? seconds=$(( SECONDS - t0 ))"
tail -n 2 chiprun_out/cuda_tests.log
for f in parent1 change1 change2 parent2; do echo "== $f"; tail -n 3 chiprun_out/$f.log | cut -c1-600; done
# The four runs' scan and entry times side by side (keys a tree's script lacks
# print as None).
python3 - <<'PY'
import json

for name in ("parent1", "change1", "change2", "parent2"):
    phases = {}
    for ln in open(f"chiprun_out/{name}.log"):
        if ln.startswith('{"phase"'):
            d = json.loads(ln)
            phases[d["phase"]] = d
    scan, timing = phases.get("scan_timing", {}), phases.get("timing", {}).get("kernels", {})
    old = scan.get("profiler", {})
    loops = scan.get("step_loops") or [{}]
    print(name, "scan", {k: scan.get(k) for k in (
        "ms_per_chunk", "msamples_per_s", "peak_allocated_bytes_k40", "host_issue_us_per_chunk",
        "step_loop_host_us_per_step", "device_busy_share", "host_bound")},
        "profiled busy share", old.get("device_busy_share",
                                       loops[0].get("profiled_device_busy_share")),
        "device ms a step", loops[0].get("device_ms_per_step",
                                         (old.get("mac_kernel_ms_per_step") or 0)
                                         + (old.get("other_device_ms_per_step") or 0)))
    print(name, "entries ms", {k: round(v["ms"], 5) for k, v in timing.items()})
    print(name, "scan modes alone ms", {k: v.get("ms")
                                        for k, v in (scan.get("scan_modes") or {}).items()},
          "engines' device ms a step", [(lp.get("rates"), lp.get("device_ms_per_step"))
                                         for lp in loops])
PY
# The host's time to issue config 7's scan, parent and change in turns, a fresh
# process each: the call's return (no synchronise) and the run's end, at
# SCAN7's two K, best of 3; the K-slope is the host's time a chunk.
scan_run() {  # tree dir
  (cd "$2" && python3 - "$1" <<'PY'
import json, sys, time

import torch

import chip_smoke as cs

gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
k1, k2 = cs.SCAN7["timing_k"]
c = cs.scan_case(cs.SCAN7["rates"], cs.SCAN7["lanes"], k2 - 1, gen)
cs.fused_scan(c, k1)
res = {}
for k in (k1, k2):
    issue, wall = [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = cs.fused_scan(c, k)
        issue.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t0))
        del out
    res[k] = (min(issue), min(wall))
print(json.dumps(dict(
    tree=sys.argv[1], k=[k1, k2], issue_ms=[res[k1][0], res[k2][0]],
    wall_ms=[res[k1][1], res[k2][1]],
    host_issue_us_per_chunk=1e3 * (res[k2][0] - res[k1][0]) / (k2 - k1),
    wall_us_per_chunk=1e3 * (res[k2][1] - res[k1][1]) / (k2 - k1))), flush=True)
PY
  )
}
for tree in parent change change parent; do
  dir=$([ "$tree" = parent ] && echo "$parent" || echo .)
  scan_run "$tree" "$dir" | tee -a chiprun_out/scan_ab.jsonl || echo "scan run $tree rc=$?"
done

# The batched chunk call (batch_mac_kernel) at the fleet, BATCH and the
# oracle-scan step, parent and change in turns, a fresh process each
# (chiprun_out/batch_ab.jsonl).
rm -f chiprun_out/batch_ab.jsonl
for tree in parent change change parent; do
  dir=$([ "$tree" = parent ] && echo "$parent" || echo .)
  python3 chip_scripts/batch_ab.py "$dir" "$tree" | tee -a chiprun_out/batch_ab.jsonl \
    || echo "batch run $tree rc=$?"
done

farm_run() {  # tree dir pre
  (cd "$2" && python3 - "$1" "$3" <<'PY'
import json, sys, time

import numpy as np
import torch

import chip_smoke as cs
from clownresampler_tpu_torch import farm as fm
from clownresampler_tpu_torch.ops import _build

tree, pre = sys.argv[1], sys.argv[2]
_build.library("resample")
if pre == "checks":
    cs.check_kernels(torch.Generator(device="cuda").manual_seed(cs.SEED))
calls = []
U = fm.UniformStreamFarm


def timed(name, fn, events=False, wait=None):
    def wrap(self, *a, **k):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)] if events else None
        if ev:
            ev[0].record()
        t0 = time.perf_counter()
        out = fn(self, *a, **k)
        t1 = time.perf_counter()
        calls[-1][name] = calls[-1].get(name, 0.0) + 1e3 * (t1 - t0)
        if ev:
            ev[1].record()
            calls[-1]["events"] = ev
        if wait and wait[0]:
            torch.cuda.synchronize()
            calls[-1]["stage_wait_ms"] = 1e3 * (time.perf_counter() - t1)
        return out
    return wrap


def opened(fn):
    """A farm call opens a record; the calls a mixed farm makes of its
    groups' flush belong to its own."""
    def wrap(self, *a, **k):
        if inside[0]:
            return fn(self, *a, **k)
        call = {}
        calls.append(call)
        inside[0] = True
        t0 = time.perf_counter()
        try:
            out = fn(self, *a, **k)
        finally:
            inside[0] = False
        call["call_ms"] = 1e3 * (time.perf_counter() - t0)
        return out
    return wrap


inside = [False]


waiting = [False]
U._stage = timed("stage_ms", U._stage, wait=waiting)
if hasattr(U, "_stage_streams"):      # a mixed farm's group (this PR's tree on)
    U._stage_streams = timed("stage_ms", U._stage_streams)
U._launch = timed("launch_issue_ms", U._launch, events=True)
U._to_host = timed("to_host_ms", U._to_host)
# Inside the staging: the upload and the stage launch issued, and inside that
# the upload (the host threads' copy and its pieces' uploads, where the tree
# has FarmProgram.upload); the rest is the host's pass into the pinned input.
fm.FarmProgram.stage = timed("stage_issue_ms", fm.FarmProgram.stage)
if hasattr(fm.FarmProgram, "upload"):
    fm.FarmProgram.upload = timed("upload_ms", fm.FarmProgram.upload)
U.process, U.flush = opened(U.process), opened(U.flush)
M = fm.MixedStreamFarm
M.process, M.flush = opened(M.process), opened(M.flush)


def run(name, farm, chunks, mode, feed):
    kept, sizes, checksum = [], [], 0
    for chunk in chunks:
        torch.cuda.synchronize()
        out = feed(farm, chunk)
        parts = out if isinstance(out, list) else [out]
        sizes.append(sum(o.size for o in parts))
        checksum += sum(int(o.reshape(-1)[0]) + int(o.reshape(-1)[-1]) for o in parts if o.size)
        if mode == "keep":
            kept.append(out)
        del out, parts
    farm.flush()
    torch.cuda.synchronize()
    for c in calls:
        ev = c.pop("events", None)
        c["launch_device_ms"] = ev[0].elapsed_time(ev[1]) if ev else None
        c["host_pass_ms"] = c.get("stage_ms", 0.0) - c.get("stage_issue_ms", 0.0)
        c["host_ms"] = c["host_pass_ms"] + c.get("upload_ms", 0.0)
    steady_s = sum(c["call_ms"] for c in calls[1:-1]) / 1e3
    print(json.dumps(dict(tree=tree, pre=pre, farm=name, mode=mode, checksum=checksum,
                          msamples_per_s=sum(sizes[1:]) / steady_s / 1e6,
                          calls=calls[:-1])), flush=True)


for name, spec in (("headline", cs.FARM), ("strided", cs.STRIDED_FARM)):
    rng = np.random.default_rng(cs.SEED)
    chunks = [rng.integers(-32768, 32768, size=(spec["streams"], spec["chunk"], spec["channels"]),
                           dtype=np.int16) for _ in range(spec["chunks"])]
    for mode in ("keep", "drop", "drop_waited"):
        waiting[0] = mode == "drop_waited"
        calls.clear()
        farm = U(spec["streams"], spec["channels"], *spec["rates"], chunk_frames=spec["chunk"],
                 device="cuda")
        run(name, farm, chunks, mode, lambda farm, chunk: farm.process(chunk))
        del farm
# Config 5's mixed farm (cs.MIXED, no adjust), each call's chunks per stream.
m = cs.MIXED
specs = [rates for rates in m["groups"] for _ in range(m["per_group"])]
rng = np.random.default_rng(cs.SEED)
chunks = [rng.integers(-32768, 32768, size=(len(specs), m["chunk"], m["channels"]),
                       dtype=np.int16) for _ in range(m["chunks"])]
for mode in ("keep", "drop"):
    waiting[0] = False
    calls.clear()
    farm = M(specs, m["channels"], chunk_frames=m["chunk"], max_radius=m["max_radius"],
             device="cuda")
    run("mixed", farm, chunks, mode, lambda farm, chunk: farm.process(list(chunk)))
    del farm
PY
  ) >> chiprun_out/farm_ab.jsonl
}
rm -f chiprun_out/farm_ab.jsonl
for ((i = 0; i < farm_pairs + farm_check_pairs; i++)); do
  pre=$([ "$i" -lt "$farm_pairs" ] && echo none || echo checks)
  if (( i % 2 )); then order="change parent"; else order="parent change"; fi
  for tree in $order; do
    dir=$([ "$tree" = parent ] && echo "$parent" || echo .)
    farm_run "$tree" "$dir" "$pre" || echo "farm run $i $tree rc=$?"
  done
done
if [ -s chiprun_out/farm_ab.jsonl ]; then
  python3 - <<'PY'
import json
import statistics as st

runs = [json.loads(ln) for ln in open("chiprun_out/farm_ab.jsonl")]
keys = ("call_ms", "stage_ms", "host_pass_ms", "stage_issue_ms", "upload_ms", "host_ms",
        "launch_issue_ms", "launch_device_ms", "to_host_ms")
modes = ("keep", "drop", "drop_waited")
for farm, mode in ((f, m) for f in ("headline", "strided", "mixed") for m in modes):
    for pre in ("none", "checks"):
        for tree in ("parent", "change"):
            rs = [r for r in runs
                  if (r["farm"], r["mode"], r["pre"], r["tree"]) == (farm, mode, pre, tree)]
            if not rs:
                continue
            if len({r["checksum"] for r in runs if (r["farm"], r["mode"]) == (farm, mode)}) != 1:
                print(farm, mode, "CHECKSUMS DIFFER between runs")
            steady = [c for r in rs for c in r["calls"][1:]]
            med = {k: round(st.median(c.get(k) or 0.0 for c in steady), 3)
                   for k in keys + (("stage_wait_ms",) if mode == "drop_waited" else ())}
            if mode == "drop_waited":
                med["chunk_to_card_ms"] = round(st.median(
                    c["stage_ms"] + c["stage_wait_ms"] for c in steady), 3)
            print(farm, mode, pre, tree, "Msamples/s",
                  [round(r["msamples_per_s"], 1) for r in rs],
                  "median", round(st.median(r["msamples_per_s"] for r in rs), 1),
                  "steady-call medians (ms)", med,
                  "slowest call", max(steady, key=lambda c: c["call_ms"]))
PY
fi
python3 chip_scripts/farm_probe.py > chiprun_out/farm_probe.log 2>&1
echo "farm probe rc=$?"
grep -E '"probe": "(copy_rates|farm_kernels|host_pass_into_pinned_input|result_delivery)"' \
  chiprun_out/farm_probe.log | cut -c1-1500
