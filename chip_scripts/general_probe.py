"""A short first run of the general entry on one CUDA card.

    python3 chip_scripts/general_probe.py

Builds the kernels, prints ptxas's registers and spills of the resample
library, holds every chip_smoke.GENERAL_CASES and TILED_CASES launch against
its plain version (exact), times the general entry at 44.1 kHz -> 8 kHz
(4096 frames x 2048 lanes, 40 taps) and the tiled headline entry (CUDA
events) beside their bounds, then counts the device launches of one general
entry call (torch.profiler, after the timings). Exits 1 if a case disagrees.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402
from clownresampler_tpu_torch.ops import resample as rs  # noqa: E402

t0 = time.time()
_build.library("resample")
print("build", round(_build.BUILD_LOG["seconds"], 2), flush=True)
for ln in _build.BUILD_LOG["ptxas"]["resample"].splitlines():
    if any(k in ln for k in ("registers", "spill", "Compiling entry")):
        print(ln.strip())
gen = torch.Generator(device="cuda").manual_seed(1)
bad = []
for run, cases in ((cs.run_general_case, cs.GENERAL_CASES), (cs.run_tiled_case, cs.TILED_CASES)):
    for case in cases:
        got, want, rows, rows_ref = run(case, gen)
        torch.cuda.synchronize()
        err = (got.long() - want.long()).abs().max().item()
        ok = err == 0 and torch.equal(rows, rows_ref) and got.dtype == want.dtype
        print(f"{case[0]:50s} err {err} rows {torch.equal(rows, rows_ref)} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        if not ok:
            bad.append(case[0])
peaks = cs.card_peaks()
g = cs.launch_case(44100, 8000, 2048, 4096, gen)
gargs = dict(max_taps=40, n_out=4096, table_strided=g["table_strided"])
general = lambda: rs.resample_uniform_lanes_general(g["table"], g["x"], g["state"], **gargs)[0]
c = cs.launch_case(48000, 44100, 2048, 8192, gen)
targs = dict(max_taps=c["max_taps"], n_out=8192, d=c["plan"]["d"], cand=c["plan"]["cand"],
             table_strided=c["table_strided"])
tiled = lambda: rs.resample_uniform_lanes_tiled(c["table"], c["x"], c["state"], **targs)[0]
print("general stage plan", rs.stage_plan(40, rs.GENERAL_MIN_INCREMENT))
print("general bound", cs.launch_bound(g, 2048, peaks, rows_out=True))
print("tiled bound", cs.launch_bound(c, 2048, peaks, rows_out=True))
for _ in range(3):
    print("general entry ms", cs.cuda_ms(general), "tiled entry ms", cs.cuda_ms(tiled), flush=True)
print("general plain entry ms", cs.cuda_ms(lambda: rs.resample_uniform_lanes_general_reference(
    g["table"], g["x"], g["state"], **gargs)[0], reps=5))
names, dev_ms = cs.device_launches(general)
print("general launches", names, dev_ms)
print("seconds", time.time() - t0)
sys.exit(1 if bad else 0)
