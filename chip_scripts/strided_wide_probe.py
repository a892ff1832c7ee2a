"""A short first run of the strided and wide kernels on one CUDA card.

    python3 chip_scripts/strided_wide_probe.py

Builds the kernels, prints ptxas's registers and spills of every library,
holds every chip_smoke.TILED_CASES, STRIDED_CASES and WIDE_CASES launch
against its plain version (exact), counts the device launches of one call
of each entry (torch.profiler, after the timings), and prints the strided
entry's time at the 96k -> 48k farm launch for each tile size the kernel
takes (and at a 40-tap reserve) and the wide entry's at 44.1k -> 132, each
beside its bound (CUDA events), then each wide kernel's device time
(torch.profiler). Exits 1 if a case disagrees.
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
for name, log in _build.BUILD_LOG["ptxas"].items():
    for ln in log.splitlines():
        if any(k in ln for k in ("registers", "spill", "Compiling entry")):
            print(name, ln.strip())
gen = torch.Generator(device="cuda").manual_seed(1)
bad = []
for run, cases in ((cs.run_tiled_case, cs.TILED_CASES), (cs.run_strided_case, cs.STRIDED_CASES),
                   (cs.run_wide_case, cs.WIDE_CASES)):
    for case in cases:
        try:
            got, want, rows, rows_ref = run(case, gen)
            torch.cuda.synchronize()
            err = (got.long() - want.long()).abs().max().item()
            ok = err == 0 and torch.equal(rows, rows_ref) and got.dtype == want.dtype
            print(f"{case[0]:45s} err {err} rows {torch.equal(rows, rows_ref)} "
                  f"{'OK' if ok else 'FAIL'}", flush=True)
        except Exception as e:  # report every case, then fail
            ok = False
            print(f"{case[0]:45s} RAISED {type(e).__name__}: {e}", flush=True)
        if not ok:
            bad.append(case[0])
print("seconds to checks", round(time.time() - t0, 1), flush=True)
if bad:
    print("FAILED", bad)
    sys.exit(1)

peaks = cs.card_peaks()
s = cs.launch_case(96000, 48000, 2048, 8192, gen)
d, taps = s["d"], s["max_taps"]
print("strided bound", cs.launch_bound(s, 2048, peaks, rows_out=True))
print("strided plan", rs.strided_stage_plan(d, taps))
st = s["state"]
for frames in (8, 16, 32, 64):
    rows = (frames - 1) * d + taps
    if _build.strided_shared_bytes(taps, rows) > _build.MAX_SHARED_BYTES:
        continue
    fn = lambda: _build.strided_mac(
        s["x"], s["table"], st.position_integer, st.position_fractional, st.cfg,
        max_taps=taps, n_out=8192, d=d, lanes=2048, lane_offset=0, frames_per_tile=frames,
        win_rows=rows, clamp_s16=False)[0]
    print(f"strided F={frames} smem {_build.strided_shared_bytes(taps, rows)} ms",
          cs.cuda_ms(fn), cs.cuda_ms(fn), flush=True)
for t in (16, 40):
    fn = lambda: rs.resample_strided_phases(s["table"], s["x"], st, max_taps=t, n_out=8192,
                                            d=d)[0]
    print(f"strided entry T={t} ms", cs.cuda_ms(fn), cs.cuda_ms(fn), flush=True)
w = cs.launch_case(44100, 132, 1024, 64, gen, f0=0x4321)
print("wide bound", cs.launch_bound(w, 1024, peaks, rows_out=True))
wargs = dict(max_taps=w["max_taps"], n_out=64, d=w["d"], table_strided=w["table_strided"])
fn = lambda: rs.resample_wide_taps(w["table"], w["x"], w["state"], **wargs)[0]
print("wide entry ms", cs.cuda_ms(fn), cs.cuda_ms(fn), flush=True)


def host_us(call, reps=200):
    """Host microseconds to issue one call (no sync inside the loop; the
    queue stays short enough not to block)."""
    call()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(reps):
        call()
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e6 * (t2 - t1) / reps


c = cs.launch_case(48000, 44100, 2048, 8192, gen)
targs = dict(max_taps=c["max_taps"], n_out=8192, d=c["plan"]["d"], cand=c["plan"]["cand"],
             table_strided=c["table_strided"])
print("host us per call: tiled",
      host_us(lambda: rs.resample_uniform_lanes_tiled(c["table"], c["x"], c["state"], **targs)),
      "strided", host_us(lambda: rs.resample_strided_phases(s["table"], s["x"], st, max_taps=16,
                                                            n_out=8192, d=d)),
      "wide", host_us(fn), flush=True)
print("launches", cs.count_entry_launches(gen))
acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
with torch.profiler.profile(activities=acts) as prof:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
for evt in prof.key_averages():
    if evt.device_type == torch.autograd.DeviceType.CUDA:
        print("wide kernel", evt.key[:60], evt.count, evt.self_device_time_total / evt.count,
              "us")
print("seconds", round(time.time() - t0, 1))
