"""A short run of tiled_mac_kernel's scan mode on one CUDA card.

    python3 chip_scripts/scan_inplace_probe.py [--quick] [--parent DIR] [--repeat N] [--sweep]

Builds the kernels and prints ptxas's registers, spills and stack of every
tiled_mac_kernel instantiation (with --parent DIR, a checkout of another
commit, also that tree's resample_kernels.cu compiled with the same flags,
each instantiation beside its counterpart); holds every
chip_smoke.SCAN_INPLACE_CASES launch against its plain version (exact) with
the copy path it took, every path of SCAN_INPLACE_PATHS required, then
TILED_CASES and GENERAL_CASES; --quick stops there. Then config 7's scan
(chip_smoke.SCAN7: K = 16 and a zero chunk) against the plain scan on every
lane, the oracle scan and two CPU replays, and N times (--repeat, default 1)
chip_smoke.time_scan: the K-slope (8 -> 40 chunks) ms a chunk, Msamples/s,
host us a step, peak memory at K = 40 (config 7's and the strided scan's),
each engine's scan mode alone at its step beside its bound, and each
engine's step loop under torch.profiler. --sweep (after the
cases, in place of the scan) times the scan mode's C entry at config 7's
step and at the tiled engine's (48 kHz -> 44.1 kHz, 2048 lanes) for stage
shapes (frames a stage, window rows) other than the plan's -- each F with
the rows its window needs at the scan's increment (more blocks an SM;
ops.resample.scan_stage_plan picks one of these), and the stage filled with
rows as the entries' plan fills it (two blocks an SM) -- in turns,
each launch checked exact. One JSON line a part; exits 1 if anything
disagrees.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402

MANGLED = re.compile(r"tiled_mac_kernelILi(\d+)E([a-z])([a-z])?(?:Lb([01])E)?")


def tiled_usage(log: str) -> dict:
    """{"taps T out O src S scan B": ptxas's lines} for every tiled_mac_kernel
    instantiation in a ptxas -v log (a tree without the scan mode reads as
    src int, scan 0)."""
    usage, key = {}, None
    for ln in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", ln)
        if entry:
            m = MANGLED.search(entry.group(1))
            key = (f"taps {m.group(1)} out {m.group(2)} src {m.group(3) or 'i'} "
                   f"scan {m.group(4) or 0}") if m else None
        elif key and ("registers" in ln or "spill" in ln):
            usage.setdefault(key, []).append(ln.split(":", 1)[-1].strip())
    return usage


def filled_stage(taps: int, inc: int) -> tuple:
    """The stage shape of int16 rows filled as ops.resample.stage_plan fills
    the entries' int32 stages, at the scan's increment: the first of
    TILED_STAGE_FRAMES whose window fits two blocks' share of shared memory,
    every row of that share held."""
    from clownresampler_tpu_torch.ops import resample as rs

    for f in rs.TILED_STAGE_FRAMES:
        rows = (rs.TILED_SHARED_BUDGET // 2 - 4 * f * (taps + 3)) // (2 * _build.TILED_LANES)
        if rows >= rs.stage_window_rows(inc, f, taps):
            return f, rows
    return rs.TILED_STAGE_FRAMES[-1], 0


def sweep(gen) -> list:
    """The scan mode's C entry at two scan steps for several stage shapes
    (see the module's docstring): mean ms of 20 back-to-back launches after
    20 untimed, in three rounds of turns."""
    from clownresampler_tpu_torch.lowlevel import scan_inplace_step_reference
    from clownresampler_tpu_torch.ops import resample as rs

    rows = []
    for rates in ((44100, 8000), (48000, 44100)):
        c = cs.scan_case(rates, 2048, 1, gen)
        inc, taps, r, n_out = c["increment"], c["max_taps"], c["radius"], c["n_out"]
        chunks, cfg = c["chunks"], c["state"].cfg
        state = torch.tensor([r + 2, 0x8421], dtype=torch.int32).to("cuda")
        shapes = {filled_stage(taps, inc)}
        shapes |= {(f, rs.stage_window_rows(inc, f, taps)) for f in (8, 16, 32, 64)}
        shapes = sorted(s for s in shapes
                        if _build.tiled_shared_bytes(*s, taps, 2) <= _build.MAX_SHARED_BYTES)
        want = scan_inplace_step_reference(c["table"], chunks, 1, state, cfg, radius=r,
                                           max_taps=taps, n_out=n_out, increment=inc,
                                           table_strided=c["table_strided"])
        calls = {}
        for f, w in shapes:
            out = torch.empty((n_out, 2048), dtype=torch.int32, device="cuda")
            book = torch.empty(4, dtype=torch.int32, device="cuda")
            args = _build.ordered_args("crt_tiled_scan", _build.tiled_scan_args(
                chunks, c["table"], c["table_strided"], state, cfg, out, book[0:1], book[1:2],
                book[2:4], step=1, radius=r, max_taps=taps, frames_per_stage=f, win_rows=w))
            calls[(f, w)] = (args, out, book)
        entry = _build.entry_function("crt_tiled_scan")
        times = {s: [] for s in shapes}
        for _ in range(3):
            for s in shapes:
                args = calls[s][0]
                for _ in range(20):
                    entry(*args)
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                for _ in range(20):
                    entry(*args)
                end.record()
                torch.cuda.synchronize()
                times[s].append(start.elapsed_time(end) / 20)
        for s in shapes:
            _, out, book = calls[s]
            exact = torch.equal(out, want[0]) and torch.equal(book[2:4], want[3])
            rows.append(dict(rates=rates, frames=s[0], window_rows=s[1],
                             plan=s == rs.scan_stage_plan(taps, inc, 2),
                             shared_bytes=_build.tiled_shared_bytes(*s, taps, 2),
                             ms=times[s], exact=exact))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--sweep", action="store_true")
    opts = ap.parse_args()
    t0 = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.library("resample")
    usage = tiled_usage(_build.BUILD_LOG["ptxas"]["resample"])
    if opts.parent:
        so = os.path.join(_build.BUILD_DIR, "parent_resample_kernels.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, os.path.join(
            opts.parent, "clownresampler_tpu_torch/ops/csrc/resample_kernels.cu"), "-o", so],
            capture_output=True, text=True, check=True)
        parent = tiled_usage(proc.stderr)
        usage = {k: dict(change=v, parent=parent.get(k)) for k, v in usage.items()}
    spills = [k for k, v in usage.items()
              if any(re.search(r"[1-9]\d* bytes spill", ln) for ln in
                     (v["change"] if opts.parent else v))]
    print(json.dumps(dict(part="build", seconds=_build.BUILD_LOG["seconds"], nvidia_smi=smi,
                          tiled_mac_kernel=usage, spills=spills)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bad, paths = [], set()
    for case in cs.SCAN_INPLACE_CASES:
        try:
            err, taken = cs.run_scan_mode_case(case, gen)
            paths |= taken
            path = sorted(taken)
        except AssertionError as exc:
            err, path = str(exc), None
            bad.append(case[0])
        print(json.dumps(dict(part="scan_inplace_case", label=case[0], err=err, path=path)),
              flush=True)
    missed = sorted(cs.SCAN_INPLACE_PATHS - paths)
    torch.cuda.synchronize()
    for run, cases in ((cs.run_tiled_case, cs.TILED_CASES),
                       (cs.run_general_case, cs.GENERAL_CASES)):
        for case in cases:
            got, want, rows, rows_ref = run(case, gen)
            if not (torch.equal(got, want) and torch.equal(rows, rows_ref)):
                bad.append(case[0])
    torch.cuda.synchronize()
    print(json.dumps(dict(part="cases", failed=bad, paths_missed=missed,
                          tiled_and_general_cases=len(cs.TILED_CASES) + len(cs.GENERAL_CASES),
                          seconds=time.time() - t0)), flush=True)
    if bad or missed or spills or opts.quick:
        return 1 if bad or missed or spills else 0
    if opts.sweep:
        rows = sweep(gen)
        for row in rows:
            print(json.dumps(dict(part="sweep", nvidia_smi=smi, **row)), flush=True)
        return 0 if all(row["exact"] for row in rows) else 1

    run = cs.run_scans(gen)[cs.SCAN7["rates"]]
    print(json.dumps(dict(part="scan_config7", **cs.check_scan(run),
                          replayed=cs.check_scan_replay(run, cs.SCAN7["replay"]))), flush=True)
    del run
    peaks = cs.card_peaks()
    for i in range(opts.repeat):
        timing = cs.time_scan(gen, peaks)
        print(json.dumps(dict(part="scan_timing", run=i, nvidia_smi=smi, **timing)), flush=True)
    print(json.dumps(dict(part="done", seconds=time.time() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
