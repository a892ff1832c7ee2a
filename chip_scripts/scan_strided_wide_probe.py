"""A short run of the strided and wide kernels' scan modes on one CUDA card.

    python3 chip_scripts/scan_strided_wide_probe.py [--quick] [--parent DIR]

Builds the kernels and prints ptxas's registers, spills and stack of every
strided_mac_kernel, wide_mac_kernel and wide_fold_kernel instantiation (with
--parent DIR, a checkout of another commit, also that tree's strided and wide
sources compiled with the same flags, each instantiation beside its
counterpart, the scan modes having none); holds every chip_smoke
STRIDED_SCAN_CASES, WIDE_SCAN_CASES and SCAN_INPLACE_CASES launch against its
plain version (exact) with the paths it took, every path of each table
required, then STRIDED_CASES and WIDE_CASES (the entries); --quick stops
there. Then the strided and wide engines' scans (chip_smoke.SCAN_ENGINES, as
the main path runs them) against the plain scan on every lane and the oracle
scan, their launch counts, and chip_smoke.time_scan (config 7's and the
strided scan's K-slopes, every engine's scan mode alone beside its bound,
the step loops under torch.profiler). One JSON line a part; exits 1 if
anything disagrees or a kernel spills.
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

KERNEL = re.compile(r"Compiling entry function '(\S+)'")


def usage(log: str) -> dict:
    """{mangled kernel name: ptxas's register and spill lines} of a -v log."""
    res, key = {}, None
    for ln in log.splitlines():
        entry = KERNEL.search(ln)
        if entry:
            key = entry.group(1)
        elif key and ("registers" in ln or "spill" in ln):
            res.setdefault(key, []).append(ln.split(":", 1)[-1].strip())
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--parent")
    opts = ap.parse_args()
    t0 = time.time()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    _build.library("resample")
    libs = {name: usage(_build.BUILD_LOG["ptxas"].get(name, ""))
            for name in ("strided", "wide", "resample")}
    if opts.parent:
        for name in ("strided", "wide"):
            so = os.path.join(_build.BUILD_DIR, f"parent_{name}_kernels.so")
            proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, os.path.join(
                opts.parent, "clownresampler_tpu_torch/ops/csrc", _build.LIBRARIES[name][0]),
                "-o", so], capture_output=True, text=True, check=True)
            parent = usage(proc.stderr)
            libs[name] = {k: dict(change=v, parent=parent.get(k)) for k, v in libs[name].items()}
    spills = [k for lib in libs.values() for k, v in lib.items()
              if any(re.search(r"[1-9]\d* bytes spill", ln)
                     for ln in (v["change"] if isinstance(v, dict) else v))]
    print(json.dumps(dict(part="build", seconds=_build.BUILD_LOG["seconds"], nvidia_smi=smi,
                          ptxas=libs, spills=spills)), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    bad, missed = [], {}
    for kernel, cases, want in cs.SCAN_MODE_CASES:
        taken = set()
        for case in cases:
            try:
                err, paths = cs.run_scan_mode_case(case, gen)
                taken |= paths
            except AssertionError as exc:
                err, paths = str(exc), set()
                bad.append(case[0])
            print(json.dumps(dict(part="scan_mode_case", kernel=kernel, label=case[0], err=err,
                                  paths=sorted(paths))), flush=True)
        if want - taken:
            missed[kernel] = sorted(want - taken)
    torch.cuda.synchronize()
    for run, cases in ((cs.run_strided_case, cs.STRIDED_CASES), (cs.run_wide_case, cs.WIDE_CASES)):
        for case in cases:
            got, want, rows, rows_ref = run(case, gen)
            if not (torch.equal(got, want) and torch.equal(rows, rows_ref)):
                bad.append(case[0])
    torch.cuda.synchronize()
    print(json.dumps(dict(part="cases", failed=bad, paths_missed=missed,
                          entry_cases=len(cs.STRIDED_CASES) + len(cs.WIDE_CASES),
                          seconds=time.time() - t0)), flush=True)
    if bad or missed or spills or opts.quick:
        return 1 if bad or missed or spills else 0

    from clownresampler_tpu_torch.lowlevel import SCAN_ROUTES, _scan_engine
    from clownresampler_tpu_torch.ops.resample import ROUTES

    for rates, lanes in cs.SCAN_ENGINES[1:]:
        c = cs.scan_case(rates, lanes, cs.SCAN_ENGINE_CHUNKS, gen)
        ROUTES.clear()
        res = cs.fused_scan(c)
        torch.cuda.synchronize()
        kind, _, _, step = _scan_engine(c["increment"], c["max_taps"], c["n_out"])
        want = {(SCAN_ROUTES[kind], "cuda"): (cs.SCAN_ENGINE_CHUNKS + 1) * -(-c["n_out"] // step)}
        if dict(ROUTES) != want:
            raise AssertionError(f"scan {rates} launched {dict(ROUTES)}, not {want}")
        print(json.dumps(dict(part="scan", **cs.check_scan(dict(case=c, result=res,
                                                                seconds=None)))), flush=True)
        del c, res
    timing = cs.time_scan(gen, cs.card_peaks())
    print(json.dumps(dict(part="scan_timing", nvidia_smi=smi, **timing)), flush=True)
    print(json.dumps(dict(part="done", seconds=time.time() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
