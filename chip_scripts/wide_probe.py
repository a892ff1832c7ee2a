"""Decompose one tree's wide kernels on one CUDA card.

    python3 chip_scripts/wide_probe.py TREE LABEL [--quick]

Imports the port and chip_smoke.py from TREE (this checkout, or a `git
archive` of another commit unpacked inside it) and builds TREE's
clownresampler_tpu_torch/ops/csrc/wide_kernels.cu (wide_mac_kernel +
wide_fold_kernel) as it is and in variants, each its own library made by
patching the source's text: the MAC launch alone, the fold alone, the run
copies alone (no MACs, no fold) and the MAC with its taps made or copied
from one word in place of the LUT gather (no fold). A variant's output is
wrong by design; only the full build is checked, against the plain
version. At the wide entry's launch (44.1 kHz -> 132 Hz, 64 frames x 1024
lanes, 2008 taps) and the wide scan's step (44.1 kHz -> 1000 Hz, chunks
(2, 8192, 512) int16, step 1 from the state (r + 2, 0x8421), 183 frames
produced), each build's C call is timed by CUDA events (20 back-to-back
calls after 20 untimed, three rounds in turns), and then, last (a profiler
run slows the host's later launches), each build's device activities by
torch.profiler: the gap between the two launches is the full call's event
time less its kernels' device time. Also ptxas's registers, shared memory
and spills of every kernel, the blocks an SM holds (from those and the
card's limits: 65,536 registers, 233,472 bytes of shared memory, 1 KB
reserved a block, 2048 threads, 32 blocks), and, from `cuobjdump -sass`,
the innermost loops of the MAC kernels: their length and opcodes, and
their instructions per tap and lane (the length over half the plain IMAD
count: macc_trunc's product and bias are two IMADs a tap and lane). Prints
one JSON line (into chiprun_out/wide_probe.jsonl too); --quick skips the
variants and the SASS. compare_wide.sh runs it parent, change, change,
parent.
"""
import ctypes
import json
import os
import re
import subprocess
import sys
import time

tree, label = os.path.abspath(sys.argv[1]), sys.argv[2]
QUICK = "--quick" in sys.argv
OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chiprun_out")
sys.path.insert(0, tree)
os.chdir(tree)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch import lowlevel  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402
from clownresampler_tpu_torch.ops import resample as rs  # noqa: E402

SOURCE = os.path.join(_build.CSRC, "wide_kernels.cu")
MAC_LAUNCH = "wide_mac_kernel<SrcT, SCAN><<<grid, WIDE_THREADS, smem, stream>>>(P);"
FOLD_LAUNCH = "wide_fold_kernel<OutT, SCAN><<<fold_grid, WIDE_FOLD_THREADS, 0, stream>>>(P);"
# variant -> its patches [(text, replacement)], or several such lists, the
# first whose texts are all in the source taken (sources of other commits).
VARIANTS = {
    "mac_alone": [(FOLD_LAUNCH, "")],
    "fold_alone": [(MAC_LAUNCH, "")],
    "copies_alone": [(FOLD_LAUNCH, ""), ("    const int n_end = min(frames.y, valid);\n",
                                         "    const int n_end = P.T < 0 ? frames.y : 0;\n")],
    "taps_made": [
        [(FOLD_LAUNCH, ""), ("lut_tap(P.tt, srow, w.kernel_start, g.step, j0 + j, j1)",
                             "(j0 + j < j1 ? 1 + ((j0 + j) & 1023) : 0)")],
        [(FOLD_LAUNCH, ""), ("src = srow ? srow + j\n"
                             "                           : P.tt.table + min(max(w.kernel_start "
                             "+ j * g.step, 0),\n                                              "
                             "P.tt.table_size - 1);", "src = P.tt.table + (srow != nullptr);")]],
}
KERNEL = re.compile(r"Compiling entry function '(\S+)'")
USAGE = re.compile(r"Used (\d+) registers.*?(\d+) bytes smem")


def ptxas(log: str) -> dict:
    """{mangled kernel: {registers, static smem, lines}} of a -v log."""
    res, key = {}, None
    for ln in log.splitlines():
        m = KERNEL.search(ln)
        if m:
            key = m.group(1)
            res[key] = dict(lines=[])
        elif key and ("registers" in ln or "spill" in ln):
            res[key]["lines"].append(ln.split(":", 1)[-1].strip())
            u = USAGE.search(ln)
            if u:
                res[key].update(registers=int(u.group(1)), static_smem=int(u.group(2)))
    return res


def blocks_per_sm(regs: int, threads: int, smem: int) -> int:
    """Blocks of ``threads`` threads, ``regs`` registers each and ``smem``
    bytes of shared memory (static and dynamic) that one SM holds."""
    by_regs = 65536 // (-(-regs // 8) * 8 * threads)
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def dynamic_smem(kernel: str) -> int:
    """The dynamic shared memory a wide_mac_kernel instantiation launches
    with: two staged runs of 64 rows x 128 lanes, int16 or int32."""
    return 2 * 64 * 128 * (2 if "wide_mac_kernelIs" in kernel else 4)


def build(variants: dict) -> dict:
    """{variant: (loaded library, ptxas, .so path)}, every nvcc at once."""
    text = open(SOURCE).read()
    work = os.path.join(_build.BUILD_DIR, f"probe_{label}")
    os.makedirs(work, exist_ok=True)
    jobs = {}
    for name, patches in {"full": [], **variants}.items():
        options = patches if patches and isinstance(patches[0], list) else [patches]
        fits = [p for p in options if all(old in text for old, _ in p)]
        if not fits:
            raise SystemExit(f"variant {name}: no patch of it fits {SOURCE}")
        src = text
        for old, new in fits[0]:
            src = src.replace(old, new)
        cu, so = os.path.join(work, f"{name}.cu"), os.path.join(work, f"{name}.so")
        with open(cu, "w") as f:
            f.write(src)
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, cu, "-o", so],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name} failed to build:\n{err}")
        lib = ctypes.CDLL(so)
        for entry in _build.LIBRARIES["wide"][1]:
            fn = getattr(lib, entry)
            fn.argtypes = [ctypes.c_void_p if a in _build.POINTER_ARGS
                           else ctypes.c_longlong if a in _build.LONG_ARGS else ctypes.c_int
                           for a in _build.ENTRY_ARGS[entry]]
            fn.restype = ctypes.c_int
        libs[name] = (lib, ptxas(err), so)
    return libs


def sass_loops(so: str) -> dict:
    """The innermost loops (a backward branch with no other inside) of each
    wide_mac_kernel instantiation, the two with the most plain IMADs (the
    MAC loops): length, opcodes, and instructions per tap and lane (length
    over half the IMAD count)."""
    dump = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"), "-sass",
                           so], capture_output=True, text=True, check=True).stdout
    res = {}
    for block in dump.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        if "wide_mac_kernel" not in name:
            continue
        ins = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                         block)
        addr = [int(a, 16) for a, _, _ in ins]
        loops = []
        for i, (_, op, rest) in enumerate(ins):
            m = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and m and int(m.group(1), 16) < addr[i]:
                lo = addr.index(int(m.group(1), 16)) if int(m.group(1), 16) in addr else None
                if lo is not None:
                    loops.append((lo, i))
        inner = [(lo, hi) for lo, hi in loops
                 if not any(lo < a and b < hi for a, b in loops if (a, b) != (lo, hi))]
        stats = []
        for lo, hi in inner:
            ops = {}
            for _, op, _ in ins[lo : hi + 1]:
                ops[op] = ops.get(op, 0) + 1
            # A tap and lane is two plain IMADs (the product, the bias).
            imad = ops.get("IMAD", 0)
            stats.append(dict(length=hi - lo + 1, imad=imad,
                              per_tap_lane=2 * (hi - lo + 1) / imad if imad else None,
                              opcodes=dict(sorted(ops.items(), key=lambda kv: -kv[1])[:14])))
        res[name[:90]] = sorted(stats, key=lambda st: -st["imad"])[:2]
    return res


def entry_calls(lib) -> tuple:
    """(C call, check) of the wide entry at the timed launch."""
    w = cs.launch_case(44100, 132, 1024, 64, gen, f0=0x4321)
    extra = {}
    if hasattr(_build, "wide_scratch_ints"):
        extra["partial"] = torch.empty(_build.wide_scratch_ints(w["max_taps"], 64, 1024),
                                       dtype=torch.int32, device="cuda")
    entry, args = rs.entry_launch_args("wide", w["table"], w["x"], w["state"], d=w["d"],
                                       cand=None, max_taps=w["max_taps"], n_out=64,
                                       table_strided=w["table_strided"], **extra)
    out = torch.empty((64, 1024), dtype=torch.int32, device="cuda")
    args.update(out=out.data_ptr(), rows_out=None, clamp_s16=0, n_valid=None, frame_offset=0)
    call = (getattr(lib, entry), _build.ordered_args(entry, args))
    want = rs.resample_wide_taps_reference(w["table"], w["x"], w["state"], max_taps=w["max_taps"],
                                           n_out=64, d=w["d"],
                                           table_strided=w["table_strided"])[0]
    return [call], lambda: torch.equal(out, want), (w, extra)


def scan_calls(lib) -> tuple:
    """(C calls of one wide scan step, check) as chip_smoke.time_scan_step
    makes them."""
    c = cs.scan_case((44100, 1000), 512, 1, gen)
    r, n_out, taps, inc = c["radius"], c["n_out"], c["max_taps"], c["increment"]
    state = torch.tensor([r + 2, 0x8421], dtype=torch.int32, device="cuda")
    out = torch.empty((n_out, 512), dtype=torch.int32, device="cuda")
    book = torch.empty(4, dtype=torch.int32, device="cuda")
    extra = {}
    if hasattr(lowlevel, "_wide_scratch"):
        extra["partial"] = lowlevel._wide_scratch(c["chunks"], inc, taps, n_out)
    launches = lowlevel._scan_step_launches(
        c["table"], c["chunks"], state, c["state"].cfg, out, book[0:1], book[1:2], book[2:4],
        k=1, radius=r, max_taps=taps, increment=inc, table_strided=c["table_strided"], **extra)
    calls = [(getattr(lib, entry), _build.ordered_args(entry, args)) for entry, args in launches]
    want = lowlevel.scan_inplace_step_reference(
        c["table"], c["chunks"], 1, state, c["state"].cfg, radius=r, max_taps=taps, n_out=n_out,
        increment=inc, table_strided=c["table_strided"])
    return calls, lambda: all(torch.equal(g, w) for g, w in
                              zip((out, book[0], book[1], book[2:4]), want)), (c, extra, state)


def events_ms(calls, reps: int = 20) -> float:
    def issue(n):
        for _ in range(n):
            for fn, args in calls:
                err = fn(*args)
                if err:
                    raise RuntimeError(f"launch failed: {err}")
    issue(reps)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    issue(reps)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(calls) -> dict:
    """{device activity: ms a call} over 20 calls by torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    events_ms(calls, 5)
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(20):
            for fn, args in calls:
                fn(*args)
        torch.cuda.synchronize()
    return {e.key[:60]: dict(ms=e.self_device_time_total / 1e3 / 20, count=e.count)
            for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA}


t0 = time.time()
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
_build.library("resample")
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
libs = build({} if QUICK else VARIANTS)
usage = {}
for name, (_, info, _) in libs.items():
    for kernel, u in info.items():
        if "wide_mac_kernel" in kernel and "registers" in u:
            # 256 threads; the dynamic shared memory the C entry asks for.
            u["blocks_per_sm"] = blocks_per_sm(u["registers"], 256,
                                               u["static_smem"] + dynamic_smem(kernel))
        usage.setdefault(name, {})[kernel[:90]] = u
shapes = {"entry": entry_calls, "scan_step": scan_calls}
res = dict(tree=label, nvidia_smi=smi, ptxas=usage, shapes={})
for shape, make in shapes.items():
    per = {}
    for name, (lib, _, _) in libs.items():
        calls, check, keep = make(lib)
        per[name] = dict(calls=calls, check=check, keep=keep, ms=[])
    for _ in range(3):
        for name, p in per.items():
            p["ms"].append(events_ms(p["calls"]))
    ok = per["full"]["check"]()
    res["shapes"][shape] = dict(exact=ok, ms={name: p["ms"] for name, p in per.items()},
                                c_calls=len(per["full"]["calls"]))
    if not ok:
        print(json.dumps(dict(error=f"{shape}: the full build != the plain version")))
if not QUICK:
    res["sass"] = sass_loops(libs["full"][2])
# Device times last (a profiler run slows the host's later launches).
for shape, make in shapes.items():
    r = res["shapes"][shape]
    for name, (lib, _, _) in libs.items():
        calls, _, keep = make(lib)
        prof = profiled(calls)
        r.setdefault("device_ms_by_build", {})[name] = sum(v["ms"] for v in prof.values())
        if name == "full":
            r["profiled_device"] = prof
            r["device_ms"] = sum(v["ms"] for v in prof.values())
            r["gap_ms"] = min(r["ms"]["full"]) - r["device_ms"]
res["seconds"] = time.time() - t0
line = json.dumps(res)
os.makedirs(OUT, exist_ok=True)
with open(os.path.join(OUT, "wide_probe.jsonl"), "a") as f:
    f.write(line + "\n")
print(line, flush=True)
sys.exit(0 if all(s["exact"] for s in res["shapes"].values()) else 1)
