"""A short first run of the farm kernels and the farm call on one CUDA card.

    python3 chip_scripts/farm_probe.py [--quick]

Builds the kernels, prints ptxas's registers and spills of the farm library,
holds every chip_smoke.FARM_STAGE_CASES and FARM_UNSTAGE_CASES launch against
its plain version (exact; exits 1 if one disagrees), then prints, each with
the card's name and power limit beside it: the pinned copy rates both ways
and the headline call's bound from them (chip_smoke.copy_rates); the two
kernels' times beside their plain versions, bounds and the unstage's library
call, the unstage written straight into pinned memory beside kernel plus
download (chip_smoke.time_farm_kernels); the host's pass of a headline chunk
into the pinned input buffer, by numpy and by torch's threaded copy; the ways
a result may reach the caller (chip_smoke.time_result_delivery); the host's
pass cut into 1-16 stream ranges, alone and each range followed by its
upload, the overlap a farm call would get from staging its chunk in pieces;
each C call of a steady headline call on the host's clock; the headline
farm's steady call split into staging (the host's pass into the pinned input
and the issue of the upload and the stage launch), launch issue and copy out
with the caller keeping every output and dropping each, unsharded and
sharded, and once with a synchronise after the staging, timed; a steady
call of each farm kind under torch.profiler (chip_smoke.profile_farms); and
last the ways a chunk may reach the card, each as the headline farm's
``_write_rows`` in a fresh process (chip_scripts/farm_host_probe.py --fresh).
``--quick`` stops after the cases.
"""
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402

smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()


def show(name, **fields):
    print(json.dumps({"probe": name, "nvidia_smi": smi, **fields}), flush=True)


t0 = time.time()
_build.library("farm")
print("build", round(_build.BUILD_LOG["seconds"], 2), flush=True)
for ln in _build.BUILD_LOG["ptxas"].get("farm", "").splitlines():
    if any(k in ln for k in ("registers", "spill", "Compiling entry")):
        print("farm", ln.strip())
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
bad = []
for run, cases in ((cs.run_farm_stage_case, cs.FARM_STAGE_CASES),
                   (cs.run_farm_unstage_case, cs.FARM_UNSTAGE_CASES)):
    for case in cases:
        try:
            err = run(case, gen)
            torch.cuda.synchronize()
            err, path = err if isinstance(err, tuple) else (err, "")
            print(f"{run.__name__[4:-5]:13s} {case[0]:55s} err {err} path {path} OK", flush=True)
        except Exception as e:  # report every case, then fail
            bad.append(case[0])
            print(f"{run.__name__[4:-5]:13s} {case[0]:55s} RAISED {type(e).__name__}: {e}",
                  flush=True)
print("seconds to checks", round(time.time() - t0, 1), flush=True)
if bad:
    print("FAILED", bad)
    sys.exit(1)
if "--quick" in sys.argv:
    sys.exit(0)

peaks = cs.card_peaks()
show("copy_rates", **cs.copy_rates())
show("farm_kernels", **cs.time_farm_kernels(gen, peaks))

# The host's pass of a headline chunk into the pinned input buffer.
f = cs.FARM
rng = np.random.default_rng(cs.SEED)
chunks = [rng.integers(-32768, 32768, size=(f["streams"], f["chunk"], f["channels"]),
                       dtype=np.int16) for _ in range(f["chunks"])]
pinned = torch.empty(chunks[0].size, dtype=torch.int16, pin_memory=True)
pinned_array = pinned.numpy().reshape(chunks[0].shape)
passes = {}
for name, fn in (("numpy_copyto_ms", lambda ch: np.copyto(pinned_array, ch, casting="unsafe")),
                 ("torch_copy_ms", lambda ch: pinned.view(ch.shape).copy_(torch.from_numpy(ch)))):
    times = []
    for ch in chunks:
        t1 = time.perf_counter()
        fn(ch)
        times.append(1e3 * (time.perf_counter() - t1))
    passes[name] = statistics.median(times[1:])
show("host_pass_into_pinned_input", bytes=chunks[0].nbytes, threads=torch.get_num_threads(),
     **passes)

# The host pass in 1-16 equal stream ranges (bounds multiples of 4 streams):
# the torch copies alone, and each followed by its range's upload
# (crt_farm_copy, as a farm issues it), the host's ms to the last copy's
# return and to the last upload's end (a synchronise).
card_chunk = torch.empty(chunks[0].size, dtype=torch.int16, device="cuda")
stream = torch.cuda.current_stream().cuda_stream
upload = _build.entry_function("crt_farm_copy")
b, n, c = chunks[0].shape
for count in (1, 2, 4, 8, 16):
    bounds = [min(b, round(k * b / count / 4) * 4) for k in range(count)] + [b]
    parts = list(zip(bounds, bounds[1:]))
    row = dict(pieces=count)
    for mode in ("copies_alone", "copies_then_uploads"):
        times, landed = [], []
        for ch in chunks:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            for lo, hi in parts:
                torch.from_numpy(pinned_array[lo:hi]).copy_(torch.from_numpy(ch[lo:hi]))
                if mode == "copies_then_uploads":
                    _build.raise_on_launch(upload(
                        card_chunk.data_ptr() + 2 * lo * n * c,
                        pinned.data_ptr() + 2 * lo * n * c, 2 * (hi - lo) * n * c, 0, stream),
                        "crt_farm_copy")
            times.append(1e3 * (time.perf_counter() - t1))
            torch.cuda.synchronize()
            landed.append(1e3 * (time.perf_counter() - t1))
        row[mode + "_ms"] = statistics.median(times[1:])
        row[mode + "_landed_ms"] = statistics.median(landed[1:])
    show("host_pass_in_pieces", **row)
del card_chunk

import clownresampler_tpu_torch as crt  # noqa: E402

fm = crt.UniformStreamFarm(f["streams"], f["channels"], *f["rates"], chunk_frames=f["chunk"],
                           device="cuda")
for ch in chunks[:3]:
    fm.process(ch)
program, spent = fm._programs[0][3], {}


def timed_call(entry, args, call=program._call):
    t1 = time.perf_counter()
    call(entry, args)
    spent.setdefault(entry, []).append(1e3 * (time.perf_counter() - t1))


program._call = timed_call
for ch in chunks[3:]:
    fm.process(ch)
show("c_calls_of_a_steady_call",
     calls_a_process={k: len(v) / len(chunks[3:]) for k, v in spent.items()},
     median_ms={k: statistics.median(v) for k, v in spent.items()},
     max_ms={k: max(v) for k, v in spent.items()})
del fm
show("result_delivery", **cs.time_result_delivery())

# The headline farm: the caller keeps every output, then drops each.
kept = cs.run_uniform_farm(f, rng, chunks=chunks)
summary = lambda r: dict(msamples_per_s=r["msamples_per_s"], ms_per_process=r["ms_per_process"],
                         steady_split_ms=r["steady_split_ms"], ms_per_call=r["ms_per_call"])

show("headline_farm_keeping_every_output", **summary(kept))
for name, mesh in (("unsharded", None), ("sharded", cs.shard_mesh()), ("sharded", cs.shard_mesh()),
                   ("unsharded", None)):
    r = cs.run_uniform_farm(f, rng, chunks=chunks, mesh=mesh, expect=kept["outs"])
    show(f"headline_farm_dropping_outputs_{name}", **summary(r))
shape = cs.check_uniform_farm(f, kept)
show("headline_farm_checked", output_shape=shape, sampled=list(f["sampled"]))
steady = r["ms_per_process"]
waited = cs.run_uniform_farm(f, rng, chunks=chunks, expect=kept["outs"], wait_staging=True)
show("headline_farm_staging_waited", **summary(waited))
del kept
profiles = cs.profile_farms(rng, dict(chunks=chunks))
show("farm_profiles", calls=profiles,
     headline_device_idle_share=1 - profiles[0]["device_ms_total"] / steady)

# The ways a headline chunk may reach the card (farm_host_probe.CANDIDATES:
# the parent's torch copy into the pinned input, (a) the pageable upload, (b)
# the registered array, (c) the farm's own route, the farm library's host
# threads), each the farm's _write_rows in a fresh process, in turns; one line
# each, also into chiprun_out/farm_host_probe.jsonl.
host_probe = os.path.join(os.path.dirname(os.path.abspath(__file__)), "farm_host_probe.py")
names = ("torch_copy", "direct", "registered", "shipped")
for name in names + names[::-1]:
    rc = subprocess.run([sys.executable, host_probe, "--fresh", name]).returncode
    if rc:
        print(f"fresh {name} rc={rc}", flush=True)
print("seconds", round(time.time() - t0, 1))
