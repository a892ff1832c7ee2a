"""The whole-stream scans of one tree of the repo, timed on one CUDA card.

    python3 chip_scripts/scan_ab.py TREE LABEL

Imports the port from TREE (this checkout, or a `git archive` of another
commit unpacked inside it), builds its kernels there and, for each engine's
scan at the main path's widths -- config 7 (44.1 kHz -> 8 kHz, the general
engine, 2048 lanes), the tiled (48 kHz -> 44.1 kHz, 2048 lanes), strided
(96 kHz -> 48 kHz, 2048 lanes) and wide (44.1 kHz -> 1000 Hz, 272 taps, 512
lanes) engines; int16 chunks of 8192 frames from one seed --, measures with
the same code in every tree: the K-slope between K = 8 and K = 40 chunks (CUDA
events around resample_scan_fused, best of 3, every output kept) in ms a
chunk and Msamples/s; the peak device memory of one K = 40 run above what was
allocated before it; the step loop's host us a step (ScanProgram.run alone,
no synchronise, best of 3) and its C calls a step; the device ms a step and
the device activities a step of the loop over K = 8 chunks (torch.profiler);
and a checksum of the K = 8 outputs, which must agree between trees. Prints
one JSON line with LABEL and the card. compare_scan.sh runs it parent,
change, change, parent, each a fresh process.
"""
import json
import os
import subprocess
import sys
import time

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)
import torch  # noqa: E402

import clownresampler_tpu_torch as crt_torch  # noqa: E402
from clownresampler_tpu_torch import fixedpoint as fx  # noqa: E402
from clownresampler_tpu_torch.configure import configure  # noqa: E402
from clownresampler_tpu_torch.lowlevel import (  # noqa: E402
    ScanProgram,
    make_device_state,
    resample_scan_fused,
)
from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor  # noqa: E402

SEED = 20261016
N_IN, K1, K2 = 8192, 8, 40
SCANS = (("config7", (44100, 8000), 2048), ("tiled", (48000, 44100), 2048),
         ("strided", (96000, 48000), 2048), ("wide", (44100, 1000), 512))


def case(rates, lanes: int, gen) -> dict:
    """K2 random int16 chunks and one zero chunk on the card, with config 7's
    geometry rules (taps the radius rounded up to 8, n_out ((n_in + 2r) <<
    16) // increment + 8 rounded up to 128)."""
    cfg = configure(*rates, max(rates))
    inc = fx.calculate_ratio(*rates)
    r = cfg.integer_stretched_kernel_radius
    taps = fx.round_up(2 * r, 8)
    chunks = torch.randint(-32768, 32768, (K2 + 1, N_IN, lanes), generator=gen,
                           dtype=torch.int32, device="cuda").to(torch.int16)
    chunks[K2] = 0
    return dict(chunks=chunks, table=table_tensor(DEFAULT_MODEL.table(), "cuda"),
                state=make_device_state(0, 0, cfg, inc, "cuda"),
                args=dict(max_taps=taps, radius=r, increment=inc,
                          n_out=fx.round_up((((N_IN + 2 * r) << 16) // inc) + 8, 128),
                          table_strided=table_tensor(
                              DEFAULT_MODEL.strided_table(cfg.kernel_step_size, taps), "cuda")))


def measure(c: dict) -> dict:
    scan = lambda k: resample_scan_fused(c["table"], c["chunks"][:k], c["state"], **c["args"])
    lanes = c["chunks"].shape[2]
    res = scan(K1)
    torch.cuda.synchronize()
    checksum = int(res[0].sum(dtype=torch.int64)) + int(res[1].sum())
    del res

    def timed(k):
        best, produced = None, None
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            torch.cuda.synchronize()
            start.record()
            out = scan(k)
            end.record()
            torch.cuda.synchronize()
            best = min(best or 1e30, start.elapsed_time(end))
            produced = int(out[1].sum())
            del out
        return best, produced

    (t1, p1), (t2, p2) = timed(K1), timed(K2)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = scan(K2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    loop_us, calls = [], None
    for _ in range(3):
        program = ScanProgram(c["table"], c["chunks"][:K2], c["state"], **c["args"])
        calls = len(program.calls) / K2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        program.run()
        loop_us.append(1e6 * (time.perf_counter() - t0) / K2)
        torch.cuda.synchronize()
        del program
    ms_per_chunk = (t2 - t1) / (K2 - K1)
    return dict(run_ms=[t1, t2], ms_per_chunk=ms_per_chunk,
                msamples_per_s=(p2 - p1) * lanes / (ms_per_chunk * (K2 - K1)) / 1e3,
                peak_bytes_k40=peak, step_loop_host_us=min(loop_us),
                step_loop_host_us_runs=loop_us, c_calls_per_step=calls, checksum_k8=checksum)


def profile(c: dict) -> dict:
    """The step loop over K1 chunks under torch.profiler: device ms and
    device activities a step."""
    program = ScanProgram(c["table"], c["chunks"][:K1], c["state"], **c["args"])
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        program.run()
        torch.cuda.synchronize()
    device_us, count = 0.0, 0
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            device_us += evt.self_device_time_total
            count += evt.count
    return dict(device_ms_per_step=device_us / 1e3 / K1, device_activities_per_step=count / K1)


def main() -> int:
    assert os.path.dirname(os.path.dirname(os.path.abspath(crt_torch.__file__))) == tree
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = {name: case(rates, lanes, gen) for name, rates, lanes in SCANS}
    res = {name: dict(rates=rates, lanes=lanes, **measure(cases[name]))
           for name, rates, lanes in SCANS}
    # Last: a profiler run slows the host's later launches in its process.
    for name, c in cases.items():
        res[name].update(profile(c))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps(dict(tree=sys.argv[2], nvidia_smi=smi, scans=res)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
