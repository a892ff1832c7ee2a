"""GPU smoke run of the PyTorch port's main path, with its hand-written kernels.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout: it
builds the kernels from clownresampler_tpu_torch/ops/csrc, holds each one
against its plain PyTorch version on the card, drives the public entry points
(the four reference goldens and a 1024-stream 48 kHz -> 44.1 kHz farm), times
the kernels and the farm, and prints one line per phase. Its last line is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}

Any failed phase raises, and the script then exits non-zero without that
line. It imports nothing of JAX.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 20261016
ROOT = os.path.dirname(os.path.abspath(__file__))
PCM = os.path.join(ROOT, "tests", "fixtures", "test_pcm_s16le.raw")
GOLDENS = [  # (in, out, lpf, md5 of the s32le output): BASELINE.md
    (8000, 44100, 44100, "949de6c35cf5bd547e5a1e9a04233c14"),
    (8000, 44100, 8000, "949de6c35cf5bd547e5a1e9a04233c14"),
    (44100, 8000, 44100, "470b7980951007f7074affc666424004"),
    (44100, 8000, 8000, "470b7980951007f7074affc666424004"),
]
# The fleet: 1024 stereo streams, 48 kHz -> 44.1 kHz, ~8192 frames a launch.
FARM_STREAMS, FARM_CHANNELS, FARM_RATES = 1024, 2, (48000, 44100)
FARM_CHUNK = 8916            # input frames that yield ~8192 output frames
FARM_CHUNKS = 8
FARM_SAMPLED = (0, 1, 517, 1023)
HEADLINE = dict(rates=(48000, 44100), lanes=2048, n_out=8192)
KERNEL_SOURCE = "clownresampler_tpu_torch/ops/csrc/resample_kernels.cu"
REPLACES = {
    "tiled_mac_kernel": "clownresampler_tpu/ops/pallas_resample.py:201",
    "general_mac_kernel": "clownresampler_tpu/ops/pallas_resample.py:475",
}


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def launch_case(in_rate, out_rate, lanes, n_out, rng, p0=0, f0=0):
    """A launch's inputs on the card: x sized so every real frame's window fits."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.lowlevel import make_device_state
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
    from clownresampler_tpu_torch.ops.resample import plan_uniform

    dev = torch.device("cuda")
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    s = p0 + ((f0 + n_out * inc) >> 16) + 2 * cfg.integer_stretched_kernel_radius + taps + 16
    x = torch.from_numpy(rng.integers(-32768, 32768, size=(s, lanes), dtype=np.int32)).to(dev)
    return dict(
        table=table_tensor(DEFAULT_MODEL.table(), dev), x=x,
        state=make_device_state(p0, f0, cfg, inc, dev), max_taps=taps, n_out=n_out,
        plan=plan_uniform(inc, n_out),
        table_strided=table_tensor(DEFAULT_MODEL.strided_table(cfg.kernel_step_size, taps), dev),
    )


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` back-to-back calls, by CUDA events.
    Every timed output is kept and checked equal to the first, so each
    launch's result is consumed; an untimed pass of `reps` kept calls first
    warms up and leaves the caching allocator holding the blocks the timed
    pass reuses, so no device allocation lands in the timed window."""
    first = fn()
    warm = [fn() for _ in range(reps)]
    del warm
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    outs = []
    start.record()
    for _ in range(reps):
        outs.append(fn())
    end.record()
    torch.cuda.synchronize()
    for o in outs:
        if not torch.equal(o, first):
            raise AssertionError("repeated launches disagree")
    return start.elapsed_time(end) / reps


def check_kernels(rng) -> dict:
    """Each kernel against its plain version on the same inputs on the card,
    exact equality over every frame of the launch (padding frames included)."""
    from clownresampler_tpu_torch.ops import resample as rs

    results = {"tiled_mac_kernel": [], "general_mac_kernel": []}
    tiled = [
        ("48k->44.1k headline", (48000, 44100), {}, {}),
        ("8k->44.1k d=0", (8000, 44100), {}, {}),
        ("44.1k->48k large cand", (44100, 48000), {}, {}),
        ("48k->44.1k p0=3 f0=12345", (48000, 44100), dict(p0=3, f0=12345), {}),
        ("48k->44.1k clamp_s16", (48000, 44100), {}, dict(clamp_s16=True)),
        ("48k->44.1k lane slice", (48000, 44100), {}, dict(lanes=1000, lane_offset=517)),
    ]
    for name, (a, b), where, opts in tiled:
        c = launch_case(a, b, HEADLINE["lanes"], HEADLINE["n_out"], rng, **where)
        args = dict(max_taps=c["max_taps"], n_out=c["n_out"], d=c["plan"]["d"],
                    cand=c["plan"]["cand"], table_strided=c["table_strided"], **opts)
        got, rows = rs.resample_uniform_lanes_tiled(c["table"], c["x"], c["state"], **args)
        want, rows_ref = rs.resample_uniform_lanes_tiled_reference(
            c["table"], c["x"], c["state"], **args)
        err = (got.long() - want.long()).abs().max().item()
        if c["plan"]["kernel"] != "tiled" or err or not torch.equal(rows, rows_ref) \
                or got.dtype != want.dtype:
            raise AssertionError(f"tiled kernel != reference at {name}: max err {err}")
        results["tiled_mac_kernel"].append((name, err))
    for a, b in ((44100, 8000), (44100, 7000)):
        c = launch_case(a, b, 2048, 4096, rng, p0=1, f0=777)
        args = dict(max_taps=c["max_taps"], n_out=c["n_out"], table_strided=c["table_strided"])
        got, _ = rs.resample_uniform_lanes_general(c["table"], c["x"], c["state"], **args)
        want, _ = rs.resample_uniform_lanes_general_reference(
            c["table"], c["x"], c["state"], **args)
        err = (got.long() - want.long()).abs().max().item()
        if c["plan"]["kernel"] != "general" or err:
            raise AssertionError(f"general kernel != reference at {a}->{b}: max err {err}")
        results["general_mac_kernel"].append((f"{a}->{b}", err))
    torch.cuda.synchronize()
    return results


def time_kernels(rng) -> dict:
    """Per-launch device times: each kernel alone and its plain version alone
    on the same precomputed inputs, and both entry points (precompute
    included), at the headline tiled launch and a 44.1k->8k general launch."""
    from clownresampler_tpu_torch.ops import _build
    from clownresampler_tpu_torch.ops import resample as rs

    out = {}
    c = launch_case(*HEADLINE["rates"], HEADLINE["lanes"], HEADLINE["n_out"], rng)
    st = c["state"]
    rows, kv, q, _, _ = rs.precompute_launch(c["table"], st, max_taps=c["max_taps"],
                                             n_out=c["n_out"], table_strided=c["table_strided"])
    rl = rs.launch_rows(rows, c["x"].shape[0], c["max_taps"])
    d, cand = c["plan"]["d"], c["plan"]["cand"]
    lanes = c["x"].shape[1]
    args = dict(max_taps=c["max_taps"], n_out=c["n_out"], d=d, cand=cand,
                table_strided=c["table_strided"])
    out["tiled_mac_kernel"] = dict(
        ms=cuda_ms(lambda: _build.tiled_mac(
            c["x"], rl, kv, q, lanes=lanes, lane_offset=0,
            frames_per_block=rs.TILED_FRAMES_PER_BLOCK,
            win_rows=rs.tiled_window_rows(d, cand, c["max_taps"]), clamp_s16=False)),
        plain_ms=cuda_ms(lambda: rs.mac_reference(c["x"], rl, kv, q, lanes, 0, False)),
        entry_ms=cuda_ms(lambda: rs.resample_uniform_lanes_tiled(
            c["table"], c["x"], st, **args)[0]),
        reference_entry_ms=cuda_ms(lambda: rs.resample_uniform_lanes_tiled_reference(
            c["table"], c["x"], st, **args)[0]),
        shape=f"x ({c['x'].shape[0]}, {lanes}) int32, n_out {c['n_out']}, taps {c['max_taps']}",
    )
    g = launch_case(44100, 8000, 2048, 4096, rng)
    rows, kv, q, _, _ = rs.precompute_launch(g["table"], g["state"], max_taps=g["max_taps"],
                                             n_out=g["n_out"], table_strided=g["table_strided"])
    rl = rs.launch_rows(rows, g["x"].shape[0], g["max_taps"])
    gargs = dict(max_taps=g["max_taps"], n_out=g["n_out"], table_strided=g["table_strided"])
    out["general_mac_kernel"] = dict(
        ms=cuda_ms(lambda: _build.general_mac(g["x"], rl, kv, q, lanes=2048, lane_offset=0,
                                              clamp_s16=False)),
        plain_ms=cuda_ms(lambda: rs.mac_reference(g["x"], rl, kv, q, 2048, 0, False)),
        entry_ms=cuda_ms(lambda: rs.resample_uniform_lanes_general(
            g["table"], g["x"], g["state"], **gargs)[0]),
        reference_entry_ms=cuda_ms(lambda: rs.resample_uniform_lanes_general_reference(
            g["table"], g["x"], g["state"], **gargs)[0]),
        shape=f"x ({g['x'].shape[0]}, 2048) int32, n_out {g['n_out']}, taps {g['max_taps']}",
    )
    return out


def run_goldens() -> list:
    """The reference's four golden conversions through resample_array, and two
    through HighLevelResampler.resample_stream (bulk, the CUDA default)."""
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.utils.audio_io import read_raw_s16le

    pcm = read_raw_s16le(PCM, channels=2)
    md5 = lambda a: hashlib.md5(np.asarray(a, dtype="<i4").tobytes()).hexdigest()
    done = []
    for in_rate, out_rate, lpf, want in GOLDENS:
        got = md5(crt.resample_array(pcm, in_rate, out_rate, lpf, device="cuda"))
        if got != want:
            raise AssertionError(f"resample_array {in_rate}->{out_rate} lpf {lpf}: md5 {got}")
        done.append(f"resample_array {in_rate}->{out_rate} lpf {lpf}")
    for in_rate, out_rate, lpf, want in GOLDENS[::2]:
        cursor = 0

        def feed(total: int) -> np.ndarray:
            nonlocal cursor
            got = pcm[cursor : cursor + total]
            cursor += got.shape[0]
            return got

        hl = crt.HighLevelResampler.init(2, in_rate, out_rate, lpf, device="cuda")
        got = md5(hl.resample_stream(feed))
        if got != want:
            raise AssertionError(f"resample_stream {in_rate}->{out_rate}: md5 {got}")
        done.append(f"resample_stream {in_rate}->{out_rate} lpf {lpf}")
    return done


def oracle_stream(data: np.ndarray, in_rate: int, out_rate: int) -> np.ndarray:
    """One stream through the port's gather oracle on the card: the whole
    radius-padded stream, every natural output frame, positions from exact
    host integers."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
    from clownresampler_tpu_torch.ops.convolve import ConfigScalars, convolve_frames

    dev = torch.device("cuda")
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = fx.calculate_ratio(in_rate, out_rate)
    r = cfg.integer_stretched_kernel_radius
    n = data.shape[0]
    padded = np.zeros((n + 2 * r, data.shape[1]), np.int16)
    padded[r : r + n] = data
    m = -(-(n << 16) // inc)
    t = np.arange(m, dtype=np.int64) * inc
    out = convolve_frames(
        table_tensor(DEFAULT_MODEL.table(), dev), torch.from_numpy(padded).to(dev),
        torch.from_numpy(t >> 16), torch.from_numpy(t & 0xFFFF),
        ConfigScalars.from_configuration(cfg, inc, dev), fx.round_up(2 * r, 8))
    return out.cpu().numpy()


def run_farm(rng) -> dict:
    """The 1024-stream farm: FARM_CHUNKS chunks then flush, each process()
    timed on the host clock (it ends in a device-to-host copy, so the device
    work is done); the first chunk is warm-up."""
    import clownresampler_tpu_torch as crt

    chunks = [rng.integers(-32768, 32768, size=(FARM_STREAMS, FARM_CHUNK, FARM_CHANNELS),
                           dtype=np.int16) for _ in range(FARM_CHUNKS)]
    farm = crt.UniformStreamFarm(FARM_STREAMS, FARM_CHANNELS, *FARM_RATES,
                                 chunk_frames=FARM_CHUNK, device="cuda")
    outs, times, frames = [], [], []
    for chunk in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = farm.process(chunk)
        times.append(time.perf_counter() - t0)
        frames.append(out.shape[1])
        outs.append(out)
    outs.append(farm.flush())
    steady_s = sum(times[1:])
    steady_samples = sum(frames[1:]) * FARM_STREAMS * FARM_CHANNELS
    return dict(outs=outs, chunks=chunks, frames=frames,
                msamples_per_s=steady_samples / steady_s / 1e6,
                ms_per_process=1e3 * steady_s / (len(times) - 1))


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one card", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    phase("environment", torch=torch.__version__, cuda=torch.version.cuda,
          device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          nvidia_smi=smi)

    from clownresampler_tpu_torch.ops import _build
    from clownresampler_tpu_torch.ops.resample import ROUTES

    _build.library()
    usage = [ln.strip() for ln in _build.BUILD_LOG["ptxas"].splitlines()
             if "registers" in ln or "Compiling entry" in ln]
    phase("build", seconds=round(_build.BUILD_LOG["seconds"], 3),
          library=os.path.relpath(_build.BUILD_LOG["path"], ROOT), ptxas=usage)

    rng = np.random.default_rng(SEED)
    checks = check_kernels(rng)
    phase("kernels_vs_plain", tolerance="exact equality", cases=checks)

    # The main path: reset the launch counts, drive the public entry points.
    ROUTES.clear()
    goldens = run_goldens()
    farm = run_farm(rng)
    launches = dict(ROUTES)
    phase("goldens", passed=goldens, md5_ok=True)
    if set(launches) != {("tiled", "cuda"), ("general", "cuda")}:
        raise AssertionError(f"main path took routes other than the two kernels: {launches}")

    got = np.concatenate(farm["outs"], axis=1)
    for i in FARM_SAMPLED:
        data = np.concatenate([c[i] for c in farm["chunks"]], axis=0)
        want = oracle_stream(data, *FARM_RATES)
        if not np.array_equal(got[i], want):
            raise AssertionError(f"farm stream {i} != gather oracle")
    if got.shape != (FARM_STREAMS, want.shape[0], FARM_CHANNELS):
        raise AssertionError(f"farm output shape {got.shape}")
    phase("farm", streams=FARM_STREAMS, channels=FARM_CHANNELS, rates=FARM_RATES,
          frames_per_process=farm["frames"], sampled_streams_exact=list(FARM_SAMPLED),
          output_shape=list(got.shape))

    timing = time_kernels(rng)
    phase("timing", nvidia_smi=smi, farm_msamples_per_s=farm["msamples_per_s"],
          farm_ms_per_process=farm["ms_per_process"], kernels=timing)

    kernels = []
    for name, route in (("tiled_mac_kernel", ("tiled", "cuda")),
                        ("general_mac_kernel", ("general", "cuda"))):
        kernels.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE, replaces=REPLACES[name],
            launches=launches.get(route, 0),
            max_abs_err=max(err for _, err in checks[name]),
            ms=timing[name]["ms"], plain_ms=timing[name]["plain_ms"]))
        if kernels[-1]["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
