"""GPU smoke run of the PyTorch port's main paths, with its hand-written kernels.

    python3 chip_smoke.py

Needs one CUDA card, the CUDA toolkit (nvcc) and the repository checkout: it
builds the kernels from clownresampler_tpu_torch/ops/csrc (one nvcc per
source, all at once), holds each kernel against its plain PyTorch version on
the card, drives the public entry points -- the four reference goldens, a
1024-stream 48 kHz -> 44.1 kHz farm, a 1024-stream 96 kHz -> 48 kHz farm
(strided kernel), the config-5 mixed-ratio farm with a per-stream adjust,
and the wide-kernel paths (44.1 kHz -> 132 Hz, and general ratios of 272
and 1016 taps) -- checks that every launch of
those paths took a CUDA kernel, checks their outputs against the gather
oracle, times the kernels and the farms, and prints one line per phase. Its
last line is

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
FARM = dict(streams=1024, channels=2, rates=(48000, 44100), chunk=8916, chunks=8,
            sampled=(0, 1, 517, 1023))
# Config 2's ratio as a fleet: 1024 stereo streams, 96 kHz -> 48 kHz,
# 16,384-frame chunks (8192 output frames a launch, the strided kernel).
STRIDED_FARM = dict(streams=1024, channels=2, rates=(96000, 48000), chunk=16384, chunks=8,
                    sampled=(0, 333, 1023))
# Config 5 (benchmarks/run_all.py:403-430): four ratio groups x 256 stereo
# streams, chunks of 8192 frames; after chunk 3 one stream moves to
# 44.1 kHz -> 8 kHz (general kernel), so every group reserves its radius 17.
MIXED = dict(groups=((48000, 44100), (44100, 48000), (8000, 48000), (96000, 48000)),
             per_group=256, channels=2, chunk=8192, chunks=6, adjust_after=3,
             moved=5, moved_to=(44100, 8000), max_radius=17)
# Config 8's ratio (taps 2008) as a fleet: 256 stereo streams, 44.1 kHz ->
# 132 Hz, one second a chunk (the wide kernel).
WIDE_FARM = dict(streams=256, channels=2, rates=(44100, 132), chunk=44100, chunks=4,
                 sampled=(0, 255))
# General-class ratios past lowlevel.GENERAL_WIDE_MIN_TAPS (taps 272 and
# 1016), which resample_array sends to the wide kernel.
GENERAL_WIDE_RATES = ((44100, 1000), (44100, 262))
HEADLINE = dict(rates=(48000, 44100), lanes=2048, n_out=8192)
STRIDED_RATIOS = ((96000, 48000), (192000, 48000), (132300, 44100), (529200, 44100))
# (rates, frames, lanes, p0, f0): the 44.1k -> 262 case (taps 1016) is in
# the general class by its width and is sent to the wide kernel directly.
WIDE_CASES = (((44100, 132), 64, 1024, 7, 0x8421), ((44100, 44), 64, 256, 3, 0x1111),
              ((96000, 480), 64, 1024, 5, 0), ((44100, 262), 64, 1024, 9, 0x8421))
# General-class ratios at taps 184, 248, 272, 312, 352 and 1016, and 2008:
# the general kernel against the wide kernel across their crossover.
CROSSOVER_RATES = ((44100, 1500), (44100, 1100), (44100, 1000), (44100, 850), (44100, 760),
                   (44100, 262), (44100, 132))
CSRC = "clownresampler_tpu_torch/ops/csrc/"
PALLAS = "clownresampler_tpu/ops/pallas_resample.py"
KERNELS = {  # name -> (ROUTES kind, source, TPU kernels it replaces)
    "tiled_mac_kernel": ("tiled", CSRC + "resample_kernels.cu", f"{PALLAS}:201"),
    "general_mac_kernel": ("general", CSRC + "resample_kernels.cu", f"{PALLAS}:475"),
    "strided_mac_kernel": ("strided", CSRC + "strided_kernels.cu",
                           f"{PALLAS}:664, {PALLAS}:720"),
    "wide_mac_kernel": ("wide", CSRC + "wide_kernels.cu", f"{PALLAS}:1074, {PALLAS}:1158"),
}


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def launch_case(in_rate, out_rate, lanes, n_out, gen, p0=0, f0=0):
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
    x = torch.randint(-32768, 32768, (s, lanes), generator=gen, dtype=torch.int32,
                      device=dev)
    return dict(
        table=table_tensor(DEFAULT_MODEL.table(), dev), x=x,
        state=make_device_state(p0, f0, cfg, inc, dev), max_taps=taps, n_out=n_out,
        plan=plan_uniform(inc, n_out), d=inc >> 16,
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


def _compare(results, kernel, name, got, want, rows=None, rows_ref=None):
    err = (got.long() - want.long()).abs().max().item()
    if err or got.dtype != want.dtype or got.shape != want.shape or (
            rows is not None and not torch.equal(rows, rows_ref)):
        raise AssertionError(f"{kernel} != plain version at {name}: max err {err}")
    results[kernel].append((name, err))


def check_kernels(gen) -> dict:
    """Each kernel against its plain version on the same inputs on the card,
    exact equality over every frame of the launch (padding frames included)."""
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.lowlevel import make_device_state
    from clownresampler_tpu_torch.ops import resample as rs

    results = {name: [] for name in KERNELS}
    tiled = [
        ("48k->44.1k headline", (48000, 44100), {}, {}),
        ("8k->44.1k d=0", (8000, 44100), {}, {}),
        ("44.1k->48k large cand", (44100, 48000), {}, {}),
        ("48k->44.1k p0=3 f0=12345", (48000, 44100), dict(p0=3, f0=12345), {}),
        ("48k->44.1k clamp_s16", (48000, 44100), {}, dict(clamp_s16=True)),
        ("48k->44.1k lane slice", (48000, 44100), {}, dict(lanes=1000, lane_offset=517)),
    ]
    for name, (a, b), where, opts in tiled:
        c = launch_case(a, b, HEADLINE["lanes"], HEADLINE["n_out"], gen, **where)
        args = dict(max_taps=c["max_taps"], n_out=c["n_out"], d=c["plan"]["d"],
                    cand=c["plan"]["cand"], table_strided=c["table_strided"], **opts)
        if c["plan"]["kernel"] != "tiled":
            raise AssertionError(f"{name} is not a tiled launch")
        got, rows = rs.resample_uniform_lanes_tiled(c["table"], c["x"], c["state"], **args)
        want, rows_ref = rs.resample_uniform_lanes_tiled_reference(
            c["table"], c["x"], c["state"], **args)
        _compare(results, "tiled_mac_kernel", name, got, want, rows, rows_ref)
    for a, b in ((44100, 8000), (44100, 7000)):
        c = launch_case(a, b, 2048, 4096, gen, p0=1, f0=777)
        args = dict(max_taps=c["max_taps"], n_out=c["n_out"], table_strided=c["table_strided"])
        if c["plan"]["kernel"] != "general":
            raise AssertionError(f"{a}->{b} is not a general launch")
        got, _ = rs.resample_uniform_lanes_general(c["table"], c["x"], c["state"], **args)
        want, _ = rs.resample_uniform_lanes_general_reference(
            c["table"], c["x"], c["state"], **args)
        _compare(results, "general_mac_kernel", f"{a}->{b}", got, want)
    for a, b in STRIDED_RATIOS:
        # One x per ratio, sized for the largest p0; the clamped-tail case
        # cuts it so that the last frames' windows clamp into the buffer.
        c = launch_case(a, b, HEADLINE["lanes"], HEADLINE["n_out"], gen, p0=5)
        if c["plan"]["kernel"] != "strided":
            raise AssertionError(f"{a}->{b} is not a strided launch")
        cfg = configure(a, b, max(a, b))
        inc = fx.calculate_ratio(a, b)
        cases = [(0, "", {}, c["x"]),
                 (1, "lane slice", dict(lanes=1000, lane_offset=517), c["x"]),
                 (5, "clamp_s16", dict(clamp_s16=True), c["x"]),
                 (5, "clamped tail", {}, c["x"][: -40 * c["d"]])]
        for p0, label, opts, x in cases:
            state = make_device_state(p0, 0, cfg, inc, x.device)
            args = dict(max_taps=c["max_taps"], n_out=c["n_out"], d=c["d"], **opts)
            got, rows = rs.resample_strided_phases(c["table"], x, state, **args)
            want, rows_ref = rs.resample_strided_reference(c["table"], x, state, **args)
            _compare(results, "strided_mac_kernel", f"{a}->{b} d={c['d']} p0={p0} {label}",
                     got, want, rows, rows_ref)
    for (a, b), n_out, lanes, p0, f0 in WIDE_CASES:
        c = launch_case(a, b, lanes, n_out, gen, p0=p0, f0=f0)
        if c["max_taps"] <= 1024 and (a, b) != (44100, 262):
            raise AssertionError(f"{a}->{b} is not a wide launch")
        for label, opts, x in (("", {}, c["x"]), ("clamp_s16", dict(clamp_s16=True), c["x"]),
                               ("clamped tail", {}, c["x"][: -8 * c["d"] - 8])):
            args = dict(max_taps=c["max_taps"], n_out=n_out, d=c["d"],
                        table_strided=c["table_strided"], **opts)
            got, rows = rs.resample_wide_taps(c["table"], x, c["state"], **args)
            want, rows_ref = rs.resample_wide_taps_reference(c["table"], x, c["state"], **args)
            _compare(results, "wide_mac_kernel",
                     f"{a}->{b} taps {c['max_taps']} {n_out}x{lanes} p0={p0} f0={f0} {label}",
                     got, want, rows, rows_ref)
    torch.cuda.synchronize()
    return results


def _precomputed(c):
    from clownresampler_tpu_torch.ops import resample as rs

    rows, kv, q, _, _ = rs.precompute_launch(c["table"], c["state"], max_taps=c["max_taps"],
                                             n_out=c["n_out"], table_strided=c["table_strided"])
    return rs.launch_rows(rows, c["x"].shape[0], c["max_taps"]), kv, q


def time_kernels(gen) -> dict:
    """Per-launch device times: each kernel alone and its plain version alone
    on the same precomputed inputs, and the entry points (precompute
    included), at the headline tiled launch, a 44.1k->8k general launch, the
    96k->48k strided farm launch and the 44.1k->132 wide launch; then the
    general kernel against the wide kernel from 184 to 2008 taps
    (CROSSOVER_RATES), and the wide entry's time per frame against its
    launch size."""
    from clownresampler_tpu_torch.ops import _build
    from clownresampler_tpu_torch.ops import resample as rs

    out = {}
    c = launch_case(*HEADLINE["rates"], HEADLINE["lanes"], HEADLINE["n_out"], gen)
    st = c["state"]
    rl, kv, q = _precomputed(c)
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
    g = launch_case(44100, 8000, 2048, 4096, gen)
    rl, kv, q = _precomputed(g)
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
    s = launch_case(*STRIDED_FARM["rates"], 2048, HEADLINE["n_out"], gen)
    rows, r0, k0, q0 = rs.strided_setup(s["table"], s["state"], max_taps=s["max_taps"],
                                        n_out=s["n_out"], d=s["d"])
    rl = rs.launch_rows(rows, s["x"].shape[0], s["max_taps"])
    fpb = rs.strided_frames_per_block(s["d"], s["max_taps"])
    sargs = dict(max_taps=s["max_taps"], n_out=s["n_out"], d=s["d"])
    out["strided_mac_kernel"] = dict(
        ms=cuda_ms(lambda: _build.strided_mac(
            s["x"], r0, k0, q0, n_out=s["n_out"], d=s["d"], lanes=2048, lane_offset=0,
            frames_per_block=fpb, clamp_s16=False)),
        plain_ms=cuda_ms(lambda: rs.mac_reference(
            s["x"], rl, k0.expand(s["n_out"], -1), q0.expand(s["n_out"]), 2048, 0, False)),
        entry_ms=cuda_ms(lambda: rs.resample_strided_phases(
            s["table"], s["x"], s["state"], **sargs)[0]),
        reference_entry_ms=cuda_ms(lambda: rs.resample_strided_reference(
            s["table"], s["x"], s["state"], **sargs)[0]),
        frames_per_block=fpb,
        shape=f"x ({s['x'].shape[0]}, 2048) int32, n_out {s['n_out']}, d {s['d']}, "
              f"taps {s['max_taps']}",
    )
    crossover = {}
    for rates in CROSSOVER_RATES:
        for n_out, lanes in ((64, 1024), (1024, 512)):
            w = launch_case(*rates, lanes, n_out, gen, f0=0x4321)
            rl, kv, q = _precomputed(w)
            wide_fn = lambda: _build.wide_mac(w["x"], rl, kv, q, lanes=lanes, lane_offset=0,
                                              tap_block=rs.WIDE_TAP_BLOCK, clamp_s16=False)
            general_fn = lambda: _build.general_mac(w["x"], rl, kv, q, lanes=lanes,
                                                    lane_offset=0, clamp_s16=False)
            if not torch.equal(wide_fn(), general_fn()):
                raise AssertionError(f"wide and general kernels disagree at {rates}")
            key = f"{rates[0]}->{rates[1]} taps {w['max_taps']}, {n_out} frames x {lanes} lanes"
            crossover[key] = dict(general_ms=cuda_ms(general_fn), wide_ms=cuda_ms(wide_fn))
            if (rates, n_out) == ((44100, 132), 64):
                wargs = dict(max_taps=w["max_taps"], n_out=n_out, d=w["d"],
                             table_strided=w["table_strided"])
                out["wide_mac_kernel"] = dict(
                    ms=crossover[key]["wide_ms"],
                    plain_ms=cuda_ms(lambda: rs.mac_reference(
                        w["x"], rl, kv, q, lanes, 0, False,
                        tap_block=rs.WIDE_REFERENCE_TAP_BLOCK), reps=5),
                    entry_ms=cuda_ms(lambda: rs.resample_wide_taps(
                        w["table"], w["x"], w["state"], **wargs)[0]),
                    reference_entry_ms=cuda_ms(lambda: rs.resample_wide_taps_reference(
                        w["table"], w["x"], w["state"], **wargs)[0], reps=5),
                    shape=f"x ({w['x'].shape[0]}, {lanes}) int32, n_out {n_out}, "
                          f"taps {w['max_taps']}")
    launch_frames = {}
    for n_out in (64, 256, 1024, rs.wide_launch_frames(2008)):
        w = launch_case(44100, 132, 512, n_out, gen)
        wargs = dict(max_taps=w["max_taps"], n_out=n_out, d=w["d"],
                     table_strided=w["table_strided"])
        ms = cuda_ms(lambda: rs.resample_wide_taps(w["table"], w["x"], w["state"], **wargs)[0],
                     reps=5)
        launch_frames[n_out] = dict(entry_ms=ms, us_per_frame=1e3 * ms / n_out)
    return dict(kernels=out, general_vs_wide=crossover, wide_launch_frames_taps2008=launch_frames)


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
    table = table_tensor(DEFAULT_MODEL.table(), dev)
    x = torch.from_numpy(padded).to(dev)
    scalars = ConfigScalars.from_configuration(cfg, inc, dev)
    step = max(1, (1 << 22) // fx.round_up(2 * r, 8))
    return np.concatenate([
        convolve_frames(table, x, torch.from_numpy(t[i : i + step] >> 16),
                        torch.from_numpy(t[i : i + step] & 0xFFFF), scalars,
                        fx.round_up(2 * r, 8)).cpu().numpy()
        for i in range(0, m, step)])


def drive_farm(farm, chunks, feed=lambda farm, chunk: farm.process(chunk)) -> dict:
    """Feed every chunk then flush; each call is timed on the host clock (it
    ends in a device-to-host copy, so the device work is done) and the first
    is left out as warm-up. Returns outputs, per-call times and the output
    samples of the steady calls."""
    outs, times = [], []
    for chunk in chunks:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(feed(farm, chunk))
        times.append(time.perf_counter() - t0)
    outs.append(farm.flush())
    return dict(outs=outs, times=times)


def _rate(res: dict, samples_per_call: list) -> dict:
    steady_s = sum(res["times"][1:])
    return dict(msamples_per_s=sum(samples_per_call[1:]) / steady_s / 1e6,
                ms_per_process=1e3 * steady_s / (len(res["times"]) - 1),
                ms_per_call=[1e3 * t for t in res["times"]])


def run_uniform_farm(spec: dict, rng) -> dict:
    import clownresampler_tpu_torch as crt

    chunks = [rng.integers(-32768, 32768, size=(spec["streams"], spec["chunk"], spec["channels"]),
                           dtype=np.int16) for _ in range(spec["chunks"])]
    farm = crt.UniformStreamFarm(spec["streams"], spec["channels"], *spec["rates"],
                                 chunk_frames=spec["chunk"], device="cuda")
    res = drive_farm(farm, chunks)
    res.update(chunks=chunks, frames=[o.shape[1] for o in res["outs"][:-1]])
    res.update(_rate(res, [o.size for o in res["outs"][:-1]]))
    return res


def check_uniform_farm(spec: dict, res: dict) -> list:
    got = np.concatenate(res["outs"], axis=1)
    for i in spec["sampled"]:
        data = np.concatenate([c[i] for c in res["chunks"]], axis=0)
        want = oracle_stream(data, *spec["rates"])
        if not np.array_equal(got[i], want):
            raise AssertionError(f"farm {spec['rates']} stream {i} != gather oracle")
    if got.shape != (spec["streams"], want.shape[0], spec["channels"]):
        raise AssertionError(f"farm output shape {got.shape}")
    return list(got.shape)


def run_mixed_farm(rng) -> dict:
    """Config 5 through MixedStreamFarm; after MIXED["adjust_after"] chunks
    stream MIXED["moved"] moves to MIXED["moved_to"]."""
    import clownresampler_tpu_torch as crt

    m = MIXED
    specs = [rates for rates in m["groups"] for _ in range(m["per_group"])]
    n = len(specs)
    chunks = [rng.integers(-32768, 32768, size=(n, m["chunk"], m["channels"]), dtype=np.int16)
              for _ in range(m["chunks"])]
    farm = crt.MixedStreamFarm(specs, m["channels"], chunk_frames=m["chunk"],
                               max_radius=m["max_radius"], device="cuda")

    def feed(farm, chunk):
        if feed.calls == m["adjust_after"] and not farm.adjust_stream(m["moved"], *m["moved_to"]):
            raise AssertionError("adjust_stream refused the move")
        feed.calls += 1
        return farm.process(list(chunk))

    feed.calls = 0
    res = drive_farm(farm, chunks, feed)
    res.update(specs=specs, chunks=chunks, groups=len(farm._groups))
    res.update(_rate(res, [sum(o.size for o in outs) for outs in res["outs"][:-1]]))
    return res


def lowlevel_replay(data: np.ndarray, rates: tuple, chunk: int, adjust_after: int,
                    moved_to: tuple, r_bound: int) -> np.ndarray:
    """A stream through LowLevelResampler on the CPU (the plain versions) on
    a farm's schedule: after each chunk it resamples every received frame
    but a radius_bound hold-back, flush adds radius_bound zero frames, and
    the adjust lands before chunk ``adjust_after``."""
    import clownresampler_tpu_torch as crt

    ch = data.shape[1]
    rs = crt.LowLevelResampler.init(ch, *rates, max(rates), max_radius=r_bound)
    zeros = np.zeros((r_bound, ch), np.int16)
    padded = np.concatenate([zeros, data, zeros])
    n_chunks = data.shape[0] // chunk
    frames, consumed, received = [], 0, 0
    for i in range(n_chunks + 1):
        if i == adjust_after and not rs.adjust(*moved_to, max(moved_to)):
            raise AssertionError("LowLevel adjust refused")
        received += chunk if i < n_chunks else r_bound
        n_visible = received - consumed - r_bound
        if n_visible <= 0:
            continue
        r = rs.config.integer_stretched_kernel_radius
        start = r_bound + consumed - r
        _, remaining, f = rs.resample(padded[start : start + n_visible + 2 * r], n_visible)
        frames.append(f)
        consumed += n_visible - remaining
    return np.concatenate(frames)


def check_mixed_farm(res: dict) -> dict:
    m = MIXED
    streams = len(res["specs"])
    got = [np.concatenate([outs[i] for outs in res["outs"]], axis=0) for i in range(streams)]
    sampled = [g * m["per_group"] + 1 for g in range(len(m["groups"]))]
    for i in sampled:
        data = np.concatenate([c[i] for c in res["chunks"]], axis=0)
        if not np.array_equal(got[i], oracle_stream(data, *res["specs"][i])):
            raise AssertionError(f"mixed farm stream {i} {res['specs'][i]} != gather oracle")
    i = m["moved"]
    data = np.concatenate([c[i] for c in res["chunks"]], axis=0)
    want = lowlevel_replay(data, res["specs"][i], m["chunk"], m["adjust_after"],
                           m["moved_to"], m["max_radius"])
    if not np.array_equal(got[i], want):
        raise AssertionError(f"moved stream {i} != LowLevelResampler replay")
    return dict(sampled_streams_exact=sampled, moved_stream_exact=i,
                moved_frames=int(want.shape[0]), groups_after_adjust=res["groups"])


def run_wide_paths(rng) -> dict:
    import clownresampler_tpu_torch as crt
    from clownresampler_tpu_torch.utils.audio_io import read_raw_s16le

    pcm = read_raw_s16le(PCM, channels=2)
    array_out = crt.resample_array(pcm, *WIDE_FARM["rates"], max(WIDE_FARM["rates"]),
                                   device="cuda")
    general = {rates: crt.resample_array(pcm, *rates, max(rates), device="cuda")
               for rates in GENERAL_WIDE_RATES}
    return dict(pcm=pcm, array_out=array_out, general=general,
                farm=run_uniform_farm(WIDE_FARM, rng))


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

    _build.library("resample")
    usage = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "Compiling entry" in ln]
             for name, log in _build.BUILD_LOG["ptxas"].items()}
    phase("build", seconds=round(_build.BUILD_LOG["seconds"], 3),
          libraries={k: os.path.relpath(v, ROOT) for k, v in _build.BUILD_LOG["paths"].items()},
          ptxas=usage)

    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    checks = check_kernels(gen)
    phase("kernels_vs_plain", tolerance="exact equality", cases=checks)

    # The main paths: reset the launch counts, drive the public entry points,
    # read the counts; the outputs are checked afterwards (the checks' own
    # launches are not counted).
    ROUTES.clear()
    goldens = run_goldens()
    farm = run_uniform_farm(FARM, rng)
    strided = run_uniform_farm(STRIDED_FARM, rng)
    mixed = run_mixed_farm(rng)
    wide = run_wide_paths(rng)
    torch.cuda.synchronize()
    launches = dict(ROUTES)
    phase("routes", launches={f"{k}/{impl}": v for (k, impl), v in sorted(launches.items())})
    if set(launches) != {(kind, "cuda") for kind, _, _ in KERNELS.values()}:
        raise AssertionError(f"main paths took routes other than the four kernels: {launches}")

    phase("goldens", passed=goldens, md5_ok=True)
    for name, spec, res in (("farm", FARM, farm), ("strided_farm", STRIDED_FARM, strided)):
        shape = check_uniform_farm(spec, res)
        phase(name, streams=spec["streams"], channels=spec["channels"], rates=spec["rates"],
              chunk_frames=spec["chunk"], frames_per_process=res["frames"],
              sampled_streams_exact=list(spec["sampled"]), output_shape=shape,
              msamples_per_s=res["msamples_per_s"], ms_per_process=res["ms_per_process"],
              ms_per_call=res["ms_per_call"])
    phase("mixed_farm", groups=MIXED["groups"], streams_per_group=MIXED["per_group"],
          chunk_frames=MIXED["chunk"], moved_to=MIXED["moved_to"], **check_mixed_farm(mixed),
          msamples_per_s=mixed["msamples_per_s"], ms_per_process=mixed["ms_per_process"],
          ms_per_call=mixed["ms_per_call"])
    want = oracle_stream(wide["pcm"], *WIDE_FARM["rates"])
    if not np.array_equal(wide["array_out"], want):
        raise AssertionError("resample_array 44.1k->132 != gather oracle")
    for rates, got in wide["general"].items():
        if not np.array_equal(got, oracle_stream(wide["pcm"], *rates)):
            raise AssertionError(f"resample_array {rates[0]}->{rates[1]} != gather oracle")
    shape = check_uniform_farm(WIDE_FARM, wide["farm"])
    phase("wide", resample_array_frames=int(want.shape[0]), resample_array_exact=True,
          general_ratio_arrays_exact=[f"{a}->{b}" for a, b in GENERAL_WIDE_RATES],
          farm_streams=WIDE_FARM["streams"], farm_chunk_frames=WIDE_FARM["chunk"],
          farm_sampled_streams_exact=list(WIDE_FARM["sampled"]), farm_output_shape=shape,
          farm_msamples_per_s=wide["farm"]["msamples_per_s"],
          farm_ms_per_process=wide["farm"]["ms_per_process"],
          farm_ms_per_call=wide["farm"]["ms_per_call"])

    timing = time_kernels(gen)
    phase("timing", nvidia_smi=smi, **timing)

    kernels = []
    for name, (kind, source, replaces) in KERNELS.items():
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches.get((kind, "cuda"), 0),
            max_abs_err=max(err for _, err in checks[name]),
            ms=timing["kernels"][name]["ms"], plain_ms=timing["kernels"][name]["plain_ms"]))
        if kernels[-1]["launches"] < 1:
            raise AssertionError(f"{name} was not launched on the main paths")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
