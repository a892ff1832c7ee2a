"""wide_mac_kernel's launch plan on the CPU.

``_build.wide_plan`` sizes a wide launch (wide_mac_kernel, then
wide_fold_kernel): the runs of WIDE_RUN_ROWS input rows its span can hold,
its lane tiles and items (run x lane tile), a frame's partial-sum slots and
scratch, and a block's shared memory. ``_build.wide_first_frame`` mirrors
how the kernel finds the frames meeting a run (in closed form, where it
searched before). These tests hold the plan to what the kernel needs at the
main paths' shapes (the 44.1k -> 132 entry, the 44.1k -> 1000 scan step, the
general ratios chip_smoke sends wide), at 6016 taps and under a 1024-tap
reserve: the closed form equal to a search over the frames' own rows on
seeded states; every live (frame, tap) summed by exactly one run, into a
slot the fold reads; the main shapes' frames a run all gathered with its
rows (WIDE_AHEAD_FRAMES); the shared memory within the card's; enough items
to fill the H100's 132 SMs. A numpy mirror of the kernels -- runs, the
frames meeting each, their taps gathered ahead (zero outside the window)
and MAC'd from an aligned row, the slots, the fold -- is held against the
plain version and the JAX package's wide Pallas kernel (interpret mode).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from clownresampler_tpu.ops import pallas_resample as jpr
from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.configure import configure
from clownresampler_tpu_torch.lowlevel import make_device_state
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from tests.test_torch_resample_ops import _launch

CPU = torch.device("cpu")
RUN = _build.WIDE_RUN_ROWS
# (label, rates, frames, lanes, p0, f0, valid frames or None, tap reserve or
# None): the wide entry's timed launch, the wide scan's step (183 of 256
# frames produced), chip_smoke's general ratios sent wide, 6016 taps, and
# 44.1k -> 1000 in a 1024-tap reserve (more frames a run than are gathered
# ahead).
SHAPES = [
    ("entry 44.1k->132", (44100, 132), 64, 1024, 7, 0x8421, None, None),
    ("scan step 44.1k->1000", (44100, 1000), 256, 512, 2, 0x8421, 183, None),
    *((f"general {a}->{b}", (a, b), 512, 1024, 2, 0xFFFF, None, None)
      for a, b in chip_smoke.GENERAL_WIDE_RATES),
    ("44.1k->44 taps 6016", (44100, 44), 64, 256, 3, 0x1111, None, None),
    ("44.1k->1000 in a 1024-tap reserve", (44100, 1000), 256, 512, 9, 0x0F0F, None, 1024),
]
MAIN = ("entry 44.1k->132", "scan step 44.1k->1000")


def _geometry(rates, frames, p0, f0, reserve=None, cut=0):
    """A wide launch's inputs (_launch, 128 lanes) and its frames' geometry
    as the kernel works it out: taps, d, the state's ints, the input's rows
    S, the unclamped and clamped window rows, live taps and masked taps
    (N, T)."""
    j, p, m = _launch(*rates, CPU, n_out=frames, lanes=128, p0=p0, f0=f0)
    taps = reserve or m["taps"]
    x = p["x"][: p["x"].shape[0] - cut] if cut else p["x"]
    rows, clamped, kvals, _ = rs.frame_geometry(p["table"], p["state"], max_taps=taps,
                                                n_out=frames, s=x.shape[0])
    _, _, live = rs._frame_windows(p["state"], torch.arange(frames, dtype=torch.int64))
    cfg = p["state"].cfg
    ints = dict(p0=int(p["state"].position_integer), f0=int(p["state"].position_fractional),
                inc=(int(cfg.increment_hi) << 16) + int(cfg.increment_lo),
                delta=int(cfg.stretched_kernel_radius_delta))
    return dict(j=j, p=dict(p, x=x), taps=taps, d=m["inc"] >> 16, ints=ints, s=x.shape[0],
                rows=rows.numpy().astype(np.int64), lo=clamped.numpy().astype(np.int64),
                live=live.clamp(0, taps).numpy(), kvals=kvals.numpy().astype(np.int64))


def _run_frames(g, run, a0, n):
    """The frames [n_lo, n_hi) that may meet run ``run`` (wide_run_frames)."""
    def first(bound):
        return _build.wide_first_frame(**g["ints"], n_frames=n,
                                       row_max=max(g["s"] - g["taps"], 0), bound=bound)

    b0 = a0 + run * RUN
    return first(b0 - g["taps"]), first(b0 + RUN - 1)


def test_torch_wide_first_frame_closed_form_matches_a_search():
    """The closed form gives the first frame whose clamped row passes the
    bound, as a search over the rows frame_window gives (rs._frame_windows)
    would, on 500 seeded states (positions and fractions at their edges
    among them), row limits and bounds around the rows."""
    rng = np.random.default_rng(1507)
    ratios = [(configure(a, b, max(a, b)), fx.calculate_ratio(a, b))
              for a, b in ((44100, 132), (44100, 1000), (44100, 262), (44100, 44), (96000, 480))]
    frames = torch.arange(64, dtype=torch.int64)
    for i in range(500):
        cfg, inc = ratios[i % len(ratios)]
        p0 = int(rng.integers(0, 5000)) if i % 7 else 0
        f0 = int(rng.choice([0, 1, 0x8000, 0xFFFF, int(rng.integers(0, 65536))]))
        rows = rs._frame_windows(make_device_state(p0, f0, cfg, inc, CPU), frames)[0].numpy()
        n = int(rng.integers(1, 65))
        rows = np.clip(rows[:n], 0, None)
        row_max = int(rng.integers(max(int(rows[-1]) - 400, 0), int(rows[-1]) + 400))
        clamped = np.minimum(rows, row_max)
        for bound in rng.integers(int(rows[0]) - 3000, int(rows[-1]) + 50, size=6):
            want = int(np.argmax(clamped > bound)) if (clamped > bound).any() else n
            got = _build.wide_first_frame(p0=p0, f0=f0, inc=inc,
                                          delta=cfg.stretched_kernel_radius_delta, n_frames=n,
                                          row_max=row_max, bound=int(bound))
            assert got == want, (inc, p0, f0, n, row_max, int(bound))


@pytest.mark.parametrize("label,rates,frames,lanes,p0,f0,valid,reserve", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_torch_wide_plan_covers_every_tap_once(label, rates, frames, lanes, p0, f0, valid,
                                               reserve):
    """Every live (frame, tap) lies in exactly one run, which lists the
    frame among its frames (the closed form), in a slot below the plan's;
    the runs stay within the plan's bound and the lane tiles cover every
    lane once; at the main shapes every frame meeting a run has its taps
    gathered with the run's rows, and the items fill the card's 132 SMs."""
    g = _geometry(rates, frames, p0, f0, reserve)
    plan = _build.wide_plan(frames, lanes, g["d"], g["taps"])
    assert (plan["lane_tiles"] - 1) * _build.TILED_LANES < lanes
    assert lanes <= plan["lane_tiles"] * _build.TILED_LANES
    lo, live = g["lo"], g["live"]
    a0 = int(lo[0])
    runs = -(-(int(lo[frames - 1]) + g["taps"] - a0) // RUN)
    assert runs <= plan["runs_bound"]
    bounds = [_run_frames(g, r, a0, frames) for r in range(runs)]
    most = 0
    for n in range(frames if valid is None else valid):
        if live[n] == 0:
            continue
        run = (lo[n] + np.arange(live[n]) - a0) // RUN
        first, last = int(run[0]), int(run[-1])
        assert last < runs and last - first + 1 <= plan["slots"], (label, n)
        for r in range(first, last + 1):
            n_lo, n_hi = bounds[r]
            assert n_lo <= n < n_hi, (label, n, r)
            most = max(most, n - n_lo + 1)
    if label in MAIN:
        assert most <= _build.WIDE_AHEAD_FRAMES, (label, most)
        assert plan["items_bound"] >= 132
    if reserve:
        assert most > _build.WIDE_AHEAD_FRAMES   # the warps' own fetch is taken too


@pytest.mark.parametrize("label,rates,frames,lanes,p0,f0,valid,reserve", SHAPES,
                         ids=[s[0] for s in SHAPES])
def test_torch_wide_plan_fits_the_card(label, rates, frames, lanes, p0, f0, valid, reserve):
    """A block's shared memory, two staged runs and the static taps, fits
    the card's 227 KB and three blocks an SM for int32 runs (four for the
    scan's int16 ones); the static part is what ptxas reports for the
    kernel (10,240 bytes) and its constants the CUDA source's; the scratch
    is the plan's slots."""
    g = _geometry(rates, frames, p0, f0, reserve)
    for elem, blocks in ((4, 3), (2, 4)):
        plan = _build.wide_plan(frames, lanes, g["d"], g["taps"], elem)
        assert plan["shared_bytes"] <= _build.MAX_SHARED_BYTES
        assert blocks * (plan["shared_bytes"] + 1024) <= 233472, (elem, plan)
        assert plan["scratch_ints"] == frames * plan["slots"] * (lanes + 1)
    assert _build.WIDE_STATIC_SHARED_BYTES == 10240
    with open(_build.os.path.join(_build.CSRC, "wide_kernels.cu")) as f:
        src = f.read()
    assert f"constexpr int WIDE_AHEAD_FRAMES = {_build.WIDE_AHEAD_FRAMES};" in src
    assert f"constexpr int WIDE_THREADS = {_build.WIDE_THREADS};" in src


def _trunc_mac(x, k):
    """C truncation of x * k / 2^16 (macc_trunc), int64."""
    p = x * k
    return (p + ((p >> 63) & 0xFFFF)) >> 16


def wide_kernel_mirror(g, *, lanes, clamp_s16=False, valid=None):
    """The two kernels in numpy: each run's frames (the closed form), a
    frame's taps for the run's 64 rows gathered ahead (zero outside its live
    window) or by its warp past WIDE_AHEAD_FRAMES, MAC'd from the run row
    of its first live tap rounded down to a quad, into slot run - (its first
    run); the fold sums the slots its geometry names. Returns the frames,
    how often each (frame, tap) was summed, and how many frames took each
    tap path."""
    n_frames, taps, s = g["lo"].shape[0], g["taps"], g["s"]
    x = g["p"]["x"][:, :lanes].numpy().astype(np.int64)
    lo, live, k = g["lo"], g["live"], g["kvals"]
    valid = n_frames if valid is None else valid
    a0 = int(lo[0])
    runs = -(-(int(lo[n_frames - 1]) + taps - a0) // RUN)
    partial, tap_sums = {}, {}
    summed = np.zeros((n_frames, taps), np.int64)
    paths = {"ahead": 0, "warp": 0}
    for run in range(runs):
        b0 = a0 + run * RUN
        n_lo, n_hi = _run_frames(g, run, a0, n_frames)
        for n in range(n_lo, min(n_hi, valid)):
            row = int(lo[n])
            j0, j1 = max(0, b0 - row), min(int(live[n]), b0 + RUN - row)
            if j0 >= j1:
                continue
            paths["ahead" if n < n_lo + _build.WIDE_AHEAD_FRAMES else "warp"] += 1
            j = b0 + np.arange(RUN) - row
            kt = np.where((j >= 0) & (j < live[n]), k[n, np.clip(j, 0, taps - 1)], 0)
            t0, t1 = (row + j0 - b0) & ~3, row + j1 - b0
            assert b0 + t1 <= s
            slot = run - (row - a0) // RUN
            assert (n, slot) not in partial
            partial[n, slot] = _trunc_mac(x[b0 + t0 : b0 + t1], kt[t0:t1, None]).sum(axis=0)
            tap_sums[n, slot] = int(kt.sum())
            summed[n, j0:j1] += 1
    out = np.zeros((n_frames, lanes), np.int64)
    for n in range(min(valid, n_frames)):
        slots = ((int(lo[n]) + int(live[n]) - 1 - a0) // RUN - (int(lo[n]) - a0) // RUN + 1
                 if live[n] > 0 else 0)
        assert {sl for m, sl in partial if m == n} == set(range(slots)), n
        acc = sum((partial[n, sl] for sl in range(slots)), np.zeros(lanes, np.int64))
        t = sum(tap_sums[n, sl] for sl in range(slots))
        q = (1 << 31) // max(abs(t), 2) * (-1 if t < 0 else 1)
        p = acc * q
        out[n] = np.where(p < 0, -((-p) >> 15), p >> 15)
    if clamp_s16:
        return np.clip(out, -0x7FFF, 0x7FFF).astype(np.int16), summed, paths
    return out.astype(np.int32), summed, paths


MIRROR = [
    ("44.1k->132 24 frames", (44100, 132), 24, 3, 0x8421, {}),
    ("44.1k->132 24 frames, 13 valid, clamp_s16", (44100, 132), 24, 1, 0xFFFF,
     dict(valid=13, clamp_s16=True)),
    ("44.1k->1000 48 frames, last frames at row_max", (44100, 1000), 48, 9, 0x1234,
     dict(cut=300)),
    ("44.1k->1000 48 frames in a 1024-tap reserve", (44100, 1000), 48, 4, 0x0ABC,
     dict(reserve=1024)),
]


@pytest.mark.parametrize("label,rates,frames,p0,f0,opts", MIRROR, ids=[m[0] for m in MIRROR])
def test_torch_wide_kernel_mirror_matches_plain_and_jax(label, rates, frames, p0, f0, opts):
    """The mirror of the kernels' runs, gathered taps, slots and fold sums
    every live (frame, tap) once and gives the plain version's frames, and
    the JAX package's wide kernel's where every frame is valid at the
    ratio's own width; the 1024-tap reserve takes the warps' own tap fetch
    too."""
    opts = dict(opts)
    valid, clamp = opts.pop("valid", None), opts.pop("clamp_s16", False)
    reserve, cut = opts.pop("reserve", None), opts.pop("cut", 0)
    g = _geometry(rates, frames, p0, f0, reserve, cut)
    got, summed, paths = wide_kernel_mirror(g, lanes=4, clamp_s16=clamp, valid=valid)
    want_summed = (np.arange(g["taps"])[None, :] < g["live"][:, None]).astype(np.int64)
    if valid is not None:
        want_summed[valid:] = 0
    np.testing.assert_array_equal(summed, want_summed)
    assert (paths["warp"] > 0) == bool(reserve)
    p, j = g["p"], g["j"]
    args = dict(max_taps=g["taps"], n_out=frames, d=g["d"])
    want, _ = rs.resample_wide_taps_reference(
        p["table"], p["x"], p["state"], clamp_s16=clamp, lanes=4,
        n_valid=None if valid is None else torch.tensor(valid, dtype=torch.int32), **args)
    np.testing.assert_array_equal(got, want.numpy())
    if valid is None and not cut and not reserve:
        jwant, _ = jpr.resample_wide_taps(j["table"], j["x"], j["state"], interpret=True,
                                          **args)
        jwant = np.asarray(jwant)[:, :4]
        if clamp:
            jwant = np.clip(jwant, -0x7FFF, 0x7FFF).astype(np.int16)
        np.testing.assert_array_equal(got, jwant)
