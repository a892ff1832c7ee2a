"""The general entry's launch geometry on the CPU.

On a card the general entry is one launch of tiled_mac_kernel, which
computes each frame's geometry itself and picks its frames per stage from
the increment (``ops.resample.stage_frames``) inside the shared memory that
``ops.resample.stage_plan`` fixes for the smallest general increment. ``ops.resample.frame_geometry``,
the plain mirror of that geometry, is held against the launch precompute it
replaces -- the port's ``precompute_launch`` + ``launch_rows`` and the JAX
package's ``precompute_launch`` -- on the same seeded inputs, with exact
equality, for general increments of d 2 to 40; the stage plan against the
card's shared memory and every tile's span; and the entry's argument flow
with its launcher stood in by the mirror and ``mac_reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu import fixedpoint as jfx
from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.lowlevel import make_device_state as jmake_state
from clownresampler_tpu.models import DEFAULT_MODEL as JMODEL
from clownresampler_tpu.ops import pallas_resample as jpr
from clownresampler_tpu_torch import interop
from clownresampler_tpu_torch.lowlevel import DeviceState
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from tests.test_torch_resample_ops import _launch

CPU = torch.device("cpu")
# 44.1k -> 8k (d 5, config 7), 44.1k -> 7k (d 6), 48k -> 22.05k (d 2),
# 192k -> 44.1k (d 4) and 44.1k -> 1100 (d 40, 248 taps).
GENERAL = [(44100, 8000), (44100, 7000), (48000, 22050), (192000, 44100), (44100, 1100)]
# (p0, f0, n_out): the start of a stream, positions at the 16-bit edges, and
# a launch of 16,384 frames.
WHERE = [(0, 0, 64), (7, 65535, 64), (65535, 1, 64), (3, 0x8421, 16384)]
CSRC_RULE = "while (F > 8 && (((F - 1) * g.inc + 0xFFFF) >> 16) + T > W) F >>= 1;"


def _state(in_rate, out_rate, p0, f0):
    cfg = jconfigure(in_rate, out_rate, max(in_rate, out_rate))
    inc = jfx.calculate_ratio(in_rate, out_rate)
    jstate = jmake_state(p0, f0, cfg, inc)
    state = interop.device_state_from_numpy(
        np.asarray(jstate.position_integer), np.asarray(jstate.position_fractional),
        [np.asarray(v) for v in jstate.cfg], CPU)
    return cfg, inc, jstate, state


@pytest.mark.parametrize("strided", [False, True], ids=["flat", "strided"])
@pytest.mark.parametrize("in_rate,out_rate", GENERAL, ids=[f"{a}-{b}" for a, b in GENERAL])
def test_torch_general_frame_geometry_matches_precompute(in_rate, out_rate, strided):
    table = interop.table_from_numpy(JMODEL.table(), CPU)
    for p0, f0, n_out in WHERE:
        cfg, inc, jstate, state = _state(in_rate, out_rate, p0, f0)
        assert rs.plan_uniform(inc, 0)["kernel"] == "general"
        taps = jfx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
        tstr = JMODEL.strided_table(cfg.kernel_step_size, taps)
        # An input that ends halfway: the later frames are padding frames
        # whose windows clamp into it.
        s = p0 + ((f0 + (n_out // 2) * inc) >> 16) + taps
        port_tstr = interop.table_from_numpy(tstr, CPU) if strided else None
        rows, clamped, kvals, q = rs.frame_geometry(
            table, state, max_taps=taps, n_out=n_out, s=s, table_strided=port_tstr)
        want_rows, want_kv, want_q, _, _ = rs.precompute_launch(
            table, state, max_taps=taps, n_out=n_out, table_strided=port_tstr)
        jrows, jkv, jq, _, _ = jpr.precompute_launch(
            jnp.asarray(JMODEL.table()), jstate, max_taps=taps, n_out=n_out,
            table_strided=jnp.asarray(tstr) if strided else None)
        where = f"{(p0, f0, n_out, taps)}"
        for got in (rows, clamped, kvals, q):
            assert got.dtype == torch.int32, where
        np.testing.assert_array_equal(rows.numpy(), want_rows.numpy(), err_msg=where)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows), err_msg=where)
        np.testing.assert_array_equal(clamped.numpy(),
                                      rs.launch_rows(want_rows, s, taps).numpy(), err_msg=where)
        assert (clamped != rows).any(), where  # the padding frames did clamp
        np.testing.assert_array_equal(kvals.numpy(), want_kv.numpy(), err_msg=where)
        np.testing.assert_array_equal(kvals.numpy(), np.asarray(jkv), err_msg=where)
        np.testing.assert_array_equal(q.numpy(), want_q.numpy(), err_msg=where)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=where)


@pytest.mark.parametrize("taps", [8, 16, 24, 32, 40, 48, 64, 72, 92, 96, 128, 184, 248])
def test_torch_general_stage_plan_bounds_every_tile(taps):
    """The general stage plan keeps two blocks an SM up to 92 taps and one
    past that; at every general increment of d 2-40 the frames the kernel
    takes (stage_frames) hold a window that bounds every tile's span, and
    the narrow main-path widths stage: config 7 (44.1k -> 8k, 40 taps) in
    8-frame stages, every d = 2 launch up to 72 taps."""
    frames_max, win_rows = rs.stage_plan(taps, rs.GENERAL_MIN_INCREMENT)
    assert frames_max in rs.TILED_STAGE_FRAMES
    smem = _build.tiled_shared_bytes(frames_max, win_rows, taps)
    assert smem <= (rs.TILED_SHARED_BUDGET if taps <= 92 else _build.MAX_SHARED_BYTES)
    assert (smem > rs.TILED_SHARED_BUDGET) == (92 < taps <= 199)
    assert (win_rows > 0) == (taps <= 199)
    for d in range(2, 41):
        for lo in (1, 0x8421, 0xFFFF):
            inc = (d << 16) + lo
            frames = rs.stage_frames(inc, frames_max, taps, win_rows)
            assert frames in rs.TILED_STAGE_FRAMES and frames <= frames_max
            bound = rs.stage_window_rows(inc, frames, taps)
            assert frames == 8 or bound <= win_rows, (d, lo)
            for delta, f0 in ((40000, 65535), (0, 0), (65535, 1)):
                n = np.arange(frames * 4, dtype=np.int64)
                rows = -(-(f0 + n * inc + delta) // 65536)
                blocks = rows.reshape(-1, frames)
                assert (blocks[:, -1] - blocks[:, 0]).max() + taps <= bound, (d, lo, f0)
    if taps <= 72:
        assert rs.stage_window_rows((2 << 16) + 0xFFFF, 8, taps) <= win_rows
    if taps == 40:
        inc = jfx.calculate_ratio(44100, 8000)
        assert rs.stage_frames(inc, frames_max, taps, win_rows) == 8
        assert rs.stage_window_rows(inc, 8, taps) == 79 <= win_rows


def test_torch_stage_frames_keeps_every_tiled_plan():
    """For every tiled increment the kernel's rule takes the frames the
    stage plan chose from its class's increment bound."""
    for inc in list(range(1, 2**17, 997)) + [65535, 65536, 2**17 - 1]:
        plan = rs.plan_uniform(inc, 0)
        assert inc <= rs.tiled_increment_bound(plan["d"], plan["cand"])
        for taps in (8, 16, 40, 48, 128, 400):
            frames, win_rows = rs.stage_plan(
                taps, rs.tiled_increment_bound(plan["d"], plan["cand"]))
            assert rs.stage_frames(inc, frames, taps, win_rows) == frames, (inc, taps)
            if win_rows:
                assert rs.stage_window_rows(inc, frames, taps) <= win_rows


def test_torch_stage_frames_match_the_kernel_source():
    """The Python mirror and the CUDA source state the same rule."""
    with open(_build.os.path.join(_build.CSRC, "resample_kernels.cu")) as f:
        src = f.read()
    assert CSRC_RULE in src
    assert "const int F = stage_frames(g, P.F, T, P.W);" in src


def _tiled_stand_in(calls):
    """_build.tiled_mac as the kernel computes it, in plain torch: the
    argument checks that need no card, the kernel's frames per stage, then
    the geometry mirror and mac_reference."""
    def launch(x, table, table_strided, p0, f0, cfg, *, max_taps, n_out, lanes, lane_offset,
               frames_per_stage, win_rows, clamp_s16):
        _build._geometry_args(x, p0, f0, cfg)
        _build._check_taps(x, max_taps, table_strided)
        assert _build.tiled_shared_bytes(frames_per_stage, win_rows, max_taps) <= (
            _build.MAX_SHARED_BYTES)
        inc = (int(cfg.increment_hi) << 16) + int(cfg.increment_lo)
        frames = rs.stage_frames(inc, frames_per_stage, max_taps, win_rows)
        rows, clamped, kvals, q = rs.frame_geometry(
            table, DeviceState(p0, f0, cfg), max_taps=max_taps, n_out=n_out, s=x.shape[0],
            table_strided=table_strided)
        calls.append(((frames_per_stage, win_rows), frames, type(p0), type(f0),
                      table_strided is not None))
        return rs.mac_reference(x, clamped, kvals, q, lanes, lane_offset, clamp_s16), rows
    return launch


def _refuse(*args, **kwargs):
    raise AssertionError("precompute_launch ran on the card path")


@pytest.mark.parametrize("ints", [False, True], ids=["tensors", "ints"])
def test_torch_general_entry_argument_flow(monkeypatch, ints):
    """resample_uniform_lanes_general as it runs on a card (the launcher
    stood in, precompute_launch refused), against the plain version: d 2, 4,
    5 and 40, from the flat and the strided table, clamped to s16 on a lane
    slice, with a clamped tail; the state as 0-dim tensors and as ints."""
    calls, cases = [], []
    for in_rate, out_rate in ((44100, 8000), (48000, 22050), (192000, 44100), (44100, 1100)):
        _, p, m = _launch(in_rate, out_rate, CPU, n_out=64, lanes=160, p0=5, f0=0x8421)
        st = p["state"]
        if ints:
            st = DeviceState(int(st.position_integer), int(st.position_fractional), st.cfg)
        cut = (m["inc"] >> 16) * 20
        for x, opts in ((p["x"], {}), (p["x"], dict(table_strided=p["tstr"])),
                        (p["x"], dict(lanes=100, lane_offset=33, clamp_s16=True)),
                        (p["x"][:-cut], dict(table_strided=p["tstr"]))):
            args = dict(max_taps=m["taps"], n_out=64, **opts)
            want = rs.resample_uniform_lanes_general_reference(p["table"], x, p["state"], **args)
            cases.append((p["table"], x, st, args, want, m))
    monkeypatch.setattr(_build, "tiled_mac", _tiled_stand_in(calls))
    monkeypatch.setattr(rs, "_takes_reference", lambda x, kind: False)
    monkeypatch.setattr(rs, "precompute_launch", _refuse)
    rs.ROUTES.clear()
    for table, x, st, args, (want, want_rows), m in cases:
        got, rows = rs.resample_uniform_lanes_general(table, x, st, **args)
        assert got.dtype == want.dtype and torch.equal(got, want), (m["inc"], args)
        assert torch.equal(rows, want_rows), (m["inc"], args)
    assert len(calls) == len(cases) and rs.ROUTES[("general", "cuda")] == len(cases)
    for (plan, frames, *_), (_, _, _, args, _, m) in zip(calls, cases):
        assert plan == rs.stage_plan(args["max_taps"], rs.GENERAL_MIN_INCREMENT)
        assert frames == rs.stage_frames(m["inc"], *plan[:1], args["max_taps"], plan[1])
    assert {c[2:4] for c in calls} == ({(int, int)} if ints else {(torch.Tensor, torch.Tensor)})
    assert {c[4] for c in calls} == {False, True}
    assert {c[1] for c in calls} >= {8, 32}  # d 5 and d 2 stage 8 and 32 frames
