"""The strided and wide kernels' launch geometry on the CPU.

``ops.resample.strided_frame_geometry`` is the plain mirror of the geometry
strided_mac_kernel computes itself (frame 0's window in int64, r0 + n*d rows,
the live tap count, the masked taps k0 and their 17.15 reciprocal q0), and
``ops.resample.frame_geometry`` that of the tiled and wide kernels. Both are
held against the launch precompute they replace -- the port's
``strided_setup`` / ``precompute_launch`` and the JAX package's
``_strided_setup`` / ``precompute_launch`` -- on the same seeded inputs, with
exact equality. The strided stage plan is checked against the card's shared
memory, and each entry's argument flow runs on the CPU with its kernel
launcher stood in by the plain mirror and ``mac_reference``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
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
# chip_smoke's strided ratios (d 2, 4, 3, 12) and 48k -> 8k (d 6).
STRIDED = list(chip_smoke.STRIDED_RATIOS) + [(48000, 8000)]
RESERVES = (16, 24, 40, 72)
# (p0, f0): the start of a stream and positions at the 16-bit edges.
EDGES = [(0, 0), (7, 65535), (65535, 1)]
WIDE = [(44100, 132), (44100, 44), (96000, 480), (44100, 262), (44100, 1000)]


def _state(in_rate, out_rate, p0, f0):
    cfg = jconfigure(in_rate, out_rate, max(in_rate, out_rate))
    inc = jfx.calculate_ratio(in_rate, out_rate)
    jstate = jmake_state(p0, f0, cfg, inc)
    state = interop.device_state_from_numpy(
        np.asarray(jstate.position_integer), np.asarray(jstate.position_fractional),
        [np.asarray(v) for v in jstate.cfg], CPU)
    return cfg, inc, jstate, state


def _reserves(cfg):
    natural = jfx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    return sorted({natural, *(t for t in RESERVES if t >= natural)})


@pytest.mark.parametrize("in_rate,out_rate", STRIDED, ids=[f"{a}-{b}" for a, b in STRIDED])
def test_torch_strided_frame_geometry_matches_setup_and_jax(in_rate, out_rate):
    table = interop.table_from_numpy(JMODEL.table(), CPU)
    jtable = jnp.asarray(JMODEL.table())
    n_out = 64
    for p0, f0 in EDGES:
        cfg, inc, jstate, state = _state(in_rate, out_rate, p0, f0)
        d = inc >> 16
        assert rs.plan_uniform(inc, 0) == {"kernel": "strided", "d": d}
        for taps in _reserves(cfg):
            where = (p0, f0, taps)
            # An input that ends halfway: the later frames are padding frames
            # whose windows clamp into it.
            s = p0 + (f0 >> 16) + (n_out // 2) * d + taps
            rows, clamped, live, k0, q0 = rs.strided_frame_geometry(
                table, state, max_taps=taps, n_out=n_out, d=d, s=s)
            want_rows, _, want_k0, want_q0 = rs.strided_setup(table, state, max_taps=taps,
                                                              n_out=n_out, d=d)
            x = jnp.zeros((d * (n_out + taps), 128), jnp.int32)
            jsetup = jpr._strided_setup(jtable, x, jstate, max_taps=taps, n_out=n_out, d=d,
                                        group=8)
            jrows, jq0 = jsetup[3], jsetup[2]
            jkv = jpr.precompute_launch(jtable, jstate, max_taps=taps, n_out=8)[1]
            for got in (rows, clamped, k0, q0):
                assert got.dtype == torch.int32, where
            np.testing.assert_array_equal(rows.numpy(), want_rows.numpy(), err_msg=f"{where}")
            np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows), err_msg=f"{where}")
            np.testing.assert_array_equal(clamped.numpy(),
                                          rs.launch_rows(want_rows, s, taps).numpy())
            assert (clamped != rows).any(), where  # the padding frames did clamp
            np.testing.assert_array_equal(k0.numpy(), want_k0.numpy(), err_msg=f"{where}")
            np.testing.assert_array_equal(k0.numpy(), np.asarray(jkv[0]), err_msg=f"{where}")
            assert int(q0[0]) == int(want_q0[0]) == int(jq0), where
            assert 0 < live <= taps, where


def test_torch_strided_k0_is_zero_past_live_taps():
    """What makes the kernel's live-tap loop exact: at every strided ratio
    and reserve, k0 past the live count is zero, and the live count is that
    of the ratio's natural width (a wider reserve adds only zero taps)."""
    table = interop.table_from_numpy(JMODEL.table(), CPU)
    for in_rate, out_rate in STRIDED:
        for p0, f0 in EDGES:
            cfg, inc, _, state = _state(in_rate, out_rate, p0, f0)
            lives = set()
            for taps in _reserves(cfg):
                _, _, live, k0, _ = rs.strided_frame_geometry(
                    table, state, max_taps=taps, n_out=8, d=inc >> 16, s=1 << 16)
                assert not k0[live:].any(), (in_rate, out_rate, p0, f0, taps)
                assert k0[:live].any()
                lives.add(live)
            assert len(lives) == 1, (in_rate, out_rate, lives)


@pytest.mark.parametrize("taps", [8, 16, 24, 40, 72, 128, 200, 400, 1024])
def test_torch_strided_stage_plan_fits_shared_memory(taps):
    """Every strided plan fits the card's shared memory; the main path's
    widths (up to 40 taps at d up to 4) keep two blocks an SM; only windows
    past the card's limit read x directly."""
    for d in range(2, 13):
        frames, rows = rs.strided_stage_plan(d, taps)
        assert frames in rs.STRIDED_STAGE_FRAMES
        smem = _build.strided_shared_bytes(taps, rows)
        assert smem <= _build.MAX_SHARED_BYTES, (d, taps)
        if rows:
            assert rows == (frames - 1) * d + taps
        else:
            assert _build.strided_shared_bytes(taps, 7 * d + taps) > _build.MAX_SHARED_BYTES
        if taps <= 40 and d <= 4:
            assert smem <= rs.STRIDED_SHARED_BUDGET and rows > 0, (d, taps)


def test_torch_wide_run_rows_match_the_kernel_source():
    """The Python scratch sizing and the CUDA source agree on the run size."""
    with open(_build.os.path.join(_build.CSRC, "wide_kernels.cu")) as f:
        src = f.read()
    rows = _build.WIDE_RUN_ROWS
    assert f"constexpr int WIDE_RUN_ROWS = {rows};" in src
    # A window of T rows meets at most wide_slots(T) runs, at any offset.
    for taps in (1, 63, 64, 65, 272, 2008, 6016):
        most = max((u + taps - 1) // rows + 1 for u in range(rows))
        assert _build.wide_slots(taps) == most, taps


@pytest.mark.parametrize("in_rate,out_rate", WIDE, ids=[f"{a}-{b}" for a, b in WIDE])
@pytest.mark.parametrize("strided", [False, True], ids=["flat", "strided"])
def test_torch_wide_frame_geometry_matches_jax_precompute(in_rate, out_rate, strided):
    table = interop.table_from_numpy(JMODEL.table(), CPU)
    n_out = 24
    for p0, f0 in EDGES:
        cfg, inc, jstate, state = _state(in_rate, out_rate, p0, f0)
        taps = jfx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
        tstr = JMODEL.strided_table(cfg.kernel_step_size, taps)
        s = p0 + ((f0 + (n_out // 2) * inc) >> 16) + taps
        rows, clamped, kvals, q = rs.frame_geometry(
            table, state, max_taps=taps, n_out=n_out, s=s,
            table_strided=interop.table_from_numpy(tstr, CPU) if strided else None)
        jrows, jkv, jq, _, _ = jpr.precompute_launch(
            jnp.asarray(JMODEL.table()), jstate, max_taps=taps, n_out=n_out,
            table_strided=jnp.asarray(tstr) if strided else None)
        where = (p0, f0, taps)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows), err_msg=f"{where}")
        np.testing.assert_array_equal(clamped.numpy(),
                                      rs.launch_rows(rows, s, taps).numpy())
        assert (clamped != rows).any(), where
        np.testing.assert_array_equal(kvals.numpy(), np.asarray(jkv), err_msg=f"{where}")
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=f"{where}")


def _strided_stand_in(calls):
    """_build.strided_mac as the kernel computes it, in plain torch: the
    argument checks that need no card, then the geometry mirror and
    mac_reference."""
    def launch(x, table, p0, f0, cfg, *, max_taps, n_out, d, lanes, lane_offset,
               frames_per_tile, win_rows, clamp_s16):
        _build._geometry_args(x, p0, f0, cfg)
        _build._check_taps(x, max_taps)
        assert (frames_per_tile, win_rows) == rs.strided_stage_plan(d, max_taps)
        assert _build.strided_shared_bytes(max_taps, win_rows) <= _build.MAX_SHARED_BYTES
        rows, clamped, _, k0, q0 = rs.strided_frame_geometry(
            table, DeviceState(p0, f0, cfg), max_taps=max_taps, n_out=n_out, d=d, s=x.shape[0])
        calls.append((type(p0), type(f0)))
        out = rs.mac_reference(x, clamped, k0.expand(n_out, -1), q0.expand(n_out), lanes,
                               lane_offset, clamp_s16)
        return out, rows
    return launch


def _wide_stand_in(calls):
    def launch(x, table, table_strided, p0, f0, cfg, *, max_taps, n_out, d, lanes,
               lane_offset, clamp_s16):
        _build._geometry_args(x, p0, f0, cfg)
        _build._check_taps(x, max_taps, table_strided)
        rows, clamped, kvals, q = rs.frame_geometry(
            table, DeviceState(p0, f0, cfg), max_taps=max_taps, n_out=n_out, s=x.shape[0],
            table_strided=table_strided)
        calls.append((type(p0), type(f0), table_strided is not None))
        return rs.mac_reference(x, clamped, kvals, q, lanes, lane_offset, clamp_s16), rows
    return launch


def _as_ints(state):
    return DeviceState(int(state.position_integer), int(state.position_fractional), state.cfg)


@pytest.mark.parametrize("ints", [False, True], ids=["tensors", "ints"])
def test_torch_strided_entry_argument_flow(monkeypatch, ints):
    """resample_strided_phases as it runs on a card (the launcher stood in),
    against the plain version: every strided ratio, a reserve of 40, a lane
    slice, the s16 clamp and a clamped tail; the state as 0-dim tensors and
    as ints."""
    calls = []
    monkeypatch.setattr(_build, "strided_mac", _strided_stand_in(calls))
    monkeypatch.setattr(rs, "_takes_reference", lambda x, kind: False)
    n = 0
    for in_rate, out_rate in STRIDED:
        _, p, m = _launch(in_rate, out_rate, CPU, n_out=64, lanes=160, p0=5, f0=3)
        st = _as_ints(p["state"]) if ints else p["state"]
        d = m["plan"]["d"]
        for x, opts in ((p["x"], {}), (p["x"], dict(max_taps=max(40, m["taps"]))),
                        (p["x"], dict(lanes=100, lane_offset=33, clamp_s16=True)),
                        (p["x"][: -20 * d], {})):
            args = dict(dict(max_taps=m["taps"], n_out=64, d=d), **opts)
            got, rows = rs.resample_strided_phases(p["table"], x, st, **args)
            want, want_rows = rs.resample_strided_reference(p["table"], x, p["state"], **args)
            assert got.dtype == want.dtype and torch.equal(got, want), (in_rate, opts)
            assert torch.equal(rows, want_rows), (in_rate, opts)
            n += 1
    assert len(calls) == n
    assert set(calls) == ({(int, int)} if ints else {(torch.Tensor, torch.Tensor)})


@pytest.mark.parametrize("ints", [False, True], ids=["tensors", "ints"])
def test_torch_wide_entry_argument_flow(monkeypatch, ints):
    """resample_wide_taps as it runs on a card (the launcher stood in),
    against the plain version at 44.1k->132 and 44.1k->262, from the flat
    and the strided table, clamped and on a lane slice; the state as 0-dim
    tensors and as ints."""
    calls = []
    monkeypatch.setattr(_build, "wide_mac", _wide_stand_in(calls))
    monkeypatch.setattr(rs, "_takes_reference", lambda x, kind: False)
    for in_rate, out_rate in ((44100, 132), (44100, 262)):
        _, p, m = _launch(in_rate, out_rate, CPU, n_out=16, lanes=96, p0=9, f0=0x8421)
        st = _as_ints(p["state"]) if ints else p["state"]
        for opts in ({}, dict(table_strided=p["tstr"]),
                     dict(clamp_s16=True, lanes=50, lane_offset=7)):
            args = dict(max_taps=m["taps"], n_out=16, d=m["inc"] >> 16, **opts)
            got, rows = rs.resample_wide_taps(p["table"], p["x"], st, **args)
            want, want_rows = rs.resample_wide_taps_reference(p["table"], p["x"], p["state"],
                                                              **args)
            assert got.dtype == want.dtype and torch.equal(got, want), (in_rate, opts)
            assert torch.equal(rows, want_rows)
    assert len(calls) == 6 and {c[2] for c in calls} == {False, True}
    assert {c[:2] for c in calls} == ({(int, int)} if ints else {(torch.Tensor, torch.Tensor)})
