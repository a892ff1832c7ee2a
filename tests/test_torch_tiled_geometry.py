"""The tiled kernel's launch geometry on the CPU.

``ops.resample.frame_geometry`` is the plain mirror of the geometry the
tiled kernel computes itself (int64 positions in closed form, window rows,
masked taps, the 17.15 reciprocal, the padding-frame clamp). It is held
against the launch precompute it replaces -- the port's ``precompute_launch``
+ ``launch_rows`` and the JAX package's ``precompute_launch`` -- on the same
seeded inputs, with exact equality, for every tiled increment class (d 0 and
1, cand 1-8), p0/f0 at the edges, n_out past 2^15 and padding frames, from
the flat and the strided table. The stage plan's shared memory is checked
against the card's limits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.lowlevel import make_device_state as jmake_state
from clownresampler_tpu.models import DEFAULT_MODEL as JMODEL
from clownresampler_tpu.ops import pallas_resample as jpr
from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch import interop
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs

CPU = torch.device("cpu")
# An input rate per tiled (d, cand) class at 48 kHz out: the middle of the
# class's increment range (d = 0 with cand = 1 would be an increment of 0).
CLASSES = [(d, c, 48000 if c == 1 else round(48000 * (d + (c - 1.5) / 7)))
           for d in (0, 1) for c in range(1, 9) if (d, c) != (0, 1)]
# (p0, f0, n_out): the start of a stream, positions at the 16-bit edges, and a
# launch past 2^15 frames (n * increment_lo stays in int32 for every class's
# increment, so the split-increment precompute is exact there too).
WHERE = [(0, 0, 64), (7, 65535, 64), (35651, 1, 33000)]


def _geometry_case(d, cand, in_rate, p0, f0, n_out):
    cfg = jconfigure(in_rate, 48000, max(in_rate, 48000))
    inc = fx.calculate_ratio(in_rate, 48000)
    assert rs.plan_uniform(inc, 0) == {"kernel": "tiled", "d": d, "cand": cand}
    taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    jstate = jmake_state(p0, f0, cfg, inc)
    state = interop.device_state_from_numpy(
        np.asarray(jstate.position_integer), np.asarray(jstate.position_fractional),
        [np.asarray(v) for v in jstate.cfg], CPU)
    tstr = JMODEL.strided_table(cfg.kernel_step_size, taps)
    # An input that ends halfway: the second half of the frames are padding
    # frames whose windows clamp into it.
    s = p0 + ((f0 + (n_out // 2) * inc) >> 16) + taps
    return dict(taps=taps, jstate=jstate, state=state, tstr=tstr, s=s)


@pytest.mark.parametrize("strided", [False, True], ids=["flat", "strided"])
@pytest.mark.parametrize("d,cand,in_rate", CLASSES,
                         ids=[f"d{d}-cand{c}" for d, c, _ in CLASSES])
def test_torch_tiled_frame_geometry_matches_precompute(d, cand, in_rate, strided):
    table = interop.table_from_numpy(JMODEL.table(), CPU)
    for p0, f0, n_out in WHERE:
        c = _geometry_case(d, cand, in_rate, p0, f0, n_out)
        tstr = interop.table_from_numpy(c["tstr"], CPU) if strided else None
        rows, clamped, kvals, q = rs.frame_geometry(
            table, c["state"], max_taps=c["taps"], n_out=n_out, s=c["s"], table_strided=tstr)
        want_rows, want_kv, want_q, _, _ = rs.precompute_launch(
            table, c["state"], max_taps=c["taps"], n_out=n_out, table_strided=tstr)
        jrows, jkv, jq, _, _ = jpr.precompute_launch(
            jnp.asarray(JMODEL.table()), c["jstate"], max_taps=c["taps"], n_out=n_out,
            table_strided=jnp.asarray(c["tstr"]) if strided else None)
        where = (p0, f0, n_out)
        for got in (rows, clamped, kvals, q):
            assert got.dtype == torch.int32, where
        np.testing.assert_array_equal(rows.numpy(), want_rows.numpy(), err_msg=f"{where}")
        np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows), err_msg=f"{where}")
        want_clamped = rs.launch_rows(want_rows, c["s"], c["taps"])
        np.testing.assert_array_equal(clamped.numpy(), want_clamped.numpy(), err_msg=f"{where}")
        assert (clamped != rows).any(), where  # the padding frames did clamp
        np.testing.assert_array_equal(kvals.numpy(), want_kv.numpy(), err_msg=f"{where}")
        np.testing.assert_array_equal(kvals.numpy(), np.asarray(jkv), err_msg=f"{where}")
        np.testing.assert_array_equal(q.numpy(), want_q.numpy(), err_msg=f"{where}")
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq), err_msg=f"{where}")


def test_torch_tiled_frame_geometry_exact_past_int32_split():
    """Where the split-increment positions of the precompute leave int32
    (n * increment_lo past 2^31), the kernel's int64 closed form stays exact:
    rows against numpy's int64 arithmetic."""
    c = _geometry_case(1, 8, CLASSES[-1][2], 0, 65535, 8)
    inc = fx.calculate_ratio(CLASSES[-1][2], 48000)
    n_out = 40000
    assert n_out * (inc & 0xFFFF) > 2**31
    table = interop.table_from_numpy(JMODEL.table(), CPU)
    rows, _, _, _ = rs.frame_geometry(table, c["state"], max_taps=c["taps"],
                                            n_out=n_out, s=1 << 20)
    cfg = jconfigure(CLASSES[-1][2], 48000, max(CLASSES[-1][2], 48000))
    t = 65535 + np.arange(n_out, dtype=np.int64) * inc
    want = (t >> 16) + ((t & 0xFFFF) + cfg.stretched_kernel_radius_delta + 0xFFFF >> 16)
    np.testing.assert_array_equal(rows.numpy(), want)


@pytest.mark.parametrize("taps", [8, 16, 24, 32, 40, 48, 64, 128, 200, 400, 1024])
def test_torch_tiled_stage_plan_fits_shared_memory(taps):
    """Every tiled class's stage plan fits the card's shared memory; the
    main path's widths (up to 40 taps) keep two blocks an SM, and only taps
    past ~200 read x directly (no staged window)."""
    for d in (0, 1):
        for cand in range(1, 9):
            bound = rs.tiled_increment_bound(d, cand)
            frames, rows = rs.stage_plan(taps, bound)
            assert frames in rs.TILED_STAGE_FRAMES
            smem = _build.tiled_shared_bytes(frames, rows, taps)
            assert smem <= _build.MAX_SHARED_BYTES, (d, cand, taps)
            if taps <= 40:
                assert smem <= rs.TILED_SHARED_BUDGET and rows > 0, (d, cand, taps)
            if rows:
                assert rows >= rs.stage_window_rows(bound, frames, taps)
            else:
                assert taps > 200, (d, cand, taps)
