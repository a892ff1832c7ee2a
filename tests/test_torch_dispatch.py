"""Port dispatch of the strided and wide classes through the public entry
points, and the gather oracle's memory bound, against the JAX package's
LowLevelResampler."""

import numpy as np
import pytest
import torch

from clownresampler_tpu.lowlevel import resample_array as jresample_array
from clownresampler_tpu_torch import LowLevelResampler, UniformStreamFarm, resample_array
from clownresampler_tpu_torch import farm as farm_mod
from clownresampler_tpu_torch import lowlevel as lowlevel_mod
from clownresampler_tpu_torch.ops import resample as rs
from tests.test_torch_farm import _jax_host_reference, _run

# (rates, class, stream frames, farm chunk sizes)
CASES = [((96000, 48000), "strided", 700, (100, 17, 256, 9, 200, 118)),
         ((44100, 132), "wide", 3000, (1000, 333, 1000, 667))]


@pytest.mark.parametrize("rates,kind,n,sizes", CASES, ids=["strided", "wide"])
def test_torch_new_classes_dispatch_on_cpu(rates, kind, n, sizes):
    """resample_array, a chunked LowLevelResampler and UniformStreamFarm take
    the class's plain version on the CPU, never the oracle, and equal the
    JAX package's LowLevelResampler."""
    rng = np.random.default_rng(41)
    data = rng.integers(-32768, 32768, size=(2, n, 2)).astype(np.int16)
    lpf = max(rates)
    want = [_jax_host_reference(data[i], 2, *rates, lpf) for i in range(2)]

    rs.ROUTES.clear()
    np.testing.assert_array_equal(resample_array(data[0], *rates, lpf), want[0])
    np.testing.assert_array_equal(resample_array(data[0], *rates, lpf),
                                  np.asarray(jresample_array(data[0], *rates, lpf)))
    got = _run(UniformStreamFarm(2, 2, *rates, lpf, chunk_frames=max(sizes)), data, sizes)
    for i in range(2):
        np.testing.assert_array_equal(got[i], want[i], err_msg=f"farm stream {i}")
    assert set(rs.ROUTES) == {(kind, "reference")}


def test_torch_wide_launch_tiling_matches_jax(monkeypatch):
    """Wide emits longer than wide_launch_frames split into several
    launches with exact host-int p0/f0 between them, in LowLevelResampler
    and in the farm."""
    monkeypatch.setattr(rs, "WIDE_MAX_TAP_MATRIX", 8 * 2008)
    assert rs.wide_launch_frames(2008) == 8
    rng = np.random.default_rng(43)
    data = rng.integers(-32768, 32768, size=(1, 9000, 2)).astype(np.int16)
    want = _jax_host_reference(data[0], 2, 44100, 132, 44100)
    assert want.shape[0] > 3 * 8
    rs.ROUTES.clear()
    np.testing.assert_array_equal(resample_array(data[0], 44100, 132, 44100), want)
    launches = rs.ROUTES[("wide", "reference")]
    assert launches == -(-want.shape[0] // 8)
    got = _run(UniformStreamFarm(1, 2, 44100, 132, chunk_frames=3000), data, (3000,) * 3)
    np.testing.assert_array_equal(got[0], want)


@pytest.mark.parametrize("taps,frames", [(6016, 1024), (2008, 3064), (1016, 6056), (272, 22648),
                                         (8, 770048), (6000000, 8)])
def test_torch_wide_launch_frames_bound_the_tap_matrix(taps, frames):
    """A wide launch holds at most WIDE_MAX_TAP_MATRIX (frames x taps) ints,
    in whole 8-frame tiles, and at least one tile."""
    assert rs.wide_launch_frames(taps) == frames
    assert frames % 8 == 0
    assert frames * taps <= rs.WIDE_MAX_TAP_MATRIX or frames == 8


@pytest.mark.parametrize("rates,taps", [((44100, 1000), 272), ((44100, 262), 1016)],
                         ids=["taps272", "taps1016"])
def test_torch_general_ratio_wide_launches_on_cpu(rates, taps):
    """A general ratio past GENERAL_WIDE_MIN_TAPS takes the wide class in
    launches as long as its tap width allows (not a fixed frame count), and
    equals the JAX package's resample_array."""
    assert taps >= lowlevel_mod.GENERAL_WIDE_MIN_TAPS
    rng = np.random.default_rng(59)
    data = rng.integers(-32768, 32768, size=(60000, 2)).astype(np.int16)
    rs.ROUTES.clear()
    got = resample_array(data, *rates, max(rates))
    np.testing.assert_array_equal(got, np.asarray(jresample_array(data, *rates, max(rates))))
    assert set(rs.ROUTES) == {("wide", "reference")}
    assert rs.ROUTES[("wide", "reference")] == -(-got.shape[0] // rs.wide_launch_frames(taps))


def test_torch_lowlevel_adjust_into_wide_and_strided_classes():
    """One stream adjusted across tiled -> strided -> wide -> general
    mid-stream equals the JAX LowLevelResampler given the same calls."""
    from clownresampler_tpu.lowlevel import LowLevelResampler as JLowLevel

    rng = np.random.default_rng(47)
    rates = [(48000, 44100), (96000, 48000), (44100, 132), (44100, 8000)]
    port = LowLevelResampler.init(2, *rates[0], 48000, max_radius=1003)
    ref = JLowLevel.init(2, *rates[0], 48000, max_radius=1003)
    rs.ROUTES.clear()
    for in_rate, out_rate in rates:
        assert port.adjust(in_rate, out_rate, max(in_rate, out_rate))
        assert ref.adjust(in_rate, out_rate, max(in_rate, out_rate))
        r = port.config.integer_stretched_kernel_radius
        n = 2500
        padded = rng.integers(-32768, 32768, size=(n + 2 * r, 2)).astype(np.int16)
        got = port.resample(padded, n)
        want = ref.resample(padded, n)
        assert got[:2] == tuple(want[:2])
        np.testing.assert_array_equal(got[2], np.asarray(want[2]))
        assert port.state_tuple() == tuple(int(v) for v in ref.state_tuple())
    assert {k for k, _ in rs.ROUTES} == {"tiled", "strided", "wide", "general"}
    assert all(impl == "reference" for _, impl in rs.ROUTES)


def test_torch_oracle_gather_cap_farm_launch(monkeypatch):
    """oracle_launch splits its frames into gathers of at most
    ORACLE_MAX_GATHER // max_taps frames: a farm whose launches are sent to
    the oracle, with the bound set small, gives the uncapped result and the
    JAX host reference, and no gather exceeds the bound."""
    monkeypatch.setattr(farm_mod, "launch_kind", lambda inc, taps: ("oracle", inc >> 16, None))
    rng = np.random.default_rng(53)
    data = rng.integers(-32768, 32768, size=(3, 1200, 2)).astype(np.int16)
    sizes = (500, 77, 500, 123)
    uncapped = _run(UniformStreamFarm(3, 2, 44100, 8000, chunk_frames=500), data, sizes)

    taps = 40
    monkeypatch.setattr(rs, "ORACLE_MAX_GATHER", 16 * taps)
    gathers = []
    real = rs.convolve_frames

    def spy(table, x, pos, frac, cfg, max_taps):
        gathers.append(pos.shape[0])
        assert max_taps == taps
        return real(table, x, pos, frac, cfg, max_taps)

    monkeypatch.setattr(rs, "convolve_frames", spy)
    rs.ROUTES.clear()
    capped = _run(UniformStreamFarm(3, 2, 44100, 8000, chunk_frames=500), data, sizes)
    assert set(rs.ROUTES) == {("oracle", "oracle")}
    assert max(gathers) == 16 and len(gathers) > rs.ROUTES[("oracle", "oracle")]
    np.testing.assert_array_equal(capped, uncapped)
    for i in range(3):
        np.testing.assert_array_equal(capped[i], _jax_host_reference(data[i], 2, 44100, 8000,
                                                                     44100))


def test_torch_multi_resample_refuses_unknown_kind():
    with pytest.raises(ValueError, match="unknown launch kind"):
        rs.multi_resample(torch.zeros(8, dtype=torch.int32), (torch.zeros((8, 1),
                          dtype=torch.int32),), (None,), (("bogus", 0, None, 8, 8, False),))
