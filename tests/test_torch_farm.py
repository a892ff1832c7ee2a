"""Port UniformStreamFarm: each stream equals the JAX LowLevelResampler run
on that stream alone (the host reference of the JAX farm tests)."""

import numpy as np
import pytest
import torch

from clownresampler_tpu.farm import UniformStreamFarm as JFarm
from clownresampler_tpu.lowlevel import LowLevelResampler as JLowLevel
from clownresampler_tpu_torch import UniformStreamFarm
from clownresampler_tpu_torch import farm as farm_mod

SIZES = (100, 17, 256, 9, 200, 118)


def _jax_host_reference(data, channels, in_rate, out_rate, lpf):
    rs = JLowLevel.init(channels, in_rate, out_rate, lpf)
    r = rs.config.integer_stretched_kernel_radius
    pad = np.zeros((r, channels), np.int16)
    _, _, frames = rs.resample(np.concatenate([pad, data, pad]), data.shape[0])
    return frames


def _run(farm, data, sizes=SIZES):
    outs, cursor = [], 0
    for size in sizes:
        outs.append(farm.process(data[:, cursor : cursor + size]))
        cursor += size
    assert cursor == data.shape[1]
    outs.append(farm.flush())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("in_rate,out_rate", [(48000, 44100), (8000, 44100), (44100, 8000),
                                              (96000, 48000)])
def test_torch_farm_streams_match_jax_lowlevel(in_rate, out_rate):
    rng = np.random.default_rng(21)
    b, ch = 4, 2
    data = rng.integers(-32768, 32768, size=(b, sum(SIZES), ch)).astype(np.int16)
    lpf = max(in_rate, out_rate)
    got = _run(UniformStreamFarm(b, ch, in_rate, out_rate, lpf, chunk_frames=256,
                                 device="cpu"), data)
    assert got.dtype == np.int32
    for i in range(b):
        np.testing.assert_array_equal(got[i], _jax_host_reference(data[i], ch, in_rate,
                                                                  out_rate, lpf),
                                      err_msg=f"stream {i}")


def test_torch_farm_pitch_bend_matches_jax_lowlevel():
    """adjust() between chunks == LowLevel_Adjust between chunked resamples,
    with the farm's schedule: after each chunk it resamples against all
    received frames minus a radius_bound hold-back; flush adds radius_bound
    zero frames."""
    rng = np.random.default_rng(5)
    b, ch, r_bound = 4, 2, 6
    rates = [(22050, 44100), (33075, 44100), (44100, 44100), (66150, 44100)]
    data = rng.integers(-32768, 32768, size=(b, 600, ch)).astype(np.int16)
    farm = UniformStreamFarm(b, ch, *rates[0], 44100, chunk_frames=256, max_radius=r_bound,
                             device="cpu", clamp_s16=True)
    outs = []
    for i in range(4):
        if i:
            assert farm.adjust(rates[i][0], rates[i][1], 44100)
        outs.append(farm.process(data[:, 150 * i : 150 * (i + 1)]))
    outs.append(farm.flush())
    got = np.concatenate(outs, axis=1)
    assert got.dtype == np.int16

    for s in range(b):
        rs = JLowLevel.init(ch, *rates[0], 44100, max_radius=r_bound)
        zeros = np.zeros((r_bound, ch), np.int16)
        padded = np.concatenate([zeros, data[s], zeros])
        frames, consumed, received = [], 0, 0
        for i in range(5):
            if 0 < i < 4:
                assert rs.adjust(rates[i][0], rates[i][1], 44100)
            received += 150 if i < 4 else r_bound
            n_visible = received - consumed - r_bound
            if n_visible <= 0:
                continue
            r = rs.config.integer_stretched_kernel_radius
            start = r_bound + consumed - r
            _, remaining, f = rs.resample(padded[start : start + n_visible + 2 * r], n_visible)
            frames.append(f)
            consumed += n_visible - remaining
        want = np.clip(np.concatenate(frames), -0x7FFF, 0x7FFF).astype(np.int16)
        np.testing.assert_array_equal(got[s], want, err_msg=f"stream {s}")


def test_torch_farm_clamp_s16_is_clamped_int32():
    rng = np.random.default_rng(9)
    data = rng.integers(-32768, 32768, size=(3, sum(SIZES), 2)).astype(np.int16)
    wide = _run(UniformStreamFarm(3, 2, 8000, 44100, chunk_frames=256, device="cpu"), data)
    narrow = _run(UniformStreamFarm(3, 2, 8000, 44100, chunk_frames=256, clamp_s16=True,
                                    device="cpu"), data)
    assert narrow.dtype == np.int16 and np.abs(wide).max() > 0x7FFF
    np.testing.assert_array_equal(narrow, np.clip(wide, -0x7FFF, 0x7FFF))


def test_torch_farm_staging_is_its_programs_rows_as_in_jax():
    """A CPU farm stages in its FarmProgram: its staging is the program's
    ``rows()``, and after every call and the flush it holds the JAX farm's
    staged rows, with the JAX farm's output bytes."""
    rng = np.random.default_rng(13)
    data = rng.integers(-32768, 32768, size=(5, sum(SIZES), 2)).astype(np.int16)
    farm = UniformStreamFarm(5, 2, 48000, 44100, chunk_frames=256, device="cpu")
    jfarm = JFarm(5, 2, 48000, 44100, chunk_frames=256, interpret=True)
    (_, lo, hi, program), = farm._programs
    assert isinstance(program, farm_mod.FarmProgram) and (lo, hi) == (0, 5)
    assert not program.on_card and program.device == torch.device("cpu")

    def check(got, want, what):
        assert got.tobytes() == np.asarray(want).tobytes(), what
        assert farm._fill == jfarm._fill, what
        rows = program.rows()
        assert farm._staging.data_ptr() == rows.data_ptr() and farm._staging.shape == rows.shape
        np.testing.assert_array_equal(rows[: farm._fill].numpy(),
                                      np.asarray(jfarm._staging)[: farm._fill, :10], err_msg=what)

    cursor = 0
    for k, size in enumerate(SIZES):
        chunk = data[:, cursor : cursor + size]
        cursor += size
        check(farm.process(chunk), jfarm.process(chunk), f"call {k}")
    check(farm.flush(), jfarm.flush(), "flush")


def test_torch_farm_launch_tiling_matches_jax_lowlevel(monkeypatch):
    """Emits longer than MAX_LAUNCH_OUTPUT_FRAMES split into several launches
    with exact host-int p0/f0 between them."""
    monkeypatch.setattr(farm_mod, "MAX_LAUNCH_OUTPUT_FRAMES", 40)
    rng = np.random.default_rng(17)
    data = rng.integers(-32768, 32768, size=(2, sum(SIZES), 2)).astype(np.int16)
    got = _run(UniformStreamFarm(2, 2, 48000, 44100, chunk_frames=256, device="cpu"), data)
    for i in range(2):
        np.testing.assert_array_equal(got[i], _jax_host_reference(data[i], 2, 48000, 44100,
                                                                  48000))


def test_torch_farm_rejects_bad_input():
    farm = UniformStreamFarm(2, 2, 44100, 44100, 44100, chunk_frames=128, device="cpu")
    assert not farm.adjust(192000, 8000)      # radius beyond the bound
    assert farm.adjust(44100, 48000)
    with pytest.raises(ValueError):
        farm.process(np.zeros((2, 129, 2), np.int16))
    with pytest.raises(ValueError):
        UniformStreamFarm(2, 2, 44100, 43, 44100, device="cpu")
