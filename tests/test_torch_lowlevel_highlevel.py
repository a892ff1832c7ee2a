"""Port streaming APIs: the reference goldens, the C-oracle scripts replayed
op by op, and a stream carried over from the JAX package mid-way.

Everything runs on the CPU, where the tiled and general classes take the
kernels' plain versions and the strided and wide classes the gather oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.lowlevel import LowLevelResampler as JLowLevel
from clownresampler_tpu.lowlevel import make_device_state as jmake_state
from clownresampler_tpu.lowlevel import resample_array as jresample_array
from clownresampler_tpu.lowlevel import resample_chunk as jresample_chunk
from clownresampler_tpu.models import lanczos_kernel_table as jtable
from clownresampler_tpu_torch import (
    HighLevelResampler,
    KernelModel,
    LowLevelResampler,
    resample_array,
)
from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.configure import configure
from clownresampler_tpu_torch.lowlevel import make_device_state, resample_chunk
from clownresampler_tpu_torch.models import lanczos_kernel_table, table_tensor
from clownresampler_tpu_torch.ops import resample as rs
from tests import oracle

GOLDENS = [
    (8000, 44100, 44100, "golden_8000_44100.raw"),   # test1
    (8000, 44100, 8000, "golden_8000_44100.raw"),    # test2
    (44100, 8000, 44100, "golden_44100_8000.raw"),   # test3
    (44100, 8000, 8000, "golden_44100_8000.raw"),    # test4
]


@pytest.mark.parametrize("in_rate,out_rate,lpf,golden_file", GOLDENS)
def test_torch_lowlevel_golden(in_rate, out_rate, lpf, golden_file):
    out = resample_array(oracle.pcm_fixture(), in_rate, out_rate, lpf, device="cpu")
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out.ravel(), oracle.golden(golden_file))


def _feeder(pcm, cap=None):
    cursor = 0

    def feed(total_frames: int) -> np.ndarray:
        nonlocal cursor
        give = min(total_frames, pcm.shape[0] - cursor, cap or total_frames)
        out = pcm[cursor : cursor + give]
        cursor += give
        return out

    return feed


@pytest.mark.parametrize("bulk", [False, True], ids=["host_loop", "bulk"])
@pytest.mark.parametrize("in_rate,out_rate,lpf,golden_file", GOLDENS[::2])
def test_torch_highlevel_golden(in_rate, out_rate, lpf, golden_file, bulk):
    rs.ROUTES.clear()
    hl = HighLevelResampler.init(2, in_rate, out_rate, lpf, device="cpu")
    out = hl.resample_stream(_feeder(oracle.pcm_fixture()), bulk=bulk)
    np.testing.assert_array_equal(out.ravel(), oracle.golden(golden_file))
    kind = "tiled" if in_rate < out_rate else "general"
    assert set(rs.ROUTES) == {(kind, "reference")}


@pytest.mark.parametrize("script", list(oracle.scripts("lowlevel")), ids=lambda s: s[0])
def test_torch_lowlevel_script(script):
    name, meta, ops, expected_out, stream = script
    ch = meta["channels"]
    pad, stream_frames = meta["pad"], meta["stream_frames"]
    stream = stream.reshape(-1, ch)
    low = LowLevelResampler.init(ch, *meta["rates"], device="cpu")
    produced, cursor = [], 0
    for row in ops:
        op, a0, a1, a2 = (int(v) for v in row[:4])
        exp_ret, exp_remaining, exp_produced = (int(v) for v in row[4:7])
        if op == 1:
            n = min(a0, stream_frames - cursor)
            radius = low.config.integer_stretched_kernel_radius
            window = stream[pad + cursor - radius : pad + cursor + n + radius]
            ret, remaining, frames = low.resample(window, n, output_limit=a1)
            assert (ret, remaining, frames.shape[0]) == \
                (bool(exp_ret), exp_remaining, exp_produced), (name, row)
            produced.append(frames)
            cursor += n - remaining
        else:
            assert op == 2 and low.adjust(a0, a1, a2) == bool(exp_ret), (name, row)
        assert low.state_tuple() == tuple(int(v) for v in row[7:14]), (name, row)
    got = np.concatenate(produced).ravel() if produced else np.zeros(0)
    np.testing.assert_array_equal(got, expected_out, err_msg=name)


CHUNK_CAPS = {
    "hl_stream_up": [100, 50, 1000, 3, 997, 10000, 10000],
    "hl_stream_down": [100, 50, 1000, 3, 997, 10000, 10000],
    "hl_stream_mono": [100, 50, 1000, 3, 997, 10000, 10000],
    "hl_eof_prime": [2, 0, 10000],
}


@pytest.mark.parametrize("script", list(oracle.scripts("highlevel")), ids=lambda s: s[0])
def test_torch_highlevel_script(script):
    name, meta, ops, expected_out, stream = script
    ch, stream_frames = meta["channels"], meta["stream_frames"]
    stream = stream.reshape(-1, ch)
    hl = HighLevelResampler.init(ch, *meta["rates"], device="cpu")
    state = {"cursor": 0, "chunk_i": 0}
    caps = CHUNK_CAPS.get(name, [])

    def input_callback(total_frames: int) -> np.ndarray:
        want = total_frames
        if state["chunk_i"] < len(caps):
            want = min(want, caps[state["chunk_i"]])
            state["chunk_i"] += 1
        give = min(want, stream_frames - state["cursor"])
        out = stream[state["cursor"] : state["cursor"] + give]
        state["cursor"] += give
        return out

    collected: list = []
    for row in ops:
        op, a0, a1, a2 = (int(v) for v in row[:4])
        before = sum(f.shape[0] for f in collected)
        if op == 1:
            ret = hl.resample(input_callback, output_limit=a0, _collect=collected)
        elif op == 2:
            ret = hl.adjust(a0, a1, a2)
        else:
            assert op == 3
            ret = hl.resample_end(output_limit=a0, _collect=collected)
        low = hl.low_level
        got = [int(ret), sum(f.shape[0] for f in collected) - before, state["cursor"],
               low.position_integer, low.position_fractional, low.increment,
               low.config.integer_stretched_kernel_radius, hl.leading_padding_frames_needed,
               hl.trailing_padding_frames_remaining, hl.buffer_fill_frames()]
        assert got == [int(v) for v in row[4:14]], (name, row.tolist(), got)
    got_out = np.concatenate(collected).ravel() if collected else np.zeros(0)
    np.testing.assert_array_equal(got_out, expected_out, err_msg=name)


@pytest.mark.parametrize("in_rate,out_rate,ch", [(48000, 44100, 2), (44100, 8000, 2),
                                                 (96000, 48000, 1)])
def test_torch_interop_continues_jax_stream(in_rate, out_rate, ch):
    """JAX LowLevelResampler runs the first part of a stream; the port picks
    it up from state_tuple() and finishes it; together they equal JAX on the
    whole stream."""
    rng = np.random.default_rng(41)
    n = 3000
    data = rng.integers(-32768, 32768, size=(n, ch)).astype(np.int16)
    lpf = max(in_rate, out_rate)
    want = jresample_array(data, in_rate, out_rate, lpf)

    jrs = JLowLevel.init(ch, in_rate, out_rate, lpf)
    r = jrs.config.integer_stretched_kernel_radius
    padded = np.zeros((n + 2 * r, ch), np.int16)
    padded[r : r + n] = data
    first = 1234
    _, remaining, part1 = jrs.resample(padded[: first + 2 * r], first)
    cursor = first - remaining

    port = LowLevelResampler.from_state_tuple(
        ch, KernelModel(jrs.model.radius, jrs.model.resolution), jrs.state_tuple(),
        jrs._max_taps, device="cpu")
    assert port.state_tuple() == jrs.state_tuple()
    _, _, part2 = port.resample(padded[cursor:], n - cursor)
    np.testing.assert_array_equal(np.concatenate([part1, part2]), want)


def test_torch_resample_chunk_matches_jax():
    rng = np.random.default_rng(43)
    x = rng.integers(-32768, 32768, size=(600, 2)).astype(np.int16)
    for rates, (p0, f0, total, quota) in (((48000, 44100, 48000), (3, 1000, 500, 10000)),
                                          ((44100, 8000, 44100), (0, 0, 560, 40)),
                                          ((8000, 44100, 44100), (590, 0, 580, 10000))):
        inc = fx.calculate_ratio(rates[0], rates[1])
        want = jresample_chunk(jnp.asarray(jtable()), jnp.asarray(x), total,
                               jmake_state(p0, f0, jconfigure(*rates), inc), quota,
                               max_taps=40, n_out=512)
        got = resample_chunk(table_tensor(lanczos_kernel_table(), torch.device("cpu")),
                             torch.from_numpy(x), total,
                             make_device_state(p0, f0, configure(*rates), inc), quota,
                             max_taps=40, n_out=512)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        for g, w in zip(got[1:3], want[1:3]):
            assert int(g) == int(w)
        assert (int(got[3].position_integer), int(got[3].position_fractional)) == \
            (int(want[3].position_integer), int(want[3].position_fractional))
        assert bool(got[4]) == bool(want[4])


def test_torch_highlevel_adjust_is_transactional():
    hl = HighLevelResampler.init(2, 48000, 44100, 48000, device="cpu")
    before = (hl.low_level.state_tuple(), hl.low_level._max_taps)
    assert not hl.adjust(44100, 8000, 44100)          # radius 17 > init radius 4
    assert (hl.low_level.state_tuple(), hl.low_level._max_taps) == before
    assert not hl.adjust(44100, 43, 44100)            # rejected ratio
    assert hl.adjust(44100, 44100, 44100)
    assert HighLevelResampler.init(17, 48000, 44100, 48000) is None


@pytest.mark.parametrize("in_rate,out_rate,n_a", [(48000, 44100, 5000), (44100, 8000, 10)])
def test_torch_bulk_stream_resumes_like_host_loop(in_rate, out_rate, n_a):
    """After resample_stream(bulk=True) the object is in the host loop's
    exact post-flush state, so incremental streaming resumes identically."""
    rng = np.random.default_rng(101)
    a = rng.integers(-32768, 32768, size=(n_a, 2)).astype(np.int16)
    b = rng.integers(-32768, 32768, size=(3000, 2)).astype(np.int16)
    lpf = max(in_rate, out_rate)
    bulk = HighLevelResampler.init(2, in_rate, out_rate, lpf)
    host = HighLevelResampler.init(2, in_rate, out_rate, lpf)
    np.testing.assert_array_equal(bulk.resample_stream(_feeder(a, 991), bulk=True),
                                  host.resample_stream(_feeder(a, 991), bulk=False))
    outs = []
    for obj in (bulk, host):
        collected: list = []
        obj.resample(_feeder(b, 613), _collect=collected)
        obj.resample_end(_collect=collected)
        outs.append(np.concatenate(collected))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].shape[0] > 0


def test_torch_bulk_stream_declines_losslessly():
    """When the bulk path declines (a stream past BULK_MAX_DEVICE_BYTES, or a
    resampler that is no longer pristine) the host loop takes over, with
    every frame already drained from the callback replayed."""
    rng = np.random.default_rng(89)
    data = rng.integers(-32768, 32768, size=(6000, 1)).astype(np.int16)
    want = HighLevelResampler.init(1, 48000, 44100, 44100).resample_stream(
        _feeder(data, 613), bulk=False)
    tiny = HighLevelResampler.init(1, 48000, 44100, 44100)
    tiny.BULK_MAX_DEVICE_BYTES = 1 << 14
    np.testing.assert_array_equal(tiny.resample_stream(_feeder(data, 613), bulk=True), want)

    rests = []
    for bulk in (True, False):
        busy = HighLevelResampler.init(1, 48000, 44100, 44100)
        feed = _feeder(data, 613)
        busy.resample(feed, output_limit=37)
        rests.append(busy.resample_stream(feed, bulk=bulk))
    np.testing.assert_array_equal(rests[0], rests[1])
