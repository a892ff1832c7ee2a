"""Port MixedStreamFarm and resample_batch: every stream equals the JAX
LowLevelResampler run on that stream alone (the host reference of the JAX
farm tests), and resample_batch equals the JAX batch.resample_batch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu import batch as jbatch
from clownresampler_tpu import fixedpoint as jfx
from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.lowlevel import LowLevelResampler as JLowLevel
from clownresampler_tpu.models import lanczos_kernel_table as jtable
from clownresampler_tpu_torch import MixedStreamFarm, make_batch_state, resample_batch
from clownresampler_tpu_torch.configure import configure
from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
from clownresampler_tpu_torch.ops import resample as rs
from tests.test_torch_farm import _jax_host_reference

# Config 5's four groups (three tiled, one strided), two streams each.
GROUPS = [(48000, 44100), (44100, 48000), (8000, 48000), (96000, 48000)]
SIZES = (100, 17, 256, 9, 200, 118)
R_BOUND = 17   # the radius of 44.1k -> 8k, so a stream may move there


def _specs():
    return [rates for rates in GROUPS for _ in range(2)]


def _run_mixed(farm, data, sizes=SIZES):
    outs, cursor = [], 0
    for size in sizes:
        outs.append(farm.process([d[cursor : cursor + size] for d in data]))
        cursor += size
    outs.append(farm.flush())
    return [np.concatenate([o[i] for o in outs]) for i in range(len(data))]


def _jax_farm_replay(data, rates, sizes, r_bound, adjusts=None):
    """The JAX LowLevelResampler on a farm's schedule: after each chunk it
    resamples every received frame but a radius_bound hold-back; flush adds
    radius_bound zero frames; ``adjusts[k]`` = rates applied before chunk k."""
    adjusts = adjusts or {}
    ch = data.shape[1]
    rsm = JLowLevel.init(ch, *rates, max(rates), max_radius=r_bound)
    zeros = np.zeros((r_bound, ch), np.int16)
    padded = np.concatenate([zeros, data, zeros])
    frames, consumed, received = [], 0, 0
    for k, size in enumerate(list(sizes) + [None]):
        if k in adjusts:
            assert rsm.adjust(*adjusts[k], max(adjusts[k]))
        received += r_bound if size is None else size
        n_visible = received - consumed - r_bound
        if n_visible <= 0:
            continue
        r = rsm.config.integer_stretched_kernel_radius
        start = r_bound + consumed - r
        _, remaining, f = rsm.resample(padded[start : start + n_visible + 2 * r], n_visible)
        frames.append(np.asarray(f))
        consumed += n_visible - remaining
    return np.concatenate(frames)


def test_torch_mixed_farm_streams_match_jax_lowlevel():
    rng = np.random.default_rng(61)
    specs = _specs()
    data = rng.integers(-32768, 32768, size=(len(specs), sum(SIZES), 2)).astype(np.int16)
    rs.ROUTES.clear()
    farm = MixedStreamFarm(specs, 2, chunk_frames=256)
    got = _run_mixed(farm, data)
    assert {k for k, _ in rs.ROUTES} == {"tiled", "strided"}
    for i, rates in enumerate(specs):
        assert got[i].dtype == np.int32
        np.testing.assert_array_equal(got[i], _jax_host_reference(data[i], 2, *rates,
                                                                  max(rates)),
                                      err_msg=f"stream {i} {rates}")


def test_torch_mixed_farm_adjust_stream_matches_jax_lowlevel():
    """Stream 1 (48k->44.1k) moves to 44.1k->8k (general class) before chunk
    3, then stream 6 (96k->48k) is re-rated twice in its own farm; a refused
    move (radius past the reserve) changes nothing. Every stream equals the
    JAX LowLevelResampler with the same adjusts on the farm's schedule."""
    rng = np.random.default_rng(67)
    specs = _specs()
    data = rng.integers(-32768, 32768, size=(len(specs), sum(SIZES), 2)).astype(np.int16)
    farm = MixedStreamFarm(specs, 2, chunk_frames=256, max_radius=R_BOUND)
    moves = {2: (1, (44100, 8000)), 3: (6, (96000, 44100)), 4: (6, (44100, 22050))}
    outs, cursor = [], 0
    for k, size in enumerate(SIZES):
        if k in moves:
            assert farm.adjust_stream(moves[k][0], *moves[k][1])
        if k == 3:
            groups = [(f, list(m)) for f, m in farm._groups]
            assert not farm.adjust_stream(0, 192000, 8000)    # radius 72 > 17
            assert [(f, m) for f, m in farm._groups] == groups
        outs.append(farm.process([d[cursor : cursor + size] for d in data]))
        cursor += size
    outs.append(farm.flush())
    got = [np.concatenate([o[i] for o in outs]) for i in range(len(specs))]
    for i, rates in enumerate(specs):
        adjusts = {k: to for k, (j, to) in moves.items() if j == i}
        np.testing.assert_array_equal(got[i], _jax_farm_replay(data[i], rates, SIZES, R_BOUND,
                                                               adjusts),
                                      err_msg=f"stream {i}")


def test_torch_mixed_farm_clamp_s16_is_clamped_int32():
    rng = np.random.default_rng(71)
    specs = _specs()
    data = rng.integers(-32768, 32768, size=(len(specs), sum(SIZES), 2)).astype(np.int16)
    wide = _run_mixed(MixedStreamFarm(specs, 2, chunk_frames=256), data)
    narrow = _run_mixed(MixedStreamFarm(specs, 2, chunk_frames=256, clamp_s16=True), data)
    assert any(np.abs(w).max() > 0x7FFF for w in wide)
    for w, n in zip(wide, narrow):
        assert n.dtype == np.int16
        np.testing.assert_array_equal(n, np.clip(w, -0x7FFF, 0x7FFF))


def test_torch_mixed_farm_rejects_bad_input():
    farm = MixedStreamFarm(_specs(), 2, chunk_frames=64)
    with pytest.raises(IndexError):
        farm.adjust_stream(99, 44100, 48000)
    with pytest.raises(ValueError):
        farm.process([np.zeros((65, 2), np.int16)] * 8)
    with pytest.raises(ValueError):
        MixedStreamFarm([(44100, 43)], 2)


BATCH_RATIOS = [(48000, 44100), (8000, 44100), (44100, 8000), (96000, 48000), (44100, 44100),
                (7, 13), (13, 7), (22050, 48000)]


def test_torch_resample_batch_matches_jax():
    rng = np.random.default_rng(73)
    channels, n_in, max_radius, n_out = 2, 256, 17, 512
    buf = np.zeros((len(BATCH_RATIOS), n_in + 2 * max_radius, channels), np.int16)
    jcfgs, cfgs = [], []
    for i, (a, b) in enumerate(BATCH_RATIOS):
        inc = jfx.calculate_ratio(a, b)
        jcfgs.append((jconfigure(a, b, max(a, b)), inc))
        cfgs.append((configure(a, b, max(a, b)), inc))
        r = cfgs[-1][0].integer_stretched_kernel_radius
        buf[i, r : r + n_in] = rng.integers(-32768, 32768, size=(n_in, channels))
    quotas = np.array([10**6, 100, 10**6, 5, 10**6, 10**6, 300, 10**6], np.int32)
    totals = np.full(len(BATCH_RATIOS), n_in, np.int32)
    want = jbatch.resample_batch(jnp.asarray(jtable()), jnp.asarray(buf), jnp.asarray(totals),
                                 jbatch.make_batch_state(jcfgs), jnp.asarray(quotas),
                                 max_taps=2 * max_radius, n_out=n_out)
    got = resample_batch(table_tensor(DEFAULT_MODEL.table(), torch.device("cpu")),
                         torch.from_numpy(buf), torch.from_numpy(totals),
                         make_batch_state(cfgs), torch.from_numpy(quotas),
                         max_taps=2 * max_radius, n_out=n_out)
    out, produced, consumed, new_states, exhausted = got
    assert out.shape == (len(BATCH_RATIOS), n_out, channels)
    for name, g, w in (("out", out, want[0]), ("produced", produced, want[1]),
                       ("consumed", consumed, want[2]), ("exhausted", exhausted, want[4]),
                       ("position_integer", new_states.position_integer,
                        want[3].position_integer),
                       ("position_fractional", new_states.position_fractional,
                        want[3].position_fractional)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for g, w in zip(new_states.cfg, want[3].cfg):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
