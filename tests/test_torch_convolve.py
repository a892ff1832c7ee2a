"""Port gather oracle (ops/convolve.py) vs the C oracle frames and JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu import fixedpoint as jfx
from clownresampler_tpu.ops.convolve import ConfigScalars as JConfigScalars
from clownresampler_tpu.ops.convolve import convolve_frames as jconvolve
from clownresampler_tpu_torch import fixedpoint as tfx
from clownresampler_tpu_torch.configure import configure
from clownresampler_tpu_torch.models import lanczos_kernel_table, table_tensor
from clownresampler_tpu_torch.ops.convolve import ConfigScalars, convolve_frames, window_geometry
from tests import oracle

CPU = torch.device("cpu")


def test_torch_oracle_reproduces_c_single_frames():
    """Every C-oracle single frame, batched per (config, input) group."""
    table = table_tensor(lanczos_kernel_table(), CPU)
    groups = {}
    for case in oracle.lowest_cases():
        key = (case["rates"], case["channels"], case["input"].tobytes())
        groups.setdefault(key, []).append(case)
    n_checked = 0
    for (rates, _ch, _), cases in groups.items():
        cfg = configure(*rates)
        inc = tfx.calculate_ratio(rates[0], rates[1])
        out = convolve_frames(
            table, torch.from_numpy(cases[0]["input"]),
            torch.tensor([c["position"][0] for c in cases]),
            torch.tensor([c["position"][1] for c in cases]),
            ConfigScalars.from_configuration(cfg, inc, CPU),
            2 * cfg.integer_stretched_kernel_radius)
        expected = np.stack([c["expected"] for c in cases])
        np.testing.assert_array_equal(out.numpy(), expected, err_msg=str(rates))
        n_checked += len(cases)
    assert n_checked == 720


@pytest.mark.parametrize("in_rate,out_rate", [
    (48000, 44100), (8000, 44100), (44100, 8000), (96000, 48000), (44100, 349), (44100, 132),
])
def test_torch_oracle_matches_jax_convolve(in_rate, out_rate):
    rng = np.random.default_rng(11)
    cfg = configure(in_rate, out_rate, max(in_rate, out_rate))
    inc = tfx.calculate_ratio(in_rate, out_rate)
    taps = tfx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    n = 48
    f0 = int(rng.integers(0, 65536))
    t = f0 + np.arange(n, dtype=np.int64) * inc
    pos, frac = (t >> 16).astype(np.int32), (t & 0xFFFF).astype(np.int32)
    x = rng.integers(-32768, 32768, size=(int(pos[-1]) + taps + 8, 3)).astype(np.int16)
    table = lanczos_kernel_table()

    got = convolve_frames(table_tensor(table, CPU), torch.from_numpy(x), torch.from_numpy(pos),
                          torch.from_numpy(frac), ConfigScalars.from_configuration(cfg, inc),
                          taps)
    want = jconvolve(jnp.asarray(table), jnp.asarray(x), jnp.asarray(pos), jnp.asarray(frac),
                     JConfigScalars.from_configuration(cfg, inc), taps)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_torch_window_geometry_matches_jax():
    from clownresampler_tpu.ops.convolve import window_geometry as jgeometry

    frac = np.arange(0, 65536, 97, dtype=np.int32)
    for rates in ((44100, 8000, 44100), (8000, 44100, 44100), (44100, 44, 44100)):
        cfg = configure(*rates)
        inc = jfx.calculate_ratio(rates[0], rates[1])
        got = window_geometry(ConfigScalars.from_configuration(cfg, inc), torch.from_numpy(frac))
        want = jgeometry(JConfigScalars.from_configuration(cfg, inc), jnp.asarray(frac))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
