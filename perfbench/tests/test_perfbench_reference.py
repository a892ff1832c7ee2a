"""The frozen reference against the port's CPU path (the kernels' plain
versions) at tiny sizes: the Lanczos table, the configuration, and each of
the three entries the window drives, held by the harness's own comparison."""

import numpy as np
import pytest
import torch

from perfbench.references import lanczos16 as ref
from perfbench.tests.conftest import CELLS, run_small

RATES = ((48000, 44100, 48000), (44100, 48000, 48000), (8000, 48000, 48000),
         (96000, 48000, 96000), (44100, 8000, 44100), (44100, 132, 44100))


def test_table_matches_the_port():
    from clownresampler_tpu_torch.models import lanczos_kernel_table

    assert np.array_equal(np.array(ref.kernel_table(3, 0x400)), lanczos_kernel_table(3, 0x400))


@pytest.mark.parametrize("rates", RATES)
def test_configuration_matches_the_port(rates):
    from clownresampler_tpu_torch import fixedpoint as fx
    from clownresampler_tpu_torch.configure import configure

    cfg, r = configure(*rates), ref.ratio(*rates)
    assert (r.increment, r.stretched_radius, r.integer_radius, r.delta, r.step) == (
        fx.calculate_ratio(*rates[:2]), cfg.stretched_kernel_radius,
        cfg.integer_stretched_kernel_radius, cfg.stretched_kernel_radius_delta,
        cfg.kernel_step_size)


@pytest.mark.parametrize("rates", RATES[:5])
def test_frames_match_the_gather_oracle(rates):
    import clownresampler_tpu_torch as crt

    x = np.random.default_rng(5).integers(-32768, 32768, (700, 2), dtype=np.int16)
    want = crt.resample_array(x, *rates, device="cpu")
    r = ref.ratio(*rates)
    t = torch.arange(want.shape[0], dtype=torch.int64) * r.increment
    stream = torch.from_numpy(x)

    def fetch(rows):
        inside = (rows >= 0) & (rows < len(x))
        return torch.where(inside[..., None], stream[rows.clamp(0, len(x) - 1)], 0)

    assert np.array_equal(ref.frames(t, r, fetch).numpy(), np.asarray(want))


def test_scan_books_match_the_port():
    from clownresampler_tpu_torch.lowlevel import make_device_state, resample_scan_fused
    from clownresampler_tpu_torch.configure import configure
    from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor

    rates, n_in, n_out = (48000, 44100, 48000), 256, 384
    cfg, r = configure(*rates), ref.ratio(*rates)
    chunks = torch.zeros((4, n_in, 2), dtype=torch.int16)
    _, produced, state, over = resample_scan_fused(
        table_tensor(DEFAULT_MODEL.table(), "cpu"), chunks,
        make_device_state(0, 0, cfg, r.increment, "cpu"), max_taps=8, n_out=n_out,
        radius=r.integer_radius, increment=r.increment)
    books = ref.scan_books(r, 4, n_in, n_out)
    assert produced.tolist() == books[0] and bool(over) == any(books[1])
    assert (int(state.position_integer), int(state.position_fractional)) == books[2]


@pytest.mark.parametrize("workload", CELLS)
def test_each_entry_on_the_cpu_is_correct(workload):
    result = run_small(workload)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    assert all(c["value"] == 0 for c in result["checked"].values())
    assert list(result)[-1] == "checked"
