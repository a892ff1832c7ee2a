"""The strided and wide kernels on the card (``cuda``-marked: they skip without one).

Every strided and wide case that ``chip_smoke.py`` checks, through
``resample_strided_phases`` and ``resample_wide_taps`` (kernels that compute
their own geometry) against their plain versions on the same inputs:
outputs and rows, exact. One strided entry call is one device launch and one
wide entry call two (torch.profiler).
"""

import pytest
import torch

import chip_smoke
from clownresampler_tpu_torch.ops import resample as rs
from tests.test_torch_resample_ops import cuda_device  # noqa: F401  (fixture)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.STRIDED_CASES,
                         ids=[c[0] for c in chip_smoke.STRIDED_CASES])
def test_torch_cuda_strided_case_matches_reference(cuda_device, case):
    gen = torch.Generator(device="cuda").manual_seed(21)
    got, want, rows, rows_ref = chip_smoke.run_strided_case(case, gen)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(rows, rows_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.WIDE_CASES,
                         ids=[c[0] for c in chip_smoke.WIDE_CASES])
def test_torch_cuda_wide_case_matches_reference(cuda_device, case):
    gen = torch.Generator(device="cuda").manual_seed(22)
    got, want, rows, rows_ref = chip_smoke.run_wide_case(case, gen)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(rows, rows_ref)


@pytest.mark.cuda
def test_torch_cuda_strided_and_wide_entries_are_their_kernels(cuda_device):
    gen = torch.Generator(device="cuda").manual_seed(24)
    s = chip_smoke.launch_case(96000, 48000, 512, 1024, gen)
    w = chip_smoke.launch_case(44100, 132, 256, 64, gen)
    names, _ = chip_smoke.device_launches(lambda: rs.resample_strided_phases(
        s["table"], s["x"], s["state"], max_taps=s["max_taps"], n_out=1024, d=s["d"]))
    assert len(names) == 1 and "strided_mac_kernel" in names[0], names
    names, _ = chip_smoke.device_launches(lambda: rs.resample_wide_taps(
        w["table"], w["x"], w["state"], max_taps=w["max_taps"], n_out=64, d=w["d"],
        table_strided=w["table_strided"]))
    assert len(names) == 2 and sum("wide_mac_kernel" in n for n in names) == 1, names
    assert sum("wide_fold_kernel" in n for n in names) == 1, names
