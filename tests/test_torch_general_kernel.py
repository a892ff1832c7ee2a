"""The general entry on the card (``cuda``-marked: they skip without one).

Every general case that ``chip_smoke.py`` checks, through
``resample_uniform_lanes_general`` (one launch of tiled_mac_kernel that
computes its own geometry and frames per stage) against
``resample_uniform_lanes_general_reference`` on the same inputs: outputs and
rows, exact. One entry call is one device launch (torch.profiler), and the
general-engine ``resample_scan_fused`` runs under
``torch.cuda.set_sync_debug_mode("error")`` and equals the oracle scan.
"""

import pytest
import torch

import chip_smoke
from clownresampler_tpu_torch.lowlevel import resample_scan
from clownresampler_tpu_torch.ops import resample as rs
from tests.test_torch_resample_ops import cuda_device  # noqa: F401  (fixture)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.GENERAL_CASES,
                         ids=[c[0] for c in chip_smoke.GENERAL_CASES])
def test_torch_cuda_general_case_matches_reference(cuda_device, case):
    gen = torch.Generator(device="cuda").manual_seed(21)
    got, want, rows, rows_ref = chip_smoke.run_general_case(case, gen)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(rows, rows_ref)


@pytest.mark.cuda
def test_torch_cuda_general_entry_is_one_launch(cuda_device):
    gen = torch.Generator(device="cuda").manual_seed(22)
    c = chip_smoke.launch_case(44100, 8000, 512, 1024, gen)
    args = dict(max_taps=c["max_taps"], n_out=1024, table_strided=c["table_strided"])
    names, _ = chip_smoke.device_launches(
        lambda: rs.resample_uniform_lanes_general(c["table"], c["x"], c["state"], **args))
    assert len(names) == 1 and "tiled_mac_kernel" in names[0], names


@pytest.mark.cuda
def test_torch_cuda_general_scan_has_no_host_sync(cuda_device):
    gen = torch.Generator(device="cuda").manual_seed(23)
    c = chip_smoke.scan_case((44100, 8000), 256, 3, gen)
    out, produced, state, backlog = chip_smoke.fused_scan(c)  # raises on a host sync
    ref = resample_scan(c["table"], c["chunks"], c["state"], max_taps=c["max_taps"],
                        n_out=c["n_out"], radius=c["radius"])
    assert not bool(backlog) and not bool(ref[3])
    assert torch.equal(out, ref[0]) and torch.equal(produced, ref[1])
    assert int(state.position_integer) == int(ref[2].position_integer)
    assert int(state.position_fractional) == int(ref[2].position_fractional)
