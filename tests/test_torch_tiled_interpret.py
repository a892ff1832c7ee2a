"""Port tiled launch vs the JAX package's Pallas tiled kernel run in
interpret mode, on the same seeded inputs (exact equality)."""

import numpy as np
import pytest
import torch

from clownresampler_tpu.ops import pallas_resample as jpr
from clownresampler_tpu_torch.ops import resample as rs
from tests.test_torch_resample_ops import TILED_RATIOS, _launch


@pytest.mark.parametrize("in_rate,out_rate", TILED_RATIOS)
def test_torch_tiled_reference_matches_jax_kernel(in_rate, out_rate):
    j, p, m = _launch(in_rate, out_rate, torch.device("cpu"))
    plan = m["plan"]
    assert plan == rs.plan_uniform(m["inc"], 64) and plan["kernel"] == "tiled"
    want, want_rows = jpr.resample_uniform_lanes_tiled(
        j["table"], j["x"], j["state"], max_taps=m["taps"], n_out=64, d=plan["d"],
        cand=plan["cand"], interpret=True)
    got, rows = rs.resample_uniform_lanes_tiled_reference(
        p["table"], p["x"], p["state"], max_taps=m["taps"], n_out=64, d=plan["d"],
        cand=plan["cand"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))


def test_torch_tiled_options_match_jax_kernel():
    """Nonzero p0/f0, the fused s16 clamp and a lane slice, in one launch."""
    j, p, m = _launch(48000, 44100, torch.device("cpu"), lanes=256, p0=3, f0=54321)
    common = dict(max_taps=m["taps"], n_out=64, d=m["plan"]["d"], cand=m["plan"]["cand"],
                  clamp_s16=True, lanes=128, lane_offset=128)
    want, _ = jpr.resample_uniform_lanes_tiled(j["table"], j["x"], j["state"], interpret=True,
                                               table_strided=j["tstr"], **common)
    got, _ = rs.resample_uniform_lanes_tiled(p["table"], p["x"], p["state"],
                                             table_strided=p["tstr"], **common)
    assert got.dtype == torch.int16 and str(want.dtype) == "int16"
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
