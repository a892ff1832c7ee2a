"""Port strided and wide launches (ops/resample.py) vs the JAX package.

The strided plain version is held against JAX's XLA strided path and its
Pallas polyphase kernels (interpret mode); the wide plain version against
JAX's Pallas wide kernel (interpret mode). Tests marked ``cuda`` hold the
CUDA kernels against the plain versions and need a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu import fixedpoint as jfx
from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.lowlevel import make_device_state as jmake_state
from clownresampler_tpu.models import DEFAULT_MODEL as JMODEL
from clownresampler_tpu.ops import pallas_resample as jpr
from clownresampler_tpu_torch import interop
from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from tests.test_torch_resample_ops import _launch

STRIDED_RATIOS = [(96000, 48000), (2, 1), (3, 1), (132300, 44100)]
# (in, out, p0, f0, frames): 44.1k->262 (taps 1016) is general by its width
# and is sent to the wide entry directly.
WIDE_CASES = [(44100, 132, 7, 0x8421, 8), (44100, 44, 3, 0x1111, 8), (44100, 262, 9, 0x8421, 8)]


def _port_state(jstate, device="cpu"):
    return interop.device_state_from_numpy(
        np.asarray(jstate.position_integer), np.asarray(jstate.position_fractional),
        [np.asarray(v) for v in jstate.cfg], device)


@pytest.mark.parametrize("in_rate,out_rate", STRIDED_RATIOS)
@pytest.mark.parametrize("p0", [0, 1, 5])
def test_torch_strided_reference_matches_jax_integer_stride(in_rate, out_rate, p0):
    j, p, m = _launch(in_rate, out_rate, torch.device("cpu"), n_out=64, p0=p0)
    d = m["plan"]["d"]
    assert m["plan"]["kernel"] == "strided"
    want, want_rows = jpr.resample_integer_stride(j["table"], j["x"], j["state"],
                                                  max_taps=m["taps"], n_out=64, d=d)
    got, rows = rs.resample_strided_phases(p["table"], p["x"], p["state"], max_taps=m["taps"],
                                           n_out=64, d=d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))


def test_torch_strided_options_match_jax_polyphase_kernels():
    """96k->48k, p0 3, the fused s16 clamp and a lane slice, against both JAX
    polyphase entry points in interpret mode (x padded to their over-read
    contract)."""
    cfg = jconfigure(96000, 48000, 96000)
    inc = jfx.calculate_ratio(96000, 48000)
    d, taps, n_out = inc >> 16, jfx.round_up(2 * cfg.integer_stretched_kernel_radius, 8), 64
    jstate = jmake_state(3, 0, cfg, inc)
    s = jfx.round_up(3 + (n_out - 64) * d + jpr.strided_phase_padding(taps, d, 8) + 8, 16)
    x = np.random.default_rng(31).integers(-32768, 32768, size=(s, 256)).astype(np.int32)
    common = dict(max_taps=taps, n_out=n_out, d=d, clamp_s16=True, lanes=128, lane_offset=128)
    table = table_tensor(DEFAULT_MODEL.table(), torch.device("cpu"))
    got, rows = rs.resample_strided_phases(table, torch.from_numpy(x), _port_state(jstate),
                                           **common)
    got_wide, _ = rs.resample_strided_phases_wide(table, torch.from_numpy(x),
                                                  _port_state(jstate), **common)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got_wide.numpy(), got.numpy())
    for fn in (jpr.resample_strided_phases, jpr.resample_strided_phases_wide):
        want, want_rows = fn(jnp.asarray(JMODEL.table()), jnp.asarray(x), jstate,
                             interpret=True, **common)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=fn.__name__)
        np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows), err_msg=fn.__name__)


@pytest.mark.parametrize("in_rate,out_rate,p0,f0,n_out", WIDE_CASES)
def test_torch_wide_reference_matches_jax_kernel(in_rate, out_rate, p0, f0, n_out):
    j, p, m = _launch(in_rate, out_rate, torch.device("cpu"), n_out=n_out, p0=p0, f0=f0)
    assert m["taps"] > 1000
    args = dict(max_taps=m["taps"], n_out=n_out, d=m["inc"] >> 16)
    want, want_rows = jpr.resample_wide_taps(j["table"], j["x"], j["state"], interpret=True,
                                             table_strided=j["tstr"], **args)
    got, rows = rs.resample_wide_taps(p["table"], p["x"], p["state"], table_strided=p["tstr"],
                                      **args)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want_rows))
    clamped, _ = rs.resample_wide_taps(p["table"], p["x"], p["state"], clamp_s16=True, **args)
    np.testing.assert_array_equal(clamped.numpy(),
                                  np.clip(np.asarray(want), -0x7FFF, 0x7FFF).astype(np.int16))


@pytest.mark.parametrize("in_rate,out_rate", [(96000, 48000), (529200, 44100)])
def test_torch_strided_reference_clamps_padding_frames_like_per_frame_mac(in_rate, out_rate):
    """Cut x so that the last frames' windows clamp: the strided plain
    version equals the per-frame MAC (launch precompute's rows and taps,
    launch_rows' clamp) on every frame, padding frames included."""
    _, p, m = _launch(in_rate, out_rate, torch.device("cpu"), n_out=64, p0=2)
    d, taps = m["plan"]["d"], m["taps"]
    prow, kvals, q, _, _ = rs.precompute_launch(p["table"], p["state"], max_taps=taps, n_out=64)
    x = p["x"][: int(prow[-1]) + taps - 10 * d]
    got, rows = rs.resample_strided_reference(p["table"], x, p["state"], max_taps=taps,
                                              n_out=64, d=d, lanes=100, lane_offset=7)
    assert torch.equal(rows, prow)
    rl = rs.launch_rows(prow, x.shape[0], taps)
    assert (rl < prow).any(), "the case must clamp some frames"
    want = rs.mac_reference(x, rl, kvals, q, 100, 7, False)
    assert torch.equal(got, want)


def test_torch_mac_reference_tap_blocks_agree():
    _, p, m = _launch(44100, 132, torch.device("cpu"), n_out=8, p0=1, f0=99)
    rows, kvals, q, _, _ = rs.precompute_launch(p["table"], p["state"], max_taps=m["taps"],
                                                n_out=8)
    outs = [rs.mac_reference(p["x"], rows, kvals, q, 128, 0, False, tap_block=b)
            for b in (1, 7, rs.WIDE_REFERENCE_TAP_BLOCK, m["taps"])]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def test_torch_strided_block_geometry_fits_shared_memory():
    """Every strided ratio the dispatchers send (taps <= 1024) gets a stage
    plan whose two stages fit the card's shared memory, within the budget
    whenever the largest tile fits it; past the card's limit the launch
    reads x directly."""
    for d in range(2, 200):
        for taps in range(8, 1025, 8):
            f, rows = rs.strided_stage_plan(d, taps)
            size = _build.strided_shared_bytes(taps, rows)
            assert size <= _build.MAX_SHARED_BYTES, (d, taps)
            big = rs.STRIDED_STAGE_FRAMES[0]
            if _build.strided_shared_bytes(taps, (big - 1) * d + taps) <= rs.STRIDED_SHARED_BUDGET:
                assert (f, rows) == (big, (big - 1) * d + taps), (d, taps)
            if rows == 0:
                assert _build.strided_shared_bytes(taps, 7 * d + taps) > _build.MAX_SHARED_BYTES


@pytest.mark.parametrize("taps,increment,kind", [
    (40, 361267, "general"), (248, 40 * 65536 + 5957, "general"),
    (256, 40 * 65536 + 5957, "wide"), (1016, 168 * 65536 + 21011, "wide"),
    (1024, 2 * 65536, "strided"), (1032, 2 * 65536, "wide"), (1032, 71330, "wide"),
    (8, 71330, "tiled")])
def test_torch_launch_kind_routes_wide_widths(taps, increment, kind):
    """Past FAST_KERNEL_MAX_TAPS every class goes wide; general-class launches
    go wide from GENERAL_WIDE_MIN_TAPS; tiled and strided keep their kernels
    up to FAST_KERNEL_MAX_TAPS."""
    from clownresampler_tpu_torch.lowlevel import launch_kind

    assert launch_kind(increment, taps)[0] == kind


def test_torch_new_kernel_wrappers_refuse_cpu_tensors():
    """The strided and wide launchers never fall back: CPU tensors are
    refused before any build is attempted (both take the launch state and
    tables and compute their own geometry)."""
    _, p, m = _launch(96000, 48000, torch.device("cpu"))
    st = p["state"]
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.strided_mac(p["x"], p["table"], st.position_integer, st.position_fractional,
                           st.cfg, max_taps=m["taps"], n_out=64, d=2, lanes=128, lane_offset=0,
                           frames_per_tile=32, win_rows=78, clamp_s16=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.wide_mac(p["x"], p["table"], p["tstr"], st.position_integer,
                        st.position_fractional, st.cfg, max_taps=m["taps"], n_out=64, d=2,
                        lanes=128, lane_offset=0, clamp_s16=False)
    with pytest.raises(ValueError, match="d >= 2"):
        rs.resample_strided_phases(p["table"], p["x"], p["state"], max_taps=m["taps"],
                                   n_out=64, d=1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("in_rate,out_rate", STRIDED_RATIOS + [(192000, 48000), (529200, 44100)])
def test_torch_cuda_strided_kernel_matches_reference(cuda_device, in_rate, out_rate):
    _, p, m = _launch(in_rate, out_rate, cuda_device, n_out=1024, lanes=300, p0=5)
    args = dict(max_taps=m["taps"], n_out=1024, d=m["plan"]["d"])
    for x, opts in ((p["x"], {}), (p["x"], dict(clamp_s16=True)),
                    (p["x"], dict(lanes=100, lane_offset=33)), (p["x"][: -30 * args["d"]], {})):
        got, rows = rs.resample_strided_phases(p["table"], x, p["state"], **args, **opts)
        want, want_rows = rs.resample_strided_reference(p["table"], x, p["state"], **args,
                                                        **opts)
        assert torch.equal(got, want) and torch.equal(rows, want_rows), opts


@pytest.mark.cuda
@pytest.mark.parametrize("in_rate,out_rate,p0,f0,n_out", WIDE_CASES + [(96000, 480, 5, 0, 64)])
def test_torch_cuda_wide_kernel_matches_reference(cuda_device, in_rate, out_rate, p0, f0, n_out):
    _, p, m = _launch(in_rate, out_rate, cuda_device, n_out=n_out, lanes=300, p0=p0, f0=f0)
    args = dict(max_taps=m["taps"], n_out=n_out, d=m["inc"] >> 16, table_strided=p["tstr"])
    for x, opts in ((p["x"], {}), (p["x"], dict(clamp_s16=True)),
                    (p["x"], dict(lanes=100, lane_offset=33)), (p["x"][: -args["d"] - 8], {})):
        got, rows = rs.resample_wide_taps(p["table"], x, p["state"], **args, **opts)
        want, want_rows = rs.resample_wide_taps_reference(p["table"], x, p["state"], **args,
                                                          **opts)
        assert torch.equal(got, want) and torch.equal(rows, want_rows), opts
