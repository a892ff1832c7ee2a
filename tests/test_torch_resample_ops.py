"""Port launch ops (ops/resample.py) vs the JAX package.

The port's tiled plain version is held against JAX's Pallas tiled kernel run
in interpret mode; its general plain version against JAX's gather oracle (the
interpreted general kernel is slow-tier in the JAX suite). Tests marked
``cuda`` hold the CUDA kernels against the plain versions and need a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu import fixedpoint as jfx
from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.lowlevel import make_device_state as jmake_state
from clownresampler_tpu.models import DEFAULT_MODEL as JMODEL
from clownresampler_tpu.ops.convolve import convolve_frames as jconvolve
from clownresampler_tpu.ops import pallas_resample as jpr
from clownresampler_tpu_torch import interop
from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs

TILED_RATIOS = [(48000, 44100), (8000, 44100), (44100, 48000), (44100, 44100),
                (65521, 65537), (32000, 48000)]
GENERAL_RATIOS = [(44100, 8000), (44100, 7000), (40000, 997), (44100, 19000)]


def _launch(in_rate, out_rate, device, n_out=64, lanes=128, p0=0, f0=0, seed=3):
    """The same launch for both packages: (jax args, port args, x numpy)."""
    cfg = jconfigure(in_rate, out_rate, max(in_rate, out_rate))
    inc = jfx.calculate_ratio(in_rate, out_rate)
    jstate = jmake_state(p0, f0, cfg, inc)
    taps = jfx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
    s = jfx.round_up(p0 + ((f0 + n_out * inc) >> 16) + 2 * cfg.integer_stretched_kernel_radius
                     + 64, 16)
    x = np.random.default_rng(seed).integers(-32768, 32768, size=(s, lanes)).astype(np.int32)
    tstr = JMODEL.strided_table(cfg.kernel_step_size, taps)
    port = dict(
        table=table_tensor(DEFAULT_MODEL.table(), device),
        x=torch.from_numpy(x).to(device),
        state=interop.device_state_from_numpy(np.asarray(jstate.position_integer),
                                              np.asarray(jstate.position_fractional),
                                              [np.asarray(v) for v in jstate.cfg], device),
        tstr=interop.table_from_numpy(tstr, device),
    )
    jax = dict(table=jnp.asarray(JMODEL.table()), x=jnp.asarray(x), state=jstate,
               tstr=jnp.asarray(tstr))
    return jax, port, dict(taps=taps, inc=inc, n_out=n_out, plan=jpr.plan_uniform(inc, n_out))


@pytest.mark.parametrize("in_rate,out_rate", TILED_RATIOS + GENERAL_RATIOS)
@pytest.mark.parametrize("strided", [False, True], ids=["flat", "strided"])
def test_torch_precompute_launch_matches_jax(in_rate, out_rate, strided):
    j, p, m = _launch(in_rate, out_rate, torch.device("cpu"), n_out=128, p0=7, f0=40000)
    want = jpr.precompute_launch(j["table"], j["state"], max_taps=m["taps"], n_out=128,
                                 table_strided=j["tstr"] if strided else None)
    got = rs.precompute_launch(p["table"], p["state"], max_taps=m["taps"], n_out=128,
                               table_strided=p["tstr"] if strided else None)
    for name, g, w in zip(("rows", "kvals", "q", "eps", "tile_rows"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


@pytest.mark.parametrize("in_rate,out_rate", GENERAL_RATIOS)
def test_torch_general_reference_matches_jax_oracle(in_rate, out_rate):
    j, p, m = _launch(in_rate, out_rate, torch.device("cpu"), n_out=128, p0=2, f0=999)
    assert m["plan"]["kernel"] == "general"
    n = jnp.arange(128, dtype=jnp.int32)
    pos, frac = jfx.positions_from_state(j["state"].position_integer,
                                         j["state"].position_fractional,
                                         j["state"].cfg.increment_hi,
                                         j["state"].cfg.increment_lo, n)
    want = jconvolve(j["table"], j["x"], pos, frac, j["state"].cfg, m["taps"])
    got, _ = rs.resample_uniform_lanes_general_reference(
        p["table"], p["x"], p["state"], max_taps=m["taps"], n_out=128, table_strided=p["tstr"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    clamped, _ = rs.resample_uniform_lanes_general(
        p["table"], p["x"], p["state"], max_taps=m["taps"], n_out=128, clamp_s16=True)
    np.testing.assert_array_equal(clamped.numpy(),
                                  np.clip(np.asarray(want), -0x7FFF, 0x7FFF).astype(np.int16))


def test_torch_plan_uniform_matches_jax():
    incs = [1, 2**15, 65535, 65536, 65537, 71330, 2**17 - 1, 2**17, 3 * 65536,
            5 * 65536 + 33000, 361267, 2**32 - 1]
    incs += list(np.random.default_rng(5).integers(1, 2**20, size=500))
    for inc in incs:
        assert rs.plan_uniform(int(inc), 0) == jpr.plan_uniform(int(inc), 0), inc


def test_torch_multi_resample_routes_on_cpu():
    """Tiled, general, strided and wide plans take their plain versions on
    the CPU; only an explicit "oracle" plan takes the gather oracle; ROUTES
    records each; all are bit-equal to the oracle."""
    launches = []
    for rates, kind in (((48000, 44100), "tiled"), ((44100, 8000), "general"),
                        ((96000, 48000), "strided"), ((44100, 132), "wide"),
                        ((44100, 8000), "oracle")):
        j, p, m = _launch(*rates, torch.device("cpu"), n_out=16 if kind == "wide" else 64)
        plan = m["plan"]
        assert kind in (plan["kernel"], "oracle") or m["taps"] > 1024
        launches.append((p, (kind, plan.get("d"), plan.get("cand"), m["taps"],
                             16 if kind == "wide" else 64, False), m))
    rs.ROUTES.clear()
    outs = rs.multi_resample(launches[0][0]["table"], tuple(p["x"] for p, _, _ in launches),
                             tuple(p["state"] for p, _, _ in launches),
                             tuple(plan for _, plan, _ in launches))
    assert dict(rs.ROUTES) == {("tiled", "reference"): 1, ("general", "reference"): 1,
                               ("strided", "reference"): 1, ("wide", "reference"): 1,
                               ("oracle", "oracle"): 1}
    for out, (p, plan, m) in zip(outs, launches):
        want = rs.oracle_launch(p["table"], p["x"], p["state"], kind="check",
                                max_taps=m["taps"], n_out=plan[4])
        np.testing.assert_array_equal(out.numpy(), want.numpy(), err_msg=plan[0])


def test_torch_kernel_wrappers_refuse_cpu_tensors():
    """The kernel launchers never fall back: CPU tensors are refused before
    any build is attempted."""
    _, p, m = _launch(48000, 44100, torch.device("cpu"))
    rows, kv, q, _, _ = rs.precompute_launch(p["table"], p["state"], max_taps=m["taps"], n_out=64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.tiled_mac(p["x"], rows, kv, q, lanes=128, lane_offset=0, frames_per_block=64,
                         win_rows=100, clamp_s16=False)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.general_mac(p["x"], rows, kv, q, lanes=128, lane_offset=0, clamp_s16=False)


def test_torch_tiled_window_rows_bounds_every_block():
    """The shared window the tiled kernel stages covers every frame's window
    in every 64-frame block, across the whole tiled increment range."""
    for inc in list(range(1, 2**17, 997)) + [65535, 65536, 2**17 - 1]:
        plan = rs.plan_uniform(inc, 0)
        delta, f0 = 40000, 65535
        n = np.arange(rs.TILED_FRAMES_PER_BLOCK * 4, dtype=np.int64)
        rows = -(-(f0 + n * inc + delta) // 65536)
        blocks = rows.reshape(-1, rs.TILED_FRAMES_PER_BLOCK)
        span = (blocks[:, -1] - blocks[:, 0]).max() + 8
        assert span <= rs.tiled_window_rows(plan["d"], plan["cand"], 8), inc


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("in_rate,out_rate", TILED_RATIOS)
def test_torch_cuda_tiled_kernel_matches_reference(cuda_device, in_rate, out_rate):
    _, p, m = _launch(in_rate, out_rate, cuda_device, n_out=1024, lanes=300, p0=1, f0=17)
    args = dict(max_taps=m["taps"], n_out=1024, d=m["plan"]["d"], cand=m["plan"]["cand"],
                table_strided=p["tstr"])
    for opts in ({}, dict(clamp_s16=True), dict(lanes=100, lane_offset=33)):
        got, _ = rs.resample_uniform_lanes_tiled(p["table"], p["x"], p["state"], **args, **opts)
        want, _ = rs.resample_uniform_lanes_tiled_reference(p["table"], p["x"], p["state"],
                                                            **args, **opts)
        assert torch.equal(got, want), opts


@pytest.mark.cuda
@pytest.mark.parametrize("in_rate,out_rate", GENERAL_RATIOS)
def test_torch_cuda_general_kernel_matches_reference(cuda_device, in_rate, out_rate):
    _, p, m = _launch(in_rate, out_rate, cuda_device, n_out=512, lanes=300, p0=1, f0=17)
    args = dict(max_taps=m["taps"], n_out=512, table_strided=p["tstr"])
    for opts in ({}, dict(clamp_s16=True)):
        got, _ = rs.resample_uniform_lanes_general(p["table"], p["x"], p["state"], **args, **opts)
        want, _ = rs.resample_uniform_lanes_general_reference(p["table"], p["x"], p["state"],
                                                              **args, **opts)
        assert torch.equal(got, want), opts
