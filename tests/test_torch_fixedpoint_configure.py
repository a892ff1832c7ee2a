"""Port vs JAX package: fixed-point ops, configure, and the kernel tables.

Same seeded numpy inputs through both packages; every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu import fixedpoint as jfx
from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.models import lanczos as jlanczos
from clownresampler_tpu_torch import fixedpoint as tfx
from clownresampler_tpu_torch.configure import MAX_KERNEL_SCALE_INT, configure
from clownresampler_tpu_torch.models import lanczos as tlanczos
from clownresampler_tpu_torch.models import table_tensor
from tests import oracle


def c_trunc_div(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _both(fn_t, fn_j, *arrays):
    got = fn_t(*(torch.from_numpy(np.asarray(a, np.int32)) for a in arrays)).numpy()
    want = np.asarray(fn_j(*(jnp.asarray(a, jnp.int32) for a in arrays)))
    return got, want


@pytest.mark.parametrize("bits", [15, 16])
def test_torch_trunc_shr_matches_jax(bits):
    rng = np.random.default_rng(0)
    xs = np.concatenate([
        rng.integers(-(2**31), 2**31, size=5000),
        np.array([0, 1, -1, 65535, -65535, 65536, -65536, 2**31 - 1, -(2**31)]),
    ])
    got, want = _both(lambda x: tfx.trunc_shr(x, bits), lambda x: jfx.trunc_shr(x, bits), xs)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [c_trunc_div(int(x), 1 << bits) for x in xs])


def test_torch_fixed_mul_trunc_matches_jax():
    samples = np.array([-32768, -32767, -1, 0, 1, 32767])
    kernels = np.array([-9651, -1, 0, 1, 65535, 65536])
    s, k = (a.ravel() for a in np.meshgrid(samples, kernels))
    got, want = _both(tfx.fixed_mul_trunc, jfx.fixed_mul_trunc, s, k)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [c_trunc_div(int(a) * int(b), 65536) for a, b in zip(s, k)])


def test_torch_reciprocal_q31_matches_jax():
    rng = np.random.default_rng(1)
    denoms = np.concatenate([
        rng.integers(2, 2**28, size=20000),
        -rng.integers(2, 2**28, size=500),
        np.array([2, 3, 65535, 65536, 65537, 2**28]),
    ])
    got, want = _both(tfx.reciprocal_q31, jfx.reciprocal_q31, denoms)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [c_trunc_div(0x80000000, int(d)) for d in denoms])


def test_torch_mul_shift15_matches_int64():
    rng = np.random.default_rng(2)
    acc = np.concatenate([rng.integers(-(2**22), 2**22, size=5000),
                          np.array([0, 1, -1, 2**21, -(2**21), 12345])])
    q = np.concatenate([rng.integers(1, 2**19, size=5000),
                        np.array([1, 2, 32768, 39321, 2**19 - 1, -6789])])
    got, want = _both(tfx.mul_shift15, jfx.mul_shift15, acc, q)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [c_trunc_div(int(a) * int(b), 1 << 15)
                                        for a, b in zip(acc, q)])


@pytest.mark.parametrize("p0,f0,inc", [(0, 0, 71330), (5, 65535, 65536 * 5 + 33000),
                                       (1000, 12345, 11889)])
def test_torch_positions_from_state_matches_jax(p0, f0, inc):
    n = np.arange(1 << 14)
    hi, lo = tfx.split_increment(inc)
    got = tfx.positions_from_state(p0, f0, hi, lo, torch.from_numpy(n.astype(np.int32)))
    want = jfx.positions_from_state(p0, f0, hi, lo, jnp.asarray(n, jnp.int32))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    t = f0 + n.astype(np.int64) * inc
    np.testing.assert_array_equal(got[0].numpy(), p0 + (t >> 16))


def test_torch_host_int_helpers_match_jax():
    cases = [(44100, 8000), (8000, 44100), (48000, 44100), (1, 2), (2, 1), (0, 5), (5, 0),
             (2**31, 1), (65536, 1), (65535, 1), (1, 10**9)]
    cases += [(int(r[0]), int(r[1])) for r in oracle.configs()]
    for a, b in cases:
        assert tfx.calculate_ratio(a, b) == jfx.calculate_ratio(a, b), (a, b)
    for x in (0, 1, 65535, 65536, 65537, 3 * 65536 + 1):
        assert tfx.fixed_ceil(x) == jfx.fixed_ceil(x)
        assert tfx.fixed_round(x) == jfx.fixed_round(x)
        assert tfx.fixed_floor(x) == jfx.fixed_floor(x)
        assert tfx.round_up(x, 8) == jfx.round_up(x, 8)


RATES = [0, 1, 2, 43, 44, 100, 8000, 11025, 22050, 32000, 44100, 48000, 96000, 192000]


def test_torch_configure_matches_jax_over_rate_grid():
    """Including the rejected domain: zero rates, kernel_scale >= 0x1000 and
    kernel_step_size == 0."""
    rejected = 0
    for a in RATES:
        for b in RATES:
            for lpf in sorted({a, b, 8000}):
                for model in (tlanczos.DEFAULT_MODEL, tlanczos.HIGH_QUALITY_MODEL):
                    got = configure(a, b, lpf, radius=model.radius, resolution=model.resolution)
                    want = jconfigure(a, b, lpf, radius=model.radius, resolution=model.resolution)
                    if want is None:
                        assert got is None, (a, b, lpf)
                        rejected += 1
                    else:
                        assert dataclasses.astuple(got) == dataclasses.astuple(want), (a, b, lpf)
    assert rejected > 50
    # kernel_scale exactly 0x1000 is refused; just below it the step floors to 0
    assert configure(MAX_KERNEL_SCALE_INT * 1000, 1000, 1000) is None
    assert configure(44100, 43, 44100) is None
    assert configure(44100, 44, 44100).integer_stretched_kernel_radius == 3007


def test_torch_configure_against_oracle():
    for row in oracle.configs():
        in_rate, out_rate, lpf, ok = (int(v) for v in row[:4])
        got = configure(in_rate, out_rate, lpf)
        if not ok or int(row[7]) == 0:
            assert got is None, (in_rate, out_rate, lpf)
            continue
        assert (got.stretched_kernel_radius, got.integer_stretched_kernel_radius,
                got.stretched_kernel_radius_delta, got.kernel_step_size) == \
            tuple(int(v) for v in row[4:8])


@pytest.mark.parametrize("name", ["DEFAULT_MODEL", "HIGH_QUALITY_MODEL", "LOW_COST_MODEL"])
def test_torch_kernel_tables_match_jax(name):
    port, jax_model = getattr(tlanczos, name), getattr(jlanczos, name)
    assert (port.radius, port.resolution, port.table_size) == \
        (jax_model.radius, jax_model.resolution, jax_model.table_size)
    np.testing.assert_array_equal(port.table(), jax_model.table())
    for step, taps in ((1024, 8), (185, 40), (512, 16), (1, 48)):
        np.testing.assert_array_equal(port.strided_table(step, taps),
                                      jax_model.strided_table(step, taps))
    t = table_tensor(port.strided_table(185, 40), torch.device("cpu"))
    assert t.dtype == torch.int32 and t.is_contiguous()
    np.testing.assert_array_equal(t.numpy(), jax_model.strided_table(185, 40))


def test_torch_kernel_tables_match_c_dumps():
    np.testing.assert_array_equal(tlanczos.DEFAULT_MODEL.table(), oracle.kernel_table())
    vectors = np.load(oracle.FIXTURES + "/model_vectors.npz")
    for tag, model in (("r10", tlanczos.KernelModel(10, 0x400)),
                       ("r2", tlanczos.KernelModel(2, 0x200))):
        np.testing.assert_array_equal(model.table(), vectors[f"{tag}__table"])
