"""Port loader of the native staging engine: differential tests against the
numpy versions (tests/test_native.py's cases), and against the JAX
package's loader of the same library."""

import contextlib

import numpy as np
import pytest

from clownresampler_tpu.utils import native as jnative
from clownresampler_tpu_torch import UniformStreamFarm
from clownresampler_tpu_torch.utils import native
from tests.test_torch_farm import _jax_host_reference


@pytest.fixture(scope="module")
def have_native():
    if not native.available():
        pytest.skip("native toolchain unavailable; numpy versions in use")
    return True


@contextlib.contextmanager
def forced_numpy():
    lib, tried = native._lib, native._tried
    native._lib, native._tried = None, True
    try:
        yield
    finally:
        native._lib, native._tried = lib, tried


def test_torch_native_available_follows_the_library(have_native):
    assert native.available() is True
    with forced_numpy():
        assert native.available() is False
    assert native.available() == jnative.available()


def test_torch_native_stage_chunk(have_native):
    rng = np.random.default_rng(0)
    b, n, c, ld = 7, 13, 2, 7 * 2 + 3
    chunk = rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16)
    staging = np.zeros((40, ld), np.int32)
    native.stage_chunk(chunk, staging, row_off=5)
    want = np.zeros_like(staging)
    want[5 : 5 + n, : b * c] = chunk.transpose(1, 0, 2).reshape(n, b * c)
    np.testing.assert_array_equal(staging, want)


def test_torch_native_shift_and_zero(have_native):
    rng = np.random.default_rng(1)
    staging = rng.integers(-(2**31), 2**31 - 1, size=(32, 16)).astype(np.int32)
    want = staging.copy()
    want[:20] = staging[9:29]
    native.shift_rows(staging, 20, 9)
    np.testing.assert_array_equal(staging[:20], want[:20])
    native.zero_rows(staging, 3, 4)
    assert not staging[3:7].any()


@pytest.mark.parametrize("b,m,c,pad", [(5, 11, 2, 6), (1, 1, 1, 0), (130, 70, 2, 0),
                                       (3, 200, 16, 5)])
def test_torch_native_unstage(have_native, b, m, c, pad):
    rng = np.random.default_rng(2)
    lanes = rng.integers(-(2**31), 2**31 - 1, size=(m, b * c + pad)).astype(np.int32)
    out = native.unstage_output(lanes, b, c)
    want = lanes[:, : b * c].reshape(m, b, c).transpose(1, 0, 2)
    assert out.shape == (b, m, c) and out.dtype == np.int32 and out.flags.c_contiguous
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, jnative.unstage_output(lanes, b, c))


def test_torch_native_unstage_refuses_too_few_lanes():
    with pytest.raises(ValueError, match="does not hold"):
        native.unstage_output(np.zeros((4, 7), np.int32), 4, 2)


def test_torch_native_roundtrip(have_native):
    rng = np.random.default_rng(3)
    b, n, c = 16, 64, 2
    chunk = rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16)
    staging = np.zeros((n, b * c), np.int32)
    native.stage_chunk(chunk, staging, 0)
    back = native.unstage_output(staging, b, c)
    np.testing.assert_array_equal(back, chunk.astype(np.int32))


def test_torch_native_numpy_versions_match_native():
    """Force the numpy versions and compare against the C implementation
    (or against themselves when no toolchain) -- incl. padded lanes."""
    rng = np.random.default_rng(4)
    b, n, c, lanes = 7, 13, 2, 128  # padded lanes: b*c=14 << 128
    chunk = rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16)

    stag_a = np.zeros((40, lanes), np.int32)
    with forced_numpy():
        native.stage_chunk(chunk, stag_a, 5)
        native.shift_rows(stag_a, 30, 3)
        native.zero_rows(stag_a, 2, 4)
        out_a = native.unstage_output(stag_a[:9], b, c)

    stag_b = np.zeros((40, lanes), np.int32)
    native.stage_chunk(chunk, stag_b, 5)
    native.shift_rows(stag_b, 30, 3)
    native.zero_rows(stag_b, 2, 4)
    out_b = native.unstage_output(stag_b[:9], b, c)

    np.testing.assert_array_equal(stag_a, stag_b)
    np.testing.assert_array_equal(out_a, out_b)


def test_torch_farm_works_with_numpy_versions():
    """The farm works without the C++ toolchain."""
    rng = np.random.default_rng(6)
    data = rng.integers(-32768, 32768, size=(3, 300, 2)).astype(np.int16)
    with forced_numpy():
        farm = UniformStreamFarm(3, 2, 48000, 44100, chunk_frames=256, device="cpu")
        outs = [farm.process(data[:, :256]), farm.process(data[:, 256:]), farm.flush()]
    got = np.concatenate(outs, axis=1)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _jax_host_reference(data[i], 2, 48000, 44100,
                                                                  48000))
