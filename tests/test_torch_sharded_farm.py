"""Port ShardedStreamFarm / ShardedMixedStreamFarm (streams over the dp axis
of a mesh that repeats the CPU) are bit-equal to the port's unsharded farms
-- and transitively to the C reference per stream -- for every ratio class,
and to the JAX package's ShardedStreamFarm on its CPU mesh."""

import numpy as np
import pytest
import torch

from clownresampler_tpu import parallel as jparallel
from clownresampler_tpu_torch.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.parallel import (
    ShardedMixedStreamFarm,
    ShardedStreamFarm,
    make_mesh,
)


def _mesh(dp=8):
    return make_mesh(dp=dp, devices=["cpu"] * dp)


def _run(farm, chunks):
    outs = [farm.process(c) for c in chunks]
    outs.append(farm.flush())
    return np.concatenate(outs, axis=1)


def _chunks(seed, n_streams, chunk, channels, count):
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, (n_streams, chunk, channels)).astype(np.int16)
            for _ in range(count)]


@pytest.mark.parametrize(
    "in_rate,out_rate,kind",
    [
        (48000, 44100, "tiled"),
        (96000, 48000, "strided"),
        (44100, 8000, "general"),
    ],
)
def test_torch_sharded_farm_matches_uniform_farm(in_rate, out_rate, kind):
    n_streams, channels, chunk = 64, 2, 384
    chunks = _chunks(11, n_streams, chunk, channels, 3)
    want = _run(UniformStreamFarm(n_streams, channels, in_rate, out_rate, chunk_frames=chunk,
                                  device="cpu"), chunks)
    rs.ROUTES.clear()
    sh_farm = ShardedStreamFarm(_mesh(), n_streams, channels, in_rate, out_rate,
                                chunk_frames=chunk)
    got = _run(sh_farm, chunks)
    assert set(rs.ROUTES) == {(kind, "reference"), ("farm_input", "direct")}
    assert rs.ROUTES[(kind, "reference")] % 8 == 0    # every shard launched its own
    assert [buf.shape for *_, program in sh_farm._programs for buf in program.buffers] == [
        (sh_farm._capacity, 16)] * 16
    assert [st.shape[1] for st in sh_farm._staging] == [16] * 8
    np.testing.assert_array_equal(got, want, err_msg=f"{in_rate}->{out_rate}")


def test_torch_sharded_farm_general_ratio_routed_wide():
    """A general ratio of 256+ taps (44.1k -> 1000, taps 272) takes the wide
    class in every shard, as the shared _launch_specs routes it."""
    n_streams, channels, chunk = 16, 1, 2048
    chunks = _chunks(17, n_streams, chunk, channels, 2)
    ref_farm = UniformStreamFarm(n_streams, channels, 44100, 1000, chunk_frames=chunk,
                                 device="cpu")
    sh_farm = ShardedStreamFarm(_mesh(4), n_streams, channels, 44100, 1000, chunk_frames=chunk)
    assert sh_farm._launch_specs(8, shard=3)[1][0][0] == "wide"
    assert ref_farm._launch_specs(8)[1] == sh_farm._launch_specs(8, shard=0)[1]
    np.testing.assert_array_equal(_run(sh_farm, chunks), _run(ref_farm, chunks))


def test_torch_sharded_farm_adjust_pitch_bend():
    """Mid-stream adjust across the tiled, strided and tiled classes
    (position carry) matches the unsharded farm."""
    n_streams, channels, chunk = 32, 1, 384
    chunks = _chunks(13, n_streams, chunk, channels, 3)
    rates = [(48000, 44100), (96000, 48000), (32000, 48000)]

    def run(farm):
        outs = []
        for (ir, orate), c in zip(rates, chunks):
            assert farm.adjust(ir, orate, max(ir, orate))
            outs.append(farm.process(c))
        outs.append(farm.flush())
        return np.concatenate(outs, axis=1)

    ref_farm = UniformStreamFarm(n_streams, channels, 48000, 44100, chunk_frames=chunk,
                                 max_radius=8, device="cpu")
    sh_farm = ShardedStreamFarm(_mesh(), n_streams, channels, 48000, 44100,
                                chunk_frames=chunk, max_radius=8)
    assert not sh_farm.adjust(44100, 8000)     # radius 17 past the reserve of 8
    np.testing.assert_array_equal(run(sh_farm), run(ref_farm))


@pytest.mark.parametrize("moved", [0, 37, 63])
def test_torch_sharded_mixed_farm_matches_mixed_farm(moved):
    """ShardedMixedStreamFarm == MixedStreamFarm per stream, including a
    mid-stream per-stream adjust: the moved stream (held by the first, a
    middle or the last shard of its group) lands in its own sharded farm of
    one stream, whose other shards are empty."""
    ch, chunk, n_chunks = 2, 384, 3
    specs = [(48000, 44100)] * 64 + [(96000, 48000)] * 64
    rng = np.random.default_rng(19)
    data = [rng.integers(-32768, 32768, (n_chunks * chunk, ch)).astype(np.int16)
            for _ in specs]

    def run(farm):
        outs = [[] for _ in specs]
        for k in range(n_chunks):
            if k == 1:
                assert farm.adjust_stream(moved, 32000, 48000)
            res = farm.process([d[k * chunk : (k + 1) * chunk] for d in data])
            for i, r in enumerate(res):
                outs[i].append(r)
        for i, r in enumerate(farm.flush()):
            outs[i].append(r)
        return [np.concatenate(o, axis=0) for o in outs]

    want = run(MixedStreamFarm(specs, ch, chunk_frames=chunk, max_radius=8, device="cpu"))
    sh = ShardedMixedStreamFarm(_mesh(), specs, ch, chunk_frames=chunk, max_radius=8)
    got = run(sh)
    solo = sh._groups[-1][0]
    assert isinstance(solo, ShardedStreamFarm) and solo.n_streams == 1
    assert [st is not None for st in solo._staging] == [True] + [False] * 7
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")


def test_torch_sharded_farm_clamp_s16():
    """clamp_s16 through the sharded launch == clipping the wide farm."""
    n_streams, ch, chunk = 32, 1, 256
    data = _chunks(17, n_streams, chunk, ch, 1)[0]
    wide = ShardedStreamFarm(_mesh(), n_streams, ch, 8000, 44100, chunk_frames=chunk)
    clamped = ShardedStreamFarm(_mesh(), n_streams, ch, 8000, 44100, chunk_frames=chunk,
                                clamp_s16=True)
    a = np.concatenate([wide.process(data), wide.flush()], axis=1)
    b = np.concatenate([clamped.process(data), clamped.flush()], axis=1)
    assert b.dtype == np.int16 and np.abs(a).max() > 0x7FFF
    np.testing.assert_array_equal(b, np.clip(a, -0x7FFF, 0x7FFF).astype(np.int16))


def test_torch_sharded_farm_wide_kernel_class():
    """The wide class (taps > FAST_KERNEL_MAX_TAPS) under shards: 44100->256
    is the narrowest default-model ratio past the guard (radius 517, taps
    1040)."""
    n_streams, channels, chunk = 16, 1, 3072
    chunks = _chunks(23, n_streams, chunk, channels, 2)
    ref_farm = UniformStreamFarm(n_streams, channels, 44100, 256, chunk_frames=chunk,
                                 device="cpu")
    assert ref_farm._max_taps > 1024, "case must exercise the wide class"
    rs.ROUTES.clear()
    sh_farm = ShardedStreamFarm(_mesh(), n_streams, channels, 44100, 256, chunk_frames=chunk)
    got = _run(sh_farm, chunks)
    assert set(rs.ROUTES) == {("wide", "reference"), ("farm_input", "direct")}
    np.testing.assert_array_equal(got, _run(ref_farm, chunks))


@pytest.mark.parametrize("dp,n_streams", [(3, 8), (4, 1), (5, 3), (1, 4)])
def test_torch_sharded_farm_uneven_and_empty_shards(dp, n_streams):
    """A dp that does not divide the stream count, and one past it: shards
    take 3/3/2 streams, or one stream and three empty shards that issue
    nothing."""
    channels, chunk = 2, 200
    chunks = _chunks(29, n_streams, chunk, channels, 3)
    want = _run(UniformStreamFarm(n_streams, channels, 44100, 48000, chunk_frames=chunk,
                                  device="cpu"), chunks)
    rs.ROUTES.clear()
    sh_farm = ShardedStreamFarm(_mesh(dp), n_streams, channels, 44100, 48000,
                                chunk_frames=chunk)
    held = [0 if st is None else st.shape[1] // channels for st in sh_farm._staging]
    assert sum(held) == n_streams and max(held) - min(held) <= 1
    got = _run(sh_farm, chunks)
    # four emits (three chunks and the flush), one launch a non-empty shard
    assert rs.ROUTES[("tiled", "reference")] == 4 * sum(1 for h in held if h)
    np.testing.assert_array_equal(got, want)


def test_torch_sharded_farm_rejects_bad_chunks():
    farm = ShardedStreamFarm(_mesh(2), 4, 2, 48000, 44100, chunk_frames=64)
    with pytest.raises(ValueError, match="does not match the farm"):
        farm.process(np.zeros((4, 65, 2), np.int16))
    with pytest.raises(ValueError, match="does not match the farm"):
        farm.process(np.zeros((3, 64, 2), np.int16))
    assert farm.device == torch.device("cpu") and farm.mesh.shape["dp"] == 2


def test_torch_sharded_farm_matches_jax_sharded_farm():
    """The same chunks through the JAX ShardedStreamFarm (make_mesh(dp=2) of
    the CPU mesh, Pallas in interpret mode) and the port's on a two-shard
    CPU mesh: 128 stereo streams, 48k -> 44.1k, two chunks of 256 frames."""
    n_streams, channels, chunk = 128, 2, 256
    chunks = _chunks(31, n_streams, chunk, channels, 2)
    jfarm = jparallel.ShardedStreamFarm(jparallel.make_mesh(dp=2), n_streams, channels,
                                        48000, 44100, chunk_frames=chunk, interpret=True)
    want = _run(jfarm, chunks)
    got = _run(ShardedStreamFarm(_mesh(2), n_streams, channels, 48000, 44100,
                                 chunk_frames=chunk), chunks)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
