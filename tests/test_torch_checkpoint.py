"""Port checkpoint/resume: every kind of snapshot restores and continues bit
for bit; the JAX package's snapshots restore in the port and continue equal
to the JAX object continuing, and the port's farm snapshots restore in the
JAX package and continue equal to the port's farm continuing. Sharded farms'
snapshots restore onto a mesh and onto one device, in both packages."""

import numpy as np
import pytest

from clownresampler_tpu import checkpoint as jckpt
from clownresampler_tpu.farm import MixedStreamFarm as JMixedFarm
from clownresampler_tpu.farm import UniformStreamFarm as JFarm
from clownresampler_tpu.highlevel import HighLevelResampler as JHighLevel
from clownresampler_tpu_torch import checkpoint as ckpt
from clownresampler_tpu_torch.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu_torch.highlevel import HighLevelResampler
from clownresampler_tpu_torch.lowlevel import LowLevelResampler
from clownresampler_tpu.models import HIGH_QUALITY_MODEL as JHIGH_QUALITY_MODEL
from clownresampler_tpu_torch.models import HIGH_QUALITY_MODEL
from clownresampler_tpu import parallel as jparallel
from clownresampler_tpu_torch.parallel import (
    ShardedMixedStreamFarm,
    ShardedStreamFarm,
    make_mesh,
)

CHUNK = 256
MIXED_SPECS = [(48000, 44100), (48000, 44100), (8000, 44100), (96000, 48000)]


def _data(seed, *shape):
    return np.random.default_rng(seed).integers(-32768, 32768, size=shape).astype(np.int16)


def _feeder(data, start=0):
    """An input callback over ``data`` from frame ``start``; ``cb.cursor``
    is the next frame it hands out."""
    def cb(n):
        got = data[cb.cursor : cb.cursor + n]
        cb.cursor += got.shape[0]
        return got

    cb.cursor = start
    return cb


def _finish_highlevel(rs, cb):
    out = []
    rs.resample(cb, _collect=out)
    rs.resample_end(_collect=out)
    return np.concatenate(out)


def _finish_farm(farm, chunks):
    return np.concatenate([farm.process(c) for c in chunks] + [farm.flush()], axis=1)


def _finish_mixed(farm, chunks):
    steps = [farm.process(list(c)) for c in chunks] + [farm.flush()]
    return [np.concatenate([s[i] for s in steps]) for i in range(len(steps[0]))]


def test_torch_lowlevel_roundtrip_continues():
    data = _data(0, 500, 2)
    r = 17
    padded = np.concatenate([np.zeros((r, 2), np.int16), data, np.zeros((r, 2), np.int16)])
    a = LowLevelResampler.init(2, 44100, 8000, 44100, device="cpu")
    _, rem, _ = a.resample(padded[: 300 + 2 * r], 300)
    b = ckpt.load_lowlevel(ckpt.save_lowlevel(a), device="cpu")
    consumed = 300 - rem
    _, _, rest_a = a.resample(padded[consumed:], 500 - consumed)
    _, _, rest_b = b.resample(padded[consumed:], 500 - consumed)
    assert rest_a.tobytes() == rest_b.tobytes() and a.state_tuple() == b.state_tuple()


def test_torch_lowlevel_roundtrip_keeps_model():
    data = _data(7, 200, 2)
    a = LowLevelResampler.init(2, 48000, 44100, 48000, model=HIGH_QUALITY_MODEL, device="cpu")
    r = a.config.integer_stretched_kernel_radius
    padded = np.concatenate([np.zeros((r, 2), np.int16), data, np.zeros((r, 2), np.int16)])
    b = ckpt.load_lowlevel(ckpt.save_lowlevel(a), device="cpu")
    assert b.model == a.model == HIGH_QUALITY_MODEL
    assert a.resample(padded, 200)[2].tobytes() == b.resample(padded, 200)[2].tobytes()


def test_torch_highlevel_roundtrip_continues():
    data = _data(1, 800, 2)
    a = HighLevelResampler.init(2, 44100, 8000, 44100, device="cpu")
    cb = _feeder(data)
    a.resample(cb, output_limit=100, _collect=[])
    b = ckpt.load_highlevel(ckpt.save_highlevel(a), device="cpu")
    cb_b = _feeder(data, cb.cursor)
    assert _finish_highlevel(a, cb).tobytes() == _finish_highlevel(b, cb_b).tobytes()


@pytest.mark.parametrize("rates", [(48000, 44100), (96000, 48000)], ids=["tiled", "strided"])
def test_torch_farm_roundtrip_continues(rates):
    data = _data(2, 4, 3 * CHUNK, 2)
    chunks = [data[:, i * CHUNK : (i + 1) * CHUNK] for i in range(3)]
    a = UniformStreamFarm(4, 2, *rates, chunk_frames=CHUNK, device="cpu")
    a.process(chunks[0])
    snap = ckpt.save_farm(a)
    assert isinstance(snap["staging"], np.ndarray)
    b = ckpt.load_farm(snap, device="cpu")
    assert _finish_farm(a, chunks[1:]).tobytes() == _finish_farm(b, chunks[1:]).tobytes()


def test_torch_mixed_farm_roundtrip_continues_after_adjust_stream():
    data = _data(51, 3, len(MIXED_SPECS), CHUNK, 2)
    a = MixedStreamFarm(MIXED_SPECS, 2, chunk_frames=CHUNK, max_radius=8, device="cpu")
    a.process(list(data[0]))
    assert a.adjust_stream(1, 96000, 48000)
    b = ckpt.load_mixed_farm(ckpt.save_mixed_farm(a), device="cpu")
    assert b.max_radius == 8 and len(b._groups) == len(a._groups)
    for got, want in zip(_finish_mixed(b, data[1:]), _finish_mixed(a, data[1:])):
        assert got.tobytes() == want.tobytes()


def test_torch_restores_jax_farm_snapshot():
    """A JAX farm snapshot (128-lane padded staging with strided over-read
    slack rows) continues in the port equal to the JAX farm."""
    data = _data(3, 4, 3 * CHUNK, 2)
    chunks = [data[:, i * CHUNK : (i + 1) * CHUNK] for i in range(3)]
    j = JFarm(4, 2, 96000, 48000, chunk_frames=CHUNK, interpret=True)
    j.process(chunks[0])
    snap = jckpt.save_farm(j)
    b = ckpt.load_farm(snap, device="cpu")
    assert snap["staging"].shape != b._staging.shape
    np.testing.assert_array_equal(_finish_farm(b, chunks[1:]), _finish_farm(j, chunks[1:]))


def test_torch_restores_jax_mixed_farm_snapshot():
    """Two tiled groups (the JAX farm runs its Pallas kernels in interpret
    mode here), one stream moved off its group before the snapshot."""
    specs = MIXED_SPECS[:3]
    data = _data(4, 2, len(specs), CHUNK, 2)
    j = JMixedFarm(specs, 2, chunk_frames=CHUNK, max_radius=8, interpret=True)
    j.process(list(data[0]))
    assert j.adjust_stream(1, 44100, 48000)
    b = ckpt.load_mixed_farm(jckpt.save_mixed_farm(j), device="cpu")
    for i, (got, want) in enumerate(zip(_finish_mixed(b, data[1:]), _finish_mixed(j, data[1:]))):
        np.testing.assert_array_equal(got, want, err_msg=f"stream {i}")


def test_torch_restores_jax_highlevel_snapshot():
    data = _data(5, 900, 2)
    j = JHighLevel.init(2, 48000, 44100, 48000)
    cb = _feeder(data)
    j.resample(cb, output_limit=300, _collect=[])
    b = ckpt.load_highlevel(jckpt.save_highlevel(j), device="cpu")
    cb_b = _feeder(data, cb.cursor)
    np.testing.assert_array_equal(_finish_highlevel(b, cb_b), _finish_highlevel(j, cb))


@pytest.mark.parametrize("rates", [(48000, 44100), (96000, 48000), (44100, 8000), (44100, 132),
                                   (529200, 44100)])
def test_torch_jax_capacity_matches_the_jax_farm(rates):
    """The port's copy of the JAX farm's staging capacity rule gives the
    capacity the JAX farm has, across radius reserves, chunk sizes on both
    sides of its input-row budget and two models."""
    for max_radius in (None, 8, 17, 100):
        for chunk in (256, 8192, 12000, 16384):
            for model, jmodel in ((None, None), (HIGH_QUALITY_MODEL, JHIGH_QUALITY_MODEL)):
                extra = {} if model is None else dict(model=model)
                jextra = {} if jmodel is None else dict(model=jmodel)
                j = JFarm(1, 2, *rates, chunk_frames=chunk, max_radius=max_radius, **jextra)
                p = UniformStreamFarm(1, 2, *rates, chunk_frames=chunk, max_radius=max_radius,
                                      device="cpu", **extra)
                assert ckpt.jax_capacity(p) == j._capacity, (max_radius, chunk, model)


@pytest.mark.parametrize("rates", [(48000, 44100), (96000, 48000)], ids=["tiled", "strided"])
def test_torch_farm_snapshot_restores_in_jax(rates):
    """64 stereo streams (128 lanes): the port's snapshot has the JAX farm's
    staging shape and keys, restores with the JAX package's load_farm
    (Pallas in interpret mode on the CPU) and continues over a further
    chunk and the flush bit for bit with the port's farm."""
    chunk = 300
    data = _data(6, 64, 2 * chunk, 2)
    chunks = [data[:, :chunk], data[:, chunk:]]
    a = UniformStreamFarm(64, 2, *rates, chunk_frames=chunk, device="cpu")
    a.process(chunks[0])
    snap = ckpt.save_farm(a)
    j = JFarm(64, 2, *rates, chunk_frames=chunk, interpret=True)
    assert snap["staging"].shape == (j._capacity, 128) and snap["interpret"] is False
    assert snap["device_staging"] is False        # the farm's device is the CPU
    b = jckpt.load_farm(dict(snap, interpret=True, device_staging=False))
    np.testing.assert_array_equal(_finish_farm(b, chunks[1:]), _finish_farm(a, chunks[1:]))


def test_torch_mixed_farm_snapshot_restores_in_jax():
    """A port mixed farm -- two tiled groups of 3 stereo streams, one stream
    moved to its own group by adjust_stream -- restores with the JAX
    package's load_mixed_farm (interpret mode) and continues bit for bit."""
    specs = MIXED_SPECS[:3]
    data = _data(7, 2, len(specs), CHUNK, 2)
    a = MixedStreamFarm(specs, 2, chunk_frames=CHUNK, max_radius=8, device="cpu")
    a.process(list(data[0]))
    assert a.adjust_stream(1, 44100, 48000)
    snap = ckpt.save_mixed_farm(a)
    assert len(snap["groups"]) == 3 and snap["interpret"] is False
    snap = dict(snap, interpret=True,
                groups=[dict(g, farm=dict(g["farm"], interpret=True)) for g in snap["groups"]])
    b = jckpt.load_mixed_farm(snap)
    for i, (got, want) in enumerate(zip(_finish_mixed(b, data[1:]), _finish_mixed(a, data[1:]))):
        np.testing.assert_array_equal(got, want, err_msg=f"stream {i}")


def test_torch_mixed_farm_snapshot_after_a_strided_move_restores_in_jax():
    """A stream of a tiled group moved to 96k -> 48k (strided) under a
    100-row radius reserve, where the JAX farm sizes a strided group's
    staging far larger than a tiled one's: its solo farm is saved with the
    source group's capacity, as the JAX adjust_stream builds it, and the
    snapshot restores in the JAX package and continues bit for bit."""
    specs = [(48000, 44100)] * 2
    data = _data(8, 2, len(specs), CHUNK, 2)
    a = MixedStreamFarm(specs, 2, chunk_frames=CHUNK, max_radius=100, device="cpu")
    a.process(list(data[0]))
    assert a.adjust_stream(1, 96000, 48000)
    j = JMixedFarm(specs, 2, chunk_frames=CHUNK, max_radius=100, interpret=True)
    assert j.adjust_stream(1, 96000, 48000)
    snap = ckpt.save_mixed_farm(a)
    rows = [g["farm"]["staging"].shape[0] for g in snap["groups"]]
    assert rows == [f._capacity for f, _ in j._groups] == [rows[0]] * 2
    assert rows[0] < JFarm(1, 2, 96000, 48000, chunk_frames=CHUNK, max_radius=100)._capacity
    snap = dict(snap, interpret=True,
                groups=[dict(g, farm=dict(g["farm"], interpret=True)) for g in snap["groups"]])
    b = jckpt.load_mixed_farm(snap)
    for i, (got, want) in enumerate(zip(_finish_mixed(b, data[1:]), _finish_mixed(a, data[1:]))):
        np.testing.assert_array_equal(got, want, err_msg=f"stream {i}")


def test_torch_capacity_ratio_survives_a_port_round_trip():
    """A farm adjusted after it was built keeps the JAX capacity of the
    ratio it was built for through save_farm and the port's load_farm."""
    a = UniformStreamFarm(2, 2, 48000, 44100, chunk_frames=CHUNK, max_radius=100, device="cpu")
    a.process(_data(9, 2, CHUNK, 2))
    assert a.adjust(96000, 48000)
    snap = ckpt.save_farm(a)
    b = ckpt.load_farm(snap, device="cpu")
    assert snap["staging"].shape[0] == ckpt.jax_capacity(b) == JFarm(
        2, 2, 48000, 44100, chunk_frames=CHUNK, max_radius=100)._capacity


def test_torch_load_refuses_other_kinds():
    snap = ckpt.save_lowlevel(LowLevelResampler.init(2, 44100, 8000, 44100, device="cpu"))
    with pytest.raises(ValueError, match="not a farm snapshot"):
        ckpt.load_farm(snap, device="cpu")


def _cpu_mesh(dp):
    return make_mesh(dp=dp, devices=["cpu"] * dp)


@pytest.mark.parametrize("dp,restore_dp", [(8, 8), (3, 5)])
def test_torch_sharded_farm_snapshot_restores_on_a_mesh_and_a_device(dp, restore_dp):
    """A sharded farm saved after a chunk, restored with ``mesh=`` (as a
    ShardedStreamFarm, on a mesh of another dp too) and without (unsharded),
    and all three continued: equal. The snapshot is the unsharded farm's."""
    n_streams, ch = 64, 2
    data = _data(53, n_streams, 2 * CHUNK, ch)
    chunks = [data[:, :CHUNK], data[:, CHUNK:]]
    a = ShardedStreamFarm(_cpu_mesh(dp), n_streams, ch, 48000, 44100, chunk_frames=CHUNK)
    plain = UniformStreamFarm(n_streams, ch, 48000, 44100, chunk_frames=CHUNK, device="cpu")
    a.process(chunks[0])
    plain.process(chunks[0])
    snap = ckpt.save_farm(a)
    np.testing.assert_array_equal(snap["staging"], ckpt.save_farm(plain)["staging"])
    b = ckpt.load_farm(snap, mesh=_cpu_mesh(restore_dp))
    assert isinstance(b, ShardedStreamFarm) and b.mesh.shape["dp"] == restore_dp
    c = ckpt.load_farm(snap, device="cpu")
    assert type(c) is UniformStreamFarm
    ra, rb, rc = (_finish_farm(f, chunks[1:]) for f in (a, b, c))
    np.testing.assert_array_equal(rb, ra)
    np.testing.assert_array_equal(rc, ra)


def test_torch_unsharded_farm_snapshot_restores_on_a_mesh():
    data = _data(54, 6, 2 * CHUNK, 2)
    chunks = [data[:, :CHUNK], data[:, CHUNK:]]
    a = UniformStreamFarm(6, 2, 96000, 48000, chunk_frames=CHUNK, device="cpu")
    a.process(chunks[0])
    b = ckpt.load_farm(ckpt.save_farm(a), mesh=_cpu_mesh(4))
    assert isinstance(b, ShardedStreamFarm)
    np.testing.assert_array_equal(_finish_farm(b, chunks[1:]), _finish_farm(a, chunks[1:]))


def test_torch_sharded_mixed_farm_snapshot_restores_on_a_mesh_and_a_device():
    """A sharded mixed farm with one stream moved by adjust_stream: restored
    onto the mesh, restored unsharded, and the original, continued equal."""
    mesh = _cpu_mesh(4)
    ch = 1
    specs = [(48000, 44100)] * 16 + [(96000, 48000)] * 16
    data = _data(59, 2, len(specs), CHUNK, ch)
    a = ShardedMixedStreamFarm(mesh, specs, ch, chunk_frames=CHUNK, max_radius=8)
    a.process(list(data[0]))
    assert a.adjust_stream(9, 32000, 48000)
    snap = ckpt.save_mixed_farm(a)
    b = ckpt.load_mixed_farm(snap, mesh=mesh)
    assert isinstance(b, ShardedMixedStreamFarm) and len(b._groups) == 3
    assert all(isinstance(f, ShardedStreamFarm) for f, _ in b._groups)
    c = ckpt.load_mixed_farm(snap, device="cpu")
    assert type(c) is MixedStreamFarm
    outs = [_finish_mixed(f, data[1:]) for f in (a, b, c)]
    for i, (ra, rb, rc) in enumerate(zip(*outs)):
        np.testing.assert_array_equal(rb, ra, err_msg=f"sharded stream {i}")
        np.testing.assert_array_equal(rc, ra, err_msg=f"plain stream {i}")


def test_torch_sharded_farm_snapshot_restores_on_the_jax_mesh():
    """A port sharded snapshot of 512 stereo streams (1024 lanes: a whole
    128-lane tile for each of the JAX mesh's 8 devices) restored by the JAX
    package's load_farm(snap, mesh=make_mesh()) and continued bit for bit."""
    n_streams, ch, chunk = 512, 2, 128
    data = _data(61, n_streams, 2 * chunk, ch)
    chunks = [data[:, :chunk], data[:, chunk:]]
    a = ShardedStreamFarm(_cpu_mesh(8), n_streams, ch, 48000, 44100, chunk_frames=chunk)
    a.process(chunks[0])
    snap = ckpt.save_farm(a)
    j = jckpt.load_farm(dict(snap, interpret=True), mesh=jparallel.make_mesh())
    assert isinstance(j, jparallel.ShardedStreamFarm)
    np.testing.assert_array_equal(_finish_farm(j, chunks[1:]), _finish_farm(a, chunks[1:]))


def test_torch_load_refuses_a_device_with_a_mesh():
    farm = UniformStreamFarm(2, 2, 48000, 44100, chunk_frames=64, device="cpu")
    mixed = MixedStreamFarm([(48000, 44100)], 2, chunk_frames=64, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        ckpt.load_farm(ckpt.save_farm(farm), device="cpu", mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="not both"):
        ckpt.load_mixed_farm(ckpt.save_mixed_farm(mixed), device="cpu", mesh=_cpu_mesh(2))
