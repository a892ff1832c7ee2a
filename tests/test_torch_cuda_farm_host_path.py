"""On a card: a farm's chunk on its way in, against the port's CPU farms.

The twins of ``tests/test_torch_farm_host_path.py`` (which holds the same
paths, stood in, against the JAX farms): every route into the pinned input
(``direct``: the farm library's host threads read a C-contiguous int16 chunk
where the caller holds it; ``converted``; a mixed farm's ``stacked``), short
and empty chunks, flush, ``adjust`` and ``adjust_stream``, a snapshot right
after ``process`` restored on the card, the sharded farm at dp 1-4 on shards of
the card, the caller's chunk left as it was and free to overwrite as soon
as ``process`` returns, each output exact against the CPU farm's; and two
farms fed at once from two threads, each exact against itself fed alone. They
skip without a card.
"""

import collections
import threading

import numpy as np
import pytest
import torch

from clownresampler_tpu_torch import checkpoint as ckpt
from clownresampler_tpu_torch.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.parallel import ShardedMixedStreamFarm, ShardedStreamFarm, make_mesh

RATES = (48000, 44100)
CHUNK = 256
SIZES = (256, 33, 0, 256, 5)
MIXED_GROUPS = [(48000, 44100), (96000, 48000), (8000, 48000)]
FORMS = {
    "int16": (lambda x: x.copy(), "direct"),
    "read_only": (lambda x: _read_only(x.copy()), "direct"),
    "int32_wrapping": (lambda x: x.astype(np.int32) * 3, "converted"),
    "float64": (lambda x: x.astype(np.float64) + 0.75, "converted"),
    "strided_view": (lambda x: np.repeat(x, 2, axis=1)[:, ::2], "converted"),
    "fortran_int16": (lambda x: np.asfortranarray(x), "converted"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


def _read_only(x):
    x.flags.writeable = False
    return x


def _base(seed, b, c, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16) for n in sizes]


def _run(farm, chunks):
    return [farm.process(c) for c in chunks] + [farm.flush()]


def _same(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} call {k}")


def _cpu(b, c, rates=RATES, **kw):
    return UniformStreamFarm(b, c, *rates, chunk_frames=CHUNK, device="cpu", **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(FORMS))
def test_torch_cuda_farm_host_path_route_matches_cpu_farm(cuda_device, form):
    make, route = FORMS[form]
    chunks = [make(x) for x in _base(61, 37, 2)]
    want = _run(_cpu(37, 2), chunks)
    rs.ROUTES.clear()
    farm = UniformStreamFarm(37, 2, *RATES, chunk_frames=CHUNK, device=cuda_device)
    _same(_run(farm, chunks), want, form)
    routes = collections.Counter(
        ("farm_input", "direct" if c.dtype == np.int16 and c.flags.c_contiguous else "converted")
        for c in chunks)
    assert {k: v for k, v in rs.ROUTES.items() if k[0] == "farm_input"} == routes
    assert routes[("farm_input", route)] >= sum(1 for c in chunks if c.shape[1])


@pytest.mark.cuda
@pytest.mark.parametrize("clamp", [False, True], ids=["int32", "clamp_s16"])
def test_torch_cuda_farm_host_path_adjust_and_snapshot(cuda_device, clamp):
    chunks = _base(62, 37, 2, (256,) * 5)
    want_farm = _cpu(37, 2, clamp_s16=clamp, max_radius=17)
    farm = UniformStreamFarm(37, 2, *RATES, chunk_frames=CHUNK, device=cuda_device,
                             clamp_s16=clamp, max_radius=17)
    _same([farm.process(c) for c in chunks[:2]], [want_farm.process(c) for c in chunks[:2]],
          "before")
    assert farm.adjust(44100, 8000) and want_farm.adjust(44100, 8000)
    _same([farm.process(chunks[2])], [want_farm.process(chunks[2])], "adjusted")
    restored = ckpt.load_farm(ckpt.save_farm(farm), device=cuda_device)
    want = _run(want_farm, chunks[3:])
    _same(_run(farm, chunks[3:]), want, "farm")
    _same(_run(restored, chunks[3:]), want, "restored")


@pytest.mark.cuda
@pytest.mark.parametrize("dp,b", [(1, 37), (2, 37), (3, 37), (4, 37), (4, 10)])
def test_torch_cuda_sharded_farm_host_path_matches_cpu_farm(cuda_device, dp, b):
    chunks = _base(63 + dp, b, 2, (256, 40, 256))
    want = _run(_cpu(b, 2), chunks)
    rs.ROUTES.clear()
    farm = ShardedStreamFarm(make_mesh(dp=dp, devices=[cuda_device] * dp), b, 2, *RATES,
                             chunk_frames=CHUNK)
    _same(_run(farm, chunks), want, f"dp {dp}")
    assert rs.ROUTES[("farm_input", "direct")] == len(chunks)


@pytest.mark.cuda
def test_torch_cuda_farm_host_path_leaves_the_callers_chunk(cuda_device):
    """Overwritten right after each ``process``, the first of which emits
    nothing (its upload may still be in flight when it returns)."""
    chunks = _base(64, 37, 2, (10, 256, 256, 7))
    want = _run(_cpu(37, 2, rates=(44100, 8000)), [c.copy() for c in chunks])
    farm = UniformStreamFarm(37, 2, 44100, 8000, chunk_frames=CHUNK, device=cuda_device)
    got = []
    for chunk in chunks:
        kept = chunk.copy()
        got.append(farm.process(chunk))
        assert np.array_equal(chunk, kept)
        chunk[...] = -12345
    assert got[0].shape[1] == 0
    got.append(farm.flush())
    _same(got, want, "overwritten after process")


@pytest.mark.cuda
def test_torch_cuda_farm_host_path_two_farms_from_two_threads(cuda_device):
    """Two farms fed at once from two host threads, every output kept (so
    past the result pool the host threads deliver too): the farm library's
    host threads take one job at a time, and each farm's outputs equal the
    same farm's fed alone, bit for bit."""
    jobs = [((512, 2), RATES, 71), ((384, 1), (44100, 8000), 72)]
    chunks = [_base(seed, b, c, (4096,) * 7) for (b, c), _, seed in jobs]

    def farm(k):
        (b, c), rates, _ = jobs[k]
        return UniformStreamFarm(b, c, *rates, chunk_frames=4096, device=cuda_device)

    want = [_run(farm(k), chunks[k]) for k in range(2)]
    for _ in range(3):
        farms, got, errors = [farm(0), farm(1)], [None, None], []
        start = threading.Barrier(2)

        def feed(k):
            try:
                start.wait()
                got[k] = _run(farms[k], chunks[k])
            except Exception as e:  # re-raised below, in the test's thread
                errors.append(e)

        threads = [threading.Thread(target=feed, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, errors
        for k in range(2):
            _same(got[k], want[k], f"farm {k}")


def _mixed_data(seed, streams, frames):
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, size=(frames, 2)).astype(np.int16)
            for _ in range(streams)]


def _run_mixed(farm, data, sizes, move=None, forms=None):
    outs, cursor = [], 0
    for k, size in enumerate(sizes):
        if move and move[0] == k:
            assert farm.adjust_stream(move[1], *move[2])
        part = [d[cursor : cursor + size] for d in data]
        if forms:
            part = [forms[i % len(forms)](p) for i, p in enumerate(part)]
        outs.append(farm.process(part))
        cursor += size
    outs.append(farm.flush())
    return [np.concatenate([o[i] for o in outs]) for i in range(len(data))]


@pytest.mark.cuda
@pytest.mark.parametrize("sharded", [0, 2, 3], ids=["unsharded", "dp2", "dp3"])
def test_torch_cuda_mixed_farm_host_path_matches_cpu_mixed_farm(cuda_device, sharded):
    specs = [rates for rates in MIXED_GROUPS for _ in range(5)]
    data = _mixed_data(70 + sharded, len(specs), 256 * 3 + 40)
    sizes, move = (256, 256, 40, 256), (2, 4, (44100, 8000))
    want = _run_mixed(MixedStreamFarm(specs, 2, chunk_frames=CHUNK, max_radius=17,
                                      device="cpu"), data, sizes, move)
    rs.ROUTES.clear()
    if sharded:
        farm = ShardedMixedStreamFarm(make_mesh(dp=sharded, devices=[cuda_device] * sharded),
                                      specs, 2, chunk_frames=CHUNK, max_radius=17)
    else:
        farm = MixedStreamFarm(specs, 2, chunk_frames=CHUNK, max_radius=17, device=cuda_device)
    for i, (g, w) in enumerate(zip(_run_mixed(farm, data, sizes, move), want)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")
    groups = len(MIXED_GROUPS)
    assert rs.ROUTES[("farm_input", "stacked")] == groups * move[0] + (groups + 1) * (
        len(sizes) - move[0])


@pytest.mark.cuda
def test_torch_cuda_mixed_farm_host_path_converts_each_chunk(cuda_device):
    specs = [rates for rates in MIXED_GROUPS for _ in range(2)]
    data = _mixed_data(75, len(specs), 256 * 2)
    forms = [lambda x: x, lambda x: x.astype(np.int32), lambda x: x.astype(np.float64) - 0.5,
             lambda x: np.repeat(x, 2, axis=0)[::2], lambda x: x.tolist(), lambda x: x]
    want = _run_mixed(MixedStreamFarm(specs, 2, chunk_frames=CHUNK, max_radius=17,
                                      device="cpu"), data, (256, 256), forms=forms)
    farm = MixedStreamFarm(specs, 2, chunk_frames=CHUNK, max_radius=17, device=cuda_device)
    for i, (g, w) in enumerate(zip(_run_mixed(farm, data, (256, 256), forms=forms), want)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")


@pytest.mark.cuda
def test_torch_cuda_mixed_farm_host_path_refuses_chunks_of_other_shapes(cuda_device):
    specs = [(48000, 44100)] * 2 + [(96000, 48000)] * 2
    good = _mixed_data(76, 4, 50)
    farm = MixedStreamFarm(specs, 2, chunk_frames=CHUNK, device=cuda_device)
    for bad in (np.zeros((49, 2), np.int16), np.zeros((50, 1), np.int16)):
        with pytest.raises(ValueError):
            farm.process(good[:3] + [bad])
    want = MixedStreamFarm(specs, 2, chunk_frames=CHUNK, device="cpu").process(good)
    for g, w in zip(farm.process(good), want):     # nothing was staged by the refusals
        np.testing.assert_array_equal(g, w)
