"""farm_stage_kernel's paths: the TMA ring and one tile a block.

On a card a farm call's staging is one launch of farm_stage_kernel on one of
three paths, which the launcher picks from the call's shapes and addresses
before the launch (``_build.farm_stage_path``): the ring, where every bulk
copy and store is 16-byte aligned and its stages fit in shared memory; else
one tile a block, with 16-byte stores where the rows and pointers allow
them, else element by element. The ring's stages, tile and slots are the
host's (``_build.farm_ring_layout``), and the C entry lays a block's shared
memory out by them. On the CPU this file holds

* the path rule on aligned and unaligned shapes;
* the ring's layout, and its header against the C source;
* a farm's card path, its C entries stood in over the same pointers
  (fixture ``card``), whose chunk lengths move its calls between paths,
  against the JAX package's farm (Pallas in interpret mode).

The ``cuda`` tests run each path on a card against the plain version.
"""

import os
import re

import numpy as np
import pytest
import torch

from clownresampler_tpu.farm import UniformStreamFarm as JFarm
from clownresampler_tpu_torch.farm import UniformStreamFarm, farm_stage, farm_stage_reference
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.parallel import ShardedStreamFarm, make_mesh
from tests.test_torch_farm_program import (  # noqa: F401  (card, cuda_device: fixtures)
    _chunks,
    _run,
    _same,
    card,
    cuda_device,
)

# ---------------------------------------------------------------------------
# The path rule and the ring's layout
# ---------------------------------------------------------------------------

_ALIGNED = dict(channels=2, streams=1024, n_in=8916, chunk_ptr=1 << 20, src_ptr=1 << 21,
                dst_ptr=1 << 22)


@pytest.mark.parametrize("change,path", [
    ({}, _build.FARM_STAGE_RING),
    (dict(channels=16, streams=64, n_in=1), _build.FARM_STAGE_RING),
    (dict(channels=4, streams=3, n_in=2), _build.FARM_STAGE_RING),
    (dict(channels=6, streams=2, n_in=4), _build.FARM_STAGE_RING),
    (dict(n_in=8915), _build.FARM_STAGE_VEC),                 # n*C no multiple of 8
    (dict(chunk_ptr=(1 << 20) + 4), _build.FARM_STAGE_VEC),   # chunk 4 bytes past
    (dict(n_in=0), _build.FARM_STAGE_VEC),                    # flush: no frames
    (dict(channels=4094, streams=2, n_in=8), _build.FARM_STAGE_VEC),   # stages too large
    (dict(chunk_ptr=(1 << 20) + 2), _build.FARM_STAGE_ELEMENT),
    (dict(streams=1023), _build.FARM_STAGE_ELEMENT),          # L = 2046: rows misaligned
    (dict(channels=1, n_in=8), _build.FARM_STAGE_ELEMENT),
    (dict(channels=3, n_in=8), _build.FARM_STAGE_ELEMENT),
    (dict(src_ptr=(1 << 21) + 8), _build.FARM_STAGE_ELEMENT),
    (dict(dst_ptr=(1 << 22) + 4), _build.FARM_STAGE_ELEMENT),
])
def test_torch_farm_stage_path_rule(change, path):
    """The ring takes a launch only where every bulk copy and store is
    16-byte aligned, there are frames and its stages fit in shared memory;
    else one tile a block, with 16-byte stores where the rows and pointers
    allow them."""
    assert _build.farm_stage_path(**dict(_ALIGNED, **change)) == path


@pytest.mark.parametrize("channels", [2, 4, 6, 16, 200, 4094, 4096])
def test_torch_farm_ring_layout(channels):
    """A ring tile: an even count of streams of about FARM_RING_ROW_BYTES a
    staged row, each stream's run whole 16-byte units of about
    FARM_RING_RUN_BYTES, in a slot of whole 16-byte units, their count odd;
    FARM_RING stages after the header. They fit in shared memory but at the
    widest channel counts."""
    got = _build.farm_ring_layout(channels)
    streams, frames, slot = got["tile_streams"], got["tile_frames"], got["slot"]
    assert streams >= 2 and streams % 2 == 0 and streams * channels * 4 % 16 == 0
    assert frames * channels * 2 % 16 == 0
    assert streams * channels * 4 <= max(_build.FARM_RING_ROW_BYTES, 8 * channels)
    assert frames * channels * 2 <= max(_build.FARM_RING_RUN_BYTES, 16 * channels)
    assert slot % 4 == 0 and slot // 4 % 2 == 1 and 0 <= 2 * slot - frames * channels <= 32
    assert got["stages"] == _build.FARM_RING
    assert got["shared_bytes"] == _build.FARM_RING_HEADER + _build.FARM_RING * streams * slot * 4
    assert (got["shared_bytes"] <= _build.MAX_SHARED_BYTES) == (channels != 4094)
    other = _build.farm_ring_layout(channels, stages=2, tile=(2, frames))
    assert other["shared_bytes"] == _build.FARM_RING_HEADER + 2 * 2 * slot * 4


def test_torch_farm_ring_header_is_the_c_sources():
    """The C entry puts the ring's stages after RING_HEADER bytes of
    barriers, two of 8 bytes a stage: the host's FARM_RING_HEADER, which
    holds FARM_RING stages' barriers. The stage count is no build knob."""
    with open(os.path.join(_build.CSRC, "farm_kernels.cu")) as f:
        source = f.read()
    header = int(re.search(r"constexpr int RING_HEADER = (\d+);", source).group(1))
    assert header == _build.FARM_RING_HEADER >= 16 * _build.FARM_RING
    assert "#ifndef" not in source


# ---------------------------------------------------------------------------
# A farm's card path, stood in, moving between paths
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_torch_farm_stage_path_follows_each_call(card, channels):
    """16 streams, chunks of 64, 63, 0, 20 and 5 frames: each call's stage
    takes the path its frames allow (the ring where n*C is a multiple of 8
    and C even, else 16-byte stores when C is even, else element by
    element; the flush one tile a block), with the ring's layout; every
    output equals the JAX farm's."""
    sizes = (64, 63, 0, 20, 5)
    chunks = _chunks(70 + channels, 16, channels, sizes)
    want = _run(JFarm(16, channels, 48000, 44100, chunk_frames=64, interpret=True), chunks)
    farm = UniformStreamFarm(16, channels, 48000, 44100, chunk_frames=64, device="cpu")
    _same(_run(farm, chunks), want, f"{channels} channels")
    stages = [a for name, a in card if name == "crt_farm_stage"]
    assert [a["n_in"] for a in stages] == [*sizes, 0]

    def path(n):
        if channels % 2:
            return _build.FARM_STAGE_ELEMENT
        return _build.FARM_STAGE_RING if n and n * channels % 8 == 0 else _build.FARM_STAGE_VEC

    assert [a["path"] for a in stages] == [path(n) for n in (*sizes, 0)]
    for a in stages:
        ring = a["path"] == _build.FARM_STAGE_RING
        assert (a["stages"], a["slot"] > 0) == ((_build.FARM_RING, True) if ring else (0, False))


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("b,c", [(1024, 2), (1000, 2), (29, 1), (29, 2), (29, 3), (64, 16),
                                 (3, 4), (2, 6)])
def test_torch_cuda_farm_stage_paths_match_reference(cuda_device, b, c):
    """A slide parked, an in-place append, a chunk of no frames and a chunk
    to the capacity's end, on each path its shapes allow, equal the plain
    version."""
    gen = torch.Generator(device="cuda").manual_seed(90 + b + c)
    capacity = 300
    rand = lambda *shape: torch.randint(-32768, 32768, shape, generator=gen, dtype=torch.int32,
                                        device=cuda_device)
    paths = set()
    for n, keep, consumed, in_place in ((200, 37, 55, False), (199, 37, 55, False),
                                        (64, 100, 0, True), (0, 9, 200, False),
                                        (240, 60, 2, False)):
        src = rand(capacity, b * c)
        dst = src if in_place else rand(capacity, b * c)
        chunk = rand(b, n, c).to(torch.int16)
        want_src = src.clone()
        want = want_src if in_place else dst.clone()
        farm_stage_reference(want_src, want, chunk, keep=keep, consumed=consumed)
        paths.add(_build.farm_stage_args(src, dst, chunk, streams=b, channels=c, n_in=n,
                                         keep=keep, consumed=consumed)["path"])
        rs.ROUTES.clear()
        farm_stage(src, dst, chunk, keep=keep, consumed=consumed)
        assert rs.ROUTES == {("farm_stage", "cuda"): 1}
        assert torch.equal(dst, want), (n, keep, consumed, in_place)
        assert in_place or torch.equal(src, want_src)
    assert (_build.FARM_STAGE_RING in paths) == (c % 2 == 0 and b * c % 4 == 0)


@pytest.mark.cuda
def test_torch_cuda_farm_paths_match_cpu_farm(cuda_device):
    """The farm on the card with chunk lengths that move its stage between
    the ring and one tile a block, unsharded and on a four-shard mesh of the
    card, against the CPU farm."""
    chunks = _chunks(91, 36, 2, (256, 255, 0, 31, 256))
    want = _run(UniformStreamFarm(36, 2, 48000, 44100, chunk_frames=256, device="cpu"), chunks)
    rs.ROUTES.clear()
    _same(_run(UniformStreamFarm(36, 2, 48000, 44100, chunk_frames=256, device=cuda_device),
               chunks), want, "unsharded")
    assert rs.ROUTES[("farm_stage", "cuda")] == len(chunks) + 1
    mesh = make_mesh(dp=4, devices=[cuda_device] * 4)
    _same(_run(ShardedStreamFarm(mesh, 36, 2, 48000, 44100, chunk_frames=256), chunks), want,
          "sharded")
