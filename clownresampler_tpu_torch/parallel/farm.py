"""Mesh-sharded transcode farms: the farm's streams split over a mesh's dp axis.

Counterpart of ``clownresampler_tpu/parallel/farm.py``.
``ShardedStreamFarm`` is ``farm.UniformStreamFarm`` with its streams split
over the ``dp`` axis of a ``parallel.Mesh`` on stream boundaries. Streams
share nothing (the reference is a scalar, single-stream library; there is no
cross-stream communication to replicate), so nothing crosses shards:

* each dp shard keeps its own ``farm.FarmProgram`` -- the staging buffers
  of its streams' lanes -- on its device, and every step of it -- the upload
  of the shard's stream range of the pinned input, the stage launch, the
  launches, the de-interleave, the download -- is issued on that device and,
  on a card, on the shard's own CUDA stream (``Mesh.shard``), in order;
* each shard launches the ratio class's kernel (ops/resample.py) on its own
  buffer with the shared phase state and its device's LUT and scalars; the
  routing (``_launch_specs``) is the unsharded farm's, so a sharded farm
  takes the same class and tiles;
* each shard's output goes to the host by its own copy, straight into its
  streams' block of the result, so no host concatenation is needed; the
  host waits for a shard at a time;
* all host bookkeeping (positions, halo slide, natural counts) is inherited
  unchanged, so outputs are bit-exact against the unsharded farm and
  transitively against the C reference per stream.

The phase state is shared across the fleet (uniform ratio), so ``adjust``
(pitch bend) works exactly as on the unsharded farm. Any dp from 1 up works,
including one that does not divide the stream count; a shard past the
stream count holds nothing and issues nothing.
"""

from __future__ import annotations

import contextlib
from typing import Optional

from clownresampler_tpu_torch.device import Device
from clownresampler_tpu_torch.farm import DeviceTables, MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu_torch.models import DEFAULT_MODEL, KernelModel
from clownresampler_tpu_torch.parallel.sharding import Mesh, split_bounds
from clownresampler_tpu_torch.utils import profiling


class ShardedStreamFarm(UniformStreamFarm):
    """UniformStreamFarm whose streams split over ``mesh``'s ``dp`` axis.

    ``device`` is the mesh's first device."""

    def __init__(
        self,
        mesh: Mesh,
        n_streams: int,
        channels: int,
        input_rate: int,
        output_rate: int,
        low_pass_rate: Optional[int] = None,
        chunk_frames: int = 4096,
        model: KernelModel = DEFAULT_MODEL,
        max_radius: Optional[int] = None,
        clamp_s16: bool = False,
    ):
        self.mesh = mesh
        super().__init__(n_streams, channels, input_rate, output_rate, low_pass_rate,
                         chunk_frames=chunk_frames, model=model, max_radius=max_radius,
                         device=mesh.device(0), clamp_s16=clamp_s16)

    def _alloc(self, device: Device) -> None:
        """One FarmProgram per non-empty dp shard on its device, holding the
        lanes of its streams (``_programs``; ``_bounds[i]`` is shard i's
        streams), the programs on one device sharing its DeviceTables."""
        mesh = self.mesh
        self.device = mesh.device(0)
        self._bounds = split_bounds(self.n_streams, mesh.shape["dp"])
        self._programs, consts = [], {}
        for i, (lo, hi) in enumerate(self._bounds):
            if hi == lo:
                continue
            with mesh.shard(i) as dev:
                if dev not in consts:
                    consts[dev] = DeviceTables(self.model, dev)
                self._programs.append((i, lo, hi, self._new_program(consts[dev], hi - lo)))
        self._alloc_host()

    @contextlib.contextmanager
    def _as_shard(self, shard: int):
        with self.mesh.shard(shard):
            yield

    @property
    def _staging(self) -> list:
        """Each dp shard's staged rows (``FarmProgram.rows``), None for an
        empty shard."""
        rows = [None] * len(self._bounds)
        for i, _, _, program in self._programs:
            rows[i] = program.rows()
        return rows

    def _take_stream(self, source: "ShardedStreamFarm", j: int) -> None:
        """Copy stream ``j``'s staged lanes from the shard of ``source`` (a
        sharded farm on the same mesh) that holds it into this new
        one-stream farm's shard, with the source's parked slide applied,
        ordered after the source shard's pending work; the source shard's
        later work is ordered after the copy."""
        mine = self._programs[0][0]
        k, lo, program = next((i, lo, program) for i, lo, hi, program in source._programs
                              if lo <= j < hi)
        col = (j - lo) * self.channels
        self.mesh.order((k, 0), (mine, 0))
        with self.mesh.shard(mine) as dev:
            lanes = program.rows()[:, col : col + self.channels]
            self._programs[0][3].rows()[: lanes.shape[0]] = lanes.to(dev)
        self.mesh.order((mine, 0), (k, 0))


class ShardedMixedStreamFarm(MixedStreamFarm):
    """MixedStreamFarm whose ratio groups each split over ``mesh``'s ``dp``
    axis: every group is a ShardedStreamFarm on the same mesh, and a chunk's
    launches are issued shard by shard, every group's launches of a shard on
    that shard's device and stream.

    Streams still share nothing, so the only mesh interaction is the split
    of each group's staging over the shards. ``adjust_stream`` moves a
    stream into its own sharded farm of one stream exactly as on the
    unsharded mixed farm (clownresampler.h:1052-1056 per stream): that farm
    keeps the whole mesh, its one stream on the first dp shard and the other
    shards empty, and takes the stream's staged lanes from whichever shard of
    the source group held them. Bit-exact against MixedStreamFarm per stream.
    """

    def __init__(self, mesh: Mesh, specs, channels: int, chunk_frames: int = 4096,
                 model: KernelModel = DEFAULT_MODEL, max_radius: Optional[int] = None,
                 clamp_s16: bool = False):
        self.mesh = mesh
        super().__init__(specs, channels, chunk_frames=chunk_frames, model=model,
                         max_radius=max_radius, clamp_s16=clamp_s16, device=mesh.device(0))

    def _make_group_farm(self, n_streams: int, rates: tuple,
                         max_radius: Optional[int] = None) -> ShardedStreamFarm:
        return ShardedStreamFarm(
            self.mesh, n_streams, self.channels, *rates, chunk_frames=self.chunk_frames,
            model=self.model, max_radius=max_radius, clamp_s16=self.clamp_s16)

    @profiling.spanned("crt.farm.launch")
    def _launch_groups(self, farms: list) -> list:
        """Each group's per-shard launched lanes (``ShardedStreamFarm._launch``'s
        return), issued shard by shard: every group's launches of dp shard i
        as that shard's, before those of shard i + 1."""
        outs = [{} for _ in farms]
        for i in range(self.mesh.shape["dp"]):
            holders = [(g, farm, n_out) for g, (farm, n_out) in enumerate(farms)
                       if any(shard == i for shard, *_ in farm._programs)]
            if not holders:
                continue
            with self.mesh.shard(i):
                for g, farm, n_out in holders:
                    outs[g][i] = farm._launch_shard(n_out, i)
        return [[lanes[shard] for shard, *_ in farm._programs]
                for (farm, _), lanes in zip(farms, outs)]
