"""Transcode farm: steady-state chunked resampling of many parallel streams.

B same-ratio streams flow through one launch per output tile as lanes of a
lane-major ``(rows, B*C)`` int32 staging buffer, with the host side doing
what the reference's high-level layer does for one stream -- staging buffer,
halo carry, edge padding (clownresampler.h:1096-1252). Dynamic ratio changes
(pitch bends) are ``adjust`` between chunks, with LowLevel_Adjust semantics
(clownresampler.h:1052-1056): position carries over, only the
increment/stretching change.

``UniformStreamFarm`` drives B same-ratio streams (one shared phase state).
``MixedStreamFarm`` groups a fleet of mixed ratios into one uniform farm per
(input, output, low-pass) rate triple and issues every group's launches of a
chunk together.

Every farm call is one device program (``FarmProgram``): the chunk copied
from the caller's memory into the farm's input buffer, uploaded, staged (the
parked slide, the chunk widened and transposed, the zero tail), the ratio
class's launches written into one output at their row offsets, the output
de-interleaved and downloaded into the array the caller receives. On a CUDA
card every step is a prebound C call with no torch op in between: the farm
library's host threads copy the chunk into pinned memory and upload its
pieces as they land, farm_stage_kernel, the engine's kernels,
farm_unstage_kernel. On the CPU the same program runs their plain versions
(``farm_host_stage_reference``, ``farm_stage_reference``, the engines'
through ``multi_resample``, ``farm_unstage_reference``) on the same buffers.
Each call is one row of the recorder (``utils.profiling``,
``crt.farm.call``): its staging, launches and copy out as spans, with the
host pool's counters.

Bit-exactness: each stream's output is identical to running the reference
(and LowLevelResampler) on that stream alone.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref
from typing import Optional

import numpy as np
import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.configure import Configuration, configure
from clownresampler_tpu_torch.device import DEFAULT_DEVICE, Device, resolve_device
from clownresampler_tpu_torch.lowlevel import DeviceState, launch_kind
from clownresampler_tpu_torch.models import DEFAULT_MODEL, KernelModel, table_tensor
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops.convolve import ConfigScalars
from clownresampler_tpu_torch.ops.resample import (
    ROUTES,
    entry_launch_args,
    multi_resample,
    wide_launch_frames,
)
from clownresampler_tpu_torch.utils import profiling

# Max output frames per launch: device positions come from
# fx.positions_from_state, int32-exact while f0 + n*inc_lo < 2^31.
MAX_LAUNCH_OUTPUT_FRAMES = 1 << 14


class DeviceTables:
    """A farm's constants on one device: the LUT, the strided tables its
    launches have taken so far, and the current configuration's scalars."""

    def __init__(self, model: KernelModel, device: torch.device):
        self.model = model
        self.table = table_tensor(model.table(), device)
        self.device = self.table.device
        self.scalars: Optional[ConfigScalars] = None
        self._strided: dict = {}   # (step, taps) -> strided table tensor

    def configure(self, cfg: Configuration, increment: int) -> None:
        self.scalars = ConfigScalars.from_configuration(cfg, increment, self.device)

    def strided_table(self, step: int, taps: int) -> torch.Tensor:
        tstr = self._strided.get((step, taps))
        if tstr is None:
            tstr = self._strided[(step, taps)] = table_tensor(
                self.model.strided_table(step, taps), self.device)
        return tstr


# Pinned result buffers of a farm, out with callers or waiting for reuse: a
# caller that drops an output before or while it takes the next needs one or
# two, and each one costs a page-locking allocation (16-25 ms for the 67 MB
# of 1024 stereo streams x 8192 frames on the H100's host, PERF.md).
RESULT_POOL_BUFFERS = 2


def _on_card(device: torch.device) -> bool:
    """True where a farm runs its kernels (a CUDA card), False on the CPU,
    where it runs their plain versions."""
    return device.type == "cuda"


def _pinned_empty(numel: int, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(numel, dtype=dtype, pin_memory=True)


def _same_buffer(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() == b.data_ptr()


def farm_stage_reference(src, dst, chunk, *, keep: int, consumed: int) -> None:
    """Plain PyTorch version of ``farm_stage``: a farm call's staging.

    ``src`` and ``dst`` are the farm's two lane-major (capacity, B*C) int32
    buffers, ``chunk`` the call's stream-major (B, n, C) int16 input (n may
    be 0). Rows [0, keep) of dst become rows [consumed, consumed + keep) of
    src (the slide the call before left parked), rows [keep, keep + n) the
    chunk widened to int32 and transposed (lane b*C + c), every later row
    zero. With src and dst the same buffer the kept rows stay where they are
    (``consumed`` must be 0)."""
    b, n, c = chunk.shape
    if not _same_buffer(src, dst):
        dst[:keep] = src[consumed : consumed + keep]
    elif consumed:
        raise ValueError(f"an in-place stage keeps its rows where they are, got {consumed} "
                         f"consumed")
    dst[keep : keep + n] = chunk.to(torch.int32).permute(1, 0, 2).reshape(n, b * c)
    dst[keep + n :] = 0


def farm_stage(src, dst, chunk, *, keep: int, consumed: int) -> None:
    """A farm call's staging, arguments as ``farm_stage_reference``: on a
    CUDA card one launch of farm_stage_kernel (ops/csrc/farm_kernels.cu, on
    the path ``_build.farm_stage_path`` picks), on the CPU the plain
    version."""
    if dst.device.type == "cpu":
        return farm_stage_reference(src, dst, chunk, keep=keep, consumed=consumed)
    b, n, c = chunk.shape
    _build.farm_stage(src, dst, chunk, streams=b, channels=c, n_in=n, keep=keep,
                      consumed=consumed)
    ROUTES[("farm_stage", "cuda")] += 1


def farm_unstage_reference(lanes_out, n_out: int, channels: int, stream_lo: int = 0,
                           streams: Optional[int] = None) -> torch.Tensor:
    """Plain PyTorch version of ``farm_unstage``: streams [stream_lo,
    stream_lo + streams) (by default all from stream_lo on) of the first
    ``n_out`` frames of the launches' lane-major (rows, B*C) output,
    de-interleaved to a contiguous stream-major (streams, n_out, channels)
    tensor of the same dtype."""
    if streams is None:
        streams = lanes_out.shape[1] // channels - stream_lo
    block = lanes_out[:n_out, stream_lo * channels : (stream_lo + streams) * channels]
    return block.reshape(n_out, streams, channels).permute(1, 0, 2).contiguous()


def farm_unstage(lanes_out, n_out: int, channels: int, stream_lo: int = 0,
                 streams: Optional[int] = None, out=None) -> torch.Tensor:
    """A farm call's de-interleave, arguments and return as
    ``farm_unstage_reference``: on a CUDA card one launch of
    farm_unstage_kernel (ops/csrc/farm_kernels.cu), which writes into ``out``
    when given (a contiguous tensor of lanes_out's dtype on its card or in
    pinned host memory; else a new tensor on the card); on the CPU the plain
    version."""
    if streams is None:
        streams = lanes_out.shape[1] // channels - stream_lo
    if lanes_out.device.type == "cpu":
        res = farm_unstage_reference(lanes_out, n_out, channels, stream_lo, streams)
        if out is not None:
            out.view(-1)[: res.numel()] = res.view(-1)
        return res
    if out is None:
        out = torch.empty((streams, n_out, channels), dtype=lanes_out.dtype,
                          device=lanes_out.device)
    _build.farm_unstage(lanes_out, out, n_out=n_out, channels=channels, stream_lo=stream_lo,
                        streams=streams)
    ROUTES[("farm_unstage", "cuda")] += 1
    return out.view(-1)[: streams * n_out * channels].view(streams, n_out, channels)


def farm_host_stage_reference(pinned: int, sources: np.ndarray, row_bytes: int,
                              card: Optional[int]) -> None:
    """Plain version of crt_farm_host_stage (``_build.farm_host_stage_args``)
    on host memory: the rows of ``row_bytes`` bytes at the uint64 addresses
    ``sources`` (0 for a row of zeros) laid end to end at the address
    ``pinned``, then copied on to the address ``card`` (None: nowhere)."""
    for r, src in enumerate(sources.tolist()):
        if src:
            ctypes.memmove(pinned + r * row_bytes, src, row_bytes)
        else:
            ctypes.memset(pinned + r * row_bytes, 0, row_bytes)
    if card:
        ctypes.memmove(card, pinned, len(sources) * row_bytes)


class ResultPool:
    """The pinned host buffers a farm's results come in.

    ``lease`` hands out a numpy array over a pinned buffer, so that the
    download from the card is the last copy of a call; the caller owns the
    array, and no later call writes to it. When the array and every view of
    it are gone the buffer comes back (``weakref.finalize``) and the next
    call reuses it, its pages warm. At most RESULT_POOL_BUFFERS buffers are
    out or waiting at a time, so a caller that keeps every output does not
    pin the host's memory: past that count ``lease`` lends the pool's scratch
    buffer instead, which the farm copies into a fresh array."""

    def __init__(self):
        self._free: list = []
        self._out = 0                 # buffers the callers hold
        self._scratch = None

    @staticmethod
    def _room(nbytes: int) -> int:
        """Emits differ by a frame or two from call to call: leave room."""
        return nbytes + nbytes // 16 + 4096

    def lease(self, shape: tuple, dtype) -> tuple:
        """(array of ``shape`` and ``dtype`` over pinned memory, its address,
        whether the caller may keep it: if not it is the scratch buffer,
        which the next call overwrites)."""
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
        if not nbytes:
            return np.zeros(shape, dtype), 0, True
        fits = [k for k, buf in enumerate(self._free) if buf.numel() >= nbytes]
        if fits:
            buf = self._free.pop(fits[0])
        elif self._out + len(self._free) < RESULT_POOL_BUFFERS or self._free:
            del self._free[:1]        # a buffer too small for this farm's emits now
            buf = _pinned_empty(self._room(nbytes), torch.uint8)
        else:
            if self._scratch is None or self._scratch.numel() < nbytes:
                self._scratch = _pinned_empty(self._room(nbytes), torch.uint8)
            array = self._scratch.numpy()[:nbytes].view(dtype).reshape(shape)
            return array, self._scratch.data_ptr(), False
        owner = (ctypes.c_char * nbytes).from_address(buf.data_ptr())
        weakref.finalize(owner, self._give_back, buf)
        self._out += 1
        return np.frombuffer(owner, dtype).reshape(shape), buf.data_ptr(), True

    def _give_back(self, buf: torch.Tensor) -> None:
        self._out -= 1
        self._free.append(buf)


class FarmProgram:
    """One device's share of a farm as a device program: the lanes of some
    of the farm's streams, staged, launched and de-interleaved there.

    It keeps two (capacity, lanes) int32 staging buffers. ``stage`` appends
    a chunk to the current one in place or, when the emit before left a
    slide parked (``slide``: the rows it consumed), writes the kept rows, the
    chunk and the zero tail into the other one, which becomes current: one
    pass, no copy of the buffer onto itself. ``rows`` is the staged data with
    a parked slide applied, for everything that reads between calls.

    A call's steps: the upload into ``chunk`` (``upload``), the stage, the
    ratio class's launches into one (frames, lanes) output ``lanes_out`` at
    their row offsets, the de-interleave into ``unstaged`` and the download.
    On a card each is a C call whose arguments were checked once -- the farm
    library's host threads and cudaMemcpyAsync, farm_stage_kernel, the
    engine's prebound launches (the last one's padding rows, every other
    launch being whole 8-frame tiles, past the emit's frames and never
    unstaged), farm_unstage_kernel --, and nothing else touches the device
    between the upload and ``wait``. On the CPU each step runs its plain
    version on the same buffers."""

    def __init__(self, tables: DeviceTables, streams: int, channels: int, capacity: int,
                 chunk_frames: int, clamp_s16: bool):
        self.tables, self.device = tables, tables.device
        self.streams, self.channels, self.lanes = streams, channels, streams * channels
        self.out_dtype = torch.int16 if clamp_s16 else torch.int32
        self.buffers = [torch.zeros((capacity, self.lanes), dtype=torch.int32, device=self.device)
                        for _ in range(2)]
        self.current = 0
        self.slide = 0
        self.on_card = _on_card(self.device)
        self.plans: dict = {}         # launch plans -> prebound launches (cleared by adjust)
        self.lanes_out = None         # the launches' (frames, lanes) output, grown to need
        self.unstaged = None          # the de-interleave's destination, as large
        self.chunk = torch.empty(max(self.lanes * chunk_frames, 1), dtype=torch.int16,
                                 device=self.device)
        if self.on_card:
            self._stage_args = _build.farm_stage_args(
                self.buffers[0], self.buffers[1], self.chunk, streams=streams,
                channels=channels, n_in=0, keep=0, consumed=0)
            # (frames, src, dst) -> crt_farm_stage's arguments with their path
            # and tile but the rows: a steady call repeats one key.
            self._stage_calls: dict = {}
            self._calls = {entry: _build.entry_function(entry)
                           for entry in ("crt_farm_stage", "crt_farm_unstage", "crt_farm_copy",
                                         "crt_farm_host_stage", "crt_farm_host_stats",
                                         "crt_farm_sync")}
            # crt_farm_host_stats' (pool_wait_ns, pool_late_ns) of this thread's last job.
            self._host_stats = np.zeros(2, np.int64)
            self._host_stats_ptr = self._host_stats.ctypes.data

    def rows(self) -> torch.Tensor:
        """The staged rows from row 0 on, a parked slide applied (a view)."""
        return self.buffers[self.current][self.slide :]

    def load(self, rows: torch.Tensor) -> None:
        """Make ``rows`` (fill, lanes) the staged rows, nothing parked."""
        buf = self.buffers[self.current]
        buf[: rows.shape[0]] = rows.to(self.device)
        buf[rows.shape[0] :] = 0
        self.slide = 0

    def _call(self, entry: str, args: dict) -> None:
        err = self._calls[entry](*_build.ordered_args(entry, args))
        if err:
            _build.raise_on_launch(err, entry)

    def _stream(self) -> int:
        return _build._stream(self.buffers[0])

    def _copy(self, dst: int, src: int, nbytes: int) -> None:
        """``nbytes`` from the address ``src`` to ``dst``, between the host and
        the program's device: on a card crt_farm_copy on the program's
        stream, on the CPU a memmove."""
        if not self.on_card:
            ctypes.memmove(dst, src, nbytes)
            return
        self._call("crt_farm_copy", dict(dst=dst, src=src, nbytes=nbytes,
                                         device=self.device.index, stream=self._stream()))

    @profiling.spanned("crt.farm.stage.host")
    def upload(self, pinned: int, n: int, sources: Optional[np.ndarray] = None) -> None:
        """Upload this program's (streams, n, channels) int16 block into
        ``chunk`` from the host address ``pinned``: from there as it stands,
        or, given ``sources`` (the uint64 host addresses of the equal rows the
        block is made of, 0 for a row of zeros), after those rows have been
        copied there (crt_farm_host_stage: on a card the farm library's host
        threads, each piece going up as it lands, and while the recorder is
        on its pool's counters go to the call's row)."""
        nbytes = 2 * n * self.lanes
        if sources is None:
            self._copy(self.chunk.data_ptr(), pinned, nbytes)
            return
        args = (pinned, sources, nbytes // len(sources), self.chunk.data_ptr())
        if not self.on_card:
            farm_host_stage_reference(*args)
            return
        self._call("crt_farm_host_stage", _build.farm_host_stage_args(
            *args, self.device.index, self._stream()))
        if profiling.tracing():
            self._calls["crt_farm_host_stats"](self._host_stats_ptr)
            profiling.count("pool_wait_ns", int(self._host_stats[0]))
            profiling.count("pool_late_ns", int(self._host_stats[1]))

    def host_copy(self, dst: np.ndarray, src: np.ndarray) -> None:
        """dst[...] = src (C-contiguous arrays of one size in host memory) by
        the farm library's host threads (crt_farm_host_stage with no card
        address: the copy alone; on a card)."""
        sources = np.array([src.ctypes.data], np.uint64)
        self._call("crt_farm_host_stage", _build.farm_host_stage_args(
            dst.ctypes.data, sources, src.nbytes, None, self.device.index, self._stream()))

    def stage(self, chunk: int, n: int, fill: int, sources: Optional[np.ndarray] = None) -> None:
        """Stage ``n`` frames at row ``fill`` with the parked slide, and zero
        the rows after them. ``chunk`` is the host address of this program's
        streams' (streams, n, channels) int16 block, uploaded here with
        ``sources`` (``upload``)."""
        src = self.buffers[self.current]
        if self.slide:
            self.current ^= 1
        dst = self.buffers[self.current]
        if n:
            self.upload(chunk, n, sources)
        if not self.on_card:
            farm_stage_reference(src, dst, self.chunk[: n * self.lanes].view(
                self.streams, n, self.channels), keep=fill, consumed=self.slide)
        else:
            with profiling.span("crt.farm.stage.kernel"):
                key = (n, src.data_ptr(), dst.data_ptr())
                args = self._stage_calls.get(key)
                if args is None:
                    if len(self._stage_calls) >= 8:
                        self._stage_calls.clear()
                    args = self._stage_calls[key] = _build.farm_stage_call_args(
                        self._stage_args, n_in=n, keep=0, consumed=0, src=key[1], dst=key[2])
                    profiling.count("plans_built", 1)
                self._call("crt_farm_stage", dict(args, keep=fill, consumed=self.slide,
                                                  stream=self._stream()))
            ROUTES[("farm_stage", "cuda")] += 1
        self.slide = 0

    def _plan(self, specs: tuple) -> list:
        """The prebound launches of ``specs`` (UniformStreamFarm._launch_specs)
        into ``lanes_out``: [(C entry, its function, its arguments by name)],
        checked once; a call replaces x, p0, f0 and the stream."""
        states, plans, tstrs, tiles = specs
        key = tuple(plans)
        launches = self.plans.get(key)
        if launches is not None:
            return launches
        launches, done = [], 0
        row_bytes = self.lanes * self.lanes_out.element_size()
        for state, (kind, d, cand, taps, n_pad, clamp), tstr, tile in zip(
                states, plans, tstrs, tiles):
            scratch = None
            if kind == "wide":
                scratch = _build.wide_scratch(taps, n_pad, self.lanes, self.device)
            entry, args = entry_launch_args(
                kind, self.tables.table, self.buffers[0], state, d=d, cand=cand, max_taps=taps,
                n_out=n_pad, table_strided=tstr, partial=scratch)
            args.update(out=self.lanes_out.data_ptr() + done * row_bytes, rows_out=None,
                        clamp_s16=int(clamp), n_valid=None, frame_offset=0)
            # What the launch reads by pointer stays referenced beside it.
            launches.append((entry, _build.entry_function(entry), args, kind,
                             (scratch, tstr, state.cfg)))
            done += tile
        self.plans[key] = launches
        profiling.count("plans_built", 1)
        return launches

    def launch(self, specs: tuple) -> None:
        """Write the frames of the launches of ``specs`` over the current
        buffer into ``lanes_out``, each launch's at the row where the frames
        before it end: on a card the prebound launches, on the CPU the
        engines' plain versions (``multi_resample``), their real frames."""
        states, plans, tstrs, tiles = specs
        rows = sum(tiles[:-1]) + plans[-1][4]
        if self.lanes_out is None or self.lanes_out.shape[0] < rows:
            self.plans.clear()        # they write into the old output
            self.lanes_out = torch.empty((rows, self.lanes), dtype=self.out_dtype,
                                         device=self.device)
            self.unstaged = torch.empty_like(self.lanes_out)
        x = self.buffers[self.current]
        if not self.on_card:
            outs = multi_resample(self.tables.table, (x,) * len(plans), tuple(states),
                                  tuple(plans), tstrs=tstrs)
            torch.cat([out[:tile] for out, tile in zip(outs, tiles)],
                      out=self.lanes_out[: sum(tiles)])
            return
        x, stream = x.data_ptr(), self._stream()
        for (entry, fn, args, kind, _), state in zip(self._plan(specs), states):
            err = fn(*_build.ordered_args(entry, dict(
                args, x=x, p0_val=state.position_integer, f0_val=state.position_fractional,
                stream=stream)))
            if err:
                _build.raise_on_launch(err, entry)
            ROUTES[(kind, "cuda")] += 1

    def unstage(self, n_out: int, host: int) -> None:
        """De-interleave the first ``n_out`` frames of ``lanes_out`` to
        (streams, n_out, channels) in ``unstaged`` (on a card
        farm_unstage_kernel, on the CPU farm_unstage_reference) and download
        them to the host address ``host`` (pinned on a card)."""
        numel = self.streams * n_out * self.channels
        if not self.on_card:
            self.unstaged.view(-1)[:numel] = farm_unstage_reference(
                self.lanes_out, n_out, self.channels).view(-1)
        else:
            self._call("crt_farm_unstage", _build.farm_unstage_args(
                self.lanes_out, self.unstaged.data_ptr(), n_out=n_out, channels=self.channels,
                stream_lo=0, streams=self.streams))
            ROUTES[("farm_unstage", "cuda")] += 1
        self._copy(host, self.unstaged.data_ptr(), numel * self.unstaged.element_size())

    def wait(self) -> None:
        """Block until the card has done everything this program issued on
        the current stream (nothing to wait for on the CPU)."""
        if self.on_card:
            self._call("crt_farm_sync", dict(device=self.device.index, stream=self._stream()))


class UniformStreamFarm:
    """B same-ratio streams, chunked, bit-exact.

    Feed chunks of at most ``chunk_frames`` frames with :meth:`process`;
    finish with :meth:`flush`. Outputs are wide int32 frames per stream (int16
    with ``clamp_s16``), exactly the reference's per-stream results for the
    concatenated input. The staging, the launches and the de-interleave run
    on ``device``, kept by a ``FarmProgram``: on a card its kernels, on the
    CPU their plain versions. Each returned array is the caller's: no later
    call writes to it.

    A call has three seams: ``_stage`` (the chunk through the input buffer
    to the device and the stage), ``_launch`` (the ratio class's launches)
    and ``_to_host`` (the de-interleave and the download). The programs
    (``_programs``: (shard, first stream, end stream, FarmProgram), here one
    for all streams) are set up by ``_alloc`` and issued under
    ``_as_shard``; parallel.ShardedStreamFarm overrides those two and
    ``_take_stream`` to keep one program per shard of a mesh. The phase
    bookkeeping and the launch routing (``_launch_specs``) are shared.
    """

    def __init__(
        self,
        n_streams: int,
        channels: int,
        input_rate: int,
        output_rate: int,
        low_pass_rate: Optional[int] = None,
        chunk_frames: int = 4096,
        model: KernelModel = DEFAULT_MODEL,
        max_radius: Optional[int] = None,
        device: Device = DEFAULT_DEVICE,
        clamp_s16: bool = False,
    ):
        low_pass_rate = low_pass_rate if low_pass_rate is not None else max(input_rate, output_rate)
        cfg = configure(input_rate, output_rate, low_pass_rate,
                        radius=model.radius, resolution=model.resolution)
        if cfg is None:
            raise ValueError("unsupported ratio (kernel scale >= 0x1000)")
        self._setup(n_streams, channels, cfg, fx.calculate_ratio(input_rate, output_rate),
                    chunk_frames=chunk_frames, model=model,
                    radius_bound=max(cfg.integer_stretched_kernel_radius, max_radius or 0),
                    device=device, clamp_s16=clamp_s16)

    def _setup(self, n_streams: int, channels: int, cfg: Configuration, increment: int, *,
               chunk_frames: int, model: KernelModel, radius_bound: int,
               device: Device, clamp_s16: bool) -> None:
        """A farm at stream position 0 with an empty staging buffer (also
        the first half of a restore, checkpoint.load_farm)."""
        self.n_streams = n_streams
        self.channels = channels
        self.chunk_frames = chunk_frames
        self.model = model
        self.clamp_s16 = clamp_s16  # emit clamped int16 (halves the device-to-host copy)

        self._lanes = n_streams * channels
        self._max_taps = fx.round_up(2 * radius_bound, 8)
        self._radius_bound = radius_bound
        # Staging buffer: [left halo | data ... | slack]. Logical stream frame
        # f lives at row f + radius_bound. Every launch reads max_taps-or-
        # fewer rows from each window start, and a real frame's window starts
        # below the fill, so max_taps rows of slack keep every real read
        # inside the buffer; padding frames' starts are clamped by the launch
        # (ops.resample.launch_rows). The capacity depends on the radius
        # bound and chunk size only, not on the ratio.
        self._capacity = 2 * radius_bound + chunk_frames + self._max_taps
        self._alloc(device)
        self._fill = radius_bound      # rows of valid data (left zero halo)

        # Host streaming state (exact Python ints).
        self.position_integer = 0
        self.position_fractional = 0
        self._set_config(cfg, increment)
        # The ratio the JAX farm sizes its staging by: the one it was built
        # for, kept through adjust, and a source group's for the solo farm of
        # adjust_stream (checkpoint.jax_capacity).
        self._capacity_increment = increment

    def _alloc(self, device: Device) -> None:
        """The device and one FarmProgram for all streams, with the device's
        constants (DeviceTables), its staging zeroed."""
        self.device = resolve_device(device)
        tables = DeviceTables(self.model, self.device)
        self._programs = [(0, 0, self.n_streams, self._new_program(tables, self.n_streams))]
        self._alloc_host()

    def _new_program(self, tables: DeviceTables, streams: int) -> FarmProgram:
        return FarmProgram(tables, streams, self.channels, self._capacity, self.chunk_frames,
                           self.clamp_s16)

    def _alloc_host(self) -> None:
        """The host ends of a call: the input buffer of the largest chunk and,
        on a card, where it is pinned, the pool the results come from."""
        self._on_card = _on_card(self.device)
        numel = max(self._lanes * self.chunk_frames, 1)
        if self._on_card:
            self._input = _pinned_empty(numel, torch.int16)
            self._results = ResultPool()
        else:
            self._input = torch.empty(numel, dtype=torch.int16)
        self._input_array = self._input.numpy()

    @contextlib.contextmanager
    def _as_shard(self, shard: int):
        """Issue the body as the work of ``shard`` (here: as it stands)."""
        yield

    @property
    def _staging(self) -> torch.Tensor:
        """The staged rows from row 0 on: the program's current buffer with a
        parked slide applied (a view)."""
        return self._programs[0][3].rows()

    # ------------------------------------------------------------------
    def _set_config(self, cfg: Configuration, increment: int) -> None:
        self.config = cfg
        self.increment = increment
        for *_, program in self._programs:     # a device's programs share its tables
            program.tables.configure(cfg, increment)
            program.plans.clear()      # they point at the old scalars

    def adjust(self, input_rate: int, output_rate: int, low_pass_rate: Optional[int] = None) -> bool:
        """Mid-stream ratio change (pitch bend); position carries over.

        Like HighLevel_Adjust (clownresampler.h:1183-1209), the radius may not
        grow past the construction-time bound (pass max_radius to reserve)."""
        low_pass_rate = low_pass_rate if low_pass_rate is not None else max(input_rate, output_rate)
        cfg = configure(input_rate, output_rate, low_pass_rate,
                        radius=self.model.radius, resolution=self.model.resolution)
        if cfg is None or cfg.integer_stretched_kernel_radius > self._radius_bound:
            return False
        self._set_config(cfg, fx.calculate_ratio(input_rate, output_rate))
        return True

    # ------------------------------------------------------------------
    def _natural_count(self, total_frames: int) -> int:
        num = ((total_frames - self.position_integer) << 16) - self.position_fractional
        return 0 if num <= 0 else -(-num // self.increment)

    def _program(self, shard: int) -> FarmProgram:
        return next(program for i, _, _, program in self._programs if i == shard)

    def _launch_specs(self, n_out: int, shard: int = 0) -> tuple:
        """(states, plans, tstrs, tiles): the ``multi_resample`` launches
        producing frames [0, n_out) of every lane of ``shard`` (a sharded
        farm's; this farm is its own one shard) from its program's current
        buffer, and each launch's real frame count.

        Routed by ``lowlevel.launch_kind`` and tiled into launches of at most
        MAX_LAUNCH_OUTPUT_FRAMES frames (wide_launch_frames for the wide
        class) with p0/f0 advanced in exact Python ints between them.
        Launches run at the CURRENT ratio's tap width (surplus taps of a
        wider reserve are masked, so any width >= the current class is
        bit-exact). The routing does not depend on the shard: only the
        strided table and the scalars are its device's."""
        taps = min(self._max_taps,
                   fx.round_up(2 * self.config.integer_stretched_kernel_radius, 8))
        kind, d, cand = launch_kind(self.increment, taps)
        step = MAX_LAUNCH_OUTPUT_FRAMES
        if kind == "wide":
            step = min(step, wide_launch_frames(taps))
        tables = self._program(shard).tables
        tstr = None
        if kind != "strided":
            tstr = tables.strided_table(self.config.kernel_step_size, taps)
        # The staging buffer keeps a fixed radius_bound-row left halo; the C
        # window contract (clownresampler.h:725-733) puts the buffer origin
        # only `radius` rows before the data, so shift positions by the
        # difference when the current radius is narrower than the bound.
        halo_shift = self._radius_bound - self.config.integer_stretched_kernel_radius

        states, plans, tiles = [], [], []
        done = 0
        while done < n_out:
            tile = min(n_out - done, step)
            t = self.position_fractional + done * self.increment
            p0 = self.position_integer + (t >> 16) + halo_shift
            states.append(DeviceState(p0, t & 0xFFFF, tables.scalars))
            plans.append((kind, d, cand, taps, fx.round_up(tile, 8), self.clamp_s16))
            tiles.append(tile)
            done += tile
        n = len(plans)
        return states, plans, (tstr,) * n, tiles

    def _launch_shard(self, n_out: int, shard: int = 0) -> torch.Tensor:
        """Frames [0, n_out) of every lane of ``shard`` into its program's
        ``lanes_out``, which it returns."""
        program = self._program(shard)
        program.launch(self._launch_specs(n_out, shard))
        return program.lanes_out

    @profiling.spanned("crt.farm.launch")
    def _launch(self, n_out: int) -> list:
        """Frames [0, n_out) of every lane, as ``_to_host`` takes them: each
        program's ``lanes_out``, in ``_programs``' order."""
        outs = []
        for shard, _, _, _ in self._programs:
            with self._as_shard(shard):
                outs.append(self._launch_shard(n_out, shard))
        return outs

    @profiling.spanned("crt.farm.to_host")
    def _to_host(self, lanes_out: list, n_out: int) -> np.ndarray:
        """A host array the caller owns, holding the launched lanes (each
        program's ``lanes_out``) de-interleaved to (B, n_out, C), shard i's
        streams in result[lo:hi].

        Each program de-interleaves its block and downloads it straight into
        the result, on its shard's stream; the host then waits for the shards
        in order. On a card the result is a pinned buffer leased from the
        farm's ``ResultPool``, so no fresh page is touched once the pool is
        warm, unless the caller holds every buffer of the pool: then the
        download goes through the pool's scratch buffer, and the farm
        library's host threads copy it into a fresh array (no torch op, whose
        threads would spin on beside the next call's host copy)."""
        shape = (self.n_streams, n_out, self.channels)
        dtype = np.int16 if self.clamp_s16 else np.int32
        with profiling.span("crt.farm.to_host.issue"):
            if self._on_card:
                result, address, owned = self._results.lease(shape, dtype)
            else:
                result = np.empty(shape, dtype)
                address, owned = result.ctypes.data, True
            stream_bytes = n_out * self.channels * result.itemsize
            for shard, lo, _, program in self._programs:
                with self._as_shard(shard):
                    program.unstage(n_out, address + lo * stream_bytes)
        with profiling.span("crt.farm.to_host.wait"):
            for shard, _, _, program in self._programs:
                with self._as_shard(shard):
                    program.wait()
        if not owned:             # the caller holds every pooled buffer
            scratch, result = result, np.empty(shape, dtype)
            self._programs[0][3].host_copy(result, scratch)
        return result

    def _emit(self, total_frames: int) -> np.ndarray:
        """Produce every frame available against `total_frames` of data."""
        n_out = self._natural_count(total_frames)
        lanes_out = self._launch(n_out) if n_out > 0 else None
        return self._finish_emit(total_frames, n_out, lanes_out)

    def _finish_emit(self, total_frames: int, n_out: int, lanes_out) -> np.ndarray:
        """De-interleave the launched lanes (what ``_launch`` returned) to
        (B, n_out, C) on the host, advance the phase and slide the staging
        window (LowLevel position carry, clownresampler.h:1063-1068). Split
        from _emit so that MixedStreamFarm can run every group's launches in
        one call between the two halves."""
        if n_out > 0:
            result = self._to_host(lanes_out, n_out)
        else:
            out_dtype = np.int16 if self.clamp_s16 else np.int32
            result = np.zeros((self.n_streams, 0, self.channels), out_dtype)

        t = self.position_fractional + n_out * self.increment
        self.position_integer += t >> 16
        self.position_fractional = t & 0xFFFF
        consumed = min(self.position_integer, total_frames)
        self.position_integer -= consumed
        # Slide out consumed frames; retain everything after them (incl. halo):
        # staging[r] = staging[r + consumed] for r < keep, zeros from there.
        # Each program parks the slide, and its next stage does it.
        if consumed:
            for *_, program in self._programs:
                program.slide = consumed
        self._fill -= consumed
        return result

    def _write_rows(self, chunk: np.ndarray) -> None:
        """Stage the (B, n, C) chunk lane-major at rows [fill, fill + n),
        converted as ``np.ascontiguousarray(chunk, dtype=np.int16)`` converts
        it. Once the devices have taken the chunk before, a C-contiguous
        int16 chunk goes straight from the caller's memory through the input
        buffer to the devices (on a card by the farm library's host threads,
        piece by piece; route ``("farm_input", "direct")``); any other is
        converted into the input buffer and uploaded from there
        (``("farm_input", "converted")``); then each program stages its
        streams' block."""
        b, n, c = chunk.shape
        self._wait_programs()
        if chunk.dtype == np.int16 and chunk.flags.c_contiguous:
            ROUTES[("farm_input", "direct")] += 1
            with profiling.span("crt.farm.stage.rows"):
                base, stream_bytes = chunk.ctypes.data, 2 * n * c
                sources = [np.array([base + lo * stream_bytes], np.uint64)
                           for _, lo, _, _ in self._programs]
            self._upload(n, sources)
        else:
            with profiling.span("crt.farm.stage.rows"):
                np.copyto(self._input_array[: b * n * c].reshape(b, n, c), chunk,
                          casting="unsafe")
            ROUTES[("farm_input", "converted")] += 1
            self._upload(n)

    @profiling.spanned("crt.farm.stage.wait")
    def _wait_programs(self) -> None:
        """Wait for every program: the card is done with the pinned input."""
        for shard, _, _, program in self._programs:
            with self._as_shard(shard):
                program.wait()

    def _upload(self, n: int, sources=None) -> None:
        """Each program uploads its streams' block of the (B, n, C) chunk from
        its place in the input buffer, with ``sources[k]`` (for the k-th of
        ``_programs``, streams [lo, hi): the uint64 addresses of the rows that
        make them up, 0 for zeros) copied there first, and stages it at the
        fill (with n = 0 nothing is uploaded, and the stage zeroes every row
        from the fill on)."""
        stream_bytes = 2 * n * self.channels
        for k, (shard, lo, hi, program) in enumerate(self._programs):
            with self._as_shard(shard):
                program.stage(self._input.data_ptr() + lo * stream_bytes, n, self._fill,
                              None if sources is None else sources[k])

    def _staged_rows(self) -> np.ndarray:
        """Rows [0, fill) of the staging as a host (fill, lanes) int32 array,
        any parked slide applied (what a snapshot keeps)."""
        parts = []
        for shard, _, _, program in self._programs:
            with self._as_shard(shard):
                parts.append(program.rows()[: self._fill].cpu().numpy())
        return np.concatenate(parts, axis=1)

    def _load_rows(self, rows: np.ndarray) -> None:
        """Restore rows [0, len(rows)) of the staging from a host (fill,
        lanes) int32 array, zero the rest and set the fill."""
        fill, c = rows.shape[0], self.channels
        for shard, lo, hi, program in self._programs:
            with self._as_shard(shard):
                program.load(torch.from_numpy(np.ascontiguousarray(rows[:, lo * c : hi * c])))
        self._fill = fill

    def _take_stream(self, source: "UniformStreamFarm", j: int) -> None:
        """Copy the staged lanes of stream ``j`` of ``source`` (a farm of the
        same staging geometry and placement) into this new one-stream farm,
        with the source's parked slide applied: this farm has none parked."""
        lo = j * self.channels
        lanes = source._staging[:, lo : lo + self.channels]
        self._staging[: lanes.shape[0]] = lanes

    def _check_chunk(self, shape: tuple) -> None:
        b, n, c = shape
        if b != self.n_streams or c != self.channels or n > self.chunk_frames:
            raise ValueError(f"chunk of shape {shape} does not match the farm "
                             f"({self.n_streams}, <= {self.chunk_frames}, {self.channels})")
        if self._fill + n > self._capacity:
            raise ValueError("staging overflow: feed chunks of at most chunk_frames")

    @profiling.spanned("crt.farm.stage")
    def _stage(self, chunk: np.ndarray) -> int:
        """Stage one (B, n, C) int16 chunk; returns the consumable frame count
        (the last `radius_bound` data rows stay held back until more data or
        flush arrives -- the high-level buffer's early `input_buffer_end`,
        clownresampler.h:1154)."""
        chunk = np.asarray(chunk)
        self._check_chunk(chunk.shape)
        self._write_rows(chunk)
        self._fill += chunk.shape[1]
        return self._fill - 2 * self._radius_bound

    def _check_streams(self, rows: list, n: int) -> None:
        """Refuse ``rows`` (``_stage_streams``) unless each is an (n, C)
        chunk and together they fit the farm."""
        shape = (n, self.channels)
        for r in rows:
            if r is not None and r.shape != shape:
                raise ValueError(f"a stream's chunk of shape {r.shape} among chunks of "
                                 f"shape {shape}")
        self._check_chunk((len(rows), *shape))

    @profiling.spanned("crt.farm.stage")
    def _stage_streams(self, rows: list, n: int) -> int:
        """``_stage`` of the chunk whose stream j is ``rows[j]``, an (n, C)
        int16 array, or zeros where it is None (MixedStreamFarm's slots): the
        rows go straight into the input buffer, one pass (on a card by the
        farm library's host threads, piece by piece, each piece going up as it
        lands; route ``("farm_input", "stacked")``). The caller has checked
        them (``_check_streams``)."""
        self._wait_programs()
        with profiling.span("crt.farm.stage.rows"):
            rows = [None if r is None else np.ascontiguousarray(r) for r in rows]
            addresses = np.array([0 if r is None else r.ctypes.data for r in rows], np.uint64)
            sources = [addresses[lo:hi] for _, lo, hi, _ in self._programs]
        ROUTES[("farm_input", "stacked")] += 1
        self._upload(n, sources)
        self._fill += n
        return self._fill - 2 * self._radius_bound

    @profiling.spanned("crt.farm.call")
    def process(self, chunk: np.ndarray) -> np.ndarray:
        """Feed (n_streams, n, channels) int16; returns (n_streams, m, channels)
        output frames (m varies with phase, ~n*out_rate/in_rate)."""
        return self._emit(max(self._stage(chunk), 0))

    def flush(self) -> np.ndarray:
        """Feed `radius_bound` zero frames and drain (ResampleEnd, 1242-1250)."""
        self._upload(0)               # the stage of no frames zeroes the rows from the fill on
        self._fill += self._radius_bound
        return self._emit(max(self._fill - 2 * self._radius_bound, 0))


class MixedStreamFarm:
    """Streams at mixed ratios, grouped per ratio into uniform farms.

    Streams share nothing, so a mixed fleet decomposes exactly into one
    UniformStreamFarm per distinct (input, output, low-pass) rate triple,
    and every group's launches for a chunk are issued together between the
    groups' staging and their copies out, each with its own class's kernel (the repo's config 5: 48k->44.1k,
    44.1k->48k and 8k->48k on the tiled kernel, 96k->48k on the strided
    kernel).

    ``specs`` is a list of per-stream (input_rate, output_rate[, lpf])
    tuples. ``process`` takes and returns per-stream lists (outputs differ
    in length per ratio). Per-stream re-rating is :meth:`adjust_stream` (the
    re-rated stream splits into its own phase-carrying group); re-rating a
    whole group is its farm's ``adjust``. ``max_radius`` reserves tap-window
    capacity in every group, so that a stream may later move to a wider
    ratio. The groups run on ``device``.
    """

    def __init__(self, specs, channels: int, chunk_frames: int = 4096,
                 model: KernelModel = DEFAULT_MODEL, max_radius: Optional[int] = None,
                 clamp_s16: bool = False, device: Device = DEFAULT_DEVICE):
        self.channels = channels
        self.n_streams = len(specs)
        self.chunk_frames = chunk_frames
        self.model = model
        self.clamp_s16 = clamp_s16
        self.device = resolve_device(device)
        self.max_radius = max_radius
        # [(farm, members)]: members[j] is the stream in the farm's slot j, or
        # None for a slot vacated by adjust_stream (fed zeros, output
        # dropped). Groups are told apart by position, not ratio: a re-rated
        # stream carries its own phase, so two groups may share a ratio.
        by_key: dict = {}
        for i, spec in enumerate(specs):
            key = (spec[0], spec[1], spec[2] if len(spec) > 2 else max(spec[0], spec[1]))
            by_key.setdefault(key, []).append(i)
        self._groups: list = [[self._make_group_farm(len(members), key, max_radius=max_radius),
                               members] for key, members in by_key.items()]

    def _make_group_farm(self, n_streams: int, rates: tuple,
                         max_radius: Optional[int] = None) -> UniformStreamFarm:
        return UniformStreamFarm(
            n_streams, self.channels, *rates, chunk_frames=self.chunk_frames,
            model=self.model, max_radius=max_radius, device=self.device,
            clamp_s16=self.clamp_s16)

    def adjust_stream(self, i: int, input_rate: int, output_rate: int,
                      low_pass_rate: Optional[int] = None) -> bool:
        """Re-rate ONE stream mid-stream (the reference's per-stream Adjust,
        clownresampler.h:1052-1056): position carries over, only the
        increment/stretching change; every other stream is untouched.

        The stream's phase is its own after an adjust, so it leaves its
        group: a single-stream farm with the source farm's staging geometry
        takes over its phase and its staged lanes (copied on the farm's
        device), and its old slot is retired. Later adjusts of the stream
        are in place on that farm. Fails (returns False, nothing changes) if
        the new ratio is unsupported or its radius exceeds the group's
        reserved bound, like HighLevel_Adjust (clownresampler.h:1183-1209).
        """
        low_pass_rate = (low_pass_rate if low_pass_rate is not None
                         else max(input_rate, output_rate))
        for group in self._groups:
            farm, members = group
            if i in members:
                break
        else:
            raise IndexError(f"no stream {i}")
        if sum(1 for m in members if m is not None) == 1:
            return farm.adjust(input_rate, output_rate, low_pass_rate)
        # Validate before any surgery, so that a refusal changes nothing.
        cfg = configure(input_rate, output_rate, low_pass_rate,
                        radius=farm.model.radius, resolution=farm.model.resolution)
        if cfg is None or cfg.integer_stretched_kernel_radius > farm._radius_bound:
            return False
        solo = self._make_group_farm(1, (input_rate, output_rate, low_pass_rate),
                                     max_radius=farm._radius_bound)
        # Same radius bound and chunk size, so the same staging geometry.
        assert solo._capacity == farm._capacity
        solo._capacity_increment = farm._capacity_increment
        solo.position_integer = farm.position_integer
        solo.position_fractional = farm.position_fractional
        solo._fill = farm._fill
        j = members.index(i)
        solo._take_stream(farm, j)
        members[j] = None
        self._groups.append([solo, [i]])
        return True

    def _distribute(self, outputs: list, members: list, out: np.ndarray) -> None:
        for j, i in enumerate(members):
            if i is not None:
                outputs[i] = out[j]

    @profiling.spanned("crt.farm.launch")
    def _launch_groups(self, farms: list) -> list:
        """Each of ``farms`` (farm, n_out)'s launched lanes, as its
        ``_launch`` returns them: every group's launches of the chunk, one
        group after the other (on a card prebound C calls, nothing between
        them)."""
        return [farm._launch(n_out) for farm, n_out in farms]

    @profiling.spanned("crt.farm.call")
    def process(self, chunks: list) -> list:
        """chunks[i]: (n, channels) int16 for stream i (the same n for every
        stream). Returns outputs[i]: (m_i, channels) int32 (int16 with
        ``clamp_s16``); m_i varies with the stream's ratio and phase. Each
        chunk is converted as ``np.asarray(chunk, np.int16)`` converts it; on
        a card a group's streams go straight into its pinned input."""
        n = np.asarray(chunks[0]).shape[0]
        groups = [(farm, members, [None if i is None else np.asarray(chunks[i], np.int16)
                                   for i in members]) for farm, members in self._groups]
        for farm, _, rows in groups:       # refuse a bad chunk before any group stages
            farm._check_streams(rows, n)
        pending = []   # (farm, members, total, n_out)
        for farm, members, rows in groups:
            total = max(farm._stage_streams(rows, n), 0)
            pending.append((farm, members, total, farm._natural_count(total)))
        launched = iter(self._launch_groups([(farm, n_out) for farm, _, _, n_out in pending
                                             if n_out > 0]))

        outputs: list = [None] * self.n_streams
        for farm, members, total, n_out in pending:
            lanes_out = next(launched) if n_out > 0 else None
            self._distribute(outputs, members, farm._finish_emit(total, n_out, lanes_out))
        return outputs

    def flush(self) -> list:
        """Drain every group (ResampleEnd, clownresampler.h:1242-1250)."""
        outputs: list = [None] * self.n_streams
        for farm, members in self._groups:
            self._distribute(outputs, members, farm.flush())
        return outputs
