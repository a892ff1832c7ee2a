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
(input, output, low-pass) rate triple and runs every group's launches of a
chunk in one ``multi_resample`` call.

Bit-exactness: each stream's output is identical to running the reference
(and LowLevelResampler) on that stream alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.configure import Configuration, configure
from clownresampler_tpu_torch.device import DEFAULT_DEVICE, Device, resolve_device
from clownresampler_tpu_torch.lowlevel import DeviceState, launch_kind
from clownresampler_tpu_torch.models import DEFAULT_MODEL, KernelModel, table_tensor
from clownresampler_tpu_torch.ops.convolve import ConfigScalars
from clownresampler_tpu_torch.ops.resample import multi_resample, wide_launch_frames
from clownresampler_tpu_torch.utils import native

# Max output frames per launch: device positions come from
# fx.positions_from_state, int32-exact while f0 + n*inc_lo < 2^31.
MAX_LAUNCH_OUTPUT_FRAMES = 1 << 14


class UniformStreamFarm:
    """B same-ratio streams, chunked, bit-exact.

    Feed chunks of at most ``chunk_frames`` frames with :meth:`process`;
    finish with :meth:`flush`. Outputs are wide int32 frames per stream (int16
    with ``clamp_s16``), exactly the reference's per-stream results for the
    concatenated input. The launches run on ``device``; the staging buffer
    lives there too (``device_staging``, the default on CUDA) or in host
    memory, staged by the native engine and uploaded per launch.
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
        device_staging: Optional[bool] = None,
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
                    device=device, device_staging=device_staging, clamp_s16=clamp_s16)

    def _setup(self, n_streams: int, channels: int, cfg: Configuration, increment: int, *,
               chunk_frames: int, model: KernelModel, radius_bound: int,
               device: Device, device_staging: Optional[bool],
               clamp_s16: bool) -> None:
        """A farm at stream position 0 with an empty staging buffer (also
        the first half of a restore, checkpoint.load_farm)."""
        self.n_streams = n_streams
        self.channels = channels
        self.chunk_frames = chunk_frames
        self.model = model
        self.device = resolve_device(device)
        self.clamp_s16 = clamp_s16  # emit clamped int16 (halves the device-to-host copy)
        self._table = table_tensor(model.table(), self.device)
        self._tables: dict = {}    # (step, taps) -> strided table tensor

        self._lanes = n_streams * channels
        self._max_taps = fx.round_up(2 * radius_bound, 8)
        self._radius_bound = radius_bound

        # Host streaming state (exact Python ints).
        self.position_integer = 0
        self.position_fractional = 0
        self._set_config(cfg, increment)
        # The ratio the JAX farm sizes its staging by: the one it was built
        # for, kept through adjust, and a source group's for the solo farm of
        # adjust_stream (checkpoint.jax_capacity).
        self._capacity_increment = increment

        # Staging buffer: [left halo | data ... | slack]. Logical stream frame
        # f lives at row f + radius_bound. Every launch reads max_taps-or-
        # fewer rows from each window start, and a real frame's window starts
        # below the fill, so max_taps rows of slack keep every real read
        # inside the buffer; padding frames' starts are clamped by the launch
        # (ops.resample.launch_rows). The capacity depends on the radius
        # bound and chunk size only, not on the ratio.
        self._capacity = 2 * radius_bound + chunk_frames + self._max_taps

        if device_staging is None:
            device_staging = self.device.type == "cuda"
        self._device_staging = device_staging
        if device_staging:
            self._staging = torch.zeros((self._capacity, self._lanes), dtype=torch.int32,
                                        device=self.device)
        else:
            self._staging = np.zeros((self._capacity, self._lanes), np.int32)
        self._fill = radius_bound      # rows of valid data (left zero halo)
        self._pinned = None            # host copy buffer for CUDA output (_to_host)

    # ------------------------------------------------------------------
    def _set_config(self, cfg: Configuration, increment: int) -> None:
        self.config = cfg
        self.increment = increment
        self._scalars = ConfigScalars.from_configuration(cfg, increment, self.device)

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

    def _launch_specs(self, n_out: int) -> tuple:
        """(xs, states, plans, tstrs, tiles): the ``multi_resample`` launches
        producing frames [0, n_out) of every lane, and each launch's real
        frame count.

        Routed by ``lowlevel.launch_kind`` and tiled into launches of at most
        MAX_LAUNCH_OUTPUT_FRAMES frames (wide_launch_frames for the wide
        class) with p0/f0 advanced in exact Python ints between them.
        Launches run at the CURRENT ratio's tap width (surplus taps of a
        wider reserve are masked, so any width >= the current class is
        bit-exact)."""
        taps = min(self._max_taps,
                   fx.round_up(2 * self.config.integer_stretched_kernel_radius, 8))
        kind, d, cand = launch_kind(self.increment, taps)
        step = MAX_LAUNCH_OUTPUT_FRAMES
        if kind == "wide":
            step = min(step, wide_launch_frames(taps))
        tstr = None
        if kind != "strided":
            key = (self.config.kernel_step_size, taps)
            tstr = self._tables.get(key)
            if tstr is None:
                tstr = self._tables[key] = table_tensor(
                    self.model.strided_table(*key), self.device)
        # The staging buffer keeps a fixed radius_bound-row left halo; the C
        # window contract (clownresampler.h:725-733) puts the buffer origin
        # only `radius` rows before the data, so shift positions by the
        # difference when the current radius is narrower than the bound.
        halo_shift = self._radius_bound - self.config.integer_stretched_kernel_radius
        x = (self._staging if self._device_staging
             else torch.from_numpy(self._staging).to(self.device))

        states, plans, tiles = [], [], []
        done = 0
        while done < n_out:
            tile = min(n_out - done, step)
            t = self.position_fractional + done * self.increment
            p0 = self.position_integer + (t >> 16) + halo_shift
            states.append(DeviceState(p0, t & 0xFFFF, self._scalars))
            plans.append((kind, d, cand, taps, fx.round_up(tile, 8), self.clamp_s16))
            tiles.append(tile)
            done += tile
        n = len(plans)
        return (x,) * n, states, plans, (tstr,) * n, tiles

    @staticmethod
    def _join(outs, tiles) -> torch.Tensor:
        """The launches' real frames, in order: (sum(tiles), lanes)."""
        return torch.cat([o[:tile] for o, tile in zip(outs, tiles)])

    def _launch(self, n_out: int) -> torch.Tensor:
        """Frames [0, n_out) of every lane, (n_out, lanes) on the device."""
        xs, states, plans, tstrs, tiles = self._launch_specs(n_out)
        outs = multi_resample(self._table, xs, tuple(states), tuple(plans), tstrs=tstrs)
        return self._join(outs, tiles)

    def _to_host(self, out: torch.Tensor) -> np.ndarray:
        """A fresh host array holding ``out`` (the de-interleaved output).

        From a CUDA card the copy goes through a pinned buffer the farm
        keeps (grown to the largest emit): a pageable device-to-host copy of
        the headline emit took ~30 ms, the pinned one ~1.5 ms, and the copy
        into fresh host memory is then a threaded host copy (PERF.md)."""
        result = np.empty(tuple(out.shape), np.int16 if self.clamp_s16 else np.int32)
        if self.device.type == "cuda":
            if self._pinned is None or self._pinned.numel() < out.numel():
                self._pinned = torch.empty(out.numel(), dtype=out.dtype, pin_memory=True)
            out = self._pinned[: out.numel()].view(out.shape).copy_(out)
        torch.from_numpy(result).copy_(out)
        return result

    def _emit(self, total_frames: int) -> np.ndarray:
        """Produce every frame available against `total_frames` of data."""
        n_out = self._natural_count(total_frames)
        lanes_out = self._launch(n_out) if n_out > 0 else None
        return self._finish_emit(total_frames, n_out, lanes_out)

    def _finish_emit(self, total_frames: int, n_out: int,
                     lanes_out: Optional[torch.Tensor]) -> np.ndarray:
        """De-interleave the launched lanes to (B, n_out, C) on the host,
        advance the phase and slide the staging window (LowLevel position
        carry, clownresampler.h:1063-1068). Split from _emit so that
        MixedStreamFarm can run every group's launches in one call between
        the two halves."""
        if n_out > 0:
            result = self._to_host(
                lanes_out.view(n_out, self.n_streams, self.channels).permute(1, 0, 2))
        else:
            out_dtype = np.int16 if self.clamp_s16 else np.int32
            result = np.zeros((self.n_streams, 0, self.channels), out_dtype)

        t = self.position_fractional + n_out * self.increment
        self.position_integer += t >> 16
        self.position_fractional = t & 0xFFFF
        consumed = min(self.position_integer, total_frames)
        self.position_integer -= consumed
        # Slide out consumed frames; retain everything after them (incl. halo).
        keep = self._fill - consumed
        if consumed:
            if self._device_staging:
                self._staging[:keep] = self._staging[consumed : consumed + keep].clone()
                self._staging[keep:] = 0
            else:
                native.shift_rows(self._staging, keep, consumed)
        self._fill = keep
        return result

    def _stage(self, chunk: np.ndarray) -> int:
        """Stage one (B, n, C) int16 chunk; returns the consumable frame count
        (the last `radius_bound` data rows stay held back until more data or
        flush arrives -- the high-level buffer's early `input_buffer_end`,
        clownresampler.h:1154)."""
        chunk = np.ascontiguousarray(chunk, dtype=np.int16)
        b, n, c = chunk.shape
        if b != self.n_streams or c != self.channels or n > self.chunk_frames:
            raise ValueError(f"chunk of shape {chunk.shape} does not match the farm "
                             f"({self.n_streams}, <= {self.chunk_frames}, {self.channels})")
        if self._fill + n > self._capacity:
            raise ValueError("staging overflow: feed chunks of at most chunk_frames")
        if self._device_staging:
            rows = torch.from_numpy(chunk).to(self.device).to(torch.int32)
            self._staging[self._fill : self._fill + n] = rows.permute(1, 0, 2).reshape(n, b * c)
        else:
            native.stage_chunk(chunk, self._staging, self._fill)
        self._fill += n
        return self._fill - 2 * self._radius_bound

    def process(self, chunk: np.ndarray) -> np.ndarray:
        """Feed (n_streams, n, channels) int16; returns (n_streams, m, channels)
        output frames (m varies with phase, ~n*out_rate/in_rate)."""
        total = self._stage(chunk)
        if total > 0:
            return self._emit(total)
        out_dtype = np.int16 if self.clamp_s16 else np.int32
        return np.zeros((self.n_streams, 0, self.channels), out_dtype)

    def flush(self) -> np.ndarray:
        """Feed `radius_bound` zero frames and drain (ResampleEnd, 1242-1250)."""
        r = self._radius_bound
        if self._device_staging:
            self._staging[self._fill : self._fill + r] = 0
        else:
            native.zero_rows(self._staging, self._fill, r)
        self._fill += r
        return self._emit(max(self._fill - 2 * self._radius_bound, 0))


class MixedStreamFarm:
    """Streams at mixed ratios, grouped per ratio into uniform farms.

    Streams share nothing, so a mixed fleet decomposes exactly into one
    UniformStreamFarm per distinct (input, output, low-pass) rate triple,
    and every group's launches for a chunk run in one ``multi_resample``
    call, each with its own class's kernel (the repo's config 5: 48k->44.1k,
    44.1k->48k and 8k->48k on the tiled kernel, 96k->48k on the strided
    kernel).

    ``specs`` is a list of per-stream (input_rate, output_rate[, lpf])
    tuples. ``process`` takes and returns per-stream lists (outputs differ
    in length per ratio). Per-stream re-rating is :meth:`adjust_stream` (the
    re-rated stream splits into its own phase-carrying group); re-rating a
    whole group is its farm's ``adjust``. ``max_radius`` reserves tap-window
    capacity in every group, so that a stream may later move to a wider
    ratio. The groups stage on ``device`` as UniformStreamFarm does by
    default (on the card for CUDA, in host memory for the CPU).
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
        lo = j * self.channels
        solo._staging[:, :] = farm._staging[:, lo : lo + self.channels]
        members[j] = None
        self._groups.append([solo, [i]])
        return True

    def _distribute(self, outputs: list, members: list, out: np.ndarray) -> None:
        for j, i in enumerate(members):
            if i is not None:
                outputs[i] = out[j]

    def process(self, chunks: list) -> list:
        """chunks[i]: (n, channels) int16 for stream i (the same n for every
        stream). Returns outputs[i]: (m_i, channels) int32 (int16 with
        ``clamp_s16``); m_i varies with the stream's ratio and phase."""
        n = np.asarray(chunks[0]).shape[0]
        zeros = np.zeros((n, self.channels), np.int16)
        pending = []   # (farm, members, total, n_out, tiles)
        xs, states, plans, tstrs = [], [], [], []
        for farm, members in self._groups:
            batch = np.stack([zeros if i is None else np.asarray(chunks[i], np.int16)
                              for i in members])
            total = farm._stage(batch)
            n_out = farm._natural_count(total) if total > 0 else 0
            tiles = []
            if n_out > 0:
                gx, gst, gpl, gts, tiles = farm._launch_specs(n_out)
                xs += gx
                states += gst
                plans += gpl
                tstrs += gts
            pending.append((farm, members, total, n_out, tiles))
        outs = multi_resample(self._groups[0][0]._table, tuple(xs), tuple(states),
                              tuple(plans), tstrs=tuple(tstrs))

        outputs: list = [None] * self.n_streams
        cursor = 0
        for farm, members, total, n_out, tiles in pending:
            lanes_out = None
            if n_out > 0:
                lanes_out = farm._join(outs[cursor : cursor + len(tiles)], tiles)
                cursor += len(tiles)
            if total > 0:
                out = farm._finish_emit(total, n_out, lanes_out)
            else:
                out = np.zeros((farm.n_streams, 0, self.channels),
                               np.int16 if self.clamp_s16 else np.int32)
            self._distribute(outputs, members, out)
        return outputs

    def flush(self) -> list:
        """Drain every group (ResampleEnd, clownresampler.h:1242-1250)."""
        outputs: list = [None] * self.n_streams
        for farm, members in self._groups:
            self._distribute(outputs, members, farm.flush())
        return outputs
