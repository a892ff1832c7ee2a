"""Transcode farm: steady-state chunked resampling of many parallel streams.

B same-ratio streams flow through one launch per output tile as lanes of a
lane-major ``(rows, B*C)`` int32 staging buffer, with the host side doing
what the reference's high-level layer does for one stream -- staging buffer,
halo carry, edge padding (clownresampler.h:1096-1252). Dynamic ratio changes
(pitch bends) are ``adjust`` between chunks, with LowLevel_Adjust semantics
(clownresampler.h:1052-1056): position carries over, only the
increment/stretching change.

Bit-exactness: each stream's output is identical to running the reference
(and LowLevelResampler) on that stream alone.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.configure import Configuration, configure
from clownresampler_tpu_torch.lowlevel import FAST_KERNEL_MAX_TAPS, DeviceState
from clownresampler_tpu_torch.models import DEFAULT_MODEL, KernelModel, table_tensor
from clownresampler_tpu_torch.ops.convolve import ConfigScalars
from clownresampler_tpu_torch.ops.resample import multi_resample, plan_uniform
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
        device: Union[str, torch.device] = "cpu",
        device_staging: Optional[bool] = None,
        clamp_s16: bool = False,
    ):
        low_pass_rate = low_pass_rate if low_pass_rate is not None else max(input_rate, output_rate)
        cfg = configure(input_rate, output_rate, low_pass_rate,
                        radius=model.radius, resolution=model.resolution)
        if cfg is None:
            raise ValueError("unsupported ratio (kernel scale >= 0x1000)")
        self.n_streams = n_streams
        self.channels = channels
        self.chunk_frames = chunk_frames
        self.model = model
        self.device = torch.device(device)
        self.clamp_s16 = clamp_s16  # emit clamped int16 (halves the device-to-host copy)
        self._table = table_tensor(model.table(), self.device)
        self._tables: dict = {}    # (step, taps) -> strided table tensor

        self._lanes = n_streams * channels
        radius_bound = max(cfg.integer_stretched_kernel_radius, max_radius or 0)
        self._max_taps = fx.round_up(2 * radius_bound, 8)
        self._radius_bound = radius_bound

        # Host streaming state (exact Python ints).
        self.position_integer = 0
        self.position_fractional = 0
        self._set_config(cfg, fx.calculate_ratio(input_rate, output_rate))

        # Staging buffer: [left halo | data ... | slack]. Logical stream frame
        # f lives at row f + radius_bound. Every launch reads max_taps-or-
        # fewer rows from each window start, and a real frame's window starts
        # below the fill, so max_taps rows of slack keep every real read
        # inside the buffer; padding frames' starts are clamped by the launch
        # (ops.resample.launch_rows).
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

    def _launch(self, n_out: int) -> torch.Tensor:
        """Frames [0, n_out) of every lane, (n_out, lanes) on the device.

        Tiled into <= MAX_LAUNCH_OUTPUT_FRAMES-frame launches with p0/f0
        advanced in exact Python ints between them. Launches run at the
        CURRENT ratio's tap width (surplus taps of a wider reserve are masked,
        so any width >= the current class is bit-exact)."""
        taps = min(self._max_taps,
                   fx.round_up(2 * self.config.integer_stretched_kernel_radius, 8))
        plan = plan_uniform(self.increment, 0)
        kind = plan["kernel"] if taps <= FAST_KERNEL_MAX_TAPS else "wide"
        tstr = None
        if kind in ("tiled", "general"):
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
            tile = min(n_out - done, MAX_LAUNCH_OUTPUT_FRAMES)
            t = self.position_fractional + done * self.increment
            p0 = self.position_integer + (t >> 16) + halo_shift
            states.append(DeviceState(p0, t & 0xFFFF, self._scalars))
            plans.append((kind, plan.get("d"), plan.get("cand"), taps,
                          fx.round_up(tile, 8), self.clamp_s16))
            tiles.append(tile)
            done += tile
        outs = multi_resample(self._table, (x,) * len(plans), tuple(states),
                              tuple(plans), tstrs=(tstr,) * len(plans))
        return torch.cat([o[:tile] for o, tile in zip(outs, tiles)])

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
        """Produce every frame available against `total_frames` of data,
        de-interleave to (B, m, C), advance the phase and slide the staging
        window (LowLevel position carry, clownresampler.h:1063-1068)."""
        n_out = self._natural_count(total_frames)
        out_dtype = np.int16 if self.clamp_s16 else np.int32
        if n_out > 0:
            lanes_out = self._launch(n_out)
            result = self._to_host(
                lanes_out.view(n_out, self.n_streams, self.channels).permute(1, 0, 2))
        else:
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
