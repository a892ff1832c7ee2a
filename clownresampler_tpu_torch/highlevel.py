"""High-level buffered streaming API: automatic edge padding and halo carry.

Mirrors ClownResampler_HighLevel_{Init,Resample,Adjust,ResampleEnd}
(clownresampler.h:650-659, 1096-1252) including the exact buffer geometry:
a fixed 0x1000-sample staging buffer with a 2*radius "dead zone" halo that is
memmoved to the buffer head on every refill (1143-1154). Keeping the geometry
bit-identical means every convolution sees exactly the same window data as the
C code, so outputs match regardless of how callers chunk their input.

Callback contracts are pythonic equivalents of clownresampler.h:661-662:
  input_callback(total_frames:int) -> np.ndarray (n, channels) int16, n <= total
    (empty array == the C callback returning 0 == end of input)
  output_callback(frame: np.ndarray (channels,) int32) -> bool
    (False == stop resampling)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from clownresampler_tpu_torch.configure import MAXIMUM_CHANNELS
from clownresampler_tpu_torch.lowlevel import LowLevelResampler
from clownresampler_tpu_torch.models import DEFAULT_MODEL, KernelModel

BUFFER_TOTAL_SAMPLES = 0x1000  # clownresampler.h:654

InputCallback = Callable[[int], np.ndarray]
OutputCallback = Callable[[np.ndarray], bool]


@dataclass
class HighLevelResampler:
    """Stateful mirror of ClownResampler_HighLevel_State (650-659)."""

    low_level: LowLevelResampler
    input_buffer: np.ndarray            # flat (BUFFER_TOTAL_SAMPLES,) int16
    input_buffer_start: int             # sample index
    input_buffer_end: int               # sample index
    maximum_integer_stretched_kernel_radius: int
    leading_padding_frames_needed: int
    trailing_padding_frames_remaining: int
    buffer_total_samples: int = BUFFER_TOTAL_SAMPLES

    # Host working-set cap for one bulk ``resample_stream``: streams whose
    # drained input and output would exceed it take the host chunk loop.
    BULK_MAX_DEVICE_BYTES = 16 << 30

    # ------------------------------------------------------------------
    @classmethod
    def init(
        cls,
        channels: int,
        input_rate: int,
        output_rate: int,
        low_pass_rate: int,
        model: KernelModel = DEFAULT_MODEL,
        buffer_total_samples: int = BUFFER_TOTAL_SAMPLES,
        device: Union[str, torch.device] = "cpu",
    ) -> Optional["HighLevelResampler"]:
        """ClownResampler_HighLevel_Init (1101-1118). None on failure.

        ``buffer_total_samples`` lifts the reference's fixed 0x1000 staging
        buffer into a parameter; the default reproduces the C geometry.
        """
        if channels > MAXIMUM_CHANNELS:
            return None
        low = LowLevelResampler.init(channels, input_rate, output_rate,
                                     low_pass_rate, model, device=device)
        if low is None:
            return None
        radius = low.config.integer_stretched_kernel_radius
        # The reference zeroes only the leading dead zone (1111-1112); an
        # all-zero start is a superset. Cursors at the middle of the first
        # kernel window (1115).
        start = radius * channels
        return cls(
            low_level=low,
            input_buffer=np.zeros(buffer_total_samples, dtype=np.int16),
            input_buffer_start=start,
            input_buffer_end=start,
            maximum_integer_stretched_kernel_radius=radius,
            leading_padding_frames_needed=radius,
            trailing_padding_frames_remaining=radius,
            buffer_total_samples=buffer_total_samples,
        )

    @property
    def channels(self) -> int:
        return self.low_level.channels

    # ------------------------------------------------------------------
    def resample(
        self,
        input_callback: InputCallback,
        output_callback: Optional[OutputCallback] = None,
        output_limit: Optional[int] = None,
        _collect: Optional[list] = None,
    ) -> bool:
        """ClownResampler_HighLevel_Resample (1120-1176).

        Returns True if it stopped because input dried up, False because the
        output side called a halt. ``output_limit`` is the array-API stand-in
        for a callback that refuses after N frames (the Nth frame is still
        delivered, then the refusal stops the loop).
        """
        ch = self.channels
        max_radius_samples = self.maximum_integer_stretched_kernel_radius * ch
        double_radius_samples = 2 * max_radius_samples

        # Prime the leading padding (1127-1136): pull the first `radius` real
        # frames into the second dead zone; give up (input-exhausted) if the
        # input dries up mid-prime.
        while self.leading_padding_frames_needed != 0:
            offset = double_radius_samples - self.leading_padding_frames_needed * ch
            got = np.asarray(input_callback(self.leading_padding_frames_needed))
            frames_read = got.shape[0] if got.size else 0
            if frames_read == 0:
                return True
            self.input_buffer[offset : offset + frames_read * ch] = got.reshape(-1)
            self.leading_padding_frames_needed -= frames_read

        produced_total = 0
        while True:
            if self.input_buffer_start == self.input_buffer_end:
                # Dead-zone refill (1143-1158): slide the trailing 2*radius
                # halo to the head, then top up from the input callback.
                src = self.input_buffer_end - max_radius_samples
                self.input_buffer[0:double_radius_samples] = self.input_buffer[
                    src : src + double_radius_samples
                ]
                self.input_buffer_start = max_radius_samples
                room = (self.buffer_total_samples - double_radius_samples) // ch
                got = np.asarray(input_callback(room))
                frames_read = got.shape[0] if got.size else 0
                if frames_read:
                    self.input_buffer[
                        double_radius_samples : double_radius_samples + frames_read * ch
                    ] = got.reshape(-1)
                self.input_buffer_end = self.input_buffer_start + frames_read * ch
                if self.input_buffer_start == self.input_buffer_end:
                    return True

            # Delegate to the low-level resampler with the current-radius halo
            # (1161-1171): pointer = start - radius, count = start..end frames.
            radius_samples = self.low_level.config.integer_stretched_kernel_radius * ch
            input_frames = (self.input_buffer_end - self.input_buffer_start) // ch
            window = self.input_buffer[
                self.input_buffer_start - radius_samples : self.input_buffer_end + radius_samples
            ]
            limit = None if output_limit is None else output_limit - produced_total

            if output_callback is not None:

                def _cb(frame):
                    nonlocal produced_total
                    keep = output_callback(frame)
                    produced_total += 1
                    return keep

                exhausted, remaining, frames = self.low_level.resample(
                    window, input_frames, output_callback=_cb, output_limit=limit
                )
            else:
                exhausted, remaining, frames = self.low_level.resample(
                    window, input_frames, output_limit=limit
                )
                produced_total += frames.shape[0]
            if _collect is not None:
                _collect.append(frames)
            self.input_buffer_start = self.input_buffer_end - remaining * ch
            if not exhausted:
                return False

    # ------------------------------------------------------------------
    def adjust(self, input_rate: int, output_rate: int, low_pass_rate: int) -> bool:
        """ClownResampler_HighLevel_Adjust (1183-1209): transactional; rolls
        back on ratio failure, on radius exceeding the Init-time radius, or on
        the doubled radius not fitting the staging buffer."""
        low = self.low_level
        backup = (low.position_integer, low.position_fractional, low.increment,
                  low.config, low._max_taps)

        if not low.adjust(input_rate, output_rate, low_pass_rate):
            return False
        ok = (
            low.config.integer_stretched_kernel_radius
            <= self.maximum_integer_stretched_kernel_radius
            and low.config.integer_stretched_kernel_radius * 2
            < self.buffer_total_samples // low.channels
        )
        if not ok:
            (low.position_integer, low.position_fractional, low.increment,
             low.config, low._max_taps) = backup
            return False
        return True

    # ------------------------------------------------------------------
    def resample_end(
        self,
        output_callback: Optional[OutputCallback] = None,
        output_limit: Optional[int] = None,
        _collect: Optional[list] = None,
    ) -> bool:
        """ClownResampler_HighLevel_ResampleEnd (1242-1250): flush the tail by
        feeding `radius` zero frames through the normal resample path. True
        once the final sample has been output."""
        ch = self.channels

        def padding_callback(total_frames: int) -> np.ndarray:
            n = min(total_frames, self.trailing_padding_frames_remaining)
            self.trailing_padding_frames_remaining -= n
            return np.zeros((n, ch), dtype=np.int16)

        return self.resample(
            padding_callback, output_callback, output_limit=output_limit, _collect=_collect
        )

    # ------------------------------------------------------------------
    def resample_stream(
        self, input_callback: InputCallback, bulk: Optional[bool] = None
    ) -> np.ndarray:
        """Run to end-of-input, then flush; returns all output frames.

        ``bulk`` processes the whole stream as closed-form segments: with the
        entire input in hand, output frame m's window position is exact host
        arithmetic (f0 + m*increment), so the reference's sequential chunk
        loop (clownresampler.h:1120-1176 + 1242-1250, incl. the ResampleEnd
        zero-flush) collapses into one LowLevel resample over the whole
        radius-padded stream, launched in MAX_CHUNK_OUTPUT_FRAMES tiles.
        Output bytes are identical to the host chunk loop. The bulk path is
        only taken from a pristine resampler (nothing primed or buffered
        yet) and leaves the object in the host loop's exact post-flush state.
        ``bulk=None`` selects it when the resampler's device is a CUDA card;
        the host loop serves the cases the bulk path declines (non-pristine
        state, empty streams, streams past BULK_MAX_DEVICE_BYTES).
        """
        if bulk is None:
            bulk = self.low_level.device.type == "cuda"
        if bulk and self._is_pristine():
            # Declined (None) for empty or over-long streams; frames the bulk
            # path already drained from the callback are replayed first.
            out, input_callback = self._resample_stream_bulk(input_callback)
            if out is not None:
                return out
        collected: list = []
        self.resample(input_callback, _collect=collected)
        self.resample_end(_collect=collected)
        if not collected:
            return np.zeros((0, self.channels), np.int32)
        return np.concatenate(collected, axis=0)

    def _is_pristine(self) -> bool:
        """True while nothing has been primed, buffered, or emitted."""
        ll = self.low_level
        r = self.maximum_integer_stretched_kernel_radius
        return (
            self.leading_padding_frames_needed == r
            and self.trailing_padding_frames_remaining == r
            and self.input_buffer_start == self.input_buffer_end == r * self.channels
            and ll.position_integer == 0
            and ll.position_fractional == 0
        )

    def _resample_stream_bulk(
        self, input_callback: InputCallback, n_in: int = 2048,
    ) -> tuple:
        """Whole-stream resample as closed-form segments (see resample_stream).

        Drains the input callback into a host buffer, radius-pads it both
        ends (the trailing pad IS the ResampleEnd zero flush), and runs ONE
        LowLevel resample over it: the natural count of the padded buffer is
        exactly the frame count the C high-level path emits for the stream.

        Returns (out, replay_callback). ``out`` is None when the bulk path
        declines; ``replay_callback`` then serves any already-drained frames
        before delegating to the original callback, so the host loop can take
        over with no data loss.
        """
        pieces: list = []

        def replay_callback(total_frames: int) -> np.ndarray:
            if pieces:
                got = pieces[0]
                if got.shape[0] > total_frames:
                    pieces[0] = got[total_frames:]
                    return got[:total_frames]
                pieces.pop(0)
                return got
            return np.asarray(input_callback(total_frames))

        ll = self.low_level
        r = ll.config.integer_stretched_kernel_radius
        ch = self.channels

        # bytes per input frame: the int32 input upload plus the int32 output
        # at the output/input frame ratio, plus the int16 host copy
        per_frame = 4 * ch + ((4 * ch) << 16) // max(ll.increment, 1) + 2 * ch + 1
        max_frames = self.BULK_MAX_DEVICE_BYTES // per_frame
        n = 0
        while n <= max_frames:
            got = np.asarray(input_callback(n_in))
            m = got.shape[0] if got.size else 0
            if m == 0:
                break
            pieces.append(got.reshape(m, ch))
            n += m
        if n == 0 or n > max_frames:
            return None, replay_callback

        padded = np.zeros((n + 2 * r, ch), np.int16)
        padded[r : r + n] = np.concatenate(pieces, axis=0)
        _, _, out = ll.resample(padded, n)
        # Post-stream bookkeeping, C-exact, so incremental streaming may
        # resume on this object and stay byte-identical to the host loop:
        # ll.resample already left the host loop's final LowLevel position
        # (each input frame is carry-subtracted exactly once either way);
        # priming is complete and ResampleEnd consumed the trailing flush
        # (clownresampler.h:1230); and the host loop's final refill moves
        # the last 2*radius samples of the logical padded stream to the
        # buffer head and parks both cursors at radius*ch (1143-1158).
        self.leading_padding_frames_needed = 0
        self.trailing_padding_frames_remaining = 0
        halo = padded[n : n + 2 * r].reshape(-1)
        self.input_buffer[: halo.shape[0]] = halo
        self.input_buffer[halo.shape[0]:] = 0
        self.input_buffer_start = self.input_buffer_end = r * ch
        return out, replay_callback

    def buffer_fill_frames(self) -> int:
        return (self.input_buffer_end - self.input_buffer_start) // self.channels
