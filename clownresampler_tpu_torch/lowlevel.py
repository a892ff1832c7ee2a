"""Low-level streaming API: phase-accumulator state over pre-padded input.

Re-expression of ClownResampler_LowLevel_{Init,Adjust,Resample}
(clownresampler.h:640-648, 1039-1094). The reference runs a sequential
per-output-frame loop whose only state is the 16.16 phase accumulator;
between Adjust calls the accumulation is linear, so output frame n has the
closed-form position t(n) = f0 + n*increment, pos(n) = p0 + (t >> 16),
frac(n) = t & 0xFFFF, which turns the loop into one batched launch per tile.

* ``resample_chunk`` -- one LowLevel_Resample call as a function of tensors,
  with the reference's termination bookkeeping (position carry on input
  exhaustion, clownresampler.h:1063-1068; rewind on output-full, 1084-1088).
* ``LowLevelResampler`` -- the host streaming class mirroring the C API,
  including the per-frame output-callback contract. Bookkeeping uses exact
  Python ints; the frames are computed on the resampler's ``device``.

Input padding contract is the reference's (clownresampler.h:725-733): the
buffer carries ``integer_stretched_kernel_radius`` extra frames before and
after the chunk, not counted in ``total_input_frames``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Union

import numpy as np
import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.configure import Configuration, configure
from clownresampler_tpu_torch.models import DEFAULT_MODEL, KernelModel, table_tensor
from clownresampler_tpu_torch.ops.convolve import ConfigScalars, convolve_frames
from clownresampler_tpu_torch.ops.resample import (
    multi_resample,
    plan_uniform,
    wide_launch_frames,
)

# Keep n*increment_lo inside int32 (fixedpoint.positions_from_state).
MAX_CHUNK_OUTPUT_FRAMES = 1 << 14

# Tap widths above this take the wide class (wide_mac_kernel), whatever the
# increment; at or below it the increment's class (plan_uniform) serves,
# except that general-class launches (d >= 2, nonzero fraction) from
# GENERAL_WIDE_MIN_TAPS taps take the wide class too. On the H100, over
# 1024-frame launches the wide kernel measured 1.2x faster than
# general_mac_kernel at 248 taps and 2.2x at 352; over 64-frame launches it
# lost 6-27 us up to 352 taps (PERF.md; chip_smoke.py times the two).
FAST_KERNEL_MAX_TAPS = 1024
GENERAL_WIDE_MIN_TAPS = 256

Scalar = Union[int, torch.Tensor]
OutputCallback = Callable[[np.ndarray], bool]


class DeviceState(NamedTuple):
    """Mirror of ClownResampler_LowLevel_State (640-648) for one launch.
    Positions are Python ints or 0-dim int32 tensors."""

    position_integer: Scalar
    position_fractional: Scalar
    cfg: ConfigScalars


def make_device_state(position_integer: int, position_fractional: int,
                      cfg: Configuration, increment: int,
                      device: torch.device = torch.device("cpu")) -> DeviceState:
    pos = torch.tensor([position_integer, position_fractional], dtype=torch.int32)
    pos = pos.to(device)
    return DeviceState(pos[0], pos[1],
                       ConfigScalars.from_configuration(cfg, increment, device))


def launch_kind(increment: int, taps: int) -> tuple:
    """(kind, d, cand) of a uniform-ratio launch at this increment and tap
    width: "wide" past FAST_KERNEL_MAX_TAPS and for general launches from
    GENERAL_WIDE_MIN_TAPS, else plan_uniform's class ("tiled", "general" or
    "strided"); cand is None outside the tiled class."""
    plan = plan_uniform(increment, 0)
    if taps > FAST_KERNEL_MAX_TAPS or (plan["kernel"] == "general"
                                       and taps >= GENERAL_WIDE_MIN_TAPS):
        return "wide", increment >> 16, None
    return plan["kernel"], plan["d"], plan.get("cand")


def natural_output_count(p0, f0, inc_hi, inc_lo, total_input_frames):
    """Number of frames the reference loop produces before the position check
    (clownresampler.h:1063) trips: smallest n with p0 + ((f0+n*inc) >> 16) >= N,
    i.e. ceil(((N - p0) << 16 - f0) / inc), clamped at 0. int32-safe for
    N < 2^14 (callers tile larger inputs)."""
    num = ((total_input_frames - p0) << 16) - f0
    inc = (inc_hi << 16) + inc_lo
    return torch.where(num > 0, (num + inc - 1) // inc.clamp_min(1), 0)


def resample_chunk(
    table: torch.Tensor,
    padded_input: torch.Tensor,    # (N_in + 2*radius_max, C) int16/int32
    total_input_frames: int,       # frames, excluding padding
    state: DeviceState,
    output_quota: int,             # max frames to emit this call
    *,
    max_taps: int,
    n_out: int,                    # output tile capacity
):
    """One LowLevel_Resample call as a function of tensors.

    Returns (output (n_out, C) int32 zero-masked past ``produced``, produced,
    consumed, new_state, input_exhausted) with the reference's return
    semantics: ``input_exhausted`` is true iff the position check exited the
    loop, which needs strictly fewer natural frames than the output quota
    (clownresampler.h:1058-1092).
    """
    if n_out > MAX_CHUNK_OUTPUT_FRAMES:
        raise ValueError(f"n_out {n_out} exceeds {MAX_CHUNK_OUTPUT_FRAMES}")
    dev = padded_input.device
    i32 = lambda v: torch.as_tensor(v, dtype=torch.int32).to(dev)
    p0, f0 = i32(state.position_integer), i32(state.position_fractional)
    inc_hi, inc_lo = state.cfg.increment_hi, state.cfg.increment_lo
    total = i32(total_input_frames)

    natural = natural_output_count(p0, f0, inc_hi, inc_lo, total)
    quota = i32(output_quota).clamp_max(n_out)
    produced = torch.minimum(natural, quota)

    n = torch.arange(n_out, dtype=torch.int32, device=dev)
    pos, frac = fx.positions_from_state(p0, f0, inc_hi, inc_lo, n)
    out = convolve_frames(table, padded_input, pos, frac, state.cfg, max_taps)
    out = torch.where((n < produced)[:, None], out, 0)

    # Advance past the produced frames, then the unified carry/rewind:
    # delta = min(position, N) covers both exits (1063-1068, 1084-1088).
    p_after, f_after = fx.positions_from_state(p0, f0, inc_hi, inc_lo, produced)
    delta = torch.minimum(p_after, total)
    new_state = DeviceState(p_after - delta, f_after, state.cfg)
    return out, produced, delta, new_state, natural < quota


@dataclass
class LowLevelResampler:
    """Stateful host-side mirror of the C low-level API.

    ``init``/``adjust``/``resample`` correspond one-to-one to
    ClownResampler_LowLevel_{Init,Adjust,Resample}. Positions are exact
    Python ints; each call's frames are computed on ``device``, in launches
    of at most MAX_CHUNK_OUTPUT_FRAMES frames.
    """

    channels: int
    model: KernelModel = DEFAULT_MODEL
    position_integer: int = 0
    position_fractional: int = 0
    increment: int = 0
    config: Optional[Configuration] = None
    device: torch.device = torch.device("cpu")
    # Tap bound fixed at init (grows only if adjust widens the ratio).
    _max_taps: int = 0
    # Device tables and config scalars, keyed by what they depend on.
    _cache: dict = field(default_factory=dict, repr=False)

    @classmethod
    def init(
        cls,
        channels: int,
        input_rate: int,
        output_rate: int,
        low_pass_rate: int,
        model: KernelModel = DEFAULT_MODEL,
        max_radius: Optional[int] = None,
        device: Union[str, torch.device] = "cpu",
    ) -> Optional["LowLevelResampler"]:
        """ClownResampler_LowLevel_Init (clownresampler.h:1044-1050).

        ``max_radius`` reserves tap-window capacity for later ``adjust``
        calls to wider ratios.
        """
        self = cls(channels=channels, model=model, device=torch.device(device))
        if not self.adjust(input_rate, output_rate, low_pass_rate, _initial=True):
            return None
        radius_bound = max(self.config.integer_stretched_kernel_radius, max_radius or 0)
        self._max_taps = fx.round_up(2 * radius_bound, 8)
        return self

    @classmethod
    def from_state_tuple(
        cls,
        channels: int,
        model: KernelModel,
        state_tuple: tuple,
        max_taps: int,
        device: Union[str, torch.device] = "cpu",
    ) -> "LowLevelResampler":
        """A resampler that continues a stream from another implementation's
        ``state_tuple()`` (pos_int, pos_frac, increment, stretched,
        int_radius, delta, step), e.g. the JAX package's LowLevelResampler."""
        pos_int, pos_frac, inc, stretched, int_radius, delta, step = (
            int(v) for v in state_tuple)
        cfg = Configuration(
            stretched_kernel_radius=stretched,
            integer_stretched_kernel_radius=int_radius,
            stretched_kernel_radius_delta=delta,
            kernel_step_size=step,
            radius=model.radius,
            resolution=model.resolution,
        )
        return cls(channels=channels, model=model, position_integer=pos_int,
                   position_fractional=pos_frac, increment=inc, config=cfg,
                   device=torch.device(device), _max_taps=int(max_taps))

    def adjust(
        self, input_rate: int, output_rate: int, low_pass_rate: int, _initial=False
    ) -> bool:
        """ClownResampler_LowLevel_Adjust (1052-1056): recompute increment and
        stretching mid-stream; position is untouched. Fails only on crazy
        ratios (scale >= 0x1000, clownresampler.h:974-975)."""
        cfg = configure(input_rate, output_rate, low_pass_rate,
                        radius=self.model.radius, resolution=self.model.resolution)
        if cfg is None:
            return False
        if not _initial and 2 * cfg.integer_stretched_kernel_radius > self._max_taps:
            # The C low-level API permits unrestricted radius growth on Adjust
            # (only the high-level API restricts it, clownresampler.h:1195).
            self._max_taps = fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8)
        self.increment = fx.calculate_ratio(input_rate, output_rate)
        self.config = cfg
        return True

    # -- core chunk computation ------------------------------------------

    def _natural_count(self, total_input_frames: int) -> int:
        num = ((total_input_frames - self.position_integer) << 16) - self.position_fractional
        if num <= 0:
            return 0
        return -(-num // self.increment)

    def _cached(self, key, make):
        hit = self._cache.get(key)
        if hit is None:
            hit = self._cache[key] = make()
        return hit

    def _compute_frames(self, padded_input: np.ndarray, n_frames: int) -> np.ndarray:
        """Convolve output frames [0, n_frames) from the current state.

        Dispatch by ``launch_kind``: every class takes its entry point in
        ops/resample.py (the CUDA kernels on a CUDA device, their plain
        versions on the CPU). Launches are tiled to MAX_CHUNK_OUTPUT_FRAMES
        frames (wide_launch_frames for the wide class) with exact
        host-int p0/f0 between tiles, and run at the current ratio's tap
        width (any width >= the current class is bit-exact: surplus taps are
        masked).
        """
        if n_frames <= 0:
            return np.zeros((0, self.channels), np.int32)
        dev = self.device
        cfg = self.config
        taps = min(self._max_taps, fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8))
        kind, d, cand = launch_kind(self.increment, taps)
        step = MAX_CHUNK_OUTPUT_FRAMES
        if kind == "wide":
            step = min(step, wide_launch_frames(taps))
        table = self._cached(("table", dev), lambda: table_tensor(self.model.table(), dev))
        scalars = self._cached(
            ("cfg", cfg, self.increment),
            lambda: ConfigScalars.from_configuration(cfg, self.increment, dev))
        tstr = None
        if kind != "strided":
            tstr = self._cached(
                ("strided", cfg.kernel_step_size, taps),
                lambda: table_tensor(self.model.strided_table(cfg.kernel_step_size, taps), dev))

        # One upload per call, with `taps` zero rows past the end so every
        # real frame's launch-width window stays inside the buffer. Each
        # launch reads the view from its first frame's row on.
        x = torch.zeros((padded_input.shape[0] + taps, self.channels), dtype=torch.int32)
        x[: padded_input.shape[0]] = torch.from_numpy(padded_input)
        x = x.to(dev)

        xs, states, plans, tiles = [], [], [], []
        done = 0
        while done < n_frames:
            tile = min(n_frames - done, step)
            t = self.position_fractional + done * self.increment
            p0 = self.position_integer + (t >> 16)
            xs.append(x[p0:])
            states.append(DeviceState(0, t & 0xFFFF, scalars))
            plans.append((kind, d, cand, taps, fx.round_up(tile, 8), False))
            tiles.append(tile)
            done += tile
        outs = multi_resample(table, tuple(xs), tuple(states), tuple(plans),
                              tstrs=(tstr,) * len(xs))
        out = torch.cat([o[:tile] for o, tile in zip(outs, tiles)])
        return out.cpu().numpy()

    def _advance(self, n_frames: int) -> None:
        t = self.position_fractional + n_frames * self.increment
        self.position_integer += t >> 16
        self.position_fractional = t & 0xFFFF

    def resample(
        self,
        padded_input: np.ndarray,     # (N + 2*radius, channels) int16
        total_input_frames: int,
        output_callback: Optional[OutputCallback] = None,
        output_limit: Optional[int] = None,
    ) -> tuple[bool, int, np.ndarray]:
        """ClownResampler_LowLevel_Resample (1058-1092).

        Returns (input_exhausted, remaining_input_frames, output_frames).
        ``output_callback(frame) -> bool`` reproduces the per-frame contract
        (return False to stop); ``output_limit`` is the array-API equivalent
        (stop after N frames). With neither, runs to input exhaustion.
        """
        padded_input = np.ascontiguousarray(padded_input, dtype=np.int16).reshape(
            -1, self.channels)
        natural = self._natural_count(total_input_frames)

        quota = natural if output_limit is None else min(natural, output_limit)
        frames = self._compute_frames(padded_input, quota)

        # "refused" mirrors the output callback returning 0: the reference
        # reports output-full (cc_false) even when the refusal lands on the
        # final natural frame (clownresampler.h:1081-1089).
        produced = quota
        refused = False
        if output_callback is not None:
            for i in range(quota):
                if not output_callback(frames[i]):
                    produced = i + 1
                    refused = True
                    break
        if not refused and output_limit is not None and natural >= output_limit:
            refused = True
        frames = frames[:produced]

        self._advance(produced)
        # Unified carry/rewind (1063-1068, 1084-1088).
        delta = min(self.position_integer, total_input_frames)
        remaining = total_input_frames - delta
        self.position_integer -= delta

        return not refused, remaining, frames

    def state_tuple(self) -> tuple[int, int, int, int, int, int, int]:
        """(pos_int, pos_frac, increment, stretched, int_radius, delta, step) —
        for oracle state-equality tests and for ``from_state_tuple``."""
        c = self.config
        return (
            self.position_integer,
            self.position_fractional,
            self.increment,
            c.stretched_kernel_radius,
            c.integer_stretched_kernel_radius,
            c.stretched_kernel_radius_delta,
            c.kernel_step_size,
        )


def resample_array(
    input_frames: np.ndarray,
    input_rate: int,
    output_rate: int,
    low_pass_rate: int,
    model: KernelModel = DEFAULT_MODEL,
    device: Union[str, torch.device] = "cpu",
) -> np.ndarray:
    """One-shot whole-buffer resample (the tests/test-low-level.c usage: the
    caller pads with radius zero-frames both ends, clownresampler.h:725-733).

    input_frames: (N, channels) int16. Returns (M, channels) int32 wide
    samples, M = natural output count.
    """
    input_frames = np.asarray(input_frames, dtype=np.int16)
    if input_frames.ndim == 1:
        input_frames = input_frames[:, None]
    n, channels = input_frames.shape
    rs = LowLevelResampler.init(channels, input_rate, output_rate, low_pass_rate, model,
                                device=device)
    if rs is None:
        raise ValueError("unsupported ratio")
    r = rs.config.integer_stretched_kernel_radius
    padded = np.zeros((n + 2 * r, channels), dtype=np.int16)
    padded[r : r + n] = input_frames
    _, _, out = rs.resample(padded, n)
    return out
