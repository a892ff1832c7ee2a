"""Low-level streaming API: phase-accumulator state over pre-padded input.

Re-expression of ClownResampler_LowLevel_{Init,Adjust,Resample}
(clownresampler.h:640-648, 1039-1094). The reference runs a sequential
per-output-frame loop whose only state is the 16.16 phase accumulator;
between Adjust calls the accumulation is linear, so output frame n has the
closed-form position t(n) = f0 + n*increment, pos(n) = p0 + (t >> 16),
frac(n) = t & 0xFFFF, which turns the loop into one batched launch per tile.

* ``resample_chunk`` -- one LowLevel_Resample call as a function of tensors,
  with the reference's termination bookkeeping (position carry on input
  exhaustion, clownresampler.h:1063-1068; rewind on output-full, 1084-1088);
  on a card one launch of batch_mac_kernel (ops.resample.resample_streams),
  on the CPU its plain version ``resample_chunk_reference``, the gather.
* ``resample_scan`` / ``resample_scan_fused`` -- a whole chunked stream,
  every chunk on the device, with the high-level layer's 2*radius halo
  carried between chunks (clownresampler.h:1143-1154): the oracle scan
  (``resample_chunk`` per step) and the scan whose steps run the ratio
  class's kernel: on a card one device program (``ScanProgram``: per step
  one scan-mode launch of the engine's kernel -- tiled_mac_kernel for the
  tiled and general engines, strided_mac_kernel, wide_mac_kernel and its
  fold --, which reads the chunks in place; nothing else), on the CPU its
  plain version (``resample_scan_fused_reference``).
* ``LowLevelResampler`` -- the host streaming class mirroring the C API,
  including the per-frame output-callback contract. Bookkeeping uses exact
  Python ints; the frames are computed on the resampler's ``device``, in
  cycles bounded by ``BATCH_DEVICE_BUDGET_BYTES``.

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
from clownresampler_tpu_torch.device import DEFAULT_DEVICE, Device, resolve_device
from clownresampler_tpu_torch.models import DEFAULT_MODEL, KernelModel, table_tensor
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops.convolve import ConfigScalars, convolve_frames
from clownresampler_tpu_torch.ops.resample import (
    ROUTES,
    multi_resample,
    plan_uniform,
    resample_streams,
    resample_strided_reference,
    resample_uniform_lanes_general_reference,
    resample_uniform_lanes_tiled_reference,
    resample_wide_taps_reference,
    scan_stage_plan,
    strided_stage_plan,
    wide_launch_frames,
)
from clownresampler_tpu_torch.utils import profiling

# Keep n*increment_lo inside int32 (fixedpoint.positions_from_state).
MAX_CHUNK_OUTPUT_FRAMES = 1 << 14

# Tap widths above this take the wide class (wide_mac_kernel), whatever the
# increment; at or below it the increment's class (plan_uniform) serves,
# except that general-class launches (d >= 2, nonzero fraction) from
# GENERAL_WIDE_MIN_TAPS taps take the wide class too. On the H100, over
# 1024-frame launches the wide entry measured 1.4x faster than the general
# entry at 248 taps and 2.7x at 352; over 64-frame launches both sit near
# their host floor up to 352 taps (PERF.md; chip_smoke.py times the two).
FAST_KERNEL_MAX_TAPS = 1024
GENERAL_WIDE_MIN_TAPS = 256
# The ROUTES kind a scan-mode launch of each fused scan engine counts as
# (every engine's steps read the chunks in place; a wide launch is a
# wide_mac_kernel and a wide_fold_kernel launch).
SCAN_ROUTES = {"tiled": "scan_inplace", "general": "scan_inplace", "strided": "scan_strided",
               "wide": "scan_wide"}
# The engines whose scan-mode launch walks every step of a request with one
# grid (tiled_mac_kernel's); the others launch once a step (the wide engine
# once a launch offset a step).
WHOLE_SCAN_KINDS = frozenset(("tiled", "general"))

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
                      device: Device = DEFAULT_DEVICE) -> DeviceState:
    device = resolve_device(device)
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

    A ``padded_input`` of (B, S, C) is B independent calls at once:
    ``total_input_frames``, ``output_quota`` and every leaf of ``state``
    then carry a leading (B,) axis, and so does every returned value (the
    output is (B, n_out, C)).

    On a CUDA tensor this is one launch of batch_mac_kernel for all B
    streams (ops.resample.resample_streams); on the CPU the plain version,
    ``resample_chunk_reference``.
    """
    return resample_streams(table, padded_input, total_input_frames, state, output_quota,
                            max_taps=max_taps, n_out=n_out)


def resample_chunk_reference(
    table: torch.Tensor,
    padded_input: torch.Tensor,
    total_input_frames: int,
    state: DeviceState,
    output_quota: int,
    *,
    max_taps: int,
    n_out: int,
):
    """Plain PyTorch version of ``resample_chunk`` (same arguments and
    return): the gather oracle (``convolve_frames``) over every frame up to
    n_out, masked past ``produced``; a batch is one set of torch ops.
    Counted as ROUTES[("batch", "oracle")]."""
    if n_out > MAX_CHUNK_OUTPUT_FRAMES:
        raise ValueError(f"n_out {n_out} exceeds {MAX_CHUNK_OUTPUT_FRAMES}")
    ROUTES[("batch", "oracle")] += 1
    dev = padded_input.device
    i32 = lambda v: torch.as_tensor(v, dtype=torch.int32).to(dev)
    # Per-stream scalars against the frame axis: (B,) -> (B, 1) with a batch.
    col = (lambda v: v[:, None]) if padded_input.dim() == 3 else (lambda v: v)
    p0, f0 = i32(state.position_integer), i32(state.position_fractional)
    inc_hi, inc_lo = state.cfg.increment_hi, state.cfg.increment_lo
    total = i32(total_input_frames)

    natural = natural_output_count(p0, f0, inc_hi, inc_lo, total)
    quota = i32(output_quota).clamp_max(n_out)
    produced = torch.minimum(natural, quota)

    n = torch.arange(n_out, dtype=torch.int32, device=dev)
    pos, frac = fx.positions_from_state(col(p0), col(f0), col(inc_hi), col(inc_lo), n)
    out = convolve_frames(table, padded_input, pos, frac,
                          ConfigScalars(*(col(v) for v in state.cfg)), max_taps)
    out = torch.where((n < col(produced))[..., None], out, 0)

    # Advance past the produced frames, then the unified carry/rewind:
    # delta = min(position, N) covers both exits (1063-1068, 1084-1088).
    p_after, f_after = fx.positions_from_state(p0, f0, inc_hi, inc_lo, produced)
    delta = torch.minimum(p_after, total)
    new_state = DeviceState(p_after - delta, f_after, state.cfg)
    return out, produced, delta, new_state, natural < quota


# ---------------------------------------------------------------------------
# Whole-stream scans: K chunks on the device, the halo carried between them
# ---------------------------------------------------------------------------

def _scan_setup(chunks: torch.Tensor, state: DeviceState, radius: int) -> DeviceState:
    """Check the chunk stack and return ``state`` with the +radius position
    bias, its positions as 0-dim int32 tensors on the chunks' device (made
    by a fill, not a host-to-device copy, when they are Python ints).

    Buffer row r of a step maps to stream frame r - 2*radius (the halo
    takes the first 2*radius rows), while the C window contract puts stream
    frame 0 at row ``radius`` (clownresampler.h:725-733): hence the bias."""
    if chunks.dim() != 3 or chunks.shape[0] < 1:
        raise ValueError(f"chunks must be (K >= 1, n_in, L), got {tuple(chunks.shape)}")
    # natural_output_count shifts (n_in - p0) left by 16 in int32.
    if chunks.shape[1] >= 1 << 14:
        raise ValueError(f"scan chunks must be < 2^14 frames, got {chunks.shape[1]}")
    dev = chunks.device

    def scalar(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=torch.int32)
        return torch.full((), int(v), dtype=torch.int32, device=dev)

    return DeviceState(scalar(state.position_integer) + radius,
                       scalar(state.position_fractional), state.cfg)


def _scan_result(outs, produced, over, state: DeviceState, radius: int):
    """(outputs (K, n_out, L), produced (K,), state' without the bias, backlog)."""
    return (torch.stack(outs), torch.stack(produced),
            DeviceState(state.position_integer - radius, state.position_fractional, state.cfg),
            torch.stack(over).any())


def resample_scan(table, chunks, state: DeviceState, *, max_taps: int, n_out: int,
                  radius: int):
    """Whole-stream resampling over K input chunks, ``resample_chunk`` per
    step (on a card a batch_mac_kernel launch a step): the oracle scan the
    fused scan is held against.

    ``chunks`` is (K, n_in, L) int16/int32 with n_in < 2^14; ``state.cfg``
    must have integer radius ``radius``. The reference's high-level layer
    refills a staging buffer and moves a 2*radius halo between refills
    (clownresampler.h:1143-1154); here each step assembles [halo | chunk],
    resamples every frame visible against n_in (the position carry keeps
    the leftover in the state, 1063-1068) and hands the chunk's last
    2*radius rows to the next step. The first halo is zeros; append a zero
    chunk to flush, as ResampleEnd does (1242-1250).

    ``n_out`` caps each step's output; size it
    ((n_in + 2*radius) << 16) // increment + slack so the initial radius
    backlog drains through any one step. Returns (outputs (K, n_out, L)
    int32 zero-masked past produced, produced (K,), state', backlog):
    ``backlog`` is True iff some step's natural frame count exceeded n_out,
    in which case frames were held back past the carried halo and the
    outputs are not to be trusted.
    """
    st = _scan_setup(chunks, state, radius)
    _, n_in, lanes = chunks.shape
    halo = torch.zeros((2 * radius, lanes), dtype=chunks.dtype, device=chunks.device)
    outs, produced, over = [], [], []
    for chunk in chunks:
        buffer = torch.cat([halo, chunk])
        natural = natural_output_count(st.position_integer, st.position_fractional,
                                       st.cfg.increment_hi, st.cfg.increment_lo, n_in)
        out, prod, _consumed, st, _exhausted = resample_chunk(
            table, buffer, n_in, st, 1 << 30, max_taps=max_taps, n_out=n_out)
        halo = buffer[n_in : n_in + 2 * radius]
        outs.append(out)
        produced.append(prod)
        over.append(natural > n_out)
    return _scan_result(outs, produced, over, st, radius)


def _scan_engine(increment: int, max_taps: int, n_out: int) -> tuple:
    """(kind, d, cand, frames between launches) of the fused scan's engine:
    ``launch_kind``'s class, whose steps are one launch each (the tiled and
    general classes: one launch a request, WHOLE_SCAN_KINDS) except for the
    wide class, which cuts n_out into launches of
    ``wide_launch_frames(max_taps)``."""
    if max_taps > FAST_KERNEL_MAX_TAPS:
        raise ValueError(f"the fused scan takes at most {FAST_KERNEL_MAX_TAPS} taps, got "
                         f"{max_taps}: stream wider kernels through LowLevelResampler")
    if n_out < 8 or n_out % 8:
        raise ValueError(f"n_out must be a multiple of 8, got {n_out}")
    kind, d, cand = launch_kind(increment, max_taps)
    step = min(n_out, wide_launch_frames(max_taps)) if kind == "wide" else n_out
    return kind, d, cand, step


def resample_scan_fused_reference(table, chunks, state: DeviceState, *, max_taps: int,
                                  n_out: int, radius: int, increment: int,
                                  table_strided=None):
    """Plain PyTorch version of ``resample_scan_fused`` (same arguments and
    return): a Python loop of torch ops around each step's engine entry.

    Each step stages [halo | chunk widened to int32 | max_taps + 8 zero
    rows]: the zero rows keep every real frame's launch-width window inside
    the buffer, so ``launch_rows`` never moves it. The buffer is built from
    the stream of chunks (``scan_stream_rows_reference``), as the engines'
    scan modes read it. The loop's state stays in 0-dim tensors on the
    chunks' device.
    """
    kind, d, cand, step = _scan_engine(increment, max_taps, n_out)
    st = _scan_setup(chunks, state, radius)
    k, n_in, _ = chunks.shape
    cfg = st.cfg
    offsets = range(0, n_out, step)
    plans = tuple((kind, d, cand, max_taps, min(step, n_out - o), False) for o in offsets)
    tstrs = (table_strided,) * len(plans)

    frame = torch.arange(n_out, dtype=torch.int32, device=chunks.device)
    p, f = st.position_integer, st.position_fractional
    outs, produced, over = [], [], []
    for s in range(k):
        buffer = scan_stream_rows_reference(chunks, s, radius, max_taps + 8)
        natural, prod, (p_next, f_next) = _step_scalars(p, f, cfg, n_in, n_out)
        states = tuple(DeviceState(*fx.positions_from_state(p, f, cfg.increment_hi,
                                                            cfg.increment_lo, o), cfg)
                       for o in offsets)
        out = torch.cat(multi_resample(table, (buffer,) * len(plans), states, plans, tstrs))
        outs.append(torch.where((frame < prod)[:, None], out, 0))
        p, f = p_next, f_next
        produced.append(prod)
        over.append(natural > n_out)
    return _scan_result(outs, produced, over, DeviceState(p, f, cfg), radius)


def _step_scalars(p, f, cfg: ConfigScalars, n_in: int, n_out: int) -> tuple:
    """A scan step's scalars from its state (p with the scan's +radius bias,
    f): (natural -- the frames due against the chunk's n_in frames --,
    produced -- at most n_out of them --, the next step's state (2,): the
    position after them with the carry, clownresampler.h:1063-1068)."""
    hi, lo = cfg.increment_hi, cfg.increment_lo
    natural = natural_output_count(p, f, hi, lo, n_in)
    produced = natural.clamp_max(n_out)
    p_after, f_next = fx.positions_from_state(p, f, hi, lo, produced)
    return natural, produced, torch.stack([p_after - p_after.clamp_max(n_in), f_next])


def scan_stream_rows_reference(chunks, k: int, radius: int, extra_rows: int):
    """Scan step ``k``'s staged buffer built from the stream: the (K, n_in, L)
    chunks read as one stream of K * n_in rows, buffer row i is stream row
    k*n_in - 2*radius + i while that lies in [0, (k+1)*n_in), else 0; 2*radius
    + n_in + ``extra_rows`` rows, int32. It equals the JAX scan's [halo |
    chunk | zeros] (clownresampler_tpu/lowlevel.py:378-412): the halo is the
    stream's 2*radius rows before the chunk (zeros before the stream), also
    when n_in < 2*radius and it reaches back over several chunks."""
    _, n_in, lanes = chunks.shape
    first, end = k * n_in - 2 * radius, (k + 1) * n_in
    rows = torch.zeros((2 * radius + n_in + extra_rows, lanes), dtype=torch.int32,
                       device=chunks.device)
    lo = max(first, 0)
    rows[lo - first : end - first] = chunks.reshape(-1, lanes)[lo:end]
    return rows


def scan_inplace_step_reference(table, chunks, k: int, state, cfg: ConfigScalars, *,
                                radius: int, max_taps: int, n_out: int, increment: int,
                                table_strided=None):
    """Plain PyTorch version of ``scan_inplace_step``: what the scan-mode
    launches of step ``k`` of a fused scan over ``chunks`` (K, n_in, L)
    int16/int32 compute, from ``state`` (2,) int32 -- (position_integer with
    the scan's +radius bias, position_fractional) --: the window from the
    stream (``scan_stream_rows_reference`` with max_taps + 8 zero rows), the
    engine's plain version with the frames from ``produced`` on stored as 0
    (the wide engine's once per launch offset, each from its launch state),
    and the bookkeeping. Returns (out (n_out, L), produced (), over () -- 1
    iff more than n_out frames were due --, next_state (2,)), all int32."""
    kind, d, cand, step = _scan_engine(increment, max_taps, n_out)
    x = scan_stream_rows_reference(chunks, k, radius, max_taps + 8)
    natural, produced, next_state = _step_scalars(state[0], state[1], cfg, chunks.shape[1], n_out)
    args = dict(max_taps=max_taps, n_valid=produced)
    st = DeviceState(state[0], state[1], cfg)
    if kind == "tiled":
        out, _ = resample_uniform_lanes_tiled_reference(
            table, x, st, d=d, cand=cand, n_out=n_out, table_strided=table_strided, **args)
    elif kind == "general":
        out, _ = resample_uniform_lanes_general_reference(
            table, x, st, n_out=n_out, table_strided=table_strided, **args)
    elif kind == "strided":
        out, _ = resample_strided_reference(table, x, st, d=d, n_out=n_out, **args)
    else:
        out = torch.cat([resample_wide_taps_reference(
            table, x, DeviceState(*fx.positions_from_state(
                state[0], state[1], cfg.increment_hi, cfg.increment_lo, o), cfg),
            d=d, n_out=min(step, n_out - o), table_strided=table_strided, frame_offset=o,
            **args)[0] for o in range(0, n_out, step)])
    return (out, produced.to(torch.int32), (natural > n_out).to(torch.int32),
            next_state.to(torch.int32))


def _scan_step_launches(table, chunks, state_in, cfg, out, produced, over, state_out, *,
                        k: int, radius: int, max_taps: int, increment: int, table_strided,
                        partial) -> list:
    """The scan-mode launches of step ``k`` of a fused scan, checked: a list
    of (C entry, its arguments by name) -- one crt_tiled_scan or
    crt_strided_scan, or a crt_wide_scan per launch offset of the wide
    engine, each writing its frames of ``out`` (n_out, L) and reading its
    launch state from the step's ``state_in``. For the WHOLE_SCAN_KINDS
    ``out`` may be (steps, n_out, L), with ``produced``, ``over`` and
    ``state_out`` of as many steps: one crt_tiled_scan then takes them all.
    ``partial`` is the wide engine's scratch (_build.wide_scratch of one
    launch)."""
    kind, d, cand, step = _scan_engine(increment, max_taps, out.shape[-2])
    books = (state_in, cfg, out, produced, over, state_out)
    common = dict(step=k, radius=radius, max_taps=max_taps)
    elem = chunks.element_size()
    if kind in ("tiled", "general"):
        frames, win_rows = scan_stage_plan(max_taps, increment, elem)
        return [("crt_tiled_scan", _build.tiled_scan_args(
            chunks, table, table_strided, *books, frames_per_stage=frames, win_rows=win_rows,
            **common))]
    if kind == "strided":
        frames, win_rows = strided_stage_plan(d, max_taps, elem)
        return [("crt_strided_scan", _build.strided_scan_args(
            chunks, table, *books, d=d, frames_per_tile=frames, win_rows=win_rows, **common))]
    n_out = out.shape[0]
    return [("crt_wide_scan", _build.wide_scan_args(
        chunks, table, table_strided, state_in, cfg, partial, out[o : o + step], produced, over,
        state_out, d=d, n_out=n_out, frame_offset=o, **common)) for o in range(0, n_out, step)]


def _wide_scratch(chunks, increment: int, max_taps: int, n_out: int):
    """The scratch a scan's wide launches share (one launch's worth, reused
    in stream order), or None for the other engines."""
    kind, _, _, step = _scan_engine(increment, max_taps, n_out)
    if kind != "wide":
        return None
    return _build.wide_scratch(max_taps, step, chunks.shape[2], chunks.device)


def scan_inplace_step(table, chunks, k: int, state, cfg: ConfigScalars, *, radius: int,
                      max_taps: int, n_out: int, increment: int, table_strided=None):
    """Step ``k`` of a fused scan, read straight from the chunks; arguments
    and return as ``scan_inplace_step_reference``.

    On a CUDA card this is the engine's scan-mode launch
    (ops/csrc/mac_common.cuh and the engine's source): tiled_mac_kernel for
    the tiled and general engines, strided_mac_kernel, or wide_mac_kernel
    and wide_fold_kernel once per launch offset. Their blocks copy their
    windows' rows from the chunks as they are (int16 or int32) into shared
    memory and work out the step's bookkeeping from its state; block 0 of
    the first launch writes it. ``chunks`` must be contiguous. On the CPU the
    plain version runs."""
    kind = _scan_engine(increment, max_taps, n_out)[0]
    if chunks.device.type == "cpu":
        ROUTES[(SCAN_ROUTES[kind], "reference")] += 1
        return scan_inplace_step_reference(
            table, chunks, k, state, cfg, radius=radius, max_taps=max_taps, n_out=n_out,
            increment=increment, table_strided=table_strided)
    if chunks.device.type != "cuda":
        raise ValueError(f"no scan_inplace route for device {chunks.device}")
    out = torch.empty((n_out, chunks.shape[2]), dtype=torch.int32, device=chunks.device)
    book = torch.empty(4, dtype=torch.int32, device=chunks.device)
    launches = _scan_step_launches(
        table, chunks, state, cfg, out, book[0:1], book[1:2], book[2:4], k=k, radius=radius,
        max_taps=max_taps, increment=increment, table_strided=table_strided,
        partial=_wide_scratch(chunks, increment, max_taps, n_out))
    for entry, args in launches:
        _build.raise_on_launch(_build.entry_function(entry)(*_build.ordered_args(entry, args)),
                               entry)
    ROUTES[(SCAN_ROUTES[kind], "cuda")] += len(launches)
    return out, book[0], book[1], book[2:4]


class ScanProgram:
    """``resample_scan_fused`` on a CUDA card as one device program: set up
    once, then ``run`` is kernel launches and nothing else.

    The constructor validates, plans the engine's launches, allocates (the
    (K, n_out, L) outputs, one int32 array for produced (K,), over (K,) and
    the carried states (K + 1, 2), and the wide engine's scratch) and builds
    every launch's argument list. ``run`` then calls the engine's scan-mode
    C entry: for the tiled and general engines (WHOLE_SCAN_KINDS) one
    crt_tiled_scan over all K steps, whose blocks carry each step's state
    forward on the card; for the others, for each step,
    ``scan_inplace_step``'s launches (one crt_strided_scan, or a
    crt_wide_scan per launch offset). Each reads a step's window rows
    straight from the chunks (as the stream rows [k*n_in - 2*radius,
    (k+1)*n_in), int16 or int32), computes the step's bookkeeping and its
    launch state from the step's state, stores the frames past ``produced``
    as 0 straight into the outputs and writes produced, over and the next
    state. No staging buffer exists.

    No torch op, allocation, argument check or host sync happens between
    the first launch and the last. A program runs once."""

    @profiling.spanned("crt.scan.build")
    def __init__(self, table, chunks, state: DeviceState, *, max_taps: int, n_out: int,
                 radius: int, increment: int, table_strided=None):
        kind = _scan_engine(increment, max_taps, n_out)[0]
        if chunks.dim() == 3 and chunks.dtype not in (torch.int16, torch.int32):
            chunks = chunks.to(torch.int32)
        st = _scan_setup(chunks, state, radius)
        chunks = chunks.contiguous()
        k, n_in, lanes = chunks.shape
        i32 = dict(dtype=torch.int32, device=chunks.device)
        # Every tensor a launch reads by pointer stays referenced here.
        self.chunks, self.cfg, self.tables = chunks, st.cfg, (table, table_strided)
        self.radius, self.kind, self.steps = radius, kind, k
        self.outputs = torch.empty((k, n_out, lanes), **i32)
        book = torch.empty(2 * k + 2 * (k + 1), **i32)
        self.produced, self.over = book[:k], book[k : 2 * k]
        self.states = book[2 * k :].view(k + 1, 2)
        self.states[0] = torch.stack([st.position_integer, st.position_fractional])
        self.scratch = _wide_scratch(chunks, increment, max_taps, n_out)
        # Step 0's launches, checked; the other steps' differ in their window
        # and pointers only. For the WHOLE_SCAN_KINDS step 0's launch takes
        # every step.
        whole = kind in WHOLE_SCAN_KINDS
        n = k if whole else 1
        launches = _scan_step_launches(
            table, chunks, self.states[0], st.cfg, self.outputs if whole else self.outputs[0],
            self.produced[:n], self.over[:n], self.states[1 : n + 1].view(-1), k=0,
            radius=radius, max_taps=max_taps, increment=increment, table_strided=table_strided,
            partial=self.scratch)
        self.launches = len(launches)
        out_bytes = self.outputs[0].nbytes
        self.calls = []
        for s in range(k // n):
            for entry, args in launches:
                self.calls.append((_build.entry_function(entry), entry, _build.ordered_args(
                    entry, dict(
                        args, **_build.scan_window(s, n_in, radius),
                        state_in=args["state_in"] + 8 * s, state_out=args["state_out"] + 8 * s,
                        produced=args["produced"] + 4 * s, over=args["over"] + 4 * s,
                        out=args["out"] + s * out_bytes))))

    @profiling.spanned("crt.scan.run")
    def run(self) -> None:
        """Queue every launch of the scan on the stream that was current at
        construction; raises if a launch is refused."""
        if self.calls is None:
            raise RuntimeError("a ScanProgram runs once")
        calls, self.calls = self.calls, None
        for fn, entry, args in calls:
            err = fn(*args)
            if err:
                _build.raise_on_launch(err, entry)
        ROUTES[(SCAN_ROUTES[self.kind], "cuda")] += len(calls)
        profiling.count("scan_launches", len(calls))

    def result(self):
        """What ``resample_scan_fused`` returns."""
        last = self.states[self.steps]
        return (self.outputs, self.produced,
                DeviceState(last[0] - self.radius, last[1], self.cfg), self.over.any())


def resample_scan_fused(table, chunks, state: DeviceState, *, max_taps: int, n_out: int,
                        radius: int, increment: int, table_strided=None):
    """``resample_scan`` with the ratio class's kernel as each step's engine.

    Same arguments, semantics and return as ``resample_scan``, plus the
    16.16 ``increment``, which picks the engine once (``launch_kind``):
    the tiled, strided or general entry point of ops/resample.py, or the
    wide one for general ratios of GENERAL_WIDE_MIN_TAPS to
    FAST_KERNEL_MAX_TAPS taps, in launches of at most
    ``wide_launch_frames(max_taps)`` frames. ``max_taps`` past
    FAST_KERNEL_MAX_TAPS is refused, as in the JAX package (stream those
    through LowLevelResampler). ``table_strided``
    (KernelModel.strided_table(step, max_taps)) turns the precompute's tap
    gather into a row take. ``n_out`` must be a multiple of 8.

    On a CUDA card the scan is one device program (``ScanProgram``): after
    one set-up the engine's scan-mode launches run (one tiled_mac_kernel
    launch over every step for the tiled and general engines, a
    strided_mac_kernel launch a step, or wide_mac_kernel and
    wide_fold_kernel per launch offset a step), which read their window rows
    straight from the chunks (no staging pass, no staging buffers) and
    compute each step's bookkeeping themselves from the step's state in
    device memory. Every launch writes the outputs in place, so the host only
    queues kernels and never synchronises. On the CPU the plain version runs
    (``resample_scan_fused_reference``).
    """
    if chunks.device.type == "cpu":
        return resample_scan_fused_reference(
            table, chunks, state, max_taps=max_taps, n_out=n_out, radius=radius,
            increment=increment, table_strided=table_strided)
    if chunks.device.type != "cuda":
        raise ValueError(f"no fused scan route for device {chunks.device}")
    with profiling.span("crt.scan.request"):
        program = ScanProgram(table, chunks, state, max_taps=max_taps, n_out=n_out,
                              radius=radius, increment=increment, table_strided=table_strided)
        program.run()
        return program.result()


def resample_scan_tiled(table, chunks, state: DeviceState, *, max_taps: int, n_out: int,
                        radius: int, d: int, cand: int):
    """The tiled-engine case of ``resample_scan_fused``, named by the
    ``plan_uniform`` parameters (d in {0, 1}, cand) instead of the
    increment: an increment of that plan picks the engine (the window math
    uses ``state.cfg``). Returns what ``resample_scan_fused`` returns."""
    # Smallest lo with 1 + ceil((0xFFFF + 7*lo) / 65536) == cand.
    lo = 0 if cand <= 1 else ((cand - 1) * 65536 - 0xFFFF + 6) // 7
    increment = (d << 16) + lo
    plan = plan_uniform(increment, n_out)
    if plan != {"kernel": "tiled", "d": d, "cand": cand}:
        raise ValueError(f"no tiled plan has d {d}, cand {cand}")
    return resample_scan_fused(table, chunks, state, max_taps=max_taps, n_out=n_out,
                               radius=radius, increment=increment)


def _pack_cycles(tiles: list, channels: int, budget: int) -> list:
    """Split ``tiles`` (frames, p0, f0, end) into runs whose device bytes fit
    ``budget``: per tile its int16 input rows [p0, end), their int32
    widening and its int32 output frames (rounded up to 8); a cycle holds
    at least one tile."""
    cycles, cur, used = [], [], 0
    for tile in tiles:
        frames, p0, _f0, end = tile
        cost = channels * (6 * (end - p0) + 4 * fx.round_up(frames, 8))
        if cur and used + cost > budget:
            cycles.append(cur)
            cur, used = [], 0
        cur.append(tile)
        used += cost
    cycles.append(cur)
    return cycles


@dataclass
class LowLevelResampler:
    """Stateful host-side mirror of the C low-level API.

    ``init``/``adjust``/``resample`` correspond one-to-one to
    ClownResampler_LowLevel_{Init,Adjust,Resample}. Positions are exact
    Python ints; each call's frames are computed on ``device`` (the card by
    default; ``device="cpu"`` runs the plain versions), in launches of at
    most MAX_CHUNK_OUTPUT_FRAMES frames.
    """

    channels: int
    model: KernelModel = DEFAULT_MODEL
    position_integer: int = 0
    position_fractional: int = 0
    increment: int = 0
    config: Optional[Configuration] = None
    device: Device = DEFAULT_DEVICE
    # Tap bound fixed at init (grows only if adjust widens the ratio).
    _max_taps: int = 0
    # Device tables and config scalars, keyed by what they depend on.
    _cache: dict = field(default_factory=dict, repr=False)

    # Device bytes one upload->launch->download cycle of _compute_frames may
    # hold (_pack_cycles' count). A call whose tiles need more runs as
    # several cycles, each dropping its device tensors before the next, so
    # a resample() over an input of any length has a bounded footprint.
    BATCH_DEVICE_BUDGET_BYTES = 2 << 30

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @classmethod
    def init(
        cls,
        channels: int,
        input_rate: int,
        output_rate: int,
        low_pass_rate: int,
        model: KernelModel = DEFAULT_MODEL,
        max_radius: Optional[int] = None,
        device: Device = DEFAULT_DEVICE,
    ) -> Optional["LowLevelResampler"]:
        """ClownResampler_LowLevel_Init (clownresampler.h:1044-1050).

        ``max_radius`` reserves tap-window capacity for later ``adjust``
        calls to wider ratios.
        """
        self = cls(channels=channels, model=model, device=device)
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
        device: Device = DEFAULT_DEVICE,
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
                   device=device, _max_taps=int(max_taps))

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
        masked). The tiles run in cycles under BATCH_DEVICE_BUDGET_BYTES
        (``_pack_cycles``).
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

        # Tiles (frames, p0, f0, end): the launch reads from row p0 on, and
        # every nonzero tap of its real frames reads a row below `end` (a
        # frame's window ends by pos + 2*radius <= pos + taps); reads past
        # it are masked taps, served by the zero rows each cycle appends.
        tiles = []
        done = 0
        while done < n_frames:
            tile = min(n_frames - done, step)
            t = self.position_fractional + done * self.increment
            t_last = self.position_fractional + (done + tile - 1) * self.increment
            end = self.position_integer + (t_last >> 16) + 1 + taps
            tiles.append((tile, self.position_integer + (t >> 16), t & 0xFFFF, end))
            done += tile
        launch = (kind, d, cand, taps, table, scalars, tstr)
        return np.concatenate([
            self._run_cycle(padded_input, cycle, launch)
            for cycle in _pack_cycles(tiles, self.channels, self.BATCH_DEVICE_BUDGET_BYTES)])

    def _run_cycle(self, padded_input: np.ndarray, cycle: list, launch: tuple) -> np.ndarray:
        """One cycle: upload the input rows its tiles read as int16 at stream
        width, with ``taps`` zero rows past them so every real frame's
        launch-width window stays inside the buffer; widen on the device;
        launch; copy the frames back. Its device tensors are dropped on
        return."""
        kind, d, cand, taps, table, scalars, tstr = launch
        lo = cycle[0][1]
        hi = max(lo, min(padded_input.shape[0], max(end for *_, end in cycle)))
        rows = torch.zeros((hi - lo + taps, self.channels), dtype=torch.int16)
        rows[: hi - lo] = torch.from_numpy(padded_input[lo:hi])
        x = rows.to(self.device).to(torch.int32)
        outs = multi_resample(
            table, tuple(x[p0 - lo :] for _, p0, _, _ in cycle),
            tuple(DeviceState(0, f0, scalars) for _, _, f0, _ in cycle),
            tuple((kind, d, cand, taps, fx.round_up(tile, 8), False) for tile, *_ in cycle),
            tstrs=(tstr,) * len(cycle))
        return torch.cat([o[:tile] for o, (tile, *_) in zip(outs, cycle)]).cpu().numpy()

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
    device: Device = DEFAULT_DEVICE,
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
