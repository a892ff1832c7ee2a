"""Uniform-ratio launches: precompute, the CUDA kernels, and their plain versions.

Counterpart of ``clownresampler_tpu/ops/pallas_resample.py``. Input is
lane-major ``x (S, L) int32`` (sign-extended s16 samples) with L = streams x
channels on the fast axis; every lane shares the launch's phase sequence, so
the per-frame quantities (window row, masked LUT taps, 17.15 reciprocal) are
computed once per launch and broadcast across lanes: inside the kernels on
a card, by ``precompute_launch`` (torch ops) in the plain versions. What is
left is the dense multiply-accumulate with the C reference's per-term
truncation, which the kernels in csrc/ perform.

Ratio classes (``plan_uniform``, then the tap width):
  tiled   -- d = increment >> 16 in {0, 1}: every upsample and every
             downsample under 2x (the farm's headline 48k->44.1k included).
             ``tiled_mac_kernel`` is the whole launch: it computes each
             frame's geometry itself and stages each tile's shared window in
             shared memory.
  general -- d >= 2 with a nonzero fraction (e.g. 44.1k->8k).
             ``tiled_mac_kernel`` too: the kernel takes as many frames a
             stage as the increment lets the window ``stage_plan`` sized
             hold.
  strided -- exact integer strides (fraction 0, d >= 2, e.g. 96k->48k).
             One tap vector and one reciprocal serve the launch;
             ``strided_mac_kernel`` computes them, holds the live taps in
             registers and stages each tile's windows.
  wide    -- tap widths past 1024 (lowlevel.FAST_KERNEL_MAX_TAPS, e.g.
             44.1k->132), any increment, and general-class launches from
             lowlevel.GENERAL_WIDE_MIN_TAPS taps. ``wide_mac_kernel`` stages
             the input in runs of rows, each row read once for every frame
             it feeds, and a fold kernel sums each frame's runs and
             normalises.

Beside the uniform-ratio launches, ``resample_streams`` runs B independent
streams, each from its own state and configuration, through one chunk call
(lowlevel.resample_chunk, batch.resample_batch): on a card one launch of
``batch_mac_kernel``, on the CPU the gather oracle's chunk call.

Each entry point takes the tensor's device as the route: a CUDA tensor goes
to the kernel (and raises if it cannot launch), a CPU tensor to the plain
PyTorch version beside it (``*_reference``; for ``resample_streams`` the
gather, counted as "oracle"). ``ROUTES`` counts which route every launch
took. The gather oracle (ops/convolve.py) is the reference all of them are
tested against; on a card it serves only an explicit "oracle" launch.
"""

from __future__ import annotations

import collections
import functools
from typing import Optional

import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops.convolve import convolve_frames, window_geometry

FRAMES_PER_TILE = 8
# Frames per stage of a tiled_mac_kernel block, in order of preference; a
# stage's shared window spans at most stage_window_rows(inc, F, taps) rows of
# _build.TILED_LANES lanes. stage_plan takes the first whose window fits
# beside its taps with two stages in TILED_SHARED_BUDGET (two blocks an SM),
# else in the card's limit.
TILED_STAGE_FRAMES = (64, 32, 16, 8)
TILED_SHARED_BUDGET = 113 * 1024
# The smallest increment of the general class: d = 2 and a fraction of 1.
GENERAL_MIN_INCREMENT = (2 << 16) + 1
# Frames per tile of a strided_mac_kernel block, in order of preference; a
# stage's window spans (F - 1)*d + T rows of _build.TILED_LANES lanes.
# strided_stage_plan takes the first whose two stages fit
# STRIDED_SHARED_BUDGET (two blocks an SM), else the first that fits the
# card's limit.
STRIDED_STAGE_FRAMES = (32, 16, 8)
STRIDED_SHARED_BUDGET = 113 * 1024
# Bound on frames x taps of one wide launch (the dispatchers tile longer
# emits, wide_launch_frames): the plain version's (N, T) tap matrix costs
# N*T*4 bytes, 24.6 MB here (1024 frames at 6016 taps), and the kernel's
# partial sums N x _build.wide_slots(T) x lanes ints.
WIDE_MAX_TAP_MATRIX = 1024 * 6016
# Taps per step of the wide plain version's gather ((N, block, lanes) ints).
WIDE_REFERENCE_TAP_BLOCK = 64
# Bound on frames x taps of one gather of the oracle: convolve_frames
# materialises (frames, taps, lanes) windows, so oracle_launch splits its
# frames into gathers of at most ORACLE_MAX_GATHER // max_taps.
ORACLE_MAX_GATHER = 1 << 22

# (kind, impl) -> launches, impl in {"cuda", "reference", "oracle"}.
ROUTES: collections.Counter = collections.Counter()


# ---------------------------------------------------------------------------
# Launch precompute (O(n_out * taps) ints, torch ops on the launch's device)
# ---------------------------------------------------------------------------

def precompute_launch(table, state, *, max_taps: int, n_out: int, table_strided=None):
    """Per-output-frame scalars for a uniform-ratio launch (the plain
    versions'; the kernels compute them themselves).

    Returns (rows (N,), kvals (N, T), q (N,), eps (N,), tile_rows (N/8,)),
    all int32: rows[n] is the first input row of frame n's tap window
    (pos + min_rel, clownresampler.h:995), kvals the masked LUT taps
    (1008-1021), q the 17.15 reciprocal (1025), eps/tile_rows the 8-frame
    tile decomposition of the JAX package (kept for comparison; the CUDA
    kernels index by rows directly).

    ``table_strided`` (KernelModel.strided_table(step, max_taps) for this
    launch's config, as a tensor) turns the (N, T) element gather into an
    (N,) whole-row take; without it the flat table is gathered.
    """
    if n_out % FRAMES_PER_TILE:
        raise ValueError(f"n_out must be a multiple of 8, got {n_out}")
    cfg = state.cfg
    dev = table.device
    n = torch.arange(n_out, dtype=torch.int32, device=dev)
    pos, frac = fx.positions_from_state(
        state.position_integer, state.position_fractional,
        cfg.increment_hi, cfg.increment_lo, n,
    )
    min_rel, _max_rel, kernel_start, taps = window_geometry(cfg, frac)
    rows = (pos + min_rel).to(torch.int32)

    j = torch.arange(max_taps, dtype=torch.int32, device=dev)
    if table_strided is None:
        kidx = kernel_start[:, None] + j[None, :] * cfg.kernel_step_size
        kv = table[kidx.clamp(0, table.shape[0] - 1).long()]
    else:
        if table_strided.shape[1] != max_taps:
            raise ValueError(f"strided table has {table_strided.shape[1]} taps, "
                             f"launch has {max_taps}")
        start = kernel_start.clamp(0, table_strided.shape[0] - 1)
        kv = table_strided.index_select(0, start)
    kvals = torch.where(j[None, :] < taps[:, None], kv, 0).to(torch.int32)

    q = fx.reciprocal_q31(kvals.sum(dim=1, dtype=torch.int32))

    tile_rows = rows[::FRAMES_PER_TILE]
    local = n % FRAMES_PER_TILE
    eps = rows - tile_rows.repeat_interleave(FRAMES_PER_TILE) - local * cfg.increment_hi
    return rows, kvals, q, eps.to(torch.int32), tile_rows


def launch_rows(rows: torch.Tensor, s: int, max_taps: int) -> torch.Tensor:
    """Window rows as the kernels read them: padding frames past the caller's
    natural count (whose results are discarded) are clamped so that every
    window [row, row + max_taps) lies inside the S-row input. Real frames
    already satisfy that, so the clamp leaves them alone."""
    return rows.clamp(0, max(s - max_taps, 0)).contiguous()


def stage_window_rows(increment: int, frames: int, max_taps: int) -> int:
    """Rows of the window that ``frames`` consecutive frames at this
    increment reach, at most: a frame's first row is p0 + ceil((f0 + n*inc +
    delta) / 2^16), so it advances by at most ceil((frames - 1)*inc / 2^16)
    over the stage. Clamping rows into the input only shortens the span."""
    return -(-(frames - 1) * increment // 65536) + max_taps


def tiled_increment_bound(d: int, cand: int) -> int:
    """The largest increment of a tiled launch with plan_uniform's (d,
    cand): cand = 1 + ceil(7*lo / 2^16) bounds lo by (cand - 1)*2^16 / 7."""
    return (d << 16) + (cand - 1) * 65536 // 7


def stage_frames(increment: int, frames: int, max_taps: int, win_rows: int) -> int:
    """The frames per stage tiled_mac_kernel takes (resample_kernels.cu
    stage_frames): the most of frames, frames/2, ..., 8 whose window fits
    the win_rows rows a stage holds; 8 when none does (those tiles read x
    directly)."""
    while frames > 8 and stage_window_rows(increment, frames, max_taps) > win_rows:
        frames //= 2
    return frames


@functools.lru_cache(maxsize=None)
def stage_plan(max_taps: int, increment: int) -> tuple:
    """(most frames per stage, staged window rows) of a tiled_mac_kernel
    launch (the tiled and general entries).

    The state and configuration are on the card, so the host plans from an
    increment it knows: the tiled entry passes its class's bound
    (tiled_increment_bound), the general entry the smallest general
    increment. Each stage fills its shared memory with window rows beside
    the taps of the first of TILED_STAGE_FRAMES whose window at that
    increment fits: two stages within TILED_SHARED_BUDGET (two blocks an
    SM), else within the card's limit (one). The kernel then takes as many
    frames as the launch's own increment lets that window hold
    (stage_frames): 64 frames of 107 rows at the 48k -> 44.1k headline, 8 of
    79 in a stage of 107 rows at 44.1k -> 8k and 40 taps. Else 8 frames
    reading x directly (0 rows)."""
    for budget in (TILED_SHARED_BUDGET, _build.MAX_SHARED_BYTES):
        for frames in TILED_STAGE_FRAMES:
            rows = (budget // 8 - frames * (max_taps + 3)) // _build.TILED_LANES
            if rows >= stage_window_rows(increment, frames, max_taps):
                return frames, rows
    return TILED_STAGE_FRAMES[-1], 0


@functools.lru_cache(maxsize=None)
def scan_stage_plan(max_taps: int, increment: int, elem_bytes: int) -> tuple:
    """(frames per stage, window rows) of a scan-mode tiled_mac_kernel launch
    over chunks of ``elem_bytes``-byte samples. The scan knows its own
    increment, so each stage holds exactly the window its frames reach
    (stage_window_rows) and what shared memory is left holds more blocks an
    SM: the most of TILED_STAGE_FRAMES whose two stages fit
    TILED_SHARED_BUDGET, else the card's limit; else 8 frames reading the
    chunks directly (0 rows). At config 7's step (int16, 40 taps) 16 frames
    of 123 rows; on the H100 that measured 4-5% faster than stages filled
    with rows as stage_plan fills them (PERF.md)."""
    for budget in (TILED_SHARED_BUDGET, _build.MAX_SHARED_BYTES):
        for frames in TILED_STAGE_FRAMES:
            rows = stage_window_rows(increment, frames, max_taps)
            if _build.tiled_shared_bytes(frames, rows, max_taps, elem_bytes) <= budget:
                return frames, rows
    return TILED_STAGE_FRAMES[-1], 0


def _frame_windows(state, n: torch.Tensor) -> tuple:
    """int64 (first window rows, LUT starts, live tap counts) of frames n
    (int64), as mac_common.cuh frame_window computes them: positions in
    closed form, exact for any n and any increment."""
    cfg = state.cfg
    i64 = lambda v: torch.as_tensor(v, device=n.device).to(torch.int64)
    t = i64(state.position_fractional) + n * ((i64(cfg.increment_hi) << 16)
                                              + i64(cfg.increment_lo))
    frac = t & 0xFFFF
    min_rel = (frac + i64(cfg.stretched_kernel_radius_delta) + 0xFFFF) >> 16
    max_rel = (frac + i64(cfg.stretched_kernel_radius)) >> 16
    kernel_start = (i64(cfg.kernel_step_size) * ((min_rel << 16) - frac)) >> 16
    taps = i64(cfg.integer_stretched_kernel_radius) + max_rel - min_rel
    return i64(state.position_integer) + (t >> 16) + min_rel, kernel_start, taps


def frame_geometry(table, state, *, max_taps: int, n_out: int, s: int, table_strided=None):
    """The per-frame geometry the tiled and wide kernels compute, in plain
    torch with their int64 arithmetic (mac_common.cuh: frame_window,
    lut_tap, reciprocal_q31), exact for any n and any increment, where
    precompute_launch splits the increment and is exact while n*lo stays in
    int32. Returns (rows, clamped rows -- launch_rows over an S-row input
    --, masked taps (N, T), q), all int32."""
    dev = table.device
    rows, kernel_start, taps = _frame_windows(
        state, torch.arange(n_out, dtype=torch.int64, device=dev))
    rows = rows.to(torch.int32)
    step = int(state.cfg.kernel_step_size)
    j = torch.arange(max_taps, dtype=torch.int64, device=dev)
    if table_strided is None:
        kv = table[(kernel_start[:, None] + j * step).clamp(0, table.shape[0] - 1)]
    else:
        kv = table_strided[kernel_start.clamp(0, table_strided.shape[0] - 1)]
    kvals = torch.where(j < taps[:, None], kv, 0).to(torch.int32)
    total = kvals.sum(dim=1, dtype=torch.int64)
    q = (1 << 31) // total.abs().clamp_min(2)
    q = torch.where(total < 0, -q, q).to(torch.int32)
    return rows, launch_rows(rows, s, max_taps), kvals, q


def _lane_range(x, lanes, lane_offset):
    lanes = x.shape[1] - lane_offset if lanes is None else lanes
    if lane_offset < 0 or lanes <= 0 or lane_offset + lanes > x.shape[1]:
        raise ValueError(f"lanes [{lane_offset}, {lane_offset + lanes}) outside "
                         f"x's {x.shape[1]} lanes")
    return lanes


def mac_reference(x, rows, kvals, q, lanes, lane_offset, clamp_s16, tap_block=1):
    """The plain PyTorch multiply-accumulate the kernels implement, on the
    kernels' own inputs (launch rows, masked taps, reciprocals): one row
    gather per tap (``tap_block`` taps at a time), C-truncated product,
    int32 accumulate, 17.15 normalise, optional s16 clamp. The tap sum is a
    plain sum of independently truncated terms, so the blocking does not
    change the result."""
    xs = x[:, lane_offset : lane_offset + lanes]
    n = rows.shape[0]
    acc = torch.zeros((n, lanes), dtype=torch.int32, device=x.device)
    taps = kvals.shape[1]
    j = torch.arange(taps, dtype=torch.int32, device=x.device)
    for t0 in range(0, taps, tap_block):
        blk = min(tap_block, taps - t0)
        idx = (rows[:, None] + j[t0 : t0 + blk]).reshape(-1)
        win = xs.index_select(0, idx).view(n, blk, lanes)
        terms = fx.fixed_mul_trunc(win, kvals[:, t0 : t0 + blk, None])
        acc += terms[:, 0] if blk == 1 else terms.sum(dim=1, dtype=torch.int32)
    out = fx.mul_shift15(acc, q[:, None])
    if clamp_s16:
        out = out.clamp(-0x7FFF, 0x7FFF).to(torch.int16)
    return out


def mask_frames(out, n_valid, frame_offset: int = 0):
    """``out`` (n_out, lanes) with every frame n, n + frame_offset >= n_valid,
    set to 0: the kernels' ``n_valid`` (a one-element int32 tensor on out's
    device; None leaves out as it is) in plain torch."""
    if n_valid is None:
        return out
    n = torch.arange(out.shape[0], dtype=torch.int32, device=out.device) + frame_offset
    return torch.where((n < n_valid.reshape(()))[:, None], out, 0)


def _valid_args(n_valid, frame_offset: int) -> dict:
    """The launchers' n_valid arguments (none without an n_valid)."""
    return {} if n_valid is None else dict(n_valid=n_valid, frame_offset=frame_offset)


def _check_x(x):
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"x must be (S, L) int32, got {x.dtype} {tuple(x.shape)}")


def plain_route(x, kind: str) -> bool:
    """True when x lies on the CPU, where an entry runs its plain version;
    False on a CUDA card, where it runs its kernel. Any other device is
    refused."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no {kind} route for device {x.device}")
    return False


def _takes_reference(x, kind: str) -> bool:
    """``plain_route``, the plain route counted as (kind, "reference")."""
    if plain_route(x, kind):
        ROUTES[(kind, "reference")] += 1
        return True
    return False


# ---------------------------------------------------------------------------
# Tiled class: d in {0, 1}
# ---------------------------------------------------------------------------

def resample_uniform_lanes_tiled_reference(
    table, x, state, *, max_taps: int, n_out: int, d: int, cand: int,
    clamp_s16: bool = False, lanes: Optional[int] = None, lane_offset: int = 0,
    table_strided=None, n_valid=None, frame_offset: int = 0,
):
    """Plain PyTorch version of ``resample_uniform_lanes_tiled``."""
    _check_x(x)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=n_out, table_strided=table_strided)
    rl = launch_rows(rows, x.shape[0], max_taps)
    out = mac_reference(x, rl, kvals, q, lanes, lane_offset, clamp_s16)
    return mask_frames(out, n_valid, frame_offset), rows


def resample_uniform_lanes_tiled(
    table, x, state, *, max_taps: int, n_out: int, d: int, cand: int,
    clamp_s16: bool = False, lanes: Optional[int] = None, lane_offset: int = 0,
    table_strided=None, n_valid=None, frame_offset: int = 0,
):
    """Fast-path uniform-ratio resample; requires increment < 2^17, i.e.
    d = increment >> 16 in {0, 1} and cand = plan_uniform's candidate count.

    The caller pads x so that every real frame's window [row, row + max_taps)
    fits in its S rows. ``lanes``/``lane_offset`` run the launch over a column
    slice of x with no copy. With ``n_valid`` (a one-element int32 tensor on
    x's device, e.g. a scan step's produced count) every frame n with
    n + frame_offset >= n_valid comes back as 0, stored so by the kernel
    (``mask_frames`` in the plain versions); the other entries take the same
    pair. Returns (out (n_out, lanes) int32 -- int16 when
    ``clamp_s16`` -- and rows (n_out,)).

    On a CUDA card this is one launch of ``tiled_mac_kernel``, which reads
    the state's positions (0-dim device tensors or ints) and ``state.cfg``
    from device memory and computes each frame's geometry itself: no host
    sync and no precompute.
    """
    _check_x(x)
    if d not in (0, 1) or not 1 <= cand <= 8:
        raise ValueError(f"tiled launches need d in (0, 1) and cand in [1, 8], got {d}, {cand}")
    if n_out % FRAMES_PER_TILE:
        raise ValueError(f"n_out must be a multiple of 8, got {n_out}")
    if _takes_reference(x, "tiled"):
        return resample_uniform_lanes_tiled_reference(
            table, x, state, max_taps=max_taps, n_out=n_out, d=d, cand=cand,
            clamp_s16=clamp_s16, lanes=lanes, lane_offset=lane_offset,
            table_strided=table_strided, n_valid=n_valid, frame_offset=frame_offset)
    lanes = _lane_range(x, lanes, lane_offset)
    frames, win_rows = stage_plan(max_taps, tiled_increment_bound(d, cand))
    out, rows = _build.tiled_mac(
        x, table, table_strided, state.position_integer, state.position_fractional,
        state.cfg, max_taps=max_taps, n_out=n_out, lanes=lanes, lane_offset=lane_offset,
        frames_per_stage=frames, win_rows=win_rows, clamp_s16=clamp_s16,
        **_valid_args(n_valid, frame_offset))
    ROUTES[("tiled", "cuda")] += 1
    return out, rows


# ---------------------------------------------------------------------------
# General class: any increment (used for d >= 2 with a nonzero fraction)
# ---------------------------------------------------------------------------

def resample_uniform_lanes_general_reference(
    table, x, state, *, max_taps: int, n_out: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, table_strided=None,
    n_valid=None, frame_offset: int = 0,
):
    """Plain PyTorch version of ``resample_uniform_lanes_general``."""
    _check_x(x)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=n_out, table_strided=table_strided)
    rl = launch_rows(rows, x.shape[0], max_taps)
    out = mac_reference(x, rl, kvals, q, lanes, lane_offset, clamp_s16)
    return mask_frames(out, n_valid, frame_offset), rows


def resample_uniform_lanes_general(
    table, x, state, *, max_taps: int, n_out: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, table_strided=None,
    n_valid=None, frame_offset: int = 0,
):
    """Any-ratio uniform-lane resample (the general class: increment >= 2^17
    with a nonzero fraction). Same contract and return as the tiled entry.

    On a CUDA card this is one launch of ``tiled_mac_kernel``, staged for
    the smallest general increment: the kernel reads the state's
    positions (0-dim device tensors or ints) and ``state.cfg`` from device
    memory and computes each frame's geometry and its frames per stage
    itself: no host sync and no precompute."""
    _check_x(x)
    if _takes_reference(x, "general"):
        return resample_uniform_lanes_general_reference(
            table, x, state, max_taps=max_taps, n_out=n_out, clamp_s16=clamp_s16,
            lanes=lanes, lane_offset=lane_offset, table_strided=table_strided,
            n_valid=n_valid, frame_offset=frame_offset)
    lanes = _lane_range(x, lanes, lane_offset)
    frames, win_rows = stage_plan(max_taps, GENERAL_MIN_INCREMENT)
    out, rows = _build.tiled_mac(
        x, table, table_strided, state.position_integer, state.position_fractional,
        state.cfg, max_taps=max_taps, n_out=n_out, lanes=lanes, lane_offset=lane_offset,
        frames_per_stage=frames, win_rows=win_rows, clamp_s16=clamp_s16,
        **_valid_args(n_valid, frame_offset))
    ROUTES[("general", "cuda")] += 1
    return out, rows


# ---------------------------------------------------------------------------
# Strided class: exact integer strides (fraction 0, d >= 2)
# ---------------------------------------------------------------------------

def strided_setup(table, state, *, max_taps: int, n_out: int, d: int):
    """One frame's geometry serves a strided launch (the fraction is
    constant): returns (rows (n_out,), r0 (1,), k0 (T,), q0 (1,)), with
    rows[n] = r0 + n*d unclamped, k0 the masked taps and q0 the 17.15
    reciprocal of frame 0. No (N, T) tap matrix is built."""
    rows8, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=FRAMES_PER_TILE)
    rows = rows8[0] + d * torch.arange(n_out, dtype=torch.int32, device=rows8.device)
    return rows, rows8[:1], kvals[0].contiguous(), q[:1]


def strided_frame_geometry(table, state, *, max_taps: int, n_out: int, d: int, s: int):
    """The geometry strided_mac_kernel computes, in plain torch with its int64
    arithmetic: frame 0's window gives r0, the live tap count and the masked
    taps k0 from the flat LUT (frame_geometry's frame 0), and rows[n] = r0 +
    n*d. Returns (rows (n_out,), clamped rows -- launch_rows over an S-row
    input --, live (an int: k0 is zero from there on, at most max_taps), k0
    (max_taps,), q0 (1,) their 17.15 reciprocal), tensors int32."""
    dev = table.device
    r0, _, taps = _frame_windows(state, torch.zeros(1, dtype=torch.int64, device=dev))
    _, _, k0, q0 = frame_geometry(table, state, max_taps=max_taps, n_out=1, s=s)
    rows = (r0 + d * torch.arange(n_out, dtype=torch.int64, device=dev)).to(torch.int32)
    live = min(max(int(taps[0]), 0), max_taps)
    return rows, launch_rows(rows, s, max_taps), live, k0[0], q0


@functools.lru_cache(maxsize=None)
def strided_stage_plan(d: int, max_taps: int, elem_bytes: int = 4) -> tuple:
    """(frames per tile, staged window rows) of a strided launch whose
    window rows are ``elem_bytes``-byte samples (int32 rows of x; a scan
    step's int16 or int32 stream rows, which take that much shared memory):
    the first of STRIDED_STAGE_FRAMES whose window of (F - 1)*d + max_taps
    rows fits two stages in STRIDED_SHARED_BUDGET, else the first within the
    card's limit, else 8 frames reading x directly (0 rows)."""
    for budget in (STRIDED_SHARED_BUDGET, _build.MAX_SHARED_BYTES):
        for frames in STRIDED_STAGE_FRAMES:
            rows = (frames - 1) * d + max_taps
            if _build.strided_shared_bytes(max_taps, rows, elem_bytes) <= budget:
                return frames, rows
    return STRIDED_STAGE_FRAMES[-1], 0


def resample_strided_reference(
    table, x, state, *, max_taps: int, n_out: int, d: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, n_valid=None, frame_offset: int = 0,
):
    """Plain PyTorch version of ``resample_strided_phases``, the port of the
    JAX package's XLA path ``resample_integer_stride``: one row take per tap
    at rows r0 + n*d (padding frames clamped by ``launch_rows``), the
    C-truncated product with the constant tap, 17.15 normalise."""
    _check_x(x)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, _r0, k0, q0 = strided_setup(table, state, max_taps=max_taps, n_out=n_out, d=d)
    rl = launch_rows(rows, x.shape[0], max_taps)
    out = mac_reference(x, rl, k0.expand(n_out, -1), q0.expand(n_out), lanes, lane_offset,
                        clamp_s16)
    return mask_frames(out, n_valid, frame_offset), rows


def resample_strided_phases(
    table, x, state, *, max_taps: int, n_out: int, d: int, group: int = 8,
    clamp_s16: bool = False, lanes: Optional[int] = None, lane_offset: int = 0,
    n_valid=None, frame_offset: int = 0,
):
    """Exact-integer-stride resample (increment fraction 0, d = increment >> 16
    >= 2, e.g. 96k->48k). ``group`` is accepted for the JAX signature and has
    no effect. The caller pads x so that every real frame's window fits;
    padding frames' windows are clamped into x. Returns (out (n_out, lanes)
    int32 -- int16 when ``clamp_s16`` -- and rows (n_out,)).

    On a CUDA card this is one launch of ``strided_mac_kernel``, which reads
    the state's positions (0-dim device tensors or ints) and ``state.cfg``
    from device memory and computes the launch's taps, reciprocal and rows
    itself: no host sync and no precompute."""
    _check_x(x)
    if d < 2:
        raise ValueError(f"strided launches need d >= 2, got {d}")
    if _takes_reference(x, "strided"):
        return resample_strided_reference(
            table, x, state, max_taps=max_taps, n_out=n_out, d=d, clamp_s16=clamp_s16,
            lanes=lanes, lane_offset=lane_offset, n_valid=n_valid, frame_offset=frame_offset)
    lanes = _lane_range(x, lanes, lane_offset)
    frames, win_rows = strided_stage_plan(d, max_taps)
    out, rows = _build.strided_mac(
        x, table, state.position_integer, state.position_fractional, state.cfg,
        max_taps=max_taps, n_out=n_out, d=d, lanes=lanes, lane_offset=lane_offset,
        frames_per_tile=frames, win_rows=win_rows, clamp_s16=clamp_s16,
        **_valid_args(n_valid, frame_offset))
    ROUTES[("strided", "cuda")] += 1
    return out, rows


def resample_strided_phases_wide(
    table, x, state, *, max_taps: int, n_out: int, d: int, group: int = 8,
    clamp_s16: bool = False, lanes: Optional[int] = None, lane_offset: int = 0,
    n_valid=None, frame_offset: int = 0,
):
    """The JAX package's large-buffer strided entry. Its TPU kernel exists
    for the v5e's VMEM budget; here ``strided_mac_kernel`` serves every
    buffer size, so this is ``resample_strided_phases``."""
    return resample_strided_phases(
        table, x, state, max_taps=max_taps, n_out=n_out, d=d, group=group,
        clamp_s16=clamp_s16, lanes=lanes, lane_offset=lane_offset, n_valid=n_valid,
        frame_offset=frame_offset)


# ---------------------------------------------------------------------------
# Wide class: tap widths past lowlevel.FAST_KERNEL_MAX_TAPS, any increment
# ---------------------------------------------------------------------------

def wide_launch_frames(max_taps: int) -> int:
    """Most frames a dispatcher gives one wide launch: its frames x taps (the
    plain version's (N, T) tap matrix, and N x ~T/64 partial sums in the
    kernel's scratch) stay within WIDE_MAX_TAP_MATRIX (1024 frames at 6016
    taps, 24,064 at 256), in whole 8-frame tiles."""
    return max(FRAMES_PER_TILE,
               WIDE_MAX_TAP_MATRIX // max_taps // FRAMES_PER_TILE * FRAMES_PER_TILE)


def resample_wide_taps_reference(
    table, x, state, *, max_taps: int, n_out: int, d: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, table_strided=None,
    pipeline: Optional[bool] = None, n_valid=None, frame_offset: int = 0,
):
    """Plain PyTorch version of ``resample_wide_taps``: ``mac_reference`` on
    the launch precompute's rows, taps and reciprocals, gathered
    WIDE_REFERENCE_TAP_BLOCK taps at a time."""
    _check_x(x)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=n_out, table_strided=table_strided)
    rl = launch_rows(rows, x.shape[0], max_taps)
    out = mac_reference(x, rl, kvals, q, lanes, lane_offset, clamp_s16,
                        tap_block=WIDE_REFERENCE_TAP_BLOCK)
    return mask_frames(out, n_valid, frame_offset), rows


def resample_wide_taps(
    table, x, state, *, max_taps: int, n_out: int, d: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, table_strided=None,
    pipeline: Optional[bool] = None, n_valid=None, frame_offset: int = 0,
):
    """Any-ratio resample for wide tap windows: the dispatchers send every
    width past 1024 (up to 6016 at radius 3007) and general-class widths
    from lowlevel.GENERAL_WIDE_MIN_TAPS. ``pipeline`` is accepted for the JAX
    signature and has no effect; ``d`` (increment >> 16) only sizes the
    kernel's grid. Same contract and return as the tiled entry; the
    dispatchers keep n_out <= wide_launch_frames(max_taps).

    On a CUDA card this is ``wide_mac_kernel`` and ``wide_fold_kernel``,
    which compute each frame's geometry from the state and ``state.cfg`` in
    device memory (no host sync, no precompute, no (N, T) tap matrix)."""
    _check_x(x)
    if _takes_reference(x, "wide"):
        return resample_wide_taps_reference(
            table, x, state, max_taps=max_taps, n_out=n_out, d=d, clamp_s16=clamp_s16,
            lanes=lanes, lane_offset=lane_offset, table_strided=table_strided,
            n_valid=n_valid, frame_offset=frame_offset)
    lanes = _lane_range(x, lanes, lane_offset)
    out, rows = _build.wide_mac(
        x, table, table_strided, state.position_integer, state.position_fractional, state.cfg,
        max_taps=max_taps, n_out=n_out, d=d, lanes=lanes, lane_offset=lane_offset,
        clamp_s16=clamp_s16, **_valid_args(n_valid, frame_offset))
    ROUTES[("wide", "cuda")] += 1
    return out, rows


# ---------------------------------------------------------------------------
# Several launches in a row, and the oracle route
# ---------------------------------------------------------------------------

def oracle_launch(table, x, state, *, kind: str, max_taps: int, n_out: int,
                  clamp_s16: bool = False, lanes: Optional[int] = None,
                  lane_offset: int = 0):
    """A launch through the gather oracle (ops/convolve.py), the reference
    every class is tested against (``kind`` names it for ROUTES). Its frames
    go in gathers of at most ORACLE_MAX_GATHER // max_taps frames, so a
    gather holds at most ORACLE_MAX_GATHER x lanes ints."""
    lanes = _lane_range(x, lanes, lane_offset)
    n = torch.arange(n_out, dtype=torch.int32, device=x.device)
    pos, frac = fx.positions_from_state(
        state.position_integer, state.position_fractional,
        state.cfg.increment_hi, state.cfg.increment_lo, n)
    xs = x[:, lane_offset : lane_offset + lanes]
    step = max(1, ORACLE_MAX_GATHER // max_taps)
    out = torch.cat([convolve_frames(table, xs, pos[i : i + step], frac[i : i + step],
                                     state.cfg, max_taps)
                     for i in range(0, n_out, step)])
    if clamp_s16:
        out = out.clamp(-0x7FFF, 0x7FFF).to(torch.int16)
    ROUTES[(kind, "oracle")] += 1
    return out


def multi_resample(table, xs: tuple, states: tuple, plans: tuple,
                   tstrs: Optional[tuple] = None) -> tuple:
    """Run several independent uniform-ratio launches, in order, on the
    current stream.

    ``plans[i]`` is (kind, d, cand, max_taps, n_out, clamp_s16[, lanes,
    lane_offset]): kind "tiled", "general", "wide" take their entry points,
    "strided" and "strided_xla" (the JAX package's name for its XLA strided
    path) the strided entry, and "oracle" the gather oracle. ``tstrs[i]`` is
    the launch's strided kernel table or None (the strided entry takes none).
    Returns a tuple of outputs.
    """
    if tstrs is None:
        tstrs = (None,) * len(xs)
    outs = []
    for x, st, p, tstr in zip(xs, states, plans, tstrs):
        kind, d, cand, max_taps, n_out, clamp = p[:6]
        lanes, lane_offset = (p[6], p[7]) if len(p) > 6 else (None, 0)
        common = dict(max_taps=max_taps, n_out=n_out, clamp_s16=clamp, lanes=lanes,
                      lane_offset=lane_offset)
        if kind == "tiled":
            out, _ = resample_uniform_lanes_tiled(table, x, st, d=d, cand=cand,
                                                  table_strided=tstr, **common)
        elif kind == "general":
            out, _ = resample_uniform_lanes_general(table, x, st, table_strided=tstr,
                                                    **common)
        elif kind in ("strided", "strided_xla"):
            out, _ = resample_strided_phases(table, x, st, d=d, **common)
        elif kind == "wide":
            out, _ = resample_wide_taps(table, x, st, d=d, table_strided=tstr, **common)
        elif kind == "oracle":
            out = oracle_launch(table, x, st, kind=kind, **common)
        else:
            raise ValueError(f"unknown launch kind {kind!r}")
        outs.append(out)
    return tuple(outs)


def entry_launch_args(kind: str, table, x, state, *, d: int, cand, max_taps: int, n_out: int,
                      table_strided=None, partial=None) -> tuple:
    """(C entry, its arguments by name without the outputs') of the launch
    that the ``kind`` entry ("tiled", "general", "strided" or "wide") makes
    on a card over all of x's lanes, checked as the entry checks it, for a
    caller that repeats the launch with other pointers (a farm's program).
    ``partial`` is the wide launch's scratch
    (_build.wide_scratch)."""
    _check_x(x)
    if n_out % FRAMES_PER_TILE:
        raise ValueError(f"n_out must be a multiple of 8, got {n_out}")
    common = dict(max_taps=max_taps, n_out=n_out, lanes=x.shape[1], lane_offset=0)
    p0, f0, cfg = state.position_integer, state.position_fractional, state.cfg
    if kind in ("tiled", "general"):
        if kind == "tiled" and (d not in (0, 1) or not 1 <= cand <= 8):
            raise ValueError(f"tiled launches need d in (0, 1) and cand in [1, 8], got "
                             f"{d}, {cand}")
        frames, win_rows = stage_plan(max_taps, tiled_increment_bound(d, cand)
                                      if kind == "tiled" else GENERAL_MIN_INCREMENT)
        return "crt_tiled_mac", _build.tiled_launch_args(
            x, table, table_strided, p0, f0, cfg, frames_per_stage=frames, win_rows=win_rows,
            **common)
    if kind == "strided":
        if d < 2:
            raise ValueError(f"strided launches need d >= 2, got {d}")
        frames, win_rows = strided_stage_plan(d, max_taps)
        return "crt_strided_mac", _build.strided_launch_args(
            x, table, p0, f0, cfg, d=d, frames_per_tile=frames, win_rows=win_rows, **common)
    if kind == "wide":
        return "crt_wide_mac", _build.wide_launch_args(
            x, table, table_strided, p0, f0, cfg, partial, d=d, **common)
    raise ValueError(f"no kernel launch of kind {kind!r}")


# ---------------------------------------------------------------------------
# B streams, each at its own ratio and state, through one chunk call
# ---------------------------------------------------------------------------

def _stream_leaf(v, b: int, x) -> torch.Tensor:
    """A per-stream scalar as batch_mac_kernel reads it: a contiguous (b,)
    int32 tensor on x's device, as it comes or made so. A one-element tensor
    serves every stream (a 0-dim leaf of a 2-D call); a Python int is filled
    on the device."""
    if not isinstance(v, torch.Tensor):
        return torch.full((b,), int(v), dtype=torch.int32, device=x.device)
    if v.dtype == torch.int32 and v.get_device() == x.get_device():
        if v.shape == (b,) and v.is_contiguous():
            return v
        if b == 1 and v.dim() == 0:
            return v.reshape(1)
    v = v.to(device=x.device, dtype=torch.int32)
    return v.reshape(-1).expand(b).contiguous()


def resample_streams(table, x, totals, state, quota, *, max_taps: int, n_out: int):
    """One LowLevel_Resample call for each of B streams: the contract and
    return of ``lowlevel.resample_chunk`` (``x`` (S, C) or (B, S, C) int16 or
    int32, ``totals``, ``quota`` and the leaves of ``state`` scalars or (B,)),
    n_out at most lowlevel.MAX_CHUNK_OUTPUT_FRAMES.

    On a CUDA tensor this is one launch of ``batch_mac_kernel``, which reads
    every stream's state, configuration, input count and quota from device
    memory (no host sync, no gather, no split of the batch) and computes its
    frames, zero from ``produced`` on, and its bookkeeping. On the CPU it is
    the plain version, the gather oracle's chunk call
    ``lowlevel.resample_chunk_reference``, counted as ("batch", "oracle").
    """
    from clownresampler_tpu_torch import lowlevel  # lowlevel imports this module

    if n_out > lowlevel.MAX_CHUNK_OUTPUT_FRAMES:
        raise ValueError(f"n_out {n_out} exceeds {lowlevel.MAX_CHUNK_OUTPUT_FRAMES}")
    if plain_route(x, "batch"):
        return lowlevel.resample_chunk_reference(table, x, totals, state, quota,
                                                 max_taps=max_taps, n_out=n_out)
    single = x.dim() == 2
    xb = x[None] if single else x
    leaf = functools.partial(_stream_leaf, b=xb.shape[0], x=xb)
    out, produced, consumed, p, f, exhausted = _build.batch_mac(
        xb, table, leaf(totals), leaf(quota), leaf(state.position_integer),
        leaf(state.position_fractional), state.cfg._make(map(leaf, state.cfg)),
        max_taps=max_taps, n_out=n_out)
    ROUTES[("batch", "cuda")] += 1
    if single:
        out = out[0]
        produced, consumed, p, f, exhausted = (
            v.reshape(()) for v in (produced, consumed, p, f, exhausted))
    return (out, produced, consumed,
            state._replace(position_integer=p, position_fractional=f), exhausted)


# ---------------------------------------------------------------------------
# Dispatch planning
# ---------------------------------------------------------------------------

def plan_uniform(increment: int, n_out: int) -> dict:
    """Choose a ratio class + static params for a launch at this increment.

    tiled   — tiled_mac_kernel; d = increment>>16 in {0,1}
    strided — strided_mac_kernel; fractional part == 0, d >= 2
    general — tiled_mac_kernel; any other ratio
              (wide downsampling)

    Tap widths past lowlevel.FAST_KERNEL_MAX_TAPS, and general launches from
    lowlevel.GENERAL_WIDE_MIN_TAPS, take the wide class (wide_mac_kernel)
    whatever this returns (lowlevel.launch_kind).
    """
    d = increment >> 16
    lo = increment & 0xFFFF
    if d <= 1:
        # eps(k) = ceil((a + k*lo)/2^16) - ceil(a/2^16) <= ceil(7*lo/2^16)
        # over an 8-frame tile (7*lo is never a multiple of 2^16 for 0<lo<2^16,
        # so the ceil covers the floor+1 worst case).
        cand = 1 + (0xFFFF + 7 * lo) // 65536
        return {"kernel": "tiled", "d": d, "cand": min(cand, 8)}
    if lo == 0:
        return {"kernel": "strided", "d": d}
    return {"kernel": "general", "d": d}
