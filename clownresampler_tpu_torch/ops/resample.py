"""Uniform-ratio launches: precompute, the CUDA kernels, and their plain versions.

Counterpart of ``clownresampler_tpu/ops/pallas_resample.py``. Input is
lane-major ``x (S, L) int32`` (sign-extended s16 samples) with L = streams x
channels on the fast axis; every lane shares the launch's phase sequence, so
the per-frame quantities (window row, masked LUT taps, 17.15 reciprocal) are
computed once per launch by ``precompute_launch`` (torch ops) and broadcast
across lanes. What is left is the dense multiply-accumulate with the C
reference's per-term truncation, which the kernels in csrc/ perform.

Ratio classes (``plan_uniform``, then the tap width):
  tiled   -- d = increment >> 16 in {0, 1}: every upsample and every
             downsample under 2x (the farm's headline 48k->44.1k included).
             ``tiled_mac_kernel`` stages each block's shared window in
             shared memory.
  general -- d >= 2 with a nonzero fraction (e.g. 44.1k->8k).
             ``general_mac_kernel`` reads each frame's window directly.
  strided -- exact integer strides (fraction 0, d >= 2, e.g. 96k->48k).
             One tap vector and one reciprocal serve the launch;
             ``strided_mac_kernel`` stages each block's windows.
  wide    -- tap widths past 1024 (lowlevel.FAST_KERNEL_MAX_TAPS, e.g.
             44.1k->132), any increment, and general-class launches from
             lowlevel.GENERAL_WIDE_MIN_TAPS taps. ``wide_mac_kernel`` splits
             the tap axis across blocks and a fold kernel sums and
             normalises.

Each entry point takes the tensor's device as the route: a CUDA tensor goes
to the kernel (and raises if it cannot launch), a CPU tensor to the plain
PyTorch version beside it (``*_reference``). ``ROUTES`` counts which route
every launch took. The gather oracle (ops/convolve.py) is the reference all
of them are tested against; it serves only an explicit "oracle" launch.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops.convolve import convolve_frames, window_geometry

FRAMES_PER_TILE = 8
# Frames per thread block of tiled_mac_kernel; the block's shared window
# spans at most 63*d + 9*(cand - 1) + max_taps rows (tiled_window_rows).
TILED_FRAMES_PER_BLOCK = 64
# strided_mac_kernel stages (F - 1)*d + T rows of 32 lanes per block; F is
# the largest power of two up to 64 whose window fits this budget (48 KiB
# keeps four 256-thread blocks on an SM), else 1 (strided_frames_per_block).
STRIDED_MAX_FRAMES_PER_BLOCK = 64
STRIDED_SHARED_BUDGET = 48 * 1024
# Taps per wide_mac_kernel block: 96-128 measured fastest, or within 10% of
# it, on the H100 from 352 to 6016 taps at 64 to 4096 frames (PERF.md).
WIDE_TAP_BLOCK = 128
# Bound on frames x taps of one wide launch (the dispatchers tile longer
# emits, wide_launch_frames): the launch precompute's (N, T) tap matrix
# costs N*T*4 bytes, 24.6 MB here (1024 frames at 6016 taps).
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
    """Per-output-frame scalars for a uniform-ratio launch.

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


def tiled_window_rows(d: int, cand: int, max_taps: int) -> int:
    """Rows of the shared window one tiled block stages.

    rows[n] = p0 + ceil((f0 + n*inc + delta) / 2^16), so across the
    TILED_FRAMES_PER_BLOCK - 1 = 63 frame steps of a block the first row
    advances by at most ceil(63*inc / 2^16) = 63*d + ceil(63*lo / 2^16), and
    plan_uniform's cand = 1 + ceil(7*lo / 2^16) bounds the second term by
    9*(cand - 1)."""
    return (TILED_FRAMES_PER_BLOCK - 1) * d + 9 * (cand - 1) + max_taps


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


def _check_x(x):
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"x must be (S, L) int32, got {x.dtype} {tuple(x.shape)}")


def _takes_reference(x, kind: str) -> bool:
    """True (and counted) when x lies on the CPU, where the plain version
    runs; False on a CUDA card, where the kernel runs. Any other device is
    refused."""
    if x.device.type == "cpu":
        ROUTES[(kind, "reference")] += 1
        return True
    if x.device.type != "cuda":
        raise ValueError(f"no {kind} route for device {x.device}")
    return False


# ---------------------------------------------------------------------------
# Tiled class: d in {0, 1}
# ---------------------------------------------------------------------------

def resample_uniform_lanes_tiled_reference(
    table, x, state, *, max_taps: int, n_out: int, d: int, cand: int,
    clamp_s16: bool = False, lanes: Optional[int] = None, lane_offset: int = 0,
    table_strided=None,
):
    """Plain PyTorch version of ``resample_uniform_lanes_tiled``."""
    _check_x(x)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=n_out, table_strided=table_strided)
    rl = launch_rows(rows, x.shape[0], max_taps)
    return mac_reference(x, rl, kvals, q, lanes, lane_offset, clamp_s16), rows


def resample_uniform_lanes_tiled(
    table, x, state, *, max_taps: int, n_out: int, d: int, cand: int,
    clamp_s16: bool = False, lanes: Optional[int] = None, lane_offset: int = 0,
    table_strided=None,
):
    """Fast-path uniform-ratio resample; requires increment < 2^17, i.e.
    d = increment >> 16 in {0, 1} and cand = plan_uniform's candidate count.

    The caller pads x so that every real frame's window [row, row + max_taps)
    fits in its S rows. ``lanes``/``lane_offset`` run the launch over a column
    slice of x with no copy. Returns (out (n_out, lanes) int32 -- int16 when
    ``clamp_s16`` -- and rows (n_out,)).
    """
    _check_x(x)
    if d not in (0, 1) or not 1 <= cand <= 8:
        raise ValueError(f"tiled launches need d in (0, 1) and cand in [1, 8], got {d}, {cand}")
    if _takes_reference(x, "tiled"):
        return resample_uniform_lanes_tiled_reference(
            table, x, state, max_taps=max_taps, n_out=n_out, d=d, cand=cand,
            clamp_s16=clamp_s16, lanes=lanes, lane_offset=lane_offset,
            table_strided=table_strided)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=n_out, table_strided=table_strided)
    out = _build.tiled_mac(
        x, launch_rows(rows, x.shape[0], max_taps), kvals, q, lanes=lanes,
        lane_offset=lane_offset, frames_per_block=TILED_FRAMES_PER_BLOCK,
        win_rows=tiled_window_rows(d, cand, max_taps), clamp_s16=clamp_s16)
    ROUTES[("tiled", "cuda")] += 1
    return out, rows


# ---------------------------------------------------------------------------
# General class: any increment (used for d >= 2 with a nonzero fraction)
# ---------------------------------------------------------------------------

def resample_uniform_lanes_general_reference(
    table, x, state, *, max_taps: int, n_out: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, table_strided=None,
):
    """Plain PyTorch version of ``resample_uniform_lanes_general``."""
    _check_x(x)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=n_out, table_strided=table_strided)
    rl = launch_rows(rows, x.shape[0], max_taps)
    return mac_reference(x, rl, kvals, q, lanes, lane_offset, clamp_s16), rows


def resample_uniform_lanes_general(
    table, x, state, *, max_taps: int, n_out: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, table_strided=None,
):
    """Any-ratio uniform-lane resample (the general class: increment >= 2^17
    with a nonzero fraction). Same contract and return as the tiled entry."""
    _check_x(x)
    if _takes_reference(x, "general"):
        return resample_uniform_lanes_general_reference(
            table, x, state, max_taps=max_taps, n_out=n_out, clamp_s16=clamp_s16,
            lanes=lanes, lane_offset=lane_offset, table_strided=table_strided)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=n_out, table_strided=table_strided)
    out = _build.general_mac(
        x, launch_rows(rows, x.shape[0], max_taps), kvals, q, lanes=lanes,
        lane_offset=lane_offset, clamp_s16=clamp_s16)
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


def strided_frames_per_block(d: int, max_taps: int) -> int:
    """Frames per strided_mac_kernel block: the largest power of two up to
    STRIDED_MAX_FRAMES_PER_BLOCK whose staged window fits
    STRIDED_SHARED_BUDGET, else 1 (a single window, opted in up to the
    card's limit)."""
    f = STRIDED_MAX_FRAMES_PER_BLOCK
    while f > 1 and _build.strided_shared_bytes(f, d, max_taps) > STRIDED_SHARED_BUDGET:
        f //= 2
    return f


def resample_strided_reference(
    table, x, state, *, max_taps: int, n_out: int, d: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0,
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
    return out, rows


def resample_strided_phases(
    table, x, state, *, max_taps: int, n_out: int, d: int, group: int = 8,
    clamp_s16: bool = False, lanes: Optional[int] = None, lane_offset: int = 0,
):
    """Exact-integer-stride resample (increment fraction 0, d = increment >> 16
    >= 2, e.g. 96k->48k). ``group`` is accepted for the JAX signature and has
    no effect. The caller pads x so that every real frame's window fits;
    padding frames' windows are clamped into x. Returns (out (n_out, lanes)
    int32 -- int16 when ``clamp_s16`` -- and rows (n_out,))."""
    _check_x(x)
    if d < 2:
        raise ValueError(f"strided launches need d >= 2, got {d}")
    if _takes_reference(x, "strided"):
        return resample_strided_reference(
            table, x, state, max_taps=max_taps, n_out=n_out, d=d, clamp_s16=clamp_s16,
            lanes=lanes, lane_offset=lane_offset)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, r0, k0, q0 = strided_setup(table, state, max_taps=max_taps, n_out=n_out, d=d)
    out = _build.strided_mac(
        x, r0, k0, q0, n_out=n_out, d=d, lanes=lanes, lane_offset=lane_offset,
        frames_per_block=strided_frames_per_block(d, max_taps), clamp_s16=clamp_s16)
    ROUTES[("strided", "cuda")] += 1
    return out, rows


def resample_strided_phases_wide(
    table, x, state, *, max_taps: int, n_out: int, d: int, group: int = 8,
    clamp_s16: bool = False, lanes: Optional[int] = None, lane_offset: int = 0,
):
    """The JAX package's large-buffer strided entry. Its TPU kernel exists
    for the v5e's VMEM budget; here ``strided_mac_kernel`` serves every
    buffer size, so this is ``resample_strided_phases``."""
    return resample_strided_phases(
        table, x, state, max_taps=max_taps, n_out=n_out, d=d, group=group,
        clamp_s16=clamp_s16, lanes=lanes, lane_offset=lane_offset)


# ---------------------------------------------------------------------------
# Wide class: tap widths past lowlevel.FAST_KERNEL_MAX_TAPS, any increment
# ---------------------------------------------------------------------------

def wide_launch_frames(max_taps: int) -> int:
    """Most frames a dispatcher gives one wide launch: its (N, T) tap matrix
    stays within WIDE_MAX_TAP_MATRIX ints (1024 frames at 6016 taps, 24,064
    at 256), in whole 8-frame tiles."""
    return max(FRAMES_PER_TILE,
               WIDE_MAX_TAP_MATRIX // max_taps // FRAMES_PER_TILE * FRAMES_PER_TILE)


def resample_wide_taps_reference(
    table, x, state, *, max_taps: int, n_out: int, d: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, table_strided=None,
    pipeline: Optional[bool] = None,
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
    return out, rows


def resample_wide_taps(
    table, x, state, *, max_taps: int, n_out: int, d: int, clamp_s16: bool = False,
    lanes: Optional[int] = None, lane_offset: int = 0, table_strided=None,
    pipeline: Optional[bool] = None,
):
    """Any-ratio resample for wide tap windows: the dispatchers send every
    width past 1024 (up to 6016 at radius 3007) and general-class widths
    from lowlevel.GENERAL_WIDE_MIN_TAPS. ``d`` (increment >> 16) and
    ``pipeline`` are accepted for the JAX signature and have no effect. Same
    contract and return as the tiled entry; the dispatchers keep n_out <=
    wide_launch_frames(max_taps)."""
    _check_x(x)
    if _takes_reference(x, "wide"):
        return resample_wide_taps_reference(
            table, x, state, max_taps=max_taps, n_out=n_out, d=d, clamp_s16=clamp_s16,
            lanes=lanes, lane_offset=lane_offset, table_strided=table_strided)
    lanes = _lane_range(x, lanes, lane_offset)
    rows, kvals, q, _eps, _tile_rows = precompute_launch(
        table, state, max_taps=max_taps, n_out=n_out, table_strided=table_strided)
    out = _build.wide_mac(
        x, launch_rows(rows, x.shape[0], max_taps), kvals, q, lanes=lanes,
        lane_offset=lane_offset, tap_block=WIDE_TAP_BLOCK, clamp_s16=clamp_s16)
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


# ---------------------------------------------------------------------------
# Dispatch planning
# ---------------------------------------------------------------------------

def plan_uniform(increment: int, n_out: int) -> dict:
    """Choose a ratio class + static params for a launch at this increment.

    tiled   — tiled_mac_kernel; d = increment>>16 in {0,1}
    strided — strided_mac_kernel; fractional part == 0, d >= 2
    general — general_mac_kernel; any other ratio (wide downsampling)

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
