"""Uniform-ratio launches: precompute, the CUDA kernels, and their plain versions.

Counterpart of ``clownresampler_tpu/ops/pallas_resample.py``. Input is
lane-major ``x (S, L) int32`` (sign-extended s16 samples) with L = streams x
channels on the fast axis; every lane shares the launch's phase sequence, so
the per-frame quantities (window row, masked LUT taps, 17.15 reciprocal) are
computed once per launch by ``precompute_launch`` (torch ops) and broadcast
across lanes. What is left is the dense multiply-accumulate with the C
reference's per-term truncation, which the kernels in csrc/ perform.

Ratio classes (``plan_uniform``):
  tiled   -- d = increment >> 16 in {0, 1}: every upsample and every
             downsample under 2x (the farm's headline 48k->44.1k included).
             ``tiled_mac_kernel`` stages each block's shared window in
             shared memory.
  general -- d >= 2 with a nonzero fraction (e.g. 44.1k->8k).
             ``general_mac_kernel`` reads each frame's window directly.
  strided -- exact integer strides (fraction 0, d >= 2). No kernel yet: the
             gather oracle (ops/convolve.py) serves it on every device.

Each entry point takes the tensor's device as the route: a CUDA tensor goes
to the kernel (and raises if it cannot launch), a CPU tensor to the plain
PyTorch version beside it (``*_reference``). ``ROUTES`` counts which route
every launch took.
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


def mac_reference(x, rows, kvals, q, lanes, lane_offset, clamp_s16):
    """The plain PyTorch multiply-accumulate both kernels implement, on the
    kernels' own inputs (launch rows, masked taps, reciprocals): one
    (N, lanes) row gather per tap, C-truncated product, int32 accumulate,
    17.15 normalise, optional s16 clamp."""
    xs = x[:, lane_offset : lane_offset + lanes]
    acc = torch.zeros((rows.shape[0], lanes), dtype=torch.int32, device=x.device)
    for t in range(kvals.shape[1]):
        win = xs.index_select(0, rows + t)
        acc += fx.fixed_mul_trunc(win, kvals[:, t : t + 1])
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
# Several launches in a row, and the oracle route
# ---------------------------------------------------------------------------

def oracle_launch(table, x, state, *, kind: str, max_taps: int, n_out: int,
                  clamp_s16: bool = False, lanes: Optional[int] = None,
                  lane_offset: int = 0):
    """A launch through the gather oracle (ops/convolve.py), for the classes
    without a kernel (``kind`` names the class for ROUTES)."""
    lanes = _lane_range(x, lanes, lane_offset)
    n = torch.arange(n_out, dtype=torch.int32, device=x.device)
    pos, frac = fx.positions_from_state(
        state.position_integer, state.position_fractional,
        state.cfg.increment_hi, state.cfg.increment_lo, n)
    out = convolve_frames(table, x[:, lane_offset : lane_offset + lanes], pos, frac,
                          state.cfg, max_taps)
    if clamp_s16:
        out = out.clamp(-0x7FFF, 0x7FFF).to(torch.int16)
    ROUTES[(kind, "oracle")] += 1
    return out


def multi_resample(table, xs: tuple, states: tuple, plans: tuple,
                   tstrs: Optional[tuple] = None) -> tuple:
    """Run several independent uniform-ratio launches, in order, on the
    current stream.

    ``plans[i]`` is (kind, d, cand, max_taps, n_out, clamp_s16[, lanes,
    lane_offset]): kind "tiled" and "general" take their entry points; any
    other kind ("strided", "wide", "oracle") goes to the gather oracle.
    Returns a tuple of outputs.
    """
    if tstrs is None:
        tstrs = (None,) * len(xs)
    outs = []
    for x, st, p, tstr in zip(xs, states, plans, tstrs):
        kind, d, cand, max_taps, n_out, clamp = p[:6]
        lanes, lane_offset = (p[6], p[7]) if len(p) > 6 else (None, 0)
        if kind == "tiled":
            out, _ = resample_uniform_lanes_tiled(
                table, x, st, max_taps=max_taps, n_out=n_out, d=d, cand=cand,
                clamp_s16=clamp, lanes=lanes, lane_offset=lane_offset,
                table_strided=tstr)
        elif kind == "general":
            out, _ = resample_uniform_lanes_general(
                table, x, st, max_taps=max_taps, n_out=n_out, clamp_s16=clamp,
                lanes=lanes, lane_offset=lane_offset, table_strided=tstr)
        else:
            out = oracle_launch(table, x, st, kind=kind, max_taps=max_taps,
                                n_out=n_out, clamp_s16=clamp, lanes=lanes,
                                lane_offset=lane_offset)
        outs.append(out)
    return tuple(outs)


# ---------------------------------------------------------------------------
# Dispatch planning
# ---------------------------------------------------------------------------

def plan_uniform(increment: int, n_out: int) -> dict:
    """Choose a ratio class + static params for a launch at this increment.

    tiled   — tiled_mac_kernel; d = increment>>16 in {0,1}
    strided — no kernel yet (gather oracle); fractional part == 0, d >= 2
    general — general_mac_kernel; any other ratio (wide downsampling)
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
