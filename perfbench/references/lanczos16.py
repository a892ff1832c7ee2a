"""The plain reference the benchmark holds the port's outputs against.

A frozen, self-contained copy of the resampler's arithmetic: the C
library's 16.16 fixed-point Lanczos windowed sinc (clownresampler.h:892-1094
as SURVEY.md describes it), written in plain PyTorch from the C semantics.
It imports nothing of the package under test, so a change there cannot move
the yardstick.

An output frame n of a stream sits at the 16.16 phase t(n) = T0 + (n - N0) *
increment (one segment of constant ratio; a re-rated stream has several).
With pos = t >> 16 and frac = t & 0xFFFF, its window reads the stream's
frames pos + min_rel + j - radius for j < taps, zeros before frame 0 (the C
window contract puts stream frame 0 at row ``radius`` of the padded input):

  min_rel      = ceil16(frac + delta)
  max_rel      = floor16(frac + stretched_radius)
  taps         = integer_radius + max_rel - min_rel
  kernel_start = (step * ((min_rel << 16) - frac)) >> 16
  acc[c]       = sum_j trunc(x[row_j, c] * K[kernel_start + j*step] / 2^16)
  norm         = sum_j K[kernel_start + j*step]
  out[c]       = trunc(acc[c] * trunc(2^31 / norm) / 2^15)

``precision="truncate_once"`` is the control: the same sum with the per-tap
truncation dropped (the products summed in int64 and truncated once), the
step a faster kernel would be tempted to take. It breaks the configuration's
bit-exactness guarantee and must fail the comparison.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

FRACTIONAL_BITS = 16
MAX_KERNEL_SCALE = 0x1000 << FRACTIONAL_BITS
PRECISIONS = ("exact", "truncate_once")


def calculate_ratio(a: int, b: int) -> int:
    """floor(a * 2^16 / b), the C library's saturation rules."""
    if a == 0 or b == 0:
        return 0xFFFFFFFF
    result = (a << FRACTIONAL_BITS) // b
    if result >= 1 << 32:
        return 0xFFFFFFFF
    return max(result, 1)


@dataclass(frozen=True)
class Ratio:
    """One rate triple's derived 16.16 parameters and increment."""

    increment: int
    stretched_radius: int
    integer_radius: int
    delta: int
    step: int
    radius: int
    resolution: int

    @property
    def max_taps(self) -> int:
        return 2 * self.integer_radius


def ratio(input_rate: int, output_rate: int, low_pass_rate: int, *, radius: int = 3,
          resolution: int = 0x400) -> Ratio:
    """The C library's configuration of a rate triple (its low-pass rate
    clamped to the lower of the two rates)."""
    low_pass = min(input_rate, output_rate, low_pass_rate)
    scale = calculate_ratio(input_rate, low_pass)
    if scale >= MAX_KERNEL_SCALE:
        raise ValueError(f"unsupported ratio {input_rate} -> {output_rate}")
    stretched = radius * scale
    integer = (stretched + 0xFFFF) >> FRACTIONAL_BITS
    step = (resolution * calculate_ratio(low_pass, input_rate)) >> FRACTIONAL_BITS
    if step == 0:
        raise ValueError(f"kernel step 0 for {input_rate} -> {output_rate}")
    return Ratio(increment=calculate_ratio(input_rate, output_rate), stretched_radius=stretched,
                 integer_radius=integer, delta=(integer << FRACTIONAL_BITS) - stretched,
                 step=step, radius=radius, resolution=resolution)


def _lanczos(x: float, radius: float) -> float:
    x_pi = x * math.pi
    x_pi_r = x_pi / radius
    if x == 0.0:
        return 1.0
    return (math.sin(x_pi) * math.sin(x_pi_r)) / (x_pi * x_pi_r)


@functools.lru_cache(maxsize=None)
def kernel_table(radius: int = 3, resolution: int = 0x400) -> tuple:
    """The int 16.16 Lanczos table, entry i at x = (i/size*2 - 1)*radius,
    truncated toward zero (libm sin, IEEE double, as the C code)."""
    size = 2 * radius * resolution
    return tuple(math.trunc(_lanczos((i / float(size) * 2.0 - 1.0) * float(radius),
                                     float(radius)) * 65536.0) for i in range(size))


def geometry(t: torch.Tensor, r: Ratio):
    """(pos, min_rel, kernel_start, taps) of the frames at 16.16 phases t
    (int64)."""
    frac = t & 0xFFFF
    min_rel = (frac + r.delta + 0xFFFF) >> FRACTIONAL_BITS
    max_rel = (frac + r.stretched_radius) >> FRACTIONAL_BITS
    start = (r.step * ((min_rel << FRACTIONAL_BITS) - frac)) >> FRACTIONAL_BITS
    return t >> FRACTIONAL_BITS, min_rel, start, r.integer_radius + max_rel - min_rel


def live_taps(t: torch.Tensor, r: Ratio) -> int:
    """The taps the frames at phases t need, summed (the operations the
    benchmark's bound counts)."""
    return int(geometry(t.to(torch.int64), r)[3].clamp(0, r.max_taps).sum())


def _trunc_div(a: torch.Tensor, b: int) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="trunc")


def frames(t: torch.Tensor, r: Ratio, fetch, precision: str = "exact") -> torch.Tensor:
    """The output frames at phases ``t`` (M,) int64, (M, C) int32.

    ``fetch(rows)`` returns the stream samples at the stream frame numbers
    ``rows`` (M, T) int64 as (M, T, C) integers, zero for frames outside the
    stream (rows < 0 among them)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    dev = t.device
    table = torch.tensor(kernel_table(r.radius, r.resolution), dtype=torch.int64, device=dev)
    pos, min_rel, start, taps = geometry(t.to(torch.int64), r)
    j = torch.arange(r.max_taps, dtype=torch.int64, device=dev)
    mask = j < taps[:, None]
    k = table[(start[:, None] + j * r.step).clamp(0, table.numel() - 1)]
    k = torch.where(mask, k, 0)
    x = fetch(pos[:, None] + min_rel[:, None] + j - r.integer_radius).to(torch.int64)
    if precision == "exact":
        acc = _trunc_div(x * k[:, :, None], 1 << FRACTIONAL_BITS).sum(dim=1)
    else:
        acc = _trunc_div((x * k[:, :, None]).sum(dim=1), 1 << FRACTIONAL_BITS)
    norm = k.sum(dim=1)
    q = _trunc_div(torch.full_like(norm, 1 << 31), norm.abs().clamp_min(2))
    q = torch.where(norm < 0, -q, q)
    return _trunc_div(acc * q[:, None], 1 << 15).to(torch.int32)


def scan_books(r: Ratio, chunks: int, n_in: int, n_out: int) -> tuple:
    """A whole-stream scan's bookkeeping from state (0, 0): each step's
    produced frames, whether more than n_out were due, and the final state,
    as the C library's position carry gives them (exact integers).

    Step k's buffer starts at stream frame k*n_in - 2*radius; the state's
    position counts from there with a +radius bias, so frames are due
    while it stays below n_in."""
    p, f = r.integer_radius, 0
    produced, over = [], []
    for _ in range(chunks):
        num = ((n_in - p) << FRACTIONAL_BITS) - f
        natural = -(-num // r.increment) if num > 0 else 0
        n = min(natural, n_out)
        t = f + n * r.increment
        p, f = p + (t >> FRACTIONAL_BITS), t & 0xFFFF
        p -= min(p, n_in)
        produced.append(n)
        over.append(natural > n_out)
    return produced, over, (p - r.integer_radius, f)
