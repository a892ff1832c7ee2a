"""16.16 fixed-point arithmetic with C-exact semantics, as torch ops.

The reference library (clownresampler.h:615-625) works in 16.16 fixed point
with C integer division, which truncates toward zero. torch's ``>>`` and
``//`` round toward minus infinity, so every signed division here goes
through ``rounding_mode="trunc"`` instead. The GPU has native 64-bit integer
multiply and divide, so the two places that need more than 32 bits (the
17.15 reciprocal and the final normalisation) use the direct C form in int64.

Host-side bookkeeping (stream positions, frame counts) uses arbitrary-precision
Python ints, so it can never overflow regardless of stream length.
"""

from __future__ import annotations

import torch


def round_up(x: int, m: int) -> int:
    """Smallest multiple of m >= x (shared alignment helper)."""
    return -(-x // m) * m


# 16.16 layout (clownresampler.h:620).
FRACTIONAL_BITS = 16
FRACTIONAL_SIZE = 1 << FRACTIONAL_BITS
FRACTIONAL_MASK = FRACTIONAL_SIZE - 1

# Sentinel returned by the ratio computation for zero rates or overflow
# (clownresampler.h:919-920, 938-940).
RATIO_SENTINEL = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Host (Python int, exact, unbounded) versions
# ---------------------------------------------------------------------------

def calculate_ratio(a: int, b: int) -> int:
    """floor(a * 65536 / b) with the reference's sentinel/saturation rules
    (ClownResampler_CalculateRatio, clownresampler.h:913-953)."""
    if a == 0 or b == 0:
        return RATIO_SENTINEL
    result = (a << FRACTIONAL_BITS) // b
    if result >= 1 << 32:
        return RATIO_SENTINEL
    if result == 0:
        return 1  # underflow clamps to the smallest increment (948-950)
    return result


def to_fixed(x: int) -> int:
    return x << FRACTIONAL_BITS


def fixed_floor(x: int) -> int:
    """Only valid for x >= 0 (the reference applies it to unsigned values)."""
    return x >> FRACTIONAL_BITS


def fixed_ceil(x: int) -> int:
    return (x + FRACTIONAL_MASK) >> FRACTIONAL_BITS


def fixed_round(x: int) -> int:
    return (x + FRACTIONAL_SIZE // 2) >> FRACTIONAL_BITS


# ---------------------------------------------------------------------------
# Device (torch int32 / int64) versions
# ---------------------------------------------------------------------------

def trunc_shr(x: torch.Tensor, bits: int) -> torch.Tensor:
    """C-style ``x / (1 << bits)`` for signed integers: truncation toward 0."""
    return torch.div(x, 1 << bits, rounding_mode="trunc")


def fixed_mul_trunc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C ``(a * b) / 65536`` for int32 values whose product fits in int32
    (CLOWNRESAMPLER_FIXED_POINT_MULTIPLY, clownresampler.h:625, as used in the
    convolution hot loop at 1020: a sign-extended s16 sample times a table
    value in [-9651, 65536], so the product spans exactly [-2^31, 2^31))."""
    return trunc_shr(a * b, FRACTIONAL_BITS)


def floor_shr16_nonneg(x):
    """``x >> 16`` for values known non-negative (floor == trunc)."""
    return x >> FRACTIONAL_BITS


def ceil_shr16_nonneg(x):
    """C CEILING macro (clownresampler.h:624) for non-negative values."""
    return (x + FRACTIONAL_MASK) >> FRACTIONAL_BITS


def reciprocal_q31(denom: torch.Tensor) -> torch.Tensor:
    """C ``0x80000000 / denom`` (clownresampler.h:1025) as int32.

    One int64 truncating division. |denom| is floored at 2 so the quotient
    fits int32 and a zero sum (never realised by a real window) cannot trap;
    the sign is put back afterwards, as C's truncating division would.
    """
    d = denom.to(torch.int64)
    m = d.abs().clamp_min(2)
    q = torch.div(torch.full_like(m, 1 << 31), m, rounding_mode="trunc")
    return torch.where(d < 0, -q, q).to(torch.int32)


def mul_shift15(acc: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """C ``(acc * q) / (1 << 15)`` (clownresampler.h:1033): an int64 product,
    then a truncating division, narrowed to int32 (the result is the output
    sample, which fits int32 for every real normalisation)."""
    p = acc.to(torch.int64) * q.to(torch.int64)
    return torch.div(p, 1 << 15, rounding_mode="trunc").to(torch.int32)


def split_increment(increment: int) -> tuple[int, int]:
    """Split a 16.16 increment into (hi, lo) 16-bit halves (see
    positions_from_state)."""
    return increment >> 16, increment & 0xFFFF


def positions_from_state(p0, f0, inc_hi, inc_lo, n):
    """Closed-form phase positions for output frames ``n`` (int32 vector).

    The reference advances the phase accumulator per output frame
    (clownresampler.h:1076-1078), which telescopes to
    t(n) = f0 + n*increment, pos(n) = p0 + (t >> 16), frac(n) = t & 0xFFFF.
    The increment is split into 16-bit halves so that f0 + n*inc_lo stays in
    int32 for n < 2^15; callers tile longer runs and carry p0/f0 between
    tiles in exact Python ints.
    """
    t_lo = f0 + n * inc_lo
    frac = t_lo & 0xFFFF
    pos = p0 + n * inc_hi + (t_lo >> 16)
    return pos, frac
