"""Lowest-level configuration: ratio math and kernel stretching.

Mirrors ClownResampler_LowestLevel_Configure (clownresampler.h:963-984) as a
pure host function over exact Python ints. The derived values parameterise
the device launches as per-launch scalars, so a ratio change (pitch bend)
changes no tensor shape; only the *maximum* kernel radius bounds the tap
window, mirroring the high-level rule that Adjust may not grow the radius
past its Init-time value (clownresampler.h:1195).
"""

from __future__ import annotations

from dataclasses import dataclass

from clownresampler_tpu_torch import fixedpoint as fx

# Reference compile-time limits (clownresampler.h:445-460, 974).
MAXIMUM_CHANNELS = 16
MAX_KERNEL_SCALE_INT = 0x1000


@dataclass(frozen=True)
class Configuration:
    """Derived per-ratio parameters (all plain ints; 16.16 where noted).

    Field-for-field equivalent of ClownResampler_LowestLevel_Configuration
    (clownresampler.h:632-638).
    """

    stretched_kernel_radius: int        # 16.16
    integer_stretched_kernel_radius: int
    stretched_kernel_radius_delta: int  # 16.16, < 65536
    kernel_step_size: int

    radius: int = 3
    resolution: int = 0x400


def configure(
    input_rate: int,
    output_rate: int,
    low_pass_rate: int,
    *,
    radius: int = 3,
    resolution: int = 0x400,
) -> Configuration | None:
    """Compute stretching parameters; None on failure.

    The kernel is only ever stretched (the low-pass rate is clamped to
    min(input, output, lpf), clownresampler.h:968), the radius is stretched
    by the scale and rounded up, and the LUT step is the table resolution
    scaled by the inverse ratio.

    Like the JAX package, this rejects configurations whose
    kernel_step_size floors to 0 (kernel_scale > resolution), which the
    reference accepts but then divides by zero on (clownresampler.h:1025).
    """
    actual_low_pass_rate = min(input_rate, min(output_rate, low_pass_rate))
    kernel_scale = fx.calculate_ratio(input_rate, actual_low_pass_rate)
    inverse_kernel_scale = fx.calculate_ratio(actual_low_pass_rate, input_rate)

    if kernel_scale >= fx.to_fixed(MAX_KERNEL_SCALE_INT):
        return None

    stretched = radius * kernel_scale
    integer_stretched = fx.fixed_ceil(stretched)
    delta = fx.to_fixed(integer_stretched) - stretched
    if not 0 <= delta < fx.to_fixed(1):
        raise ArithmeticError(f"stretch delta {delta} outside [0, 1.0)")
    step = (resolution * inverse_kernel_scale) >> 16
    if step == 0:
        return None  # the reference divides by zero here; see docstring

    return Configuration(
        stretched_kernel_radius=stretched,
        integer_stretched_kernel_radius=integer_stretched,
        stretched_kernel_radius_delta=delta,
        kernel_step_size=step,
        radius=radius,
        resolution=resolution,
    )
