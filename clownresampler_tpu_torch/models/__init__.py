"""Filter model definitions: Lanczos kernel families and quality presets.

The reference exposes the filter design as compile-time knobs
(CLOWNRESAMPLER_KERNEL_RADIUS / CLOWNRESAMPLER_KERNEL_RESOLUTION,
clownresampler.h:443-454). Here each (radius, resolution) pair is a
``KernelModel``; the default model reproduces the reference bit-exactly.
"""

from clownresampler_tpu_torch.models.lanczos import (
    DEFAULT_MODEL,
    HIGH_QUALITY_MODEL,
    LOW_COST_MODEL,
    KernelModel,
    lanczos_kernel_table,
    table_tensor,
)

__all__ = [
    "KernelModel",
    "lanczos_kernel_table",
    "table_tensor",
    "DEFAULT_MODEL",
    "HIGH_QUALITY_MODEL",
    "LOW_COST_MODEL",
]
