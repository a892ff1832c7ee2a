"""Lanczos windowed-sinc kernel table generation.

Reproduces ClownResampler_Precompute / ClownResampler_LanczosKernel
(clownresampler.h:892-908, 955-961) bit-exactly: the table is computed in
IEEE double precision on the host with the platform libm ``sin`` (via
math.sin, the same routine the C reference calls) and truncated toward zero
into int32 16.16 values. numpy's vectorised sin is deliberately not used: its
SIMD polynomial can differ from libm by an ulp, which after truncation would
flip table entries. Tables are numpy arrays; ``table_tensor`` moves one to a
device.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch

# The reference hardcodes pi to 100 digits (clownresampler.h:896); parsed to a
# double this is identical to math.pi, but keep the literal for auditability.
_PI_100 = float(
    "3.1415926535897932384626433832795028841971693993751058209749445923078164"
    "062862089986280348253421170679"
)


@dataclass(frozen=True)
class KernelModel:
    """A filter model: one (radius, resolution) windowed-sinc design.

    radius: lobes of the sinc window (CLOWNRESAMPLER_KERNEL_RADIUS, default 3).
    resolution: table samples per lobe (CLOWNRESAMPLER_KERNEL_RESOLUTION,
    default 1024).
    """

    radius: int = 3
    resolution: int = 0x400

    @property
    def table_size(self) -> int:
        # clownresampler.h:629 — KERNEL_RADIUS * 2 * KERNEL_RESOLUTION entries.
        return self.radius * 2 * self.resolution

    def table(self) -> np.ndarray:
        return lanczos_kernel_table(self.radius, self.resolution)

    def strided_table(self, step: int, max_taps: int) -> np.ndarray:
        """(2*step + 2, max_taps) row-gather layout of the LUT for a launch
        at kernel_step_size ``step``: entry [s, j] = table[clip(s + j*step)].

        The per-frame tap gather (clownresampler.h:1008, index kernel_start
        + j*step) then becomes one whole-row take at kernel_start, which is
        <= 2*step for every accepted config; out-of-range entries clip to the
        table end like the flat gather's index clip (they are always masked
        by the tap count)."""
        return _strided_kernel_table(self.radius, self.resolution, step, max_taps)


def table_tensor(table: np.ndarray, device: torch.device) -> torch.Tensor:
    """A kernel table (flat or strided) as a contiguous int32 tensor."""
    return torch.from_numpy(np.array(table, dtype=np.int32, order="C")).to(device)


def _lanczos(x: float, radius: float) -> float:
    """L(x) = sinc(x) * sinc(x/R) evaluated exactly like the C routine
    (clownresampler.h:892-908): same operation order, same libm sin."""
    x_times_pi = x * _PI_100
    x_times_pi_divided_by_radius = x_times_pi / radius
    if x == 0.0:
        return 1.0
    return (math.sin(x_times_pi) * math.sin(x_times_pi_divided_by_radius)) / (
        x_times_pi * x_times_pi_divided_by_radius
    )


@functools.lru_cache(maxsize=None)
def _strided_kernel_table(radius: int, resolution: int, step: int,
                          max_taps: int) -> np.ndarray:
    table = lanczos_kernel_table(radius, resolution)
    s = np.arange(2 * step + 2, dtype=np.int64)[:, None]
    j = np.arange(max_taps, dtype=np.int64)[None, :]
    idx = np.clip(s + j * step, 0, table.shape[0] - 1)
    out = np.ascontiguousarray(table[idx])
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=None)
def lanczos_kernel_table(radius: int = 3, resolution: int = 0x400) -> np.ndarray:
    """int32 16.16 kernel LUT, bit-identical to ClownResampler_Precompute.

    Entry i covers x in [-radius, +radius):
        table[i] = (int32) trunc( L((i/size * 2 - 1) * radius) * 65536 )
    with every float op in IEEE double and C's double->long truncation
    (clownresampler.h:960).
    """
    size = radius * 2 * resolution
    out = np.empty(size, dtype=np.int64)
    fradius = float(radius)
    for i in range(size):
        x = (i / float(size) * 2.0 - 1.0) * fradius
        out[i] = math.trunc(_lanczos(x, fradius) * 65536.0)
    table = out.astype(np.int32)
    table.setflags(write=False)
    return table


# Quality presets (the reference's compile-time trade-off, made runtime).
DEFAULT_MODEL = KernelModel(radius=3, resolution=0x400)
HIGH_QUALITY_MODEL = KernelModel(radius=10, resolution=0x400)
LOW_COST_MODEL = KernelModel(radius=2, resolution=0x200)
