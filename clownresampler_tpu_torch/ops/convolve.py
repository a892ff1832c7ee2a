"""Batched windowed-sinc convolution as a torch gather: the port's oracle.

Re-expresses ClownResampler_LowestLevel_Resample (clownresampler.h:986-1035)
as a data-parallel computation over a vector of output frames. Per output
frame n with phase (pos, frac) the reference computes:
  min_rel      = ceil16(frac + delta)                        (993)
  max_rel      = floor16(frac + stretched_radius)            (994)
  taps         = int_radius + max_rel - min_rel              (995-996)
  kernel_start = (step * ((min_rel << 16) - frac)) >> 16     (1001)
  acc[c]       = sum_j trunc((x[pos+min_rel+j, c] * K[kernel_start+j*step]) / 2^16)
  norm         = sum_j K[...]                                (1008-1021)
  out[c]       = trunc((acc[c] * trunc(2^31 / norm)) / 2^15) (1025, 1033)

Windows are padded to a fixed ``max_taps`` and masked: a masked tap adds
kernel value 0 to both the accumulator and the normaliser, which is exactly
equivalent to not iterating it. This module serves the ratio classes that
have no hand-written kernel yet (strided and wide) on every device, and is
the reference that the kernels and their plain versions are tested against.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from clownresampler_tpu_torch import fixedpoint as fx


class ConfigScalars(NamedTuple):
    """0-dim int32 tensors mirroring ClownResampler_LowestLevel_Configuration
    plus the phase increment. Build from a host Configuration with
    ``from_configuration``."""

    stretched_kernel_radius: torch.Tensor        # 16.16
    integer_stretched_kernel_radius: torch.Tensor
    stretched_kernel_radius_delta: torch.Tensor  # 16.16
    kernel_step_size: torch.Tensor
    increment: torch.Tensor                      # 16.16 (info only; hi/lo are authoritative)
    increment_hi: torch.Tensor
    increment_lo: torch.Tensor

    @classmethod
    def from_configuration(cls, cfg, increment: int,
                           device: torch.device = torch.device("cpu")) -> "ConfigScalars":
        hi, lo = fx.split_increment(increment)
        return cls.from_fields(
            (cfg.stretched_kernel_radius, cfg.integer_stretched_kernel_radius,
             cfg.stretched_kernel_radius_delta, cfg.kernel_step_size,
             increment & 0x7FFFFFFF, hi, lo),
            device,
        )

    @classmethod
    def from_fields(cls, fields, device: torch.device) -> "ConfigScalars":
        """From seven integers in field order (one host-to-device copy)."""
        t = torch.tensor([int(v) for v in fields], dtype=torch.int32).to(device)
        return cls(*t.unbind())


def window_geometry(cfg: ConfigScalars, frac: torch.Tensor):
    """(min_rel, max_rel, kernel_start, taps) for each phase fraction.

    All quantities are non-negative and fit int32: frac, delta < 2^16;
    step <= resolution; (min_rel << 16) - frac <= 2^17.
    """
    min_rel = fx.ceil_shr16_nonneg(frac + cfg.stretched_kernel_radius_delta)
    max_rel = fx.floor_shr16_nonneg(frac + cfg.stretched_kernel_radius)
    kernel_start = fx.floor_shr16_nonneg(
        cfg.kernel_step_size * ((min_rel << 16) - frac)
    )
    taps = cfg.integer_stretched_kernel_radius + max_rel - min_rel
    return min_rel, max_rel, kernel_start, taps


def convolve_frames(
    table: torch.Tensor,          # (table_size,) int32 kernel LUT
    input_samples: torch.Tensor,  # (S, C) int16/int32 padded input
    pos: torch.Tensor,            # (N,) integer positions (relative to input_samples)
    frac: torch.Tensor,           # (N,) 16.16 fractions in [0, 65536)
    cfg: ConfigScalars,
    max_taps: int,                # tap-window bound (>= 2 * max integer radius)
) -> torch.Tensor:
    """Compute N output frames bit-exactly; returns (N, C) int32."""
    dev = input_samples.device
    table_size = table.shape[0]
    pos = pos.to(device=dev, dtype=torch.int32)
    frac = frac.to(device=dev, dtype=torch.int32)

    min_rel, _max_rel, kernel_start, taps = window_geometry(cfg, frac)

    j = torch.arange(max_taps, dtype=torch.int32, device=dev)
    mask = j[None, :] < taps[:, None]                        # (N, T)

    kidx = kernel_start[:, None] + j[None, :] * cfg.kernel_step_size
    kidx = kidx.clamp(0, table_size - 1)                     # clamp masked taps
    kvals = torch.where(mask, table[kidx.long()], 0)

    rows = pos[:, None] + min_rel[:, None] + j[None, :]      # (N, T)
    rows = rows.clamp(0, input_samples.shape[0] - 1)
    x = input_samples.to(torch.int32)[rows.long()]           # (N, T, C)

    # Per-tap trunc-toward-zero scaling, then accumulate (clownresampler.h:1020).
    terms = fx.fixed_mul_trunc(x, kvals[:, :, None])
    acc = terms.sum(dim=1, dtype=torch.int32)                # (N, C)

    norm = kvals.sum(dim=1, dtype=torch.int32)               # (N,)
    q = fx.reciprocal_q31(norm)                              # 17.15 reciprocal (1025)

    return fx.mul_shift15(acc, q[:, None])                   # (N, C)
