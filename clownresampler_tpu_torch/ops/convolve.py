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
equivalent to not iterating it. This module is the reference that the
kernels and their plain versions are tested against, and the body of the
batched chunk call's plain version (lowlevel.resample_chunk_reference); on
a card every entry runs a hand-written kernel instead.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.device import DEFAULT_DEVICE, Device, resolve_device


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
                           device: Device = DEFAULT_DEVICE) -> "ConfigScalars":
        hi, lo = fx.split_increment(increment)
        return cls.from_fields(
            (cfg.stretched_kernel_radius, cfg.integer_stretched_kernel_radius,
             cfg.stretched_kernel_radius_delta, cfg.kernel_step_size,
             increment & 0x7FFFFFFF, hi, lo),
            device,
        )

    @classmethod
    def from_fields(cls, fields, device: Device) -> "ConfigScalars":
        """From seven integers in field order (one host-to-device copy)."""
        t = torch.tensor([int(v) for v in fields], dtype=torch.int32).to(resolve_device(device))
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
    input_samples: torch.Tensor,  # (S, C) int16/int32 padded input, or (B, S, C)
    pos: torch.Tensor,            # (N,) integer positions (relative to input_samples), or (B, N)
    frac: torch.Tensor,           # (N,) 16.16 fractions in [0, 65536), or (B, N)
    cfg: ConfigScalars,           # 0-dim fields, or (B, 1) fields with a batch
    max_taps: int,                # tap-window bound (>= 2 * max integer radius)
) -> torch.Tensor:
    """Compute N output frames bit-exactly; returns (N, C) int32.

    With a leading batch axis -- ``input_samples`` (B, S, C), ``pos`` and
    ``frac`` (B, N), every field of ``cfg`` (B, 1) -- stream b's frames come
    from ``input_samples[b]`` at its own configuration, all B streams in one
    set of torch ops; returns (B, N, C). The gather then holds B x N x
    max_taps x C ints several times over: callers bound B
    (batch.resample_batch_reference).
    """
    dev = input_samples.device
    table_size = table.shape[0]
    pos = pos.to(device=dev, dtype=torch.int32)
    frac = frac.to(device=dev, dtype=torch.int32)

    min_rel, _max_rel, kernel_start, taps = window_geometry(cfg, frac)

    j = torch.arange(max_taps, dtype=torch.int32, device=dev)
    mask = j < taps[..., None]                               # (..., N, T)

    kidx = kernel_start[..., None] + j * cfg.kernel_step_size[..., None]
    kidx = kidx.clamp(0, table_size - 1)                     # clamp masked taps
    kvals = torch.where(mask, table[kidx.long()], 0)

    s = input_samples.shape[-2]
    rows = pos[..., None] + min_rel[..., None] + j           # (..., N, T)
    rows = rows.clamp(0, s - 1).long()
    x = input_samples.to(torch.int32)
    if x.dim() == 3:
        # Stream b's rows live at [b*S, (b+1)*S) of the flattened batch.
        rows = rows + s * torch.arange(x.shape[0], device=dev)[:, None, None]
        x = x.reshape(-1, x.shape[-1])
    x = x[rows]                                              # (..., N, T, C)

    # Per-tap trunc-toward-zero scaling, then accumulate (clownresampler.h:1020).
    terms = fx.fixed_mul_trunc(x, kvals[..., None])
    acc = terms.sum(dim=-2, dtype=torch.int32)               # (..., N, C)

    norm = kvals.sum(dim=-1, dtype=torch.int32)              # (..., N)
    q = fx.reciprocal_q31(norm)                              # 17.15 reciprocal (1025)

    return fx.mul_shift15(acc, q[..., None])                 # (..., N, C)
