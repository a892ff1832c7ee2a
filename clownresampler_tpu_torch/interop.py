"""Carry tables and stream state across from the JAX package, as numpy.

The JAX package's arrays and ``ConfigScalars`` fields, handed over as numpy
(``np.asarray`` of each), become this package's tensors on an explicit
device. A JAX ``LowLevelResampler.state_tuple()`` continues as a port
resampler through ``LowLevelResampler.from_state_tuple``. Nothing here
imports JAX.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from clownresampler_tpu_torch.lowlevel import DeviceState
from clownresampler_tpu_torch.models import table_tensor
from clownresampler_tpu_torch.ops.convolve import ConfigScalars

Device = Union[str, torch.device]

__all__ = ["table_from_numpy", "config_scalars_from_numpy", "device_state_from_numpy"]


def table_from_numpy(table: np.ndarray, device: Device = "cpu") -> torch.Tensor:
    """A kernel table (flat or strided) as an int32 tensor on ``device``."""
    return table_tensor(np.asarray(table), torch.device(device))


def config_scalars_from_numpy(cfg_fields: Sequence, device: Device = "cpu") -> ConfigScalars:
    """The seven ``ConfigScalars`` fields, in field order, as 0-dim tensors."""
    if len(cfg_fields) != len(ConfigScalars._fields):
        raise ValueError(f"expected {len(ConfigScalars._fields)} fields, got {len(cfg_fields)}")
    return ConfigScalars.from_fields([np.asarray(v).item() for v in cfg_fields],
                                     torch.device(device))


def device_state_from_numpy(position_integer, position_fractional, cfg_fields: Sequence,
                            device: Device = "cpu") -> DeviceState:
    """A launch state from numpy positions and ``ConfigScalars`` fields."""
    dev = torch.device(device)
    pos = torch.tensor([np.asarray(position_integer).item(),
                        np.asarray(position_fractional).item()], dtype=torch.int32).to(dev)
    return DeviceState(pos[0], pos[1], config_scalars_from_numpy(cfg_fields, dev))
