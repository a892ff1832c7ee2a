"""Batched multi-stream resampling: B independent streams, each with its own
ratio and phase, through one chunk call.

Counterpart of ``clownresampler_tpu/batch.py``, whose ``resample_batch`` is
a ``jax.vmap`` of ``lowlevel.resample_chunk`` over the stream axis; here the
stream axis is a loop over the port's ``resample_chunk``. States are
DeviceStates whose leaves carry a leading (B,) axis.
"""

from __future__ import annotations

from typing import Union

import torch

from clownresampler_tpu_torch.configure import Configuration
from clownresampler_tpu_torch.lowlevel import DeviceState, make_device_state, resample_chunk
from clownresampler_tpu_torch.ops.convolve import ConfigScalars


def stack_states(states: list) -> DeviceState:
    """Stack per-stream DeviceStates into one state with (B,) leaves."""
    stack = lambda vals: torch.stack([torch.as_tensor(v, dtype=torch.int32) for v in vals])
    return DeviceState(
        stack([s.position_integer for s in states]),
        stack([s.position_fractional for s in states]),
        ConfigScalars(*(stack(field) for field in zip(*(s.cfg for s in states)))),
    )


def _state_at(states: DeviceState, b: int) -> DeviceState:
    return DeviceState(states.position_integer[b], states.position_fractional[b],
                       ConfigScalars(*(field[b] for field in states.cfg)))


def make_batch_state(configs_increments: list,
                     device: Union[str, torch.device] = "cpu") -> DeviceState:
    """A stacked state for B streams at position zero, from per-stream
    (Configuration, increment) pairs (e.g. the mixed fleet of config 5)."""
    dev = torch.device(device)
    return stack_states([make_device_state(0, 0, cfg, inc, dev)
                         for cfg, inc in configs_increments])


def resample_batch(
    table: torch.Tensor,                # (table_size,) int32, shared by all streams
    padded_inputs: torch.Tensor,        # (B, S, C) int16
    total_input_frames: torch.Tensor,   # (B,) int32
    states: DeviceState,                # stacked, (B,) leaves
    output_quota: torch.Tensor,         # (B,) int32
    *,
    max_taps: int,
    n_out: int,
):
    """``resample_chunk`` for each stream of the batch.

    Returns (outputs (B, n_out, C) int32, produced (B,), consumed (B,),
    new_states, input_exhausted (B,)). Streams that produce fewer than n_out
    frames have their tails zero-masked; ``produced`` is authoritative.
    """
    results = [
        resample_chunk(table, padded_inputs[b], total_input_frames[b], _state_at(states, b),
                       output_quota[b], max_taps=max_taps, n_out=n_out)
        for b in range(padded_inputs.shape[0])
    ]
    out, produced, consumed, new_states, exhausted = zip(*results)
    return (torch.stack(out), torch.stack(produced), torch.stack(consumed),
            stack_states(list(new_states)), torch.stack(exhausted))
