"""Batched multi-stream resampling: B independent streams, each with its own
ratio and phase, through one chunk call.

Counterpart of ``clownresampler_tpu/batch.py``, whose ``resample_batch`` is
a ``jax.vmap`` of ``lowlevel.resample_chunk`` over the stream axis; here the
stream axis is a leading batch axis through the port's ``resample_chunk``:
on a card one launch of batch_mac_kernel for the B streams, on the CPU the
plain version ``resample_batch_reference``, the gather oracle in runs of
streams bounded by ``BATCH_GATHER_BUDGET_BYTES``. States are DeviceStates
whose leaves carry a leading (B,) axis.
"""

from __future__ import annotations

import torch

from clownresampler_tpu_torch.configure import Configuration
from clownresampler_tpu_torch.device import DEFAULT_DEVICE, Device, resolve_device
from clownresampler_tpu_torch.lowlevel import (
    DeviceState,
    make_device_state,
    resample_chunk,
    resample_chunk_reference,
)
from clownresampler_tpu_torch.ops import resample as ops_resample
from clownresampler_tpu_torch.ops.convolve import ConfigScalars


def stack_states(states: list) -> DeviceState:
    """Stack per-stream DeviceStates into one state with (B,) leaves."""
    stack = lambda vals: torch.stack([torch.as_tensor(v, dtype=torch.int32) for v in vals])
    return DeviceState(
        stack([s.position_integer for s in states]),
        stack([s.position_fractional for s in states]),
        ConfigScalars(*(stack(field) for field in zip(*(s.cfg for s in states)))),
    )


# Bytes one gather of resample_batch_reference may hold (``gather_bytes``'
# count): a batch whose streams need more runs as several gathers of whole
# streams, one after the other, so a call over any number of streams has a
# bounded footprint.
BATCH_GATHER_BUDGET_BYTES = 1 << 30


def gather_bytes(n_out: int, max_taps: int, channels: int) -> int:
    """Bytes the gather oracle holds for one stream of a batched call: the
    (n_out, max_taps, channels) int32 window, its products and their
    truncation, and the (n_out, max_taps) int64 row and LUT indices with
    the int32 grids they come from."""
    return n_out * max_taps * (12 * channels + 40)


def slice_states(states: DeviceState, lo: int, hi: int) -> DeviceState:
    """Streams [lo, hi) of a stacked DeviceState."""
    return DeviceState(states.position_integer[lo:hi], states.position_fractional[lo:hi],
                       ConfigScalars(*(field[lo:hi] for field in states.cfg)))


def cat_states(states: list) -> DeviceState:
    """Join stacked DeviceStates along their (B,) axis."""
    return DeviceState(
        torch.cat([s.position_integer for s in states]),
        torch.cat([s.position_fractional for s in states]),
        ConfigScalars(*(torch.cat(field) for field in zip(*(s.cfg for s in states)))),
    )


def make_batch_state(configs_increments: list,
                     device: Device = DEFAULT_DEVICE) -> DeviceState:
    """A stacked state for B streams at position zero, from per-stream
    (Configuration, increment) pairs (e.g. the mixed fleet of config 5)."""
    dev = resolve_device(device)
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
    """``resample_chunk`` for each stream of the batch, the B streams as
    one batched call (no loop over streams).

    Returns (outputs (B, n_out, C) int32, produced (B,), consumed (B,),
    new_states, input_exhausted (B,)). Streams that produce fewer than n_out
    frames have their tails zero-masked; ``produced`` is authoritative.

    On a CUDA tensor this is one launch of batch_mac_kernel, whatever B; on
    the CPU the plain version, ``resample_batch_reference``.
    """
    if ops_resample.plain_route(padded_inputs, "batch"):
        return resample_batch_reference(table, padded_inputs, total_input_frames, states,
                                        output_quota, max_taps=max_taps, n_out=n_out)
    return resample_chunk(table, padded_inputs, total_input_frames, states, output_quota,
                          max_taps=max_taps, n_out=n_out)


def resample_batch_reference(table, padded_inputs, total_input_frames, states, output_quota,
                             *, max_taps: int, n_out: int):
    """Plain PyTorch version of ``resample_batch`` (same arguments and
    return): ``resample_chunk_reference``, the gather, over the batch. The
    gather holds ``gather_bytes`` a stream, so a batch past
    BATCH_GATHER_BUDGET_BYTES goes as several calls over runs of whole
    streams (at least one a run), joined along the batch axis.
    """
    b, _, channels = padded_inputs.shape
    run = max(1, BATCH_GATHER_BUDGET_BYTES // gather_bytes(n_out, max_taps, channels))
    results = [
        resample_chunk_reference(table, padded_inputs[lo : lo + run],
                                 total_input_frames[lo : lo + run],
                                 slice_states(states, lo, lo + run), output_quota[lo : lo + run],
                                 max_taps=max_taps, n_out=n_out)
        for lo in range(0, b, run)
    ]
    if len(results) == 1:
        return results[0]
    out, produced, consumed, new_states, exhausted = zip(*results)
    return (torch.cat(out), torch.cat(produced), torch.cat(consumed),
            cat_states(list(new_states)), torch.cat(exhausted))
