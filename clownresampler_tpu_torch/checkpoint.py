"""State checkpoint/resume for every stateful API.

The reference's state is two plain structs that are trivially copyable,
which it exploits for transactional rollback (clownresampler.h:1186-1191)
and which users exploit for save/restore. Here every stateful object
serialises to a plain dict of ints and numpy arrays, under the JAX
package's keys, and restores exactly: a resumed stream continues bit for
bit.

Snapshots hold no tensors (staging is saved as numpy wherever it lived), so
``load_*(snapshot, device=...)`` restores a snapshot taken on a card onto
the CPU and the other way round. A sharded farm saves its shards' rows as
the one (rows, lanes) array the format has, so ``load_farm`` and
``load_mixed_farm`` restore any farm snapshot onto a mesh (``mesh=``, as a
parallel.ShardedStreamFarm / ShardedMixedStreamFarm) or onto one device,
whichever way it was saved, in this package and in the JAX package. The two packages read each other's farm
snapshots: both farms keep logical stream frame f at staging row f +
radius_bound, so ``load_*`` here copies rows [0, fill) and the streams'
lanes and leaves the rest zero, whatever capacity and lane padding the
snapshot's buffer had, and ignores the keys the port has no use for
(``interpret``, ``device_staging``). ``save_farm`` writes those keys and
pads its staging the way the JAX farm holds it -- zero lanes up to a
multiple of 128, zero rows up to that farm's capacity -- because the JAX
package's ``load_farm`` takes the buffer's shape as its own. Neither
package's farm holds work parked between ``process`` calls: the JAX mixed
farm applies every deferred staging slide before its ``process`` returns
(clownresampler_tpu/farm.py, ``_pending_slide``), and saves none.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.configure import Configuration
from clownresampler_tpu_torch.device import DEFAULT_DEVICE, Device
from clownresampler_tpu_torch.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu_torch.highlevel import HighLevelResampler
from clownresampler_tpu_torch.lowlevel import FAST_KERNEL_MAX_TAPS, LowLevelResampler
from clownresampler_tpu_torch.models import KernelModel
from clownresampler_tpu_torch.ops.resample import plan_uniform
from clownresampler_tpu_torch.parallel.farm import ShardedMixedStreamFarm, ShardedStreamFarm
from clownresampler_tpu_torch.parallel.sharding import Mesh

# The JAX farm's staging geometry (clownresampler_tpu/farm.py), which its
# load_farm reads from the snapshot's buffer: lanes in whole kernel tiles,
# and the input-row budget its capacity rule weighs.
JAX_LANES = 128
JAX_VMEM_SAFE_INPUT_ROWS = 12288


def _config_dict(cfg: Configuration) -> dict:
    return {
        "stretched_kernel_radius": cfg.stretched_kernel_radius,
        "integer_stretched_kernel_radius": cfg.integer_stretched_kernel_radius,
        "stretched_kernel_radius_delta": cfg.stretched_kernel_radius_delta,
        "kernel_step_size": cfg.kernel_step_size,
        "radius": cfg.radius,
        "resolution": cfg.resolution,
    }


def _check_kind(d: dict, kind: str) -> None:
    if d.get("kind") != kind:
        raise ValueError(f"not a {kind} snapshot: kind {d.get('kind')!r}")


def _model(d: dict) -> KernelModel:
    return KernelModel(d["model_radius"], d["model_resolution"])


def save_lowlevel(rs: LowLevelResampler) -> dict[str, Any]:
    return {
        "kind": "lowlevel",
        "channels": rs.channels,
        "position_integer": rs.position_integer,
        "position_fractional": rs.position_fractional,
        "increment": rs.increment,
        "config": _config_dict(rs.config),
        "max_taps": rs._max_taps,
        "model_radius": rs.model.radius,
        "model_resolution": rs.model.resolution,
    }


def load_lowlevel(d: dict[str, Any], device: Device = DEFAULT_DEVICE) -> LowLevelResampler:
    _check_kind(d, "lowlevel")
    return LowLevelResampler(
        channels=d["channels"], model=_model(d), position_integer=d["position_integer"],
        position_fractional=d["position_fractional"], increment=d["increment"],
        config=Configuration(**d["config"]), device=device,
        _max_taps=d["max_taps"])


def save_highlevel(rs: HighLevelResampler) -> dict[str, Any]:
    return {
        "kind": "highlevel",
        "low_level": save_lowlevel(rs.low_level),
        "input_buffer": rs.input_buffer.copy(),
        "input_buffer_start": rs.input_buffer_start,
        "input_buffer_end": rs.input_buffer_end,
        "maximum_integer_stretched_kernel_radius": rs.maximum_integer_stretched_kernel_radius,
        "leading_padding_frames_needed": rs.leading_padding_frames_needed,
        "trailing_padding_frames_remaining": rs.trailing_padding_frames_remaining,
        "buffer_total_samples": rs.buffer_total_samples,
    }


def load_highlevel(d: dict[str, Any], device: Device = DEFAULT_DEVICE) -> HighLevelResampler:
    _check_kind(d, "highlevel")
    return HighLevelResampler(
        low_level=load_lowlevel(d["low_level"], device),
        input_buffer=np.array(d["input_buffer"], dtype=np.int16),
        input_buffer_start=d["input_buffer_start"],
        input_buffer_end=d["input_buffer_end"],
        maximum_integer_stretched_kernel_radius=d["maximum_integer_stretched_kernel_radius"],
        leading_padding_frames_needed=d["leading_padding_frames_needed"],
        trailing_padding_frames_remaining=d["trailing_padding_frames_remaining"],
        buffer_total_samples=d["buffer_total_samples"],
    )


def _pow2_at_least(n: int) -> int:
    w = 16
    while w < n:
        w *= 2
    return w


def jax_capacity(farm: UniformStreamFarm) -> int:
    """Staging rows the JAX package's UniformStreamFarm holds for this farm
    (its radius bound, chunk size, model and the ratio it was built for --
    for the solo farm of ``MixedStreamFarm.adjust_stream``, its source
    group's, whose capacity the JAX solo farm takes): 2 * radius_bound +
    chunk_frames + a slack for its kernels' aligned and polyphase over-reads
    (clownresampler_tpu/farm.py, ``__init__``; the port's own farm needs
    only max_taps rows of slack)."""
    rb, taps = farm._radius_bound, farm._max_taps
    base = 2 * rb + farm.chunk_frames
    if taps > FAST_KERNEL_MAX_TAPS:
        return base + rb + 16
    # The tiled kernel's aligned window, a power of two (window_rows_needed
    # at d = 1, cand = 8), and 3 radius bounds.
    slack = 96 + _pow2_at_least(taps + 21) + 3 * rb
    # The polyphase strided kernel's over-read at every stride the bound
    # admits (strided_phase_padding at 32 groups).
    strided = max((96 + 256 * d + d * (_pow2_at_least(256 + 1 - (-(taps - 1) // d) + 15) + 8)
                   for d in range(2, rb // farm.model.radius + 1)), default=0)
    primary_strided = plan_uniform(farm._capacity_increment, 0)["kernel"] == "strided"
    if strided > slack and (base + strided <= JAX_VMEM_SAFE_INPUT_ROWS
                            or base + slack > JAX_VMEM_SAFE_INPUT_ROWS or primary_strided):
        slack = strided
    return base + slack


def save_farm(farm: UniformStreamFarm) -> dict[str, Any]:
    """Serialise a farm; its staging rows [0, fill) and lanes padded with
    zeros to the JAX farm's shape (jax_capacity rows, JAX_LANES-lane
    multiples), so the JAX package's load_farm restores it too."""
    padded = np.zeros((jax_capacity(farm), fx.round_up(farm._lanes, JAX_LANES)), np.int32)
    padded[: farm._fill, : farm._lanes] = farm._staged_rows()
    return {
        "kind": "farm",
        "n_streams": farm.n_streams,
        "channels": farm.channels,
        "chunk_frames": farm.chunk_frames,
        "interpret": False,
        "position_integer": farm.position_integer,
        "position_fractional": farm.position_fractional,
        "increment": farm.increment,
        "capacity_increment": farm._capacity_increment,
        "config": _config_dict(farm.config),
        "radius_bound": farm._radius_bound,
        "staging": padded,
        "fill": farm._fill,
        "device_staging": farm.device.type == "cuda",   # the JAX package's placement hint
        "clamp_s16": farm.clamp_s16,
        "model_radius": farm.model.radius,
        "model_resolution": farm.model.resolution,
    }


def _check_placement(device: Device, mesh: Optional[Mesh]) -> None:
    if mesh is not None and device != DEFAULT_DEVICE:
        raise ValueError(f"restore onto a device or onto a mesh, not both: got device "
                         f"{str(device)!r} and {mesh}")


def load_farm(d: dict[str, Any], device: Device = DEFAULT_DEVICE,
              mesh: Optional[Mesh] = None) -> UniformStreamFarm:
    """Restore a farm onto ``device``, or with ``mesh`` as a ShardedStreamFarm
    over that mesh's dp axis (any dp; give a mesh or a device, not both).
    The snapshot may come from a sharded or an unsharded farm of this
    package or from the JAX package's ``save_farm``."""
    _check_kind(d, "farm")
    _check_placement(device, mesh)
    if mesh is None:
        farm = UniformStreamFarm.__new__(UniformStreamFarm)
    else:
        farm = ShardedStreamFarm.__new__(ShardedStreamFarm)
        farm.mesh = mesh
    farm._setup(d["n_streams"], d["channels"], Configuration(**d["config"]), d["increment"],
                chunk_frames=d["chunk_frames"], model=_model(d),
                radius_bound=d["radius_bound"], device=device,
                clamp_s16=d.get("clamp_s16", False))
    farm.position_integer = d["position_integer"]
    farm.position_fractional = d["position_fractional"]
    farm._capacity_increment = d.get("capacity_increment", d["increment"])
    fill = d["fill"]
    if fill > farm._capacity:
        raise ValueError(f"snapshot fill {fill} exceeds the staging capacity {farm._capacity}")
    farm._load_rows(np.ascontiguousarray(np.asarray(d["staging"])[:fill, : farm._lanes],
                                         np.int32))
    return farm


def save_mixed_farm(farm: MixedStreamFarm) -> dict[str, Any]:
    """Serialise a MixedStreamFarm: each group's uniform farm plus its
    member slots (None = a slot vacated by adjust_stream)."""
    return {
        "kind": "mixed_farm",
        "n_streams": farm.n_streams,
        "channels": farm.channels,
        "chunk_frames": farm.chunk_frames,
        "interpret": False,
        "max_radius": farm.max_radius,
        "clamp_s16": farm.clamp_s16,
        "model_radius": farm.model.radius,
        "model_resolution": farm.model.resolution,
        "groups": [{"farm": save_farm(f), "members": list(members)}
                   for f, members in farm._groups],
    }


def load_mixed_farm(d: dict[str, Any], device: Device = DEFAULT_DEVICE,
                    mesh: Optional[Mesh] = None) -> MixedStreamFarm:
    """Restore a mixed farm onto ``device``, or with ``mesh`` as a
    ShardedMixedStreamFarm whose every group splits over that mesh (a mesh
    or a device, not both); the snapshot may come from a sharded or an
    unsharded mixed farm of this package or from the JAX package's
    ``save_mixed_farm``."""
    _check_kind(d, "mixed_farm")
    _check_placement(device, mesh)
    options = dict(chunk_frames=d["chunk_frames"], model=_model(d), max_radius=d["max_radius"],
                   clamp_s16=d.get("clamp_s16", False))
    if mesh is None:
        farm = MixedStreamFarm([], d["channels"], device=device, **options)
    else:
        farm = ShardedMixedStreamFarm(mesh, [], d["channels"], **options)
    farm.n_streams = d["n_streams"]
    farm._groups = [[load_farm(g["farm"], device, mesh), list(g["members"])]
                    for g in d["groups"]]
    return farm
