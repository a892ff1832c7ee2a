"""clownresampler_tpu_torch — the resampler in PyTorch with hand-written CUDA kernels.

A port of ``clownresampler_tpu`` (JAX/Pallas) to PyTorch for NVIDIA Hopper
GPUs, bit-exact to the C reference (Clownacy/clownresampler, a streaming
Lanczos resampler in 16.16 fixed point) and to the JAX package. It imports
neither JAX nor the JAX package.

Layer map:
  models/       Lanczos LUT generation (Precompute)
  configure     ratio/stretching math (LowestLevel_Configure)
  ops/          launch precompute, the CUDA kernels (csrc/) and their plain
                PyTorch versions, and the gather oracle (LowestLevel_Resample)
  lowlevel      phase-accumulator streaming (LowLevel_Init/Adjust/Resample)
  highlevel     buffered streaming with edge padding (HighLevel_*)
  farm          many same-ratio streams as lanes of one launch; mixed-ratio
                fleets as one such farm per ratio
  batch         independent streams, each with its own ratio, per chunk call
  interop       tables and stream state carried over from the JAX package
  utils/        host staging engine loader, PCM/WAV helpers

Every public constructor and function that allocates takes ``device``; the
default is the CPU, where the kernels' plain versions run.
"""

from clownresampler_tpu_torch import fixedpoint
from clownresampler_tpu_torch.batch import make_batch_state, resample_batch, stack_states
from clownresampler_tpu_torch.configure import MAXIMUM_CHANNELS, Configuration, configure
from clownresampler_tpu_torch.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu_torch.highlevel import HighLevelResampler
from clownresampler_tpu_torch.lowlevel import LowLevelResampler, resample_array, resample_chunk
from clownresampler_tpu_torch.models import (
    DEFAULT_MODEL,
    HIGH_QUALITY_MODEL,
    LOW_COST_MODEL,
    KernelModel,
    lanczos_kernel_table,
)
from clownresampler_tpu_torch.ops.resample import (
    resample_strided_phases,
    resample_strided_phases_wide,
    resample_wide_taps,
)

__version__ = "0.1.0"

__all__ = [
    "fixedpoint",
    "Configuration",
    "configure",
    "MAXIMUM_CHANNELS",
    "KernelModel",
    "lanczos_kernel_table",
    "DEFAULT_MODEL",
    "HIGH_QUALITY_MODEL",
    "LOW_COST_MODEL",
    "LowLevelResampler",
    "HighLevelResampler",
    "UniformStreamFarm",
    "MixedStreamFarm",
    "resample_chunk",
    "resample_array",
    "resample_batch",
    "make_batch_state",
    "stack_states",
    "resample_strided_phases",
    "resample_strided_phases_wide",
    "resample_wide_taps",
    "__version__",
]
