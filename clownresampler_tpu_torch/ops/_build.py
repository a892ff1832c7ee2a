"""Build, load and launch the hand-written CUDA kernels (csrc/resample_kernels.cu).

The source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, into ``ops/_build/`` beside
this file, under a name keyed by the source's hash; the library is loaded
with ctypes. Tensors pass as ``data_ptr()`` ints and the launch goes on
PyTorch's current stream. Nothing here falls back: a failed compile, load or
launch raises.

The launchers check device, dtype, shape and contiguity before they hand
pointers to C, allocate the output with ``torch.empty`` and never
synchronise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_HERE, "csrc", "resample_kernels.cu")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_lock = threading.Lock()
_lib = None
BUILD_LOG = {"seconds": None, "path": None, "ptxas": ""}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libresample_kernels-{digest}.so")


def library() -> ctypes.CDLL:
    """The loaded kernel library, compiled first if this source is new."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        so = library_path()
        t0 = time.perf_counter()
        if not os.path.exists(so):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{so}.tmp{os.getpid()}"
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
            BUILD_LOG["ptxas"] = proc.stderr
            os.replace(tmp, so)  # atomic: concurrent builders converge
        lib = ctypes.CDLL(so)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.crt_tiled_mac.argtypes = [p, i, i, i, i, p, p, p, i, i, i, i, p, i, i, p]
        lib.crt_tiled_mac.restype = i
        lib.crt_general_mac.argtypes = [p, i, i, i, i, p, p, p, i, i, p, i, i, p]
        lib.crt_general_mac.restype = i
        lib.crt_error_string.argtypes = [i]
        lib.crt_error_string.restype = ctypes.c_char_p
        BUILD_LOG["seconds"] = time.perf_counter() - t0
        BUILD_LOG["path"] = so
        _lib = lib
        return lib


def _check_launch(x, rows, kv, q, lanes, lane_offset):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x.device}")
    for name, t, nd in (("x", x, 2), ("rows", rows, 1), ("kv", kv, 2), ("q", q, 1)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.int32 or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-d int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    n = rows.shape[0]
    if kv.shape[0] != n or q.shape[0] != n:
        raise ValueError(f"rows/kv/q disagree on frames: {n}, {kv.shape[0]}, {q.shape[0]}")
    if not (lanes > 0 and lane_offset >= 0 and lane_offset + lanes <= x.shape[1]):
        raise ValueError(f"lanes [{lane_offset}, {lane_offset + lanes}) outside x's "
                         f"{x.shape[1]} lanes")
    if kv.shape[1] > x.shape[0]:
        raise ValueError(f"{kv.shape[1]} taps exceed the {x.shape[0]}-row input")


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {lib.crt_error_string(err).decode()}")


def tiled_mac(x, rows, kv, q, *, lanes: int, lane_offset: int, frames_per_block: int,
              win_rows: int, clamp_s16: bool) -> torch.Tensor:
    """Launch tiled_mac_kernel; returns (N, lanes) int32 (int16 if clamped)."""
    _check_launch(x, rows, kv, q, lanes, lane_offset)
    lib = library()
    n, t = kv.shape
    out = torch.empty((n, lanes), dtype=torch.int16 if clamp_s16 else torch.int32,
                      device=x.device)
    if n:
        err = lib.crt_tiled_mac(
            x.data_ptr(), x.shape[0], x.shape[1], lane_offset, lanes, rows.data_ptr(),
            kv.data_ptr(), q.data_ptr(), n, t, frames_per_block, win_rows,
            out.data_ptr(), int(clamp_s16), x.device.index,
            torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, lib, "tiled_mac_kernel")
    return out


def general_mac(x, rows, kv, q, *, lanes: int, lane_offset: int,
                clamp_s16: bool) -> torch.Tensor:
    """Launch general_mac_kernel; returns (N, lanes) int32 (int16 if clamped)."""
    _check_launch(x, rows, kv, q, lanes, lane_offset)
    lib = library()
    n, t = kv.shape
    out = torch.empty((n, lanes), dtype=torch.int16 if clamp_s16 else torch.int32,
                      device=x.device)
    if n:
        err = lib.crt_general_mac(
            x.data_ptr(), x.shape[0], x.shape[1], lane_offset, lanes, rows.data_ptr(),
            kv.data_ptr(), q.data_ptr(), n, t, out.data_ptr(), int(clamp_s16),
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
        _raise_on(err, lib, "general_mac_kernel")
    return out
