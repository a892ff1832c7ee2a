"""Build, load and launch the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface, at first use, into ``ops/_build/``
beside this file, under a name keyed by the hash of the source, the shared
header and the flags; every missing library is compiled by one ``nvcc``
started at the same time as the others, and all are loaded with ctypes.
Tensors pass as ``data_ptr()`` ints and the launch goes on PyTorch's current
stream. Nothing here falls back: a failed compile, load or launch raises.

The launchers check device, dtype, shape and contiguity before they hand
pointers to C, allocate outputs and scratch with ``torch.empty`` and never
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
CSRC = os.path.join(_HERE, "csrc")
HEADER = os.path.join(CSRC, "mac_common.cuh")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Largest dynamic shared memory a Hopper block may opt in to (232,448 bytes).
MAX_SHARED_BYTES = 227 * 1024

_p, _i = ctypes.c_void_p, ctypes.c_int
# library -> (source file, {C entry: argtypes}); every entry returns int.
LIBRARIES = {
    "resample": ("resample_kernels.cu", {
        "crt_tiled_mac": [_p, _i, _i, _i, _i, _p, _p, _p, _i, _i, _i, _i, _p, _i, _i, _p],
        "crt_general_mac": [_p, _i, _i, _i, _i, _p, _p, _p, _i, _i, _p, _i, _i, _p],
    }),
    "strided": ("strided_kernels.cu", {
        "crt_strided_mac": [_p, _i, _i, _i, _i, _p, _i, _p, _p, _i, _i, _i, _p, _i, _i, _p],
    }),
    "wide": ("wide_kernels.cu", {
        "crt_wide_mac": [_p, _i, _i, _i, _p, _p, _p, _i, _i, _i, _i, _p, _p, _i, _i, _p],
    }),
}

_lock = threading.Lock()
_libs: dict = {}
# seconds: wall time of the whole build and load; paths / ptxas per library.
BUILD_LOG = {"seconds": None, "paths": {}, "ptxas": {}}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in (os.path.join(CSRC, LIBRARIES[name][0]), HEADER):
        with open(path, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}_kernels-{digest.hexdigest()[:16]}.so")


def _build_missing() -> None:
    """Compile every library whose .so is missing, one nvcc each, all at once."""
    jobs = []
    for name, (source, _) in LIBRARIES.items():
        so = library_path(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, os.path.join(CSRC, source), "-o", tmp],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, so, tmp, proc))
    failures = []
    for name, so, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc failed ({proc.returncode}):\n{err}")
            continue
        BUILD_LOG["ptxas"][name] = err
        os.replace(tmp, so)  # atomic: concurrent builds converge
    if failures:
        raise RuntimeError("\n".join(failures))


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (a key of LIBRARIES); the first call
    compiles every library whose source is new and loads them all."""
    with _lock:
        if not _libs:
            t0 = time.perf_counter()
            _build_missing()
            for lib_name, (_, entries) in LIBRARIES.items():
                so = library_path(lib_name)
                lib = ctypes.CDLL(so)
                for entry, argtypes in entries.items():
                    fn = getattr(lib, entry)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
                BUILD_LOG["paths"][lib_name] = so
                _libs[lib_name] = lib
            err = _libs["resample"].crt_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            BUILD_LOG["seconds"] = time.perf_counter() - t0
        return _libs[name]


def _check_tensors(x, lanes, lane_offset, **tensors):
    """x is a contiguous (S, L) int32 CUDA tensor, each named tensor
    (value: (tensor, ndim)) a contiguous int32 tensor of that rank on x's
    device, and [lane_offset, lane_offset + lanes) lies inside x's lanes."""
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x.device}")
    for name, (t, nd) in {"x": (x, 2), **tensors}.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.int32 or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-d int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not (lanes > 0 and lane_offset >= 0 and lane_offset + lanes <= x.shape[1]):
        raise ValueError(f"lanes [{lane_offset}, {lane_offset + lanes}) outside x's "
                         f"{x.shape[1]} lanes")


def _check_launch(x, rows, kv, q, lanes, lane_offset):
    _check_tensors(x, lanes, lane_offset, rows=(rows, 1), kv=(kv, 2), q=(q, 1))
    n = rows.shape[0]
    if kv.shape[0] != n or q.shape[0] != n:
        raise ValueError(f"rows/kv/q disagree on frames: {n}, {kv.shape[0]}, {q.shape[0]}")
    if kv.shape[1] > x.shape[0]:
        raise ValueError(f"{kv.shape[1]} taps exceed the {x.shape[0]}-row input")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = library("resample").crt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def _out(n: int, lanes: int, clamp_s16: bool, device) -> torch.Tensor:
    return torch.empty((n, lanes), dtype=torch.int16 if clamp_s16 else torch.int32,
                       device=device)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def tiled_mac(x, rows, kv, q, *, lanes: int, lane_offset: int, frames_per_block: int,
              win_rows: int, clamp_s16: bool) -> torch.Tensor:
    """Launch tiled_mac_kernel; returns (N, lanes) int32 (int16 if clamped)."""
    _check_launch(x, rows, kv, q, lanes, lane_offset)
    lib = library("resample")
    n, t = kv.shape
    out = _out(n, lanes, clamp_s16, x.device)
    if n:
        err = lib.crt_tiled_mac(
            x.data_ptr(), x.shape[0], x.shape[1], lane_offset, lanes, rows.data_ptr(),
            kv.data_ptr(), q.data_ptr(), n, t, frames_per_block, win_rows,
            out.data_ptr(), int(clamp_s16), x.device.index, _stream(x))
        _raise_on(err, "tiled_mac_kernel")
    return out


def general_mac(x, rows, kv, q, *, lanes: int, lane_offset: int,
                clamp_s16: bool) -> torch.Tensor:
    """Launch general_mac_kernel; returns (N, lanes) int32 (int16 if clamped)."""
    _check_launch(x, rows, kv, q, lanes, lane_offset)
    lib = library("resample")
    n, t = kv.shape
    out = _out(n, lanes, clamp_s16, x.device)
    if n:
        err = lib.crt_general_mac(
            x.data_ptr(), x.shape[0], x.shape[1], lane_offset, lanes, rows.data_ptr(),
            kv.data_ptr(), q.data_ptr(), n, t, out.data_ptr(), int(clamp_s16),
            x.device.index, _stream(x))
        _raise_on(err, "general_mac_kernel")
    return out


def strided_shared_bytes(frames_per_block: int, d: int, taps: int) -> int:
    """Dynamic shared memory of one strided_mac_kernel block: k0 plus the
    staged window of (frames_per_block - 1)*d + taps rows x 32 lanes."""
    return 4 * (taps + ((frames_per_block - 1) * d + taps) * 32)


def strided_mac(x, r0, k0, q0, *, n_out: int, d: int, lanes: int, lane_offset: int,
                frames_per_block: int, clamp_s16: bool) -> torch.Tensor:
    """Launch strided_mac_kernel: frame n's window starts at r0[0] + n*d
    (clamped into x), taps k0 (T,), reciprocal q0[0]; returns (n_out, lanes)
    int32 (int16 if clamped)."""
    _check_tensors(x, lanes, lane_offset, r0=(r0, 1), k0=(k0, 1), q0=(q0, 1))
    t = k0.shape[0]
    if r0.shape[0] < 1 or q0.shape[0] < 1 or not 0 < t <= x.shape[0] or d < 1:
        raise ValueError(f"bad strided launch: r0 {tuple(r0.shape)}, q0 {tuple(q0.shape)}, "
                         f"{t} taps over {x.shape[0]} rows, d {d}")
    if strided_shared_bytes(frames_per_block, d, t) > MAX_SHARED_BYTES:
        raise ValueError(f"strided window of {frames_per_block} frames at d {d}, {t} taps "
                         f"exceeds {MAX_SHARED_BYTES} bytes of shared memory")
    lib = library("strided")
    out = _out(n_out, lanes, clamp_s16, x.device)
    if n_out:
        err = lib.crt_strided_mac(
            x.data_ptr(), x.shape[0], x.shape[1], lane_offset, lanes, r0.data_ptr(), d,
            k0.data_ptr(), q0.data_ptr(), n_out, t, frames_per_block, out.data_ptr(),
            int(clamp_s16), x.device.index, _stream(x))
        _raise_on(err, "strided_mac_kernel")
    return out


def wide_mac(x, rows, kv, q, *, lanes: int, lane_offset: int, tap_block: int,
             clamp_s16: bool) -> torch.Tensor:
    """Launch wide_mac_kernel over ceil(T / tap_block) tap blocks into an
    int32 scratch of partial sums, then wide_fold_kernel; returns (N, lanes)
    int32 (int16 if clamped)."""
    _check_launch(x, rows, kv, q, lanes, lane_offset)
    n, t = kv.shape
    if tap_block < 1 or n > 65535 or -(-lanes // 32) > 65535:
        raise ValueError(f"bad wide launch: {n} frames, {lanes} lanes, tap block {tap_block}")
    lib = library("wide")
    n_k = -(-t // tap_block)
    partial = torch.empty((n_k, n, lanes), dtype=torch.int32, device=x.device)
    out = _out(n, lanes, clamp_s16, x.device)
    if n:
        err = lib.crt_wide_mac(
            x.data_ptr(), x.shape[1], lane_offset, lanes, rows.data_ptr(), kv.data_ptr(),
            q.data_ptr(), n, t, tap_block, n_k, partial.data_ptr(), out.data_ptr(),
            int(clamp_s16), x.device.index, _stream(x))
        _raise_on(err, "wide_mac_kernel")
    return out
