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
        "crt_tiled_mac": [_p, _i, _i, _i, _i, _p, _i, _p, _i, _p, _p, _p, _p, _p, _p,
                          _p, _i, _p, _i, _i, _i, _i, _i, _i, _p, _p, _i, _i, _p],
    }),
    "strided": ("strided_kernels.cu", {
        "crt_strided_mac": [_p, _i, _i, _i, _i, _p, _i, _p, _i, _p, _p, _p, _p, _p, _p,
                            _p, _i, _i, _i, _i, _i, _i, _i, _p, _p, _i, _i, _p],
    }),
    "wide": ("wide_kernels.cu", {
        "crt_wide_mac": [_p, _i, _i, _i, _i, _p, _i, _p, _i, _p, _p, _p, _p, _p, _p,
                         _p, _i, _p, _i, _i, _i, _i, _i, _i, _p, _p, _p, _p, _i, _i, _p],
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


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        msg = library("resample").crt_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg}")


def _out(n: int, lanes: int, clamp_s16: bool, device) -> torch.Tensor:
    return torch.empty((n, lanes), dtype=torch.int16 if clamp_s16 else torch.int32,
                       device=device)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# Lanes of one staged tile of the tiled and strided kernels (32 threads x 4
# lanes); a staged window row is this many ints.
TILED_LANES = 128
# The ConfigScalars fields the kernels read, in their argument order.
TILED_CONFIG_FIELDS = ("increment_hi", "increment_lo", "stretched_kernel_radius",
                       "stretched_kernel_radius_delta", "integer_stretched_kernel_radius",
                       "kernel_step_size")
# Input rows of one staged run of wide_mac_kernel (wide_kernels.cu
# WIDE_RUN_ROWS); 64 measured faster than 32 and 128 on the H100 (PERF.md).
WIDE_RUN_ROWS = 64


def tiled_shared_bytes(frames: int, win_rows: int, taps: int) -> int:
    """Dynamic shared memory of one tiled_mac_kernel block: two stages, each
    a window of win_rows x TILED_LANES ints and its frames' taps, rows,
    reciprocals and live tap counts."""
    return 2 * 4 * (win_rows * TILED_LANES + frames * (taps + 3))


def strided_shared_bytes(taps: int, win_rows: int) -> int:
    """Dynamic shared memory of one strided_mac_kernel block: the tap vector
    k0 (padded to a multiple of 4), its sum and 3 ints of padding, and two
    stages of win_rows x TILED_LANES ints."""
    return 4 * (-(-taps // 4) * 4 + 4 + 2 * win_rows * TILED_LANES)


def wide_slots(taps: int) -> int:
    """Partial-sum slots of one frame in wide_mac_kernel's scratch: the most
    runs of WIDE_RUN_ROWS rows a window of ``taps`` rows can meet."""
    return (taps + WIDE_RUN_ROWS - 2) // WIDE_RUN_ROWS + 1


def _scalar_arg(v, x, name: str) -> tuple:
    """(pointer, value) of a launch scalar: a one-element int32 tensor on x's
    device goes by pointer (no host sync), a Python int by value."""
    if isinstance(v, torch.Tensor):
        if v.device != x.device or v.dtype != torch.int32 or v.numel() != 1:
            raise ValueError(f"{name} must be a one-element int32 tensor on {x.device}, got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
        return v.data_ptr(), 0
    v = int(v)
    if not -(1 << 31) <= v < 1 << 31:
        raise ValueError(f"{name} {v} does not fit int32")
    return None, v


def _geometry_args(x, p0, f0, cfg) -> list:
    """The C entries' GeometryArgs: p0 and f0 (pointer, value) and the
    pointers of TILED_CONFIG_FIELDS, which must be tensors on x's device."""
    scalars = [_scalar_arg(getattr(cfg, f), x, f)[0] for f in TILED_CONFIG_FIELDS]
    if None in scalars:
        raise ValueError("the kernels read ConfigScalars as tensors on x's device")
    return [*_scalar_arg(p0, x, "position_integer"), *_scalar_arg(f0, x, "position_fractional"),
            *scalars]


def _vec(x, lanes: int, lane_offset: int) -> int:
    """1 when x, its rows and the lane slice are 4-lane aligned (the kernels'
    16-byte path), else 0."""
    return int(x.data_ptr() % 16 == 0 and x.shape[1] % 4 == 0 and lane_offset % 4 == 0
               and lanes % 4 == 0)


def _check_taps(x, max_taps: int, table_strided=None) -> None:
    if table_strided is not None and table_strided.shape[1] != max_taps:
        raise ValueError(f"strided table has {table_strided.shape[1]} taps, "
                         f"launch has {max_taps}")
    if not 0 < max_taps <= x.shape[0]:
        raise ValueError(f"{max_taps} taps exceed the {x.shape[0]}-row input")


def tiled_mac(x, table, table_strided, p0, f0, cfg, *, max_taps: int, n_out: int, lanes: int,
              lane_offset: int, frames_per_stage: int, win_rows: int,
              clamp_s16: bool) -> tuple:
    """Launch tiled_mac_kernel (the tiled and general entries), which
    computes each frame's geometry itself from the launch state (p0, f0:
    0-dim int32 tensors on x's device, or ints) and ``cfg`` (ConfigScalars
    on x's device), reading the flat LUT ``table`` or, when given, its
    strided form (R, max_taps). Each stage holds ``win_rows`` rows (0: read
    x directly) and the frames of at most ``frames_per_stage`` frames: the
    kernel takes the most of frames_per_stage, half that, ..., 8 whose
    window fits (ops.resample.stage_frames). Returns (out (n_out, lanes)
    int32 -- int16 if clamped --, rows (n_out,) int32, the unclamped first
    window rows)."""
    tables = {"table": (table, 1)}
    if table_strided is not None:
        tables["table_strided"] = (table_strided, 2)
    _check_tensors(x, lanes, lane_offset, **tables)
    _check_taps(x, max_taps, table_strided)
    if frames_per_stage not in (8, 16, 32, 64) or win_rows < 0:
        raise ValueError(f"bad tiled stage: {frames_per_stage} frames, {win_rows} rows")
    smem = tiled_shared_bytes(frames_per_stage, win_rows, max_taps)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"tiled stages of {smem} bytes exceed {MAX_SHARED_BYTES} bytes "
                         f"of shared memory")
    geometry = _geometry_args(x, p0, f0, cfg)
    lib = library("resample")
    out = _out(n_out, lanes, clamp_s16, x.device)
    rows = torch.empty(n_out, dtype=torch.int32, device=x.device)
    if n_out:
        tstr_ptr, tstr_rows = ((None, 0) if table_strided is None
                               else (table_strided.data_ptr(), table_strided.shape[0]))
        err = lib.crt_tiled_mac(
            x.data_ptr(), x.shape[0], x.shape[1], lane_offset, lanes, *geometry,
            table.data_ptr(), table.shape[0], tstr_ptr, tstr_rows, n_out, max_taps,
            frames_per_stage, win_rows, _vec(x, lanes, lane_offset), out.data_ptr(),
            rows.data_ptr(), int(clamp_s16), x.device.index, _stream(x))
        _raise_on(err, "tiled_mac_kernel")
    return out, rows


def strided_mac(x, table, p0, f0, cfg, *, max_taps: int, n_out: int, d: int, lanes: int,
                lane_offset: int, frames_per_tile: int, win_rows: int,
                clamp_s16: bool) -> tuple:
    """Launch strided_mac_kernel, which computes the launch's geometry itself
    from the launch state (p0, f0: 0-dim int32 tensors on x's device, or
    ints) and ``cfg`` (ConfigScalars on x's device): frame n's window starts
    at r0 + n*d (clamped into x), its taps are frame 0's masked taps k0 from
    the flat LUT ``table``. Tiles of ``frames_per_tile`` frames stage
    ``win_rows`` rows each (0: read x directly). Returns (out (n_out, lanes)
    int32 -- int16 if clamped --, rows (n_out,) int32, the unclamped first
    window rows)."""
    _check_tensors(x, lanes, lane_offset, table=(table, 1))
    _check_taps(x, max_taps)
    if d < 1 or frames_per_tile not in (8, 16, 32, 64) or win_rows < 0:
        raise ValueError(f"bad strided launch: d {d}, {frames_per_tile} frames, "
                         f"{win_rows} rows")
    smem = strided_shared_bytes(max_taps, win_rows)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"strided stages of {smem} bytes exceed {MAX_SHARED_BYTES} bytes "
                         f"of shared memory")
    geometry = _geometry_args(x, p0, f0, cfg)
    lib = library("strided")
    out = _out(n_out, lanes, clamp_s16, x.device)
    rows = torch.empty(n_out, dtype=torch.int32, device=x.device)
    if n_out:
        err = lib.crt_strided_mac(
            x.data_ptr(), x.shape[0], x.shape[1], lane_offset, lanes, *geometry,
            table.data_ptr(), table.shape[0], n_out, max_taps, d, frames_per_tile, win_rows,
            _vec(x, lanes, lane_offset), out.data_ptr(), rows.data_ptr(), int(clamp_s16),
            x.device.index, _stream(x))
        _raise_on(err, "strided_mac_kernel")
    return out, rows


def wide_mac(x, table, table_strided, p0, f0, cfg, *, max_taps: int, n_out: int, d: int,
             lanes: int, lane_offset: int, clamp_s16: bool) -> tuple:
    """Launch wide_mac_kernel, which computes each frame's geometry itself
    from the launch state and ``cfg`` (as for tiled_mac) and sums each frame's
    taps run by run of WIDE_RUN_ROWS input rows into an int32 scratch
    (n_out, wide_slots(max_taps), lanes), with
    each slot's sum of taps beside it, then wide_fold_kernel, which sums
    each frame's slots and normalises. ``d``
    (increment >> 16) only sizes the grid. Returns (out (n_out, lanes) int32 -- int16 if clamped --, rows
    (n_out,) int32, the unclamped first window rows)."""
    tables = {"table": (table, 1)}
    if table_strided is not None:
        tables["table_strided"] = (table_strided, 2)
    _check_tensors(x, lanes, lane_offset, **tables)
    _check_taps(x, max_taps, table_strided)
    if n_out > 65535 or d < 0:
        raise ValueError(f"bad wide launch: {n_out} frames, d {d}")
    geometry = _geometry_args(x, p0, f0, cfg)
    lib = library("wide")
    slots = wide_slots(max_taps)
    # (n_out, slots, lanes) partial sums, then (n_out, slots) tap sums.
    partial = torch.empty(n_out * slots * (lanes + 1), dtype=torch.int32, device=x.device)
    out = _out(n_out, lanes, clamp_s16, x.device)
    rows = torch.empty(n_out, dtype=torch.int32, device=x.device)
    if n_out:
        # Runs the input span can hold: the last frame's window starts at most
        # (n_out - 1)(d + 1) rows after the first's.
        runs_bound = -(-((n_out - 1) * (d + 1) + max_taps) // WIDE_RUN_ROWS) + 1
        tstr_ptr, tstr_rows = ((None, 0) if table_strided is None
                               else (table_strided.data_ptr(), table_strided.shape[0]))
        err = lib.crt_wide_mac(
            x.data_ptr(), x.shape[0], x.shape[1], lane_offset, lanes, *geometry,
            table.data_ptr(), table.shape[0], tstr_ptr, tstr_rows, n_out, max_taps, slots,
            runs_bound, _vec(x, lanes, lane_offset), partial.data_ptr(),
            partial.data_ptr() + 4 * n_out * slots * lanes, out.data_ptr(),
            rows.data_ptr(), int(clamp_s16), x.device.index, _stream(x))
        _raise_on(err, "wide_mac_kernel")
    return out, rows
