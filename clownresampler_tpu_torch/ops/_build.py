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
synchronise. Each C entry's arguments have names (ENTRY_ARGS): a launcher
checks its tensors and builds the arguments by name (``*_launch_args``), so a
caller that repeats a launch (the whole-stream scan) checks once and then
calls the entry (``entry_function``) with ``ordered_args`` of the same
arguments, a few pointers replaced, with no torch op in between. A farm call
issues its copies and its wait the same way (``crt_farm_copy``,
``crt_farm_sync``), and its chunk's way into pinned memory and up
(``crt_farm_host_stage``, host threads of the farm library, whose counters
``crt_farm_host_stats`` reads).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import operator
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

# The C entries' arguments, in order and by name; the names in POINTER_ARGS
# pass as pointers (void*), every other as int. Every entry returns int.
POINTER_ARGS = frozenset((
    "x", "p0_ptr", "f0_ptr", "inc_hi", "inc_lo", "radius", "delta", "int_radius", "step",
    "table", "tstr", "partial", "tap_sums", "out", "rows_out", "n_valid", "stream",
    "chunk", "state_in", "produced", "over", "state_out",
    "src", "dst", "totals", "quotas", "consumed", "p_out", "f_out", "exhausted",
    "pinned", "srcs", "card"))
# The ConfigScalars pointers every MAC entry takes, in order (TILED_CONFIG_FIELDS).
CONFIG_ARGS = ("inc_hi", "inc_lo", "radius", "delta", "int_radius", "step")
LONG_ARGS = frozenset(("nbytes", "stride_b", "src_first", "src_end",
                       "row_bytes"))   # pass as long long
_LAUNCH_INPUT = ("x", "S", "L", "lane_offset", "lanes", "p0_ptr", "p0_val", "f0_ptr", "f0_val",
                 *CONFIG_ARGS, "table", "table_size")
_LAUNCH_OUTPUT = ("out", "rows_out", "clamp_s16", "n_valid", "frame_offset", "device", "stream")
# A scan-mode entry's source and state, and its bookkeeping and stream.
_SCAN_INPUT = ("src", "src_s16", "src_first", "src_end", "n_in", "S", "L", "copy", "vec",
               "state_in", *CONFIG_ARGS, "table", "table_size")
_SCAN_OUTPUT = ("produced", "over", "state_out", "device", "stream")
ENTRY_ARGS = {
    "crt_tiled_mac": (*_LAUNCH_INPUT, "tstr", "tstr_rows", "N", "T", "frames_per_stage",
                      "win_rows", "vec", *_LAUNCH_OUTPUT),
    "crt_tiled_scan": (*_SCAN_INPUT, "tstr", "tstr_rows", "N", "T", "frames_per_stage",
                       "win_rows", "out", *_SCAN_OUTPUT),
    "crt_strided_mac": (*_LAUNCH_INPUT, "N", "T", "d", "frames_per_tile", "win_rows", "vec",
                        *_LAUNCH_OUTPUT),
    "crt_strided_scan": (*_SCAN_INPUT, "N", "T", "d", "frames_per_tile", "win_rows", "out",
                         *_SCAN_OUTPUT),
    "crt_wide_mac": (*_LAUNCH_INPUT, "tstr", "tstr_rows", "N", "T", "K", "runs_bound", "vec",
                     "partial", "tap_sums", *_LAUNCH_OUTPUT),
    "crt_wide_scan": (*_SCAN_INPUT, "tstr", "tstr_rows", "N", "T", "K", "runs_bound", "n_out",
                      "frame_offset", "partial", "tap_sums", "out", *_SCAN_OUTPUT),
    "crt_farm_stage": ("src", "dst", "chunk", "streams", "n_in", "channels", "keep", "consumed",
                       "capacity", "tile_streams", "tile_frames", "path", "stages", "slot",
                       "device", "stream"),
    "crt_farm_unstage": ("src", "dst", "L", "n_out", "stream_lo", "streams", "channels",
                         "out_s16", "words", "tile_streams", "tile_frames", "device", "stream"),
    "crt_farm_copy": ("dst", "src", "nbytes", "device", "stream"),
    "crt_farm_host_stage": ("pinned", "srcs", "rows", "row_bytes", "card", "device", "stream"),
    "crt_farm_host_stats": ("out",),
    "crt_farm_sync": ("device", "stream"),
    "crt_batch_mac": ("x", "x_s16", "B", "S", "C", "stride_b", "totals", "quotas", "p0_ptr",
                      "f0_ptr", "inc_hi", "inc_lo", "radius", "delta", "int_radius", "step",
                      "table", "table_size", "T", "N", "channel_tile", "range_frames", "copy",
                      "out", "produced", "consumed", "p_out", "f_out", "exhausted", "device",
                      "stream"),
}
# library -> (source file, its C entries).
LIBRARIES = {
    "resample": ("resample_kernels.cu", ("crt_tiled_mac", "crt_tiled_scan")),
    "strided": ("strided_kernels.cu", ("crt_strided_mac", "crt_strided_scan")),
    "wide": ("wide_kernels.cu", ("crt_wide_mac", "crt_wide_scan")),
    "farm": ("farm_kernels.cu", ("crt_farm_stage", "crt_farm_unstage", "crt_farm_copy",
                                 "crt_farm_host_stage", "crt_farm_host_stats", "crt_farm_sync")),
    "batch": ("batch_kernels.cu", ("crt_batch_mac",)),
}
# C entry -> (its library, what it launches, for error messages).
ENTRIES = {"crt_tiled_mac": ("resample", "tiled_mac_kernel"),
           "crt_tiled_scan": ("resample", "tiled_mac_kernel"),
           "crt_strided_mac": ("strided", "strided_mac_kernel"),
           "crt_strided_scan": ("strided", "strided_mac_kernel"),
           "crt_wide_mac": ("wide", "wide_mac_kernel"),
           "crt_wide_scan": ("wide", "wide_mac_kernel"),
           "crt_farm_stage": ("farm", "farm_stage_kernel"),
           "crt_farm_unstage": ("farm", "farm_unstage_kernel"),
           "crt_farm_copy": ("farm", "cudaMemcpyAsync"),
           "crt_farm_host_stage": ("farm", "the host copy into pinned memory"),
           "crt_farm_host_stats": ("farm", "the host copy's counters"),
           "crt_farm_sync": ("farm", "cudaStreamSynchronize"),
           "crt_batch_mac": ("batch", "batch_mac_kernel")}

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
                for entry in entries:
                    fn = getattr(lib, entry)
                    fn.argtypes = [ctypes.c_void_p if arg in POINTER_ARGS
                                   else ctypes.c_longlong if arg in LONG_ARGS else ctypes.c_int
                                   for arg in ENTRY_ARGS[entry]]
                    fn.restype = ctypes.c_int
                BUILD_LOG["paths"][lib_name] = so
                _libs[lib_name] = lib
            err = _libs["resample"].crt_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            BUILD_LOG["seconds"] = time.perf_counter() - t0
        return _libs[name]


def _check_cuda(x) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernels take CUDA tensors, got {x.device}")


def _check_tensors(x, lanes, lane_offset, **tensors):
    """x is a contiguous (S, L) int32 CUDA tensor, each named tensor
    (value: (tensor, ndim)) a contiguous int32 tensor of that rank on x's
    device, and [lane_offset, lane_offset + lanes) lies inside x's lanes."""
    _check_cuda(x)
    for name, (t, nd) in {"x": (x, 2), **tensors}.items():
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.int32 or t.dim() != nd or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {nd}-d int32 tensor, "
                             f"got {t.dtype} {tuple(t.shape)}")
    if not (lanes > 0 and lane_offset >= 0 and lane_offset + lanes <= x.shape[1]):
        raise ValueError(f"lanes [{lane_offset}, {lane_offset + lanes}) outside x's "
                         f"{x.shape[1]} lanes")


def entry_function(entry: str):
    """The C entry ``entry`` of its loaded library, its argument types set."""
    return getattr(library(ENTRIES[entry][0]), entry)


_ORDERED = {entry: operator.itemgetter(*names) for entry, names in ENTRY_ARGS.items()}


def ordered_args(entry: str, args: dict) -> tuple:
    """``args`` (by name) in the order the C entry takes them."""
    return _ORDERED[entry](args)


def raise_on_launch(err: int, entry: str) -> None:
    """Raise if the C entry ``entry`` returned a CUDA error."""
    if err != 0:
        msg = library("resample").crt_error_string(err).decode()
        raise RuntimeError(f"{ENTRIES[entry][1]} failed: {msg}")


def _launch(entry: str, args: dict) -> None:
    raise_on_launch(entry_function(entry)(*ordered_args(entry, args)), entry)


def _stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# Lanes of one staged tile of the tiled and strided kernels (32 threads x 4
# lanes); a staged window row is this many ints.
TILED_LANES = 128
# The ConfigScalars fields the kernels read, in their argument order
# (CONFIG_ARGS names those arguments).
TILED_CONFIG_FIELDS = ("increment_hi", "increment_lo", "stretched_kernel_radius",
                       "stretched_kernel_radius_delta", "integer_stretched_kernel_radius",
                       "kernel_step_size")
# Input rows of one staged run of wide_mac_kernel (wide_kernels.cu
# WIDE_RUN_ROWS); 64 measured faster than 32 and 128 on the H100 (PERF.md).
WIDE_RUN_ROWS = 64


def tiled_shared_bytes(frames: int, win_rows: int, taps: int, elem_bytes: int = 4) -> int:
    """Dynamic shared memory of one tiled_mac_kernel block: two stages, each
    a window of win_rows x TILED_LANES samples of ``elem_bytes`` bytes (int32
    rows; the scan mode's int16 or int32 stream rows) and its frames' taps,
    rows, reciprocals and live tap counts."""
    return 2 * (win_rows * TILED_LANES * elem_bytes + 4 * frames * (taps + 3))


def strided_shared_bytes(taps: int, win_rows: int, elem_bytes: int = 4) -> int:
    """Dynamic shared memory of one strided_mac_kernel block: the tap vector
    k0 (padded to a multiple of 4), its sum and 3 ints of padding, and two
    stages of win_rows x TILED_LANES samples of ``elem_bytes`` bytes (int32
    rows; the scan mode's int16 or int32 stream rows)."""
    return 4 * (-(-taps // 4) * 4 + 4) + 2 * win_rows * TILED_LANES * elem_bytes


def wide_slots(taps: int) -> int:
    """Partial-sum slots of one frame in wide_mac_kernel's scratch: the most
    runs of WIDE_RUN_ROWS rows a window of ``taps`` rows can meet."""
    return (taps + WIDE_RUN_ROWS - 2) // WIDE_RUN_ROWS + 1


# wide_mac_kernel (wide_kernels.cu): its threads, and the frames of an item
# whose taps it gathers with the item's rows (WIDE_AHEAD_FRAMES; a warp
# fetches a further frame's taps itself); its static shared memory (those
# taps, two stages of WIDE_AHEAD_FRAMES x WIDE_RUN_ROWS ints, and a row of
# WIDE_RUN_ROWS taps a warp).
WIDE_THREADS = 256
WIDE_AHEAD_FRAMES = 16
WIDE_STATIC_SHARED_BYTES = 4 * WIDE_RUN_ROWS * (2 * WIDE_AHEAD_FRAMES + WIDE_THREADS // 32)


def wide_first_frame(*, p0: int, f0: int, inc: int, delta: int, n_frames: int, row_max: int,
                     bound: int) -> int:
    """The first frame in [0, n_frames] whose window row, clamped into [0,
    row_max], exceeds ``bound`` (wide_kernels.cu wide_first_frame): frame
    n's row p0 + (t >> 16) + min_rel, t = f0 + n*inc, is p0 + ceil((t +
    delta) / 2^16), so for 0 <= bound < row_max it passes bound from n =
    x // inc + 1 on, x = (bound - p0) * 2^16 - f0 - delta (from 0 if x <
    0)."""
    if bound < 0:
        return 0
    if bound >= row_max:
        return n_frames
    x = (bound - p0) * 65536 - f0 - delta
    n = 0 if x < 0 else (x // inc + 1 if inc > 0 else n_frames)
    return min(n, n_frames)


def wide_plan(n_out: int, lanes: int, d: int, max_taps: int, elem_bytes: int = 4) -> dict:
    """wide_mac_kernel's launch, from its shape: the runs of WIDE_RUN_ROWS
    rows its input span can hold at most (d = increment >> 16), its lane
    tiles of TILED_LANES and the items (run x lane tile) the persistent
    blocks walk at most, a frame's partial-sum slots and the scratch they
    take (wide_scratch_ints), and a block's shared memory: two staged runs
    of ``elem_bytes``-byte samples and the static taps."""
    runs = _wide_runs_bound(n_out, d, max_taps)
    lane_tiles = -(-lanes // TILED_LANES)
    return dict(runs_bound=runs, lane_tiles=lane_tiles, items_bound=runs * lane_tiles,
                slots=wide_slots(max_taps), scratch_ints=wide_scratch_ints(max_taps, n_out, lanes),
                shared_bytes=(2 * WIDE_RUN_ROWS * TILED_LANES * elem_bytes
                              + WIDE_STATIC_SHARED_BYTES))


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


def _geometry_args(x, p0, f0, cfg) -> dict:
    """The C entries' GeometryArgs by name: p0 and f0 (pointer, value) and the
    pointers of TILED_CONFIG_FIELDS, which must be tensors on x's device."""
    scalars = [_scalar_arg(getattr(cfg, f), x, f)[0] for f in TILED_CONFIG_FIELDS]
    if None in scalars:
        raise ValueError("the kernels read ConfigScalars as tensors on x's device")
    p0_ptr, p0_val = _scalar_arg(p0, x, "position_integer")
    f0_ptr, f0_val = _scalar_arg(f0, x, "position_fractional")
    return dict(p0_ptr=p0_ptr, p0_val=p0_val, f0_ptr=f0_ptr, f0_val=f0_val,
                **dict(zip(CONFIG_ARGS, scalars)))


def _input_args(x, table, p0, f0, cfg, lanes: int, lane_offset: int) -> dict:
    """The arguments every MAC entry starts with, by name, and the launch's
    device and stream (PyTorch's current one on x's device), in a new dict
    that the caller completes."""
    args = _geometry_args(x, p0, f0, cfg)
    args.update(x=x.data_ptr(), S=x.shape[0], L=x.shape[1], lane_offset=lane_offset,
                lanes=lanes, table=table.data_ptr(), table_size=table.shape[0],
                vec=_vec(x, lanes, lane_offset), device=x.device.index, stream=_stream(x))
    return args


def _allocate_outputs(args: dict, x, n_out: int, lanes: int, clamp_s16: bool, n_valid,
                      frame_offset: int) -> tuple:
    """(out, rows) of a launcher that allocates its outputs, their arguments
    added to ``args``; ``n_valid`` is None or a one-element int32 tensor on
    x's device."""
    out = torch.empty((n_out, lanes), dtype=torch.int16 if clamp_s16 else torch.int32,
                      device=x.device)
    rows = torch.empty(n_out, dtype=torch.int32, device=x.device)
    valid = None if n_valid is None else _scalar_arg(n_valid, x, "n_valid")[0]
    if n_valid is not None and valid is None:
        raise ValueError("n_valid must be a one-element int32 tensor on x's device")
    args.update(out=out.data_ptr(), rows_out=rows.data_ptr(), clamp_s16=int(clamp_s16),
                n_valid=valid, frame_offset=int(frame_offset))
    return out, rows


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


def tiled_launch_args(x, table, table_strided, p0, f0, cfg, *, max_taps: int, n_out: int,
                      lanes: int, lane_offset: int, frames_per_stage: int,
                      win_rows: int) -> dict:
    """Check a tiled_mac_kernel launch and return crt_tiled_mac's arguments by
    name, all but the outputs' (out, rows_out, clamp_s16, n_valid,
    frame_offset)."""
    _check_tensors(x, lanes, lane_offset, **_tables(table, table_strided))
    _check_taps(x, max_taps, table_strided)
    if frames_per_stage not in (8, 16, 32, 64) or win_rows < 0:
        raise ValueError(f"bad tiled stage: {frames_per_stage} frames, {win_rows} rows")
    smem = tiled_shared_bytes(frames_per_stage, win_rows, max_taps)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"tiled stages of {smem} bytes exceed {MAX_SHARED_BYTES} bytes "
                         f"of shared memory")
    args = _input_args(x, table, p0, f0, cfg, lanes, lane_offset)
    args.update(**_tstr_args(table_strided), N=n_out, T=max_taps,
                frames_per_stage=frames_per_stage, win_rows=win_rows)
    return args


def tiled_mac(x, table, table_strided, p0, f0, cfg, *, max_taps: int, n_out: int, lanes: int,
              lane_offset: int, frames_per_stage: int, win_rows: int,
              clamp_s16: bool, n_valid=None, frame_offset: int = 0) -> tuple:
    """Launch tiled_mac_kernel (the tiled and general entries), which
    computes each frame's geometry itself from the launch state (p0, f0:
    0-dim int32 tensors on x's device, or ints) and ``cfg`` (ConfigScalars
    on x's device), reading the flat LUT ``table`` or, when given, its
    strided form (R, max_taps). Each stage holds ``win_rows`` rows (0: read
    x directly) and the frames of at most ``frames_per_stage`` frames: the
    kernel takes the most of frames_per_stage, half that, ..., 8 whose
    window fits (ops.resample.stage_frames). With ``n_valid`` (a one-element
    int32 tensor on x's device) frames n with n + frame_offset >= n_valid
    are stored as 0. Returns (out (n_out, lanes)
    int32 -- int16 if clamped --, rows (n_out,) int32, the unclamped first
    window rows)."""
    args = tiled_launch_args(x, table, table_strided, p0, f0, cfg, max_taps=max_taps,
                             n_out=n_out, lanes=lanes, lane_offset=lane_offset,
                             frames_per_stage=frames_per_stage, win_rows=win_rows)
    out, rows = _allocate_outputs(args, x, n_out, lanes, clamp_s16, n_valid, frame_offset)
    if n_out:
        _launch("crt_tiled_mac", args)
    return out, rows


def strided_launch_args(x, table, p0, f0, cfg, *, max_taps: int, n_out: int, d: int,
                        lanes: int, lane_offset: int, frames_per_tile: int,
                        win_rows: int) -> dict:
    """Check a strided_mac_kernel launch and return crt_strided_mac's
    arguments by name, all but the outputs'."""
    _check_tensors(x, lanes, lane_offset, table=(table, 1))
    _check_taps(x, max_taps)
    if d < 1 or frames_per_tile not in (8, 16, 32, 64) or win_rows < 0:
        raise ValueError(f"bad strided launch: d {d}, {frames_per_tile} frames, "
                         f"{win_rows} rows")
    smem = strided_shared_bytes(max_taps, win_rows)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"strided stages of {smem} bytes exceed {MAX_SHARED_BYTES} bytes "
                         f"of shared memory")
    args = _input_args(x, table, p0, f0, cfg, lanes, lane_offset)
    args.update(N=n_out, T=max_taps, d=d, frames_per_tile=frames_per_tile, win_rows=win_rows)
    return args


def strided_mac(x, table, p0, f0, cfg, *, max_taps: int, n_out: int, d: int, lanes: int,
                lane_offset: int, frames_per_tile: int, win_rows: int,
                clamp_s16: bool, n_valid=None, frame_offset: int = 0) -> tuple:
    """Launch strided_mac_kernel, which computes the launch's geometry itself
    from the launch state (p0, f0: 0-dim int32 tensors on x's device, or
    ints) and ``cfg`` (ConfigScalars on x's device): frame n's window starts
    at r0 + n*d (clamped into x), its taps are frame 0's masked taps k0 from
    the flat LUT ``table``. Tiles of ``frames_per_tile`` frames stage
    ``win_rows`` rows each (0: read x directly). ``n_valid`` and
    ``frame_offset`` as for tiled_mac. Returns (out (n_out, lanes)
    int32 -- int16 if clamped --, rows (n_out,) int32, the unclamped first
    window rows)."""
    args = strided_launch_args(x, table, p0, f0, cfg, max_taps=max_taps, n_out=n_out, d=d,
                               lanes=lanes, lane_offset=lane_offset,
                               frames_per_tile=frames_per_tile, win_rows=win_rows)
    out, rows = _allocate_outputs(args, x, n_out, lanes, clamp_s16, n_valid, frame_offset)
    if n_out:
        _launch("crt_strided_mac", args)
    return out, rows


def wide_scratch_ints(max_taps: int, n_out: int, lanes: int) -> int:
    """Ints of a wide launch's scratch: (n_out, slots, lanes) partial sums,
    then (n_out, slots) tap sums."""
    return n_out * wide_slots(max_taps) * (lanes + 1)


def wide_launch_args(x, table, table_strided, p0, f0, cfg, partial, *, max_taps: int,
                     n_out: int, d: int, lanes: int, lane_offset: int) -> dict:
    """Check a wide launch (wide_mac_kernel, then wide_fold_kernel) and return
    crt_wide_mac's arguments by name, all but the outputs'; ``partial`` is
    its int32 scratch of at least wide_scratch_ints ints on x's device."""
    _check_tensors(x, lanes, lane_offset, partial=(partial, 1), **_tables(table, table_strided))
    _check_taps(x, max_taps, table_strided)
    if n_out > 65535 or d < 0:
        raise ValueError(f"bad wide launch: {n_out} frames, d {d}")
    slots = wide_slots(max_taps)
    if partial.numel() < wide_scratch_ints(max_taps, n_out, lanes):
        raise ValueError(f"wide scratch of {partial.numel()} ints is too small")
    args = _input_args(x, table, p0, f0, cfg, lanes, lane_offset)
    args.update(**_tstr_args(table_strided), N=n_out, T=max_taps, K=slots,
                runs_bound=_wide_runs_bound(n_out, d, max_taps), partial=partial.data_ptr(),
                tap_sums=partial.data_ptr() + 4 * n_out * slots * lanes)
    return args


def _wide_runs_bound(n_out: int, d: int, max_taps: int) -> int:
    """Runs of WIDE_RUN_ROWS rows a wide launch's input span can hold: the
    last frame's window starts at most (n_out - 1)(d + 1) rows after the
    first's."""
    return -(-(max(n_out - 1, 0) * (d + 1) + max_taps) // WIDE_RUN_ROWS) + 1


def wide_mac(x, table, table_strided, p0, f0, cfg, *, max_taps: int, n_out: int, d: int,
             lanes: int, lane_offset: int, clamp_s16: bool, n_valid=None,
             frame_offset: int = 0) -> tuple:
    """Launch wide_mac_kernel, which computes each frame's geometry itself
    from the launch state and ``cfg`` (as for tiled_mac) and sums each frame's
    taps run by run of WIDE_RUN_ROWS input rows into an int32 scratch
    (n_out, wide_slots(max_taps), lanes), with
    each slot's sum of taps beside it, then wide_fold_kernel, which sums
    each frame's slots and normalises. ``d``
    (increment >> 16) only sizes the grid. ``n_valid`` and ``frame_offset``
    as for tiled_mac (the fold stores the zeros). Returns (out (n_out, lanes) int32 -- int16 if clamped --, rows
    (n_out,) int32, the unclamped first window rows)."""
    partial = torch.empty(wide_scratch_ints(max_taps, n_out, lanes), dtype=torch.int32,
                          device=x.device)
    args = wide_launch_args(x, table, table_strided, p0, f0, cfg, partial, max_taps=max_taps,
                            n_out=n_out, d=d, lanes=lanes, lane_offset=lane_offset)
    out, rows = _allocate_outputs(args, x, n_out, lanes, clamp_s16, n_valid, frame_offset)
    if n_out:
        _launch("crt_wide_mac", args)
    return out, rows


# How a scan mode copies a window's stream rows (mac_common.cuh SCAN_COPY_*):
# element loads, 4-byte or 16-byte cp.async.
SCAN_COPY_ELEMENTS, SCAN_COPY_WORDS, SCAN_COPY_VEC = 0, 1, 2


def scan_copy_path(*, elem_bytes: int, lanes: int, ptr: int) -> int:
    """The copy path of a scan-mode launch over a stream of ``lanes`` lanes
    of ``elem_bytes``-byte samples at address ``ptr``: SCAN_COPY_VEC when
    every row and the stream start on 16 bytes (8 int16 or 4 int32 lanes a
    copy), else SCAN_COPY_WORDS when on 4 bytes, else SCAN_COPY_ELEMENTS
    (an odd int16 lane count, or an int16 stream off 4 bytes)."""
    row = lanes * elem_bytes
    if row % 16 == 0 and ptr % 16 == 0:
        return SCAN_COPY_VEC
    return SCAN_COPY_WORDS if row % 4 == 0 and ptr % 4 == 0 else SCAN_COPY_ELEMENTS


def scan_window(step: int, n_in: int, radius: int) -> dict:
    """Scan step ``step``'s window in stream rows: window row i is stream row
    src_first + i while that lies in [0, src_end), else 0 -- the JAX scan's
    staged [halo | chunk | zeros] (clownresampler_tpu/lowlevel.py:378-412)."""
    return dict(src_first=step * n_in - 2 * radius, src_end=(step + 1) * n_in)


def _scan_args(chunks, state_in, cfg, out, produced, over, state_out, *, step: int,
               radius: int, max_taps: int, **tensors) -> dict:
    """Check what every scan-mode launch takes and return the arguments its C
    entry shares with the others (_SCAN_INPUT, out, _SCAN_OUTPUT) by name:
    scan step ``step`` of ``chunks`` (K, n_in, L) int16 or int32, read as one
    stream, from the state ``state_in`` (2,) -- (p with the scan's +radius
    bias, f) --, frames into ``out`` (N, L) int32, ``produced`` and ``over``
    (1,) and ``state_out`` (2,) int32; ``cfg`` ConfigScalars; ``tensors``
    (name: (tensor, ndim)) the launch's tables and scratch, int32;
    everything contiguous on the chunks' card."""
    _check_cuda(chunks)
    if (chunks.dim() != 3 or chunks.dtype not in (torch.int16, torch.int32)
            or not chunks.is_contiguous()):
        raise ValueError(f"chunks must be a contiguous (K, n_in, L) int16 or int32 tensor, got "
                         f"{chunks.dtype} {tuple(chunks.shape)}")
    k, n_in, lanes = chunks.shape
    n_out = out.shape[0] if out.dim() == 2 else -1
    small = dict(state_in=(state_in, 2), state_out=(state_out, 2), produced=(produced, 1),
                 over=(over, 1))
    _check_tensors(out, lanes, 0, **tensors, **{name: (t, 1) for name, (t, _) in small.items()})
    for name, (t, numel) in small.items():
        if t.numel() != numel:
            raise ValueError(f"{name} must have {numel} elements, got {t.numel()}")
    if chunks.device != out.device or not (0 <= step < k and n_out > 0 and radius >= 0):
        raise ValueError(f"bad scan step {step} of chunks {tuple(chunks.shape)} on "
                         f"{chunks.device}, radius {radius}, out {tuple(out.shape)} on "
                         f"{out.device}")
    table_strided = tensors.get("table_strided", (None,))[0]
    if max_taps <= 0 or (table_strided is not None and table_strided.shape[1] != max_taps):
        raise ValueError(f"bad scan taps: {max_taps}, strided table "
                         f"{None if table_strided is None else tuple(table_strided.shape)}")
    scalars = [_scalar_arg(getattr(cfg, f), out, f)[0] for f in TILED_CONFIG_FIELDS]
    if None in scalars:
        raise ValueError("the kernels read ConfigScalars as tensors on the chunks' device")
    ptr, table = chunks.data_ptr(), tensors["table"][0]
    return dict(src=ptr, src_s16=int(chunks.dtype == torch.int16),
                # S: the staged buffer the step stands for, [halo | chunk | max_taps + 8
                # zero rows], by which the padding frames' windows are clamped.
                **scan_window(step, n_in, radius), n_in=n_in, S=2 * radius + n_in + max_taps + 8,
                L=lanes,
                copy=scan_copy_path(elem_bytes=chunks.element_size(), lanes=lanes, ptr=ptr),
                vec=int(lanes % 4 == 0 and out.data_ptr() % 16 == 0),
                state_in=state_in.data_ptr(), **dict(zip(CONFIG_ARGS, scalars)),
                table=table.data_ptr(), table_size=table.shape[0], out=out.data_ptr(),
                produced=produced.data_ptr(), over=over.data_ptr(),
                state_out=state_out.data_ptr(), device=out.device.index, stream=_stream(out))


def _tables(table, table_strided) -> dict:
    """A launch's LUT tensors for _check_tensors / _scan_args: the flat
    table, and its strided form when given."""
    tables = {"table": (table, 1)}
    if table_strided is not None:
        tables["table_strided"] = (table_strided, 2)
    return tables


def _tstr_args(table_strided) -> dict:
    return (dict(tstr=None, tstr_rows=0) if table_strided is None
            else dict(tstr=table_strided.data_ptr(), tstr_rows=table_strided.shape[0]))


def tiled_scan_args(chunks, table, table_strided, state_in, cfg, out, produced, over,
                    state_out, *, step: int, radius: int, max_taps: int, frames_per_stage: int,
                    win_rows: int) -> dict:
    """Check one scan-mode tiled_mac_kernel launch (a tiled or general scan
    step) and return crt_tiled_scan's arguments by name (_scan_args: its n_out
    frames into ``out`` (n_out, L)); the flat LUT ``table`` or its strided
    form; stages as for tiled_mac, their rows of the chunks' type."""
    args = _scan_args(chunks, state_in, cfg, out, produced, over, state_out, step=step,
                      radius=radius, max_taps=max_taps, **_tables(table, table_strided))
    if frames_per_stage not in (8, 16, 32, 64) or win_rows < 0:
        raise ValueError(f"bad tiled stage: {frames_per_stage} frames, {win_rows} rows")
    smem = tiled_shared_bytes(frames_per_stage, win_rows, max_taps, chunks.element_size())
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"tiled stages of {smem} bytes exceed {MAX_SHARED_BYTES} bytes "
                         f"of shared memory")
    args.update(**_tstr_args(table_strided), N=out.shape[0], T=max_taps,
                frames_per_stage=frames_per_stage, win_rows=win_rows)
    return args


def tiled_scan(chunks, table, table_strided, state_in, cfg, out, produced, over, state_out, *,
               step: int, radius: int, max_taps: int, frames_per_stage: int,
               win_rows: int) -> None:
    """Launch tiled_mac_kernel once in scan mode (tiled_scan_args): scan step
    ``step`` straight from the chunks -- each block copies its tiles' window
    rows from the stream, as int16 when the chunks are, into shared memory --
    and its bookkeeping, written in place."""
    _launch("crt_tiled_scan", tiled_scan_args(
        chunks, table, table_strided, state_in, cfg, out, produced, over, state_out, step=step,
        radius=radius, max_taps=max_taps, frames_per_stage=frames_per_stage, win_rows=win_rows))


def strided_scan_args(chunks, table, state_in, cfg, out, produced, over, state_out, *,
                      step: int, radius: int, max_taps: int, d: int, frames_per_tile: int,
                      win_rows: int) -> dict:
    """Check one scan-mode strided_mac_kernel launch (a strided scan step) and
    return crt_strided_scan's arguments by name (_scan_args: its n_out frames
    into ``out`` (n_out, L)); frame 0's taps from the flat LUT ``table``;
    tiles as for strided_mac, their rows of the chunks' type."""
    args = _scan_args(chunks, state_in, cfg, out, produced, over, state_out, step=step,
                      radius=radius, max_taps=max_taps, table=(table, 1))
    if d < 1 or frames_per_tile not in (8, 16, 32, 64) or win_rows < 0:
        raise ValueError(f"bad strided launch: d {d}, {frames_per_tile} frames, "
                         f"{win_rows} rows")
    smem = strided_shared_bytes(max_taps, win_rows, chunks.element_size())
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"strided stages of {smem} bytes exceed {MAX_SHARED_BYTES} bytes "
                         f"of shared memory")
    args.update(N=out.shape[0], T=max_taps, d=d, frames_per_tile=frames_per_tile,
                win_rows=win_rows)
    return args


def strided_scan(chunks, table, state_in, cfg, out, produced, over, state_out, *, step: int,
                 radius: int, max_taps: int, d: int, frames_per_tile: int,
                 win_rows: int) -> None:
    """Launch strided_mac_kernel once in scan mode (strided_scan_args): scan
    step ``step`` straight from the chunks and its bookkeeping, written in
    place."""
    _launch("crt_strided_scan", strided_scan_args(
        chunks, table, state_in, cfg, out, produced, over, state_out, step=step, radius=radius,
        max_taps=max_taps, d=d, frames_per_tile=frames_per_tile, win_rows=win_rows))


def wide_scan_args(chunks, table, table_strided, state_in, cfg, partial, out, produced, over,
                   state_out, *, step: int, radius: int, max_taps: int, d: int, n_out: int,
                   frame_offset: int) -> dict:
    """Check one scan-mode wide launch (wide_mac_kernel, then
    wide_fold_kernel) of a wide scan step and return crt_wide_scan's
    arguments by name (_scan_args): frames [frame_offset, frame_offset + N)
    of the step's ``n_out`` into ``out`` (N, L); the kernels derive the
    launch's state from the step's state and the offset, and the offset-0
    launch writes the bookkeeping. ``partial`` is the
    launch's int32 scratch of at least wide_scratch_ints ints; ``d``
    (increment >> 16) only sizes the grid."""
    args = _scan_args(chunks, state_in, cfg, out, produced, over, state_out, step=step,
                      radius=radius, max_taps=max_taps, partial=(partial, 1),
                      **_tables(table, table_strided))
    frames, lanes = out.shape
    if d < 0 or frames > 65535 or frame_offset < 0 or frame_offset + frames > n_out:
        raise ValueError(f"bad wide scan launch: frames [{frame_offset}, "
                         f"{frame_offset + frames}) of {n_out}, d {d}")
    if partial.numel() < wide_scratch_ints(max_taps, frames, lanes):
        raise ValueError(f"wide scratch of {partial.numel()} ints is too small")
    slots = wide_slots(max_taps)
    args.update(**_tstr_args(table_strided), N=frames, T=max_taps, K=slots,
                runs_bound=_wide_runs_bound(frames, d, max_taps), n_out=n_out,
                frame_offset=frame_offset, partial=partial.data_ptr(),
                tap_sums=partial.data_ptr() + 4 * frames * slots * lanes,
                vec=int(args["vec"] and partial.data_ptr() % 16 == 0))
    return args


def wide_scan(chunks, table, table_strided, state_in, cfg, partial, out, produced, over,
              state_out, *, step: int, radius: int, max_taps: int, d: int, n_out: int,
              frame_offset: int) -> None:
    """Launch wide_mac_kernel and wide_fold_kernel once in scan mode
    (wide_scan_args): one launch of scan step ``step`` straight from the
    chunks, written in place."""
    _launch("crt_wide_scan", wide_scan_args(
        chunks, table, table_strided, state_in, cfg, partial, out, produced, over, state_out,
        step=step, radius=radius, max_taps=max_taps, d=d, n_out=n_out,
        frame_offset=frame_offset))


# Samples of a farm tile's row (about 128 lanes) and its frames; the most
# channels a farm kernel takes (a tile then holds two streams of one frame).
FARM_TILE_LANES = 128
FARM_TILE_FRAMES = 32
FARM_MAX_CHANNELS = 4096
# farm_stage_kernel's ring (farm_kernels.cu): its stages, a stream's run of a
# tile (bytes of int16 input, one bulk copy) and a tile's part of a staged row
# (bytes of int32 output), which chip_scripts/farm_ring_sweep.py measured
# against others on the H100 (PERF.md); and the bytes of a block's shared
# memory before its stages, which hold 2 x stages mbarriers (RING_HEADER in
# the C source), so at most FARM_RING_HEADER // 16 stages.
FARM_RING = 4
FARM_RING_RUN_BYTES = 256
FARM_RING_ROW_BYTES = 256
FARM_RING_HEADER = 128
# crt_farm_stage's paths: element by element, 16-byte stores, the ring.
FARM_STAGE_ELEMENT, FARM_STAGE_VEC, FARM_STAGE_RING = 0, 1, 2
# crt_farm_host_stage's pieces, whose uploads are issued as each lands
# (farm_kernels.cu HOST_PIECES; its thread count is the source's alone).
FARM_HOST_PIECES = 8


def farm_host_pieces(nbytes: int) -> list:
    """The byte bounds of crt_farm_host_stage's pieces of ``nbytes``: equal
    pieces of whole 64-byte units, the last one shorter, none empty (the C
    entry's rule)."""
    step = -(-(-(-nbytes // FARM_HOST_PIECES)) // 64) * 64
    return [(lo, min(nbytes, lo + step)) for lo in range(0, nbytes, step)] if nbytes else []


def farm_host_stage_args(pinned: int, sources, row_bytes: int, card: int, device: int,
                         stream: int) -> dict:
    """crt_farm_host_stage's arguments: the rows at the addresses of the
    uint64 array ``sources`` (0 for a row of zeros), ``row_bytes`` each, to
    the host address ``pinned`` (pinned memory where they go on) and from
    there to the card address ``card`` (None: nowhere). ``sources`` must stay
    alive until the call returns."""
    if row_bytes <= 0 or len(sources) == 0 or sources.dtype != "uint64":
        raise ValueError(f"bad farm host stage: {len(sources)} rows of {row_bytes} bytes")
    return dict(pinned=pinned, srcs=sources.ctypes.data, rows=len(sources), row_bytes=row_bytes,
                card=card, device=device, stream=stream)


def farm_tile(granule: int) -> tuple:
    """(streams, frames) of one shared-memory tile of farm_unstage_kernel and
    of farm_stage_kernel off the ring, for ``granule`` samples (or words) a
    stream and frame: an even count of streams of about FARM_TILE_LANES
    lanes, FARM_TILE_FRAMES frames unless the granule is so wide that two
    streams pass 2 x FARM_TILE_LANES."""
    streams = max(2, FARM_TILE_LANES // granule // 2 * 2)
    width = streams * granule
    frames = (FARM_TILE_FRAMES if width <= 2 * FARM_TILE_LANES
              else max(1, 2 * FARM_TILE_LANES * FARM_TILE_FRAMES // width))
    return streams, frames


def farm_ring_layout(channels: int, stages: int = FARM_RING, tile: tuple | None = None) -> dict:
    """crt_farm_stage's ring arguments for ``channels`` channels, which the C
    entry lays a block's shared memory out by, and the bytes that takes
    (``shared_bytes``): ``stages`` stages after FARM_RING_HEADER bytes, each
    a tile of ``tile`` (streams, frames) -- by default an even count of
    streams whose lanes fill about FARM_RING_ROW_BYTES of a staged row, and
    the frames of a run of about FARM_RING_RUN_BYTES, whole 16-byte units --,
    each stream's slot of a stage whole 16-byte units, their count odd, so
    that neighbouring slots start on different banks."""
    if tile is None:
        unit = 8 // math.gcd(channels, 8)          # frames of a multiple of 8 samples
        tile = (max(2, FARM_RING_ROW_BYTES // (4 * channels) // 2 * 2),
                max(unit, FARM_RING_RUN_BYTES // (2 * channels) // unit * unit))
    streams, frames = tile
    words = -(-frames * channels // 8) * 4
    slot = words if words // 4 % 2 else words + 4
    return dict(tile_streams=streams, tile_frames=frames, stages=stages, slot=slot,
                shared_bytes=FARM_RING_HEADER + stages * streams * slot * 4)


def farm_stage_path(*, channels: int, streams: int, n_in: int, chunk_ptr: int, src_ptr: int,
                    dst_ptr: int) -> int:
    """The path of a farm_stage launch, from its shapes and addresses: the
    ring (FARM_STAGE_RING) when every bulk copy and store it makes is 16-byte
    aligned -- C even, n_in * C a multiple of 8, L = streams * C a multiple
    of 4, the chunk, src and dst 16-byte aligned --, there are frames and its
    stages fit in shared memory; else one tile in flight a block with 16-byte
    stores (FARM_STAGE_VEC) when C is even, L a multiple of 4 and the
    pointers aligned; else element by element (FARM_STAGE_ELEMENT)."""
    aligned = (channels % 2 == 0 and streams * channels % 4 == 0 and src_ptr % 16 == 0
               and dst_ptr % 16 == 0)
    if (aligned and n_in > 0 and n_in * channels % 8 == 0 and chunk_ptr % 16 == 0
            and farm_ring_layout(channels)["shared_bytes"] <= MAX_SHARED_BYTES):
        return FARM_STAGE_RING
    return FARM_STAGE_VEC if aligned and chunk_ptr % 4 == 0 else FARM_STAGE_ELEMENT


def _check_channels(channels: int) -> None:
    if not 0 < channels <= FARM_MAX_CHANNELS:
        raise ValueError(f"the farm kernels take 1 to {FARM_MAX_CHANNELS} channels, "
                         f"got {channels}")


def farm_stage_call_args(args: dict, *, n_in: int, keep: int, consumed: int, src: int,
                         dst: int) -> dict:
    """crt_farm_stage's arguments for a call on the buffers and chunk that
    ``args`` were checked for (farm_stage_args), with its rows and buffer
    addresses, and its path and tile chosen; no tensor is touched. Refuses
    rows outside the buffers."""
    channels, capacity = args["channels"], args["capacity"]
    if (n_in < 0 or keep < 0 or consumed < 0 or keep + n_in > capacity
            or consumed + keep > capacity or (src == dst and consumed)):
        raise ValueError(f"bad farm stage: {n_in} frames at row {keep} of {capacity}, "
                         f"{consumed} rows consumed{' in place' if src == dst else ''}")
    path = farm_stage_path(channels=channels, streams=args["streams"], n_in=n_in,
                           chunk_ptr=args["chunk"], src_ptr=src, dst_ptr=dst)
    if path == FARM_STAGE_RING:
        layout = farm_ring_layout(channels)
        del layout["shared_bytes"]
    else:
        tile_streams, tile_frames = farm_tile(channels)
        layout = dict(tile_streams=tile_streams, tile_frames=tile_frames, stages=0, slot=0)
    return dict(args, src=src, dst=dst, n_in=n_in, keep=keep, consumed=consumed, path=path,
                **layout)


def farm_stage_args(src, dst, chunk, *, streams: int, channels: int, n_in: int, keep: int,
                    consumed: int) -> dict:
    """Check one farm_stage_kernel launch and return crt_farm_stage's
    arguments by name. ``src`` and ``dst`` are the farm's (capacity, streams *
    channels) int32 buffers -- one buffer given twice appends in place and
    needs ``consumed`` 0 --, ``chunk`` an int16 tensor of at least streams *
    n_in * channels elements whose start is the (streams, n_in, channels)
    chunk; everything contiguous on dst's device."""
    _check_channels(channels)
    lanes = streams * channels
    _check_tensors(dst, lanes, 0, src=(src, 2))
    if src.shape != dst.shape or dst.shape[1] != lanes:
        raise ValueError(f"bad farm stage: buffers {tuple(src.shape)} and {tuple(dst.shape)} "
                         f"for {streams} streams x {channels} channels")
    if (chunk.device != dst.device or chunk.dtype != torch.int16 or not chunk.is_contiguous()
            or chunk.numel() < lanes * max(n_in, 0)):
        raise ValueError(f"chunk must be contiguous int16 on {dst.device} with at least "
                         f"{lanes * max(n_in, 0)} elements, got {chunk.dtype} "
                         f"{tuple(chunk.shape)}")
    base = dict(chunk=chunk.data_ptr(), streams=streams, channels=channels,
                capacity=dst.shape[0], device=dst.device.index, stream=_stream(dst))
    return farm_stage_call_args(base, n_in=n_in, keep=keep, consumed=consumed,
                                src=src.data_ptr(), dst=dst.data_ptr())


def farm_stage(src, dst, chunk, *, streams: int, channels: int, n_in: int, keep: int,
               consumed: int) -> None:
    """Launch farm_stage_kernel once, on the path farm_stage_path picks: rows
    [0, keep) of ``dst`` = rows [consumed, consumed + keep) of ``src`` (left
    where they are when src is dst), rows [keep, keep + n_in) = the (streams,
    n_in, channels) int16 ``chunk`` widened to int32 and transposed to
    lane-major, every later row zero."""
    _launch("crt_farm_stage", farm_stage_args(src, dst, chunk, streams=streams,
                                              channels=channels, n_in=n_in, keep=keep,
                                              consumed=consumed))


def farm_unstage_args(src, dst_ptr: int, *, n_out: int, channels: int, stream_lo: int,
                      streams: int) -> dict:
    """Check one farm_unstage_kernel launch and return crt_farm_unstage's
    arguments by name. ``src`` is a contiguous (rows >= n_out, L) int32 or
    int16 CUDA tensor of lane-major frames; streams [stream_lo, stream_lo +
    streams) of it go stream-major, (streams, n_out, channels), to the
    address ``dst_ptr``: device memory of src's card or pinned host memory,
    which the caller keeps alive and large enough."""
    _check_channels(channels)
    _check_cuda(src)
    if src.dim() != 2 or src.dtype not in (torch.int16, torch.int32) or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous (n_out, L) int32 or int16 tensor, got "
                         f"{src.dtype} {tuple(src.shape)}")
    lanes = src.shape[1]
    if not (0 < n_out <= src.shape[0] and streams > 0 and stream_lo >= 0
            and (stream_lo + streams) * channels <= lanes):
        raise ValueError(f"bad farm unstage: streams [{stream_lo}, {stream_lo + streams}) x "
                         f"{channels} channels x {n_out} frames of {tuple(src.shape)}")
    s16 = src.dtype == torch.int16
    words = int(not s16 or (channels % 2 == 0 and lanes % 2 == 0 and src.data_ptr() % 4 == 0
                            and dst_ptr % 4 == 0))
    tile_streams, tile_frames = farm_tile(channels // 2 if s16 and words else channels)
    return dict(src=src.data_ptr(), dst=dst_ptr, L=lanes, n_out=n_out, stream_lo=stream_lo,
                streams=streams, channels=channels, out_s16=int(s16), words=words,
                tile_streams=tile_streams, tile_frames=tile_frames, device=src.device.index,
                stream=_stream(src))


def farm_unstage(src, dst, *, n_out: int, channels: int, stream_lo: int, streams: int) -> None:
    """Launch farm_unstage_kernel once: streams [stream_lo, stream_lo +
    streams) of the lane-major (n_out, L) ``src`` into the contiguous tensor
    ``dst`` (src's dtype, on src's card or in pinned host memory) as
    (streams, n_out, channels)."""
    if (dst.dtype != src.dtype or not dst.is_contiguous()
            or dst.numel() < streams * n_out * channels
            or not (dst.device == src.device or (dst.device.type == "cpu" and dst.is_pinned()))):
        raise ValueError(f"dst must be contiguous {src.dtype} on {src.device} or pinned, with "
                         f"at least {streams * n_out * channels} elements, got {dst.dtype} "
                         f"{tuple(dst.shape)} on {dst.device}")
    _launch("crt_farm_unstage", farm_unstage_args(src, dst.data_ptr(), n_out=n_out,
                                                  channels=channels, stream_lo=stream_lo,
                                                  streams=streams))


# batch_mac_kernel (batch_kernels.cu): threads a block; the most channels a
# block takes (more channels split into tiles of this many; up to it a
# block's frames are one contiguous span of the output); the blocks a
# launch aims for, which the frame ranges are sized to reach (4096: at
# config 5's fleet four ranges a stream, which measured faster on the H100
# than 1024, 2048, 8192 or 16,384; PERF.md); the fewest
# frames of a range; the bytes of each of a block's two stages
# (batch_kernels.cu BATCH_STAGE_BYTES: 2 x 24 KB, the most a block takes
# without opting in to more); the frames of a stage (BATCH_MAX_TILE, or
# BATCH_MAX_THREAD_TILE where a thread takes a frame -- flat, C <= 4 --, and
# BATCH_MIN_TILE: below it, a stream reads x directly); how a stage's window
# may be copied (batch_copy_path: bits BATCH_COPY_VEC and BATCH_COPY_WORDS,
# or BATCH_COPY_PLAIN).
BATCH_THREADS = 256
BATCH_CHANNEL_TILE = 64
BATCH_GRID_BLOCKS = 4096
BATCH_MIN_RANGE_FRAMES = 8
BATCH_STAGE_BYTES = 24 * 1024
BATCH_MAX_TILE = 512
BATCH_MAX_THREAD_TILE = 2048
BATCH_MIN_TILE = 8
BATCH_COPY_PLAIN = 0
BATCH_COPY_VEC = 1
BATCH_COPY_WORDS = 2


def batch_plan(streams: int, n_out: int, channels: int) -> dict:
    """crt_batch_mac's grid, from the launch's shape alone (only the card
    knows how many frames each stream produces): the channels a block takes
    (channel_tile: all C up to BATCH_CHANNEL_TILE, else tiles of that many),
    the frames of its range (range_frames: the longest, in whole
    BATCH_MIN_RANGE_FRAMES, that still gives BATCH_GRID_BLOCKS blocks where
    the launch has them)."""
    tile = min(channels, BATCH_CHANNEL_TILE)
    per_range = streams * -(-channels // tile)
    ranges = max(1, min(-(-BATCH_GRID_BLOCKS // per_range), -(-n_out // BATCH_MIN_RANGE_FRAMES)))
    frames = -(-max(n_out, 1) // ranges)
    frames = -(-frames // BATCH_MIN_RANGE_FRAMES) * BATCH_MIN_RANGE_FRAMES
    return dict(channel_tile=tile, range_frames=frames)


def batch_tap_stride(*, int_radius: int, radius: int, delta: int, max_taps: int) -> int:
    """batch_kernels.cu tap_stride: the most live taps a frame of a stream
    with these ConfigScalars can have (frame_window's min_rel and max_rel
    are both nondecreasing in the phase's fraction), at most max_taps."""
    most = int_radius + ((0xFFFF + radius) >> 16) - ((delta + 0xFFFF) >> 16)
    return max(1, min(most, max_taps))


def batch_stage_frames(*, increment: int, tap_stride: int, channels: int, frames: int,
                       elem_bytes: int, by_thread: bool) -> tuple:
    """The rule by which a batch_mac_kernel block picks its frames a stage
    on the card (stage_frames; by_thread: mac_frames_by_thread, flat blocks
    of C <= 4, whose stage is its window alone): the most of the largest
    tile, halved, no more than the ``frames`` live frames need, whose window
    -- at most ceil((F - 1) * increment / 2^16) + tap_stride rows of
    ``channels`` samples, in whole 16-byte granules and one more -- fits
    BATCH_STAGE_BYTES beside the frames' geometry (tap_stride taps and three
    ints a frame; none by_thread). Returns (F, window bytes); (0, 0) when
    not even BATCH_MIN_TILE frames fit: the block reads x directly."""
    f = BATCH_MAX_THREAD_TILE if by_thread else BATCH_MAX_TILE
    while f > BATCH_MIN_TILE and f // 2 >= frames:
        f //= 2
    while f >= BATCH_MIN_TILE:
        rows = (((f - 1) * increment + 0xFFFF) >> 16) + tap_stride
        window = (rows * channels * elem_bytes + 15) // 16 * 16 + 16
        if window + (0 if by_thread else 4 * f * (tap_stride + 3)) <= BATCH_STAGE_BYTES:
            return f, window
        f //= 2
    return 0, 0


def batch_copy_path(*, channels: int, elem_bytes: int, stride_b: int, ptr: int) -> int:
    """How batch_mac_kernel may copy a stage's window (x (B, S, C) of
    elem_bytes-byte samples at address ptr, stride_b elements between
    streams), as bits: BATCH_COPY_VEC, 16-byte granules, for windows inside
    the buffer, when a block takes all C channels -- its window is one
    contiguous byte range, covered by whole granules; the card copies a
    window so only where those granules lie inside x's streams -- or,
    with channel tiles, when every row segment of a tile starts and ends on 16 bytes
    (C * elem_bytes, stride_b * elem_bytes and ptr multiples of 16);
    BATCH_COPY_WORDS, 4-byte words with each row clamped (windows at the
    buffer's edges, or every window without VEC), when every row segment is
    whole words at 4-byte aligned addresses. Neither (BATCH_COPY_PLAIN):
    element by element."""
    def aligned(to: int) -> bool:
        return (channels * elem_bytes % to == 0 and stride_b * elem_bytes % to == 0
                and ptr % to == 0)

    vec = channels <= BATCH_CHANNEL_TILE or aligned(16)
    return (BATCH_COPY_VEC if vec else 0) | (BATCH_COPY_WORDS if aligned(4) else 0)


def batch_launch_args(x, table, totals, quotas, p0, f0, cfg, *, max_taps: int,
                      n_out: int) -> dict:
    """Check a batch_mac_kernel launch and return crt_batch_mac's arguments
    by name, all but the outputs'. ``x`` is a (B, S, C) int16 or int32 CUDA
    tensor whose streams are each contiguous (any stride between streams);
    ``totals``, ``quotas``, ``p0``, ``f0`` and the TILED_CONFIG_FIELDS of
    ``cfg`` are contiguous (B,) int32 tensors on x's device, ``table`` the
    flat LUT there."""
    _check_cuda(x)
    if x.dim() != 3 or x.dtype not in (torch.int16, torch.int32):
        raise ValueError(f"x must be (B, S, C) int16 or int32, got {x.dtype} {tuple(x.shape)}")
    b, s, c = x.shape
    stride_b, stride_s, stride_c = x.stride()
    if stride_c != 1 or stride_s != c:
        raise ValueError(f"each stream of x must be contiguous, got strides {x.stride()}")
    if not (0 < b <= 65535 and s > 0 and c > 0 and max_taps > 0 and n_out >= 0):
        raise ValueError(f"bad batch launch: x {tuple(x.shape)}, {max_taps} taps, "
                         f"{n_out} frames")
    leaves = dict(totals=totals, quotas=quotas, p0_ptr=p0, f0_ptr=f0,
                  **{arg: getattr(cfg, f) for arg, f in zip(CONFIG_ARGS, TILED_CONFIG_FIELDS)})
    dev = x.get_device()
    for name, t in {**leaves, "table": table}.items():
        if not (t.dtype == torch.int32 and t.get_device() == dev and t.dim() == 1
                and t.is_contiguous() and (name == "table" or t.shape[0] == b)):
            raise ValueError(f"{name} must be a contiguous 1-d int32 tensor on {x.device}"
                             f"{'' if name == 'table' else f' of {b} streams'}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    ptr = x.data_ptr()
    copy = batch_copy_path(channels=c, elem_bytes=x.element_size(), stride_b=stride_b, ptr=ptr)
    return dict(x=ptr, x_s16=int(x.dtype == torch.int16), B=b, S=s, C=c, stride_b=stride_b,
                **{name: t.data_ptr() for name, t in leaves.items()}, table=table.data_ptr(),
                table_size=table.shape[0], T=max_taps, N=n_out, **batch_plan(b, n_out, c),
                copy=copy, device=dev, stream=_stream(x))


def batch_mac(x, table, totals, quotas, p0, f0, cfg, *, max_taps: int, n_out: int) -> tuple:
    """Launch batch_mac_kernel once: stream b of ``x`` (B, S, C) through one
    chunk call from its own state (p0[b], f0[b], cfg's fields [b]) with
    totals[b] input frames and quota quotas[b] (batch_launch_args). Returns
    (out (B, n_out, C) int32, zero from each stream's produced frame on,
    produced, consumed, position_integer, position_fractional -- (B,) int32
    -- and exhausted (B,) bool)."""
    args = batch_launch_args(x, table, totals, quotas, p0, f0, cfg, max_taps=max_taps,
                             n_out=n_out)
    b, _, c = x.shape
    out = torch.empty((b, n_out, c), dtype=torch.int32, device=x.device)
    produced, consumed, p_out, f_out = torch.empty((4, b), dtype=torch.int32, device=x.device)
    exhausted = torch.empty(b, dtype=torch.bool, device=x.device)
    args.update(out=out.data_ptr(), produced=produced.data_ptr(), consumed=consumed.data_ptr(),
                p_out=p_out.data_ptr(), f_out=f_out.data_ptr(), exhausted=exhausted.data_ptr())
    _launch("crt_batch_mac", args)
    return out, produced, consumed, p_out, f_out, exhausted
