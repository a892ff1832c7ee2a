"""ctypes loader for the native host staging engine (native/stage.cpp).

The farm's host-staging path keeps a lane-major int32 staging buffer in host
memory; these threaded C++ loops move chunks into it. The shared library is
compiled on first use (g++ -O3) into ``native/build/`` under a name keyed by
the source hash, so no binary is checked in. These are host staging ops, not
a device path: if the toolchain is unavailable each op runs its numpy
version instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_SRC = os.path.join(_NATIVE_DIR, "stage.cpp")

_lock = threading.Lock()
_lib = None
_tried = False


def _so_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_NATIVE_DIR, "build", f"libclownstage-{digest}.so")


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            so = _so_path()
            if not os.path.exists(so):
                os.makedirs(os.path.dirname(so), exist_ok=True)
                tmp = so + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
                     _SRC, "-o", tmp],
                    check=True, capture_output=True,
                )
                os.replace(tmp, so)  # atomic: concurrent builders converge
            lib = ctypes.CDLL(so)
        except (OSError, subprocess.CalledProcessError):
            return None
        L = ctypes.c_long
        lib.stage_i16_to_i32_lanes.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, L, L, L, L, L]
        lib.zero_rows_i32.argtypes = [ctypes.c_void_p, L, L, L]
        lib.shift_rows_i32.argtypes = [ctypes.c_void_p, L, L, L]
        _lib = lib
        return _lib


def _check_staging(staging: np.ndarray) -> None:
    if staging.dtype != np.int32 or staging.ndim != 2 or not staging.flags.c_contiguous:
        raise ValueError("staging must be a C-contiguous 2-d int32 array")


def stage_chunk(chunk: np.ndarray, staging: np.ndarray, row_off: int) -> None:
    """(B, n, C) int16 -> staging rows [row_off, row_off+n) lane-major int32."""
    _check_staging(staging)
    b, n, c = chunk.shape
    if chunk.dtype != np.int16 or not chunk.flags.c_contiguous:
        raise ValueError("chunk must be a C-contiguous int16 array")
    if row_off < 0 or row_off + n > staging.shape[0] or b * c > staging.shape[1]:
        raise ValueError("chunk does not fit the staging buffer")
    lib = _load()
    if lib is not None:
        lib.stage_i16_to_i32_lanes(
            chunk.ctypes.data, staging.ctypes.data, b, n, c, staging.shape[1], row_off)
    else:
        staging[row_off : row_off + n, : b * c] = (
            chunk.transpose(1, 0, 2).reshape(n, b * c).astype(np.int32))


def zero_rows(staging: np.ndarray, row_off: int, n: int) -> None:
    """Zero staging rows [row_off, row_off+n)."""
    _check_staging(staging)
    if row_off < 0 or row_off + n > staging.shape[0]:
        raise ValueError("rows outside the staging buffer")
    lib = _load()
    if lib is not None:
        lib.zero_rows_i32(staging.ctypes.data, staging.shape[1], row_off, n)
    else:
        staging[row_off : row_off + n] = 0


def shift_rows(staging: np.ndarray, rows_keep: int, shift: int) -> None:
    """staging[r] = staging[r + shift] for r in [0, rows_keep)."""
    _check_staging(staging)
    if shift == 0:
        return
    if shift < 0 or rows_keep < 0 or shift + rows_keep > staging.shape[0]:
        raise ValueError("shift outside the staging buffer")
    lib = _load()
    if lib is not None:
        lib.shift_rows_i32(staging.ctypes.data, rows_keep, staging.shape[1], shift)
    else:
        staging[:rows_keep] = staging[shift : shift + rows_keep]
