"""PCM/WAV I/O helpers for examples, tests and the GPU smoke run.

Small raw-PCM/WAV helpers on numpy arrays with no third-party decoders; the
test fixture is pre-decoded PCM (tests/fixtures/test_pcm_s16le.raw).
"""

from __future__ import annotations

import wave

import numpy as np


def read_raw_s16le(path: str, channels: int) -> np.ndarray:
    """Interleaved little-endian s16 PCM -> (frames, channels) int16."""
    data = np.fromfile(path, dtype="<i2")
    return data.reshape(-1, channels)


def write_raw_s32le(path: str, frames: np.ndarray) -> None:
    """Wide int32 output frames -> raw s32le dump (the reference test-harness
    serialisation, tests/test-low-level.c:41-53)."""
    np.asarray(frames, dtype="<i4").tofile(path)


def clamp_s16(frames: np.ndarray) -> np.ndarray:
    """Clamp wide accumulator samples to signed 16-bit, as the reference
    examples do before playback (clownresampler.h:96-100)."""
    return np.clip(frames, -0x7FFF, 0x7FFF).astype(np.int16)


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a 16-bit PCM WAV -> ((frames, channels) int16, sample_rate)."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2:
            raise ValueError("only 16-bit PCM WAV is supported")
        frames = np.frombuffer(w.readframes(w.getnframes()), dtype="<i2")
        return frames.reshape(-1, w.getnchannels()), w.getframerate()


def write_wav(path: str, frames: np.ndarray, sample_rate: int) -> None:
    """Write (frames, channels) int16 to a 16-bit PCM WAV."""
    frames = np.asarray(frames, dtype="<i2")
    if frames.ndim == 1:
        frames = frames[:, None]
    with wave.open(path, "wb") as w:
        w.setnchannels(frames.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(frames.tobytes())
