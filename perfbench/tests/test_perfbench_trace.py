"""The trace's reading on a made-up chrome trace: busy and idle time, the
kernels' time, the copies between host and card counted once where they
overlap, and the link's share read from them."""

import types

import pytest

from perfbench import harness
from perfbench.metrics import link_roofline


def _event(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


TRACE = {"traceEvents": [
    _event(harness.WINDOW_SPAN, "user_annotation", 0, 1000),
    _event("stage", "user_annotation", 0, 300),
    _event("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 100, 200),
    _event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 250, 150),
    _event("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 500, 100),
    _event("void tiled_mac_kernel<8, int, int>(int const*)", "kernel", 700, 50),
]}


def test_read_trace_counts_busy_kernel_and_copy_time():
    read = harness.read_trace(TRACE)
    assert read["window_s"] == pytest.approx(1e-3)
    assert read["busy_s"] == pytest.approx(450e-6)
    assert read["kernel_s"] == pytest.approx(50e-6)
    assert read["memcpy_s"] == pytest.approx(300e-6)     # 100-400, DtoD left out
    assert dict(read["device_ops"])["tiled_mac_kernel<8, int, int>"] == pytest.approx(50e-6)
    assert dict(read["idle_gaps"])["stage"] == pytest.approx(100e-6)


def test_link_roofline_is_the_transfers_bound_over_the_copies():
    trace = harness.read_trace(TRACE)
    work = {0: dict(bytes_in=1000, bytes_out=3000, over_link=True)}
    run = types.SimpleNamespace(trace=trace, window=types.SimpleNamespace(profiled=(0, 1)),
                                peaks={"link_bytes_per_s": 64e9},
                                work=lambda k, taps=True: work[k])
    assert link_roofline.read(run) == pytest.approx(100 * (3000 / 64e9) / 300e-6)
    run.trace = {**trace, "memcpy_s": 0.0}
    assert link_roofline.read(run) is None
