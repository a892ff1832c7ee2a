"""Profiling: a torch.profiler trace, and the port's own recorder of spans
and counters, one row a farm call or scan request.

Usage:
    with trace("/tmp/resample-trace"):        # chrome://tracing or Perfetto
        farm.process(chunk)

    rows = recent_calls("crt.farm.call", 100)  # the last 100 farm calls
    rows[-1]["crt.farm.stage.host"]            # seconds; counters as counted

The recorder is on by default (``CLOWNRESAMPLER_TRACE=0`` at import, or
``set_tracing(False)``, turns it off). The outermost span of a call --
``crt.farm.call`` (``UniformStreamFarm.process``, ``MixedStreamFarm.process``)
or ``crt.scan.request`` (``resample_scan_fused`` on a card) -- opens the
thread's row; every span inside adds its host time, on
``time.perf_counter_ns``, to the row's column of its name (a farm's groups
summed), and counters add their counts. A span nested in a span of its own
name adds nothing: the outer one holds its time. A span with no row open
records nothing. Closed rows go into a preallocated ring of ``RING_ROWS``
rows a kind, so a steady call allocates nothing but its span objects.
While a torch profiler records, the spans in ``RANGES`` are also
``record_function`` ranges of their name, so that a trace puts the card's
idle time down to the innermost one. Off, a span is one branch and no
clock read.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading
import time

import numpy as np
import torch

# Each kind's columns: its spans (the first one opens the kind's row) and
# then its counters.
KINDS = {
    "crt.farm.call": (
        ("crt.farm.call", "crt.farm.stage", "crt.farm.stage.wait", "crt.farm.stage.rows",
         "crt.farm.stage.host", "crt.farm.stage.kernel", "crt.farm.launch", "crt.farm.to_host",
         "crt.farm.to_host.issue", "crt.farm.to_host.wait"),
        ("pool_wait_ns", "pool_late_ns", "plans_built")),
    "crt.scan.request": (("crt.scan.request", "crt.scan.build", "crt.scan.run"),
                         ("scan_launches",)),
}
# The spans that are record_function ranges while a profiler records: a
# 5-group mixed call opens 17 (a trace reader that looks back a fixed number
# of ranges, such as perfbench's 32, must still see the innermost one).
RANGES = frozenset(("crt.farm.call", "crt.farm.stage.rows", "crt.farm.stage.host",
                    "crt.farm.launch", "crt.farm.to_host.wait", "crt.scan.request",
                    "crt.scan.build", "crt.scan.run"))
RING_ROWS = 1 << 14

# name -> (kind, column, whether it is a range); a kind's spans come first.
_COLUMNS = {name: (kind, col, name in RANGES) for kind, (spans, counters) in KINDS.items()
            for col, name in enumerate(spans + counters)}
_perf_ns = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled
_on = os.environ.get("CLOWNRESAMPLER_TRACE", "1") != "0"


@contextlib.contextmanager
def trace(log_dir: str):
    """A torch.profiler trace of the block (host ops, and the card's kernels
    and copies when there is a card), written to ``log_dir/trace.json``.
    Yields the profiler, whose ``key_averages()`` sums time by op."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def set_tracing(on: bool) -> None:
    """Turn the recorder on or off (for every thread)."""
    global _on
    _on = bool(on)


def tracing() -> bool:
    """Whether the recorder is on."""
    return _on


class _Ring:
    """RING_ROWS rows of one kind, int64 nanoseconds and counts."""

    def __init__(self, width: int):
        self.rows = np.zeros((RING_ROWS, width), np.int64)
        self.closed = 0
        self.lock = threading.Lock()


_RINGS = {kind: _Ring(len(spans) + len(counters)) for kind, (spans, counters) in KINDS.items()}
_ZEROS = {kind: [0] * ring.rows.shape[1] for kind, ring in _RINGS.items()}


class _Open:
    """A thread's open row: its kind (None: no row open), its columns and
    which of its spans are open."""

    __slots__ = ("kind", "row", "open", "rows", "opens")

    def __init__(self):
        self.kind = self.row = self.open = None
        self.rows = {kind: [0] * ring.rows.shape[1] for kind, ring in _RINGS.items()}
        self.opens = {kind: [False] * ring.rows.shape[1] for kind, ring in _RINGS.items()}


class _Thread(threading.local):
    # The open row is a plain object: a thread-local's own attributes cost
    # more to reach, and a span reaches them several times.
    def __init__(self):
        self.at = _Open()


_thread = _Thread()


class _Span:
    __slots__ = ("name", "at", "col", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        kind, col, ranged = _COLUMNS[self.name]
        at = _thread.at
        if at.kind is None:
            if col:
                self.col = -1           # no row open: nothing to add to
                return self
            at.kind, at.row, at.open = kind, at.rows[kind], at.opens[kind]
            at.row[:] = _ZEROS[kind]
        elif at.kind != kind or at.open[col]:
            self.col = -1
            return self
        at.open[col] = True
        self.at, self.col, self.range = at, col, None
        if ranged and _profiling():
            self.range = torch.autograd.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = _perf_ns()
        return self

    def __exit__(self, *exc):
        col = self.col
        if col < 0:
            return False
        end = _perf_ns()
        at = self.at
        at.row[col] += end - self.t0
        at.open[col] = False
        if self.range is not None:
            self.range.__exit__(*exc)
        if col == 0:
            ring = _RINGS[at.kind]
            with ring.lock:
                ring.rows[ring.closed % RING_ROWS] = at.row
                ring.closed += 1
            at.kind = at.row = at.open = None
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager adding the block's host time to column ``name`` of
    the thread's open row (``name`` one of KINDS' spans; the kind's first
    span opens the row and closes it into the ring)."""
    return _Span(name) if _on else _OFF


def spanned(name: str):
    """A decorator: the function's every call is ``span(name)``."""
    def decorate(fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return timed
    return decorate


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of the thread's open row, if it is of
    the counter's kind."""
    if _on:
        at = _thread.at
        kind, col, _ = _COLUMNS[name]
        if kind == at.kind:
            at.row[col] += n


def recent_calls(kind: str, n: int) -> list:
    """The last ``n`` closed rows of ``kind`` (at most RING_ROWS), oldest
    first: each a dict of every span's seconds and every counter's count."""
    spans, counters = KINDS[kind]
    ring = _RINGS[kind]
    with ring.lock:
        end = ring.closed
        n = max(0, min(n, end, RING_ROWS))
        rows = ring.rows[np.arange(end - n, end) % RING_ROWS]
    return [{**{name: int(v) * 1e-9 for name, v in zip(spans, row)},
             **{name: int(v) for name, v in zip(counters, row[len(spans):])}} for row in rows]
