"""The benchmark's driver: one run of one cell of BENCHMARK.json.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name: ``configs/<config>.json`` (named by the
manifest), ``traffic/<traffic>.json``, the entry the mix drives
(``entries/<entry>.py``, named by the mix) and a reader per metric
(``metrics/<name up to its first dot>.py``). This module times the window,
records the spans, reads the profiler trace, runs the comparison with the
plain reference and prints the result line.

A run: set-up (the port loaded and its kernels built or found, the inputs
made from the seed, every shape the mix uses warmed up), the window
(``--seconds`` of calls, closed loop: one caller issues the next call when
one returns), then, with the program's state freed, the comparison. With
``--trace 1`` the seams of the program are wrapped in spans and the last
part of the window runs under torch.profiler.
"""

from __future__ import annotations

import bisect
import collections
import gc
import importlib
import json
import os
import statistics
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "clownresampler_tpu_torch"
# Top-level module names no run may hold once its window has closed.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "clownresampler_tpu")
# The traced run profiles this much of the end of its window (at most half).
PROFILE_SECONDS = 2.0
BREAKDOWN_ENTRIES = 10
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "perfbench.window"


class SetupError(RuntimeError):
    """The run cannot measure: no card, a missing file, the wrong port."""


# ---------------------------------------------------------------------------
# The manifest and the files it names
# ---------------------------------------------------------------------------

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The workload ``name`` of BENCHMARK.json with its configuration, its
    traffic mix and the per-layer metrics it reports."""
    manifest = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SetupError(f"no workload {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = load_json(os.path.join(root, configs[cell["config"]]["file"]))
    traffic = load_json(os.path.join(root, "perfbench", "traffic", cell["traffic"] + ".json"))
    end_to_end = [m for m in manifest["end_to_end"]
                  if "workloads" not in m or name in m["workloads"]]
    reported = {m["name"] for m in end_to_end}
    per_layer = [m for m in manifest["per_layer"]
                 if name in m.get("workloads", ()) or
                 ("workloads" not in m and m["moves"] in reported)]
    return dict(name=name, chips=cell["chips"], config=config, traffic=traffic,
                end_to_end=end_to_end, per_layer=per_layer)


def load_entry(name: str):
    """The module that drives a traffic mix's entry: entries/<name>.py."""
    return importlib.import_module(f"perfbench.entries.{name}")


def load_reader(metric: str):
    """The reader of a per-layer metric: metrics/<name up to its first
    dot>.py (one reader serves every split of a quantity)."""
    return importlib.import_module(f"perfbench.metrics.{metric.split('.', 1)[0]}")


def check_port_location(root: str = ROOT) -> None:
    """The port must be the checkout's own, not one installed elsewhere."""
    module = sys.modules.get(PACKAGE)
    where = os.path.dirname(os.path.dirname(os.path.abspath(module.__file__)))
    if os.path.realpath(where) != os.path.realpath(root):
        raise SetupError(f"{PACKAGE} was imported from {where}, not from the checkout {root}")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is one of
    FORBIDDEN_MODULES (whole names: the port's own name does not count)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

class Spans:
    """Host time of the program's seams, a sum per name per call.

    ``wrap`` replaces a bound method by one that times it; while
    ``profiling`` is set a span that has a label is also a
    torch.profiler.record_function range, so that the trace can tell what
    the host was doing during each idle gap of the card."""

    def __init__(self):
        self.calls: list = []
        self.current = None
        self.profiling = False

    def add(self, name: str, seconds: float) -> None:
        if self.current is not None:
            self.current[name] = self.current.get(name, 0.0) + seconds

    def span(self, name: str, label=True):
        """A context manager timing its block as ``name``."""
        return _Span(self, name, name if label is True else label)

    def wrap(self, obj, attr: str, name: str, label=True) -> None:
        fn = getattr(obj, attr)

        def timed(*args, **kwargs):
            with self.span(name, label):
                return fn(*args, **kwargs)

        setattr(obj, attr, timed)

    def begin_call(self) -> None:
        self.current = {}

    def end_call(self) -> None:
        if not self.profiling:
            self.calls.append(self.current)
        self.current = None


class _Span:
    def __init__(self, spans: Spans, name: str, label):
        self.spans, self.name, self.label = spans, name, label
        self.range = None

    def __enter__(self):
        if self.spans.profiling and self.label:
            import torch

            self.range = torch.profiler.record_function(self.label)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.spans.add(self.name, time.perf_counter() - self.t0)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


# ---------------------------------------------------------------------------
# The window
# ---------------------------------------------------------------------------

class Window:
    """The calls of one run: what each completed, its latency, and the first
    and last call of the profiled part."""

    def __init__(self):
        self.latency: list = []
        self.samples: list = []
        self.start = None
        self.end = None
        self.calls = 0
        self.profiled = None   # (first call, end call) under the profiler


def run_calls(cell, window: Window, seconds: float, spans=None) -> None:
    """Issue calls for ``seconds`` from now, closed loop: the next call is
    issued when one returns, and none is issued after the limit."""
    origin = time.perf_counter()
    if window.start is None:
        window.start = origin
    limit, first = origin + seconds, window.calls
    while True:
        k = window.calls
        issued = time.perf_counter()
        if k > first and issued >= limit:
            break
        if spans is not None:
            spans.begin_call()
            with spans.span("call", cell.call_span):
                result = cell.issue(k)
            done = time.perf_counter()
            spans.end_call()
        else:
            result = cell.issue(k)
            done = time.perf_counter()
        window.latency.append(done - issued)
        window.samples.append(cell.consume(k, result))
        window.calls = k + 1
        window.end = done


def profile_calls(cell, window: Window, seconds: float, spans: Spans, directory: str) -> dict:
    """``run_calls`` for ``seconds`` more under torch.profiler (host and
    card activity), every labelled span a record_function range; returns
    the trace's reading (``read_trace``)."""
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    first = window.calls
    spans.profiling = True
    with torch.profiler.profile(activities=activities) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            run_calls(cell, window, seconds, spans)
    spans.profiling = False
    window.profiled = (first, window.calls)
    path = os.path.join(directory, "trace.json")
    prof.export_chrome_trace(path)
    try:
        return read_trace(load_json(path))
    finally:
        os.remove(path)


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

def _merge(intervals: list) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _op_name(event: dict) -> str:
    name = event["name"]
    if event.get("cat") == "kernel":
        name = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
        name = name[5:] if name.startswith("void ") else name
    return name


def read_trace(trace: dict) -> dict:
    """From a chrome trace of the profiled window: the seconds in which a
    kernel or a copy ran on the card (``busy_s``), the window's length, the
    kernels' summed seconds, the seconds in which a copy between host and
    card ran (``memcpy_s``, overlapping copies counted once), device seconds
    by operation, and idle seconds
    by the innermost labelled span the host was in (``generator`` where it
    was in none: the benchmark's own loop)."""
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == WINDOW_SPAN
               and e.get("cat") == "user_annotation"]
    if not windows:
        return {}
    w0 = windows[0]["ts"]
    w1 = w0 + windows[0]["dur"]
    device = [e for e in events if e.get("cat") in DEVICE_CATEGORIES
              and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    ops = collections.Counter()
    for e in device:
        ops[_op_name(e)] += e["dur"] * 1e-6
    busy = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e["name"] != WINDOW_SPAN)
    starts = [s[0] for s in spans]
    idle = collections.Counter()
    edges = [w0] + [x for a, b in busy for x in (a, b)] + [w1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid, label = (a + b) / 2, "generator"
        i = bisect.bisect_right(starts, mid)
        for s0, s1, name in reversed(spans[max(i - 32, 0) : i]):
            if s1 >= mid:
                label = name
                break
        idle[label] += (b - a) * 1e-6
    copies = _merge([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in device
                     if e["cat"] == "gpu_memcpy" and ("HtoD" in e["name"] or "DtoH" in e["name"])])
    return dict(busy_s=busy_s, window_s=(w1 - w0) * 1e-6,
                kernel_s=sum(e["dur"] for e in device if e["cat"] == "kernel") * 1e-6,
                memcpy_s=sum(b - a for a, b in copies) * 1e-6,
                device_ops=ops.most_common(BREAKDOWN_ENTRIES),
                idle_gaps=idle.most_common(BREAKDOWN_ENTRIES))


# ---------------------------------------------------------------------------
# A run
# ---------------------------------------------------------------------------

class RunRecord:
    """What the per-layer readers read: the spans of the calls outside the
    profiled part, the trace of the profiled part, each call's work, the
    peaks and the window."""

    def __init__(self, cell, window: Window, spans, trace: dict, peaks: dict):
        self.cell, self.window, self.spans, self.trace, self.peaks = (
            cell, window, spans, trace, peaks)

    def span_calls(self) -> list:
        return self.spans.calls if self.spans is not None else []

    def work(self, k: int, taps: bool = True) -> dict:
        return self.cell.work(k, taps)


def quantile(values: list, q: float) -> float:
    """The q-quantile of every value (linear between order statistics)."""
    return float(np.quantile(np.asarray(values, dtype=np.float64), q))


def _device_info(chips: int, device: str) -> dict:
    import torch

    if device != "cuda":
        return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0), count=chips,
                memory_peak_bytes=max(torch.cuda.max_memory_allocated(i) for i in range(chips)))


def run(workload: str, seed: int, seconds: float, trace: bool, *, started: float,
        device: str = "cuda", adjust=None, prepare=None, judge=None, log=print) -> dict:
    """One run of ``workload``; returns the result line (a dict).

    ``adjust(cell_spec)`` may change the cell's configuration and mix before
    set-up, ``prepare(cell)`` the built cell before its warm-up (the tests
    run small cells on the CPU and plant faults this way) and ``judge(cell)``
    the cell's kept outputs before the comparison (the control puts its own
    in their place)."""
    setup = {"start": time.perf_counter() - started}
    import torch

    setup["torch"] = time.perf_counter() - started

    spec = load_cell(workload)
    if adjust is not None:
        adjust(spec)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < spec["chips"]):
        raise SetupError(f"the cell needs {spec['chips']} CUDA card(s); "
                         f"{torch.cuda.device_count()} available")
    importlib.import_module(PACKAGE)
    check_port_location()
    from clownresampler_tpu_torch.ops import _build
    from clownresampler_tpu_torch.ops.resample import ROUTES

    from perfbench import peaks as peak_table

    setup["port"] = time.perf_counter() - started
    smi = peak_table.read_smi() if device == "cuda" else {}
    setup["imports"] = time.perf_counter() - started
    if device == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        setup["card"] = time.perf_counter() - started
        _build.library("resample")     # the kernels built, or found built
        log(json.dumps({"card": smi, "build_s": _build.BUILD_LOG["seconds"]}))
    sms = torch.cuda.get_device_properties(0).multi_processor_count if device == "cuda" else 0
    peaks = peak_table.card_peaks(smi, sms)

    entry = load_entry(spec["traffic"]["entry"])
    cell = entry.build(spec["config"], spec["traffic"], seed=seed, device=device)
    setup["inputs"] = time.perf_counter() - started
    if prepare is not None:
        prepare(cell)
    spans = None
    if trace:
        spans = Spans()
        cell.instrument(spans)
    cell.warm_up()
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    routes_before = collections.Counter(ROUTES)
    gc.collect()
    gc.freeze()     # set-up's objects out of the collector's way in the window
    setup_s = time.perf_counter() - started
    log(json.dumps({"setup_s_at": {**setup, "warm": setup_s}}))

    window = Window()
    trace_read = {}
    if trace:
        profiled = min(PROFILE_SECONDS, seconds / 2)
        run_calls(cell, window, seconds - profiled, spans)
        with tempfile.TemporaryDirectory() as tmp:
            trace_read = profile_calls(cell, window, profiled, spans, tmp)
    else:
        run_calls(cell, window, seconds)
    routes = {"/".join(k): (n - routes_before.get(k, 0)) / window.calls
              for k, n in ROUTES.items() if n != routes_before.get(k, 0)}
    device_info = _device_info(spec["chips"], device)
    cell.release()

    window_s = window.end - window.start
    lat_ms = [1e3 * x for x in window.latency]
    tenths = np.array_split(np.asarray(lat_ms), 10)
    log(json.dumps({"calls": window.calls, "window_s": window_s,
                    "call_median_ms": statistics.median(lat_ms),
                    "call_p95_ms": quantile(lat_ms, 0.95),
                    "median_ms_by_tenth": [float(np.median(t)) for t in tenths if len(t)],
                    "between_calls_ms": (1e3 * window_s - sum(lat_ms)) / window.calls,
                    "routes_per_call": routes}))

    if judge is not None:
        judge(cell)
    checked, failed = cell.check()
    correct = failed == 0 and all(value <= limit for _, value, limit in checked)
    if trace:
        record = RunRecord(cell, window, spans, trace_read, peaks)
        metrics = {}
        for m in spec["per_layer"]:
            value = load_reader(m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"msamples_per_s": sum(window.samples) / window_s / 1e6, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"].split(".", 1)[0]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    result = dict(correct=correct, attempted=window.calls, failed=failed, metrics=metrics,
                  device=device_info)
    if trace:
        result["device"].update(busy_s=trace_read.get("busy_s", 0.0),
                                window_s=trace_read.get("window_s", 0.0))
        result["breakdown"] = {"device_ops": [list(x) for x in trace_read.get("device_ops", [])],
                               "idle_gaps": [list(x) for x in trace_read.get("idle_gaps", [])]}
    result["power_limit_w"] = peaks.get("power_limit_w")
    result["checked"] = {name: {"value": value, "limit": limit} for name, value, limit in checked}
    return result
