"""The reader of the port's scan_launches counter on a made-up run: the
median a request of the window's rows, the profiled tail left out, and
nothing where there are no rows, the rows lack the counter (a port from
before it) or the port has no recorder."""

import types

from clownresampler_tpu_torch.utils import profiling
from perfbench import harness

METRIC = "scan_launches.scan"


def _run(calls, profiled):
    return types.SimpleNamespace(window=types.SimpleNamespace(calls=calls, profiled=profiled))


def test_scan_launches_reader_takes_the_unprofiled_window(monkeypatch):
    # Rows 0-2 of the window unprofiled, 3-4 profiled; a warm-up row before.
    values = [64, 1, 3, 1, 64, 64]
    asked = []

    def recent_calls(kind, n):
        asked.append((kind, n))
        return [{"crt.scan.request": 0.004, "scan_launches": v} for v in values[-n:]]

    monkeypatch.setattr(profiling, "recent_calls", recent_calls)
    read = harness.load_reader(METRIC).read
    assert read(_run(5, (3, 5))) == 1
    assert asked == [("crt.scan.request", 5)]
    assert read(_run(3, None)) == 64                 # the last three rows
    assert read(_run(5, (0, 5))) is None             # every request profiled
    assert read(_run(0, None)) is None
    monkeypatch.setattr(profiling, "recent_calls",
                        lambda kind, n: [{"crt.scan.request": 0.004}] * n)
    assert read(_run(5, (3, 5))) is None             # rows without the counter
    monkeypatch.setattr(profiling, "recent_calls", lambda kind, n: [])
    assert read(_run(5, (3, 5))) is None
    monkeypatch.delattr(profiling, "recent_calls")   # a port without the recorder
    assert read(_run(5, (3, 5))) is None


def test_scan_launches_is_the_manifests():
    spec = {m["name"]: m for m in harness.load_json(
        harness.os.path.join(harness.ROOT, "BENCHMARK.json"))["per_layer"]}
    m = spec[METRIC]
    assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"], m["workloads"]) == (
        "launches", "lower", "program_span", "scan issue", "msamples_per_s.scan",
        ["fleet_48k_44k1.scan"])
    assert "scan_launches" in profiling.KINDS["crt.scan.request"][1]
