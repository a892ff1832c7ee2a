"""The readers of the port's own spans and counters on a made-up run: the
median a call of the window's rows, the profiled tail left out, and nothing
where there are no rows or the port has no recorder."""

import types

import pytest

from clownresampler_tpu_torch.utils import profiling
from perfbench import harness

# metric -> (row kind, column (a tuple: the columns summed), scale to the
# metric's unit)
READS = {
    "stage_rows_ms.stream": ("crt.farm.call", "crt.farm.stage.rows", 1e3),
    "host_copy_ms.stream": ("crt.farm.call", "crt.farm.stage.host", 1e3),
    "pool_wait_ms.stream": ("crt.farm.call", "pool_wait_ns", 1e-6),
    "pool_late_ms.stream": ("crt.farm.call", "pool_late_ns", 1e-6),
    "output_wait_ms.stream": ("crt.farm.call", "crt.farm.to_host.wait", 1e3),
    "scan_build_ms.scan": ("crt.scan.request", "crt.scan.build", 1e3),
    "scan_launch_ms.scan": ("crt.scan.request", "crt.scan.run", 1e3),
    "stage_cuda_ms.stream": ("crt.farm.call", ("crt.farm.stage.wait", "crt.farm.stage.kernel"),
                             1e3),
}


def _run(calls, profiled):
    return types.SimpleNamespace(window=types.SimpleNamespace(calls=calls, profiled=profiled))


@pytest.mark.parametrize("metric", list(READS))
def test_reader_takes_the_unprofiled_window(monkeypatch, metric):
    kind, column, scale = READS[metric]
    # Rows 0-2 of the window unprofiled, 3-4 profiled; a warm-up row before.
    values = [900, 5, 1, 3, 700, 800]
    asked = []

    columns = column if isinstance(column, tuple) else (column,)

    def recent_calls(k, n):
        asked.append((k, n))
        # the columns of a sum split a row's value between them
        return [{**{c: v / len(columns) for c in columns}, "other": 0} for v in values[-n:]]

    monkeypatch.setattr(profiling, "recent_calls", recent_calls)
    read = harness.load_reader(metric).read
    assert read(_run(5, (3, 5))) == pytest.approx(3 * scale)
    assert asked == [(kind, 5)]
    assert read(_run(3, None)) == pytest.approx(700 * scale)   # the last three rows
    assert read(_run(5, (0, 5))) is None       # every call profiled
    assert read(_run(0, None)) is None
    monkeypatch.setattr(profiling, "recent_calls", lambda k, n: [])
    assert read(_run(5, (3, 5))) is None
    monkeypatch.delattr(profiling, "recent_calls")    # a port without the recorder
    assert read(_run(5, (3, 5))) is None


def test_readers_are_the_manifests():
    spec = {m["name"]: m for m in harness.load_json(
        harness.os.path.join(harness.ROOT, "BENCHMARK.json"))["per_layer"]}
    for metric, (kind, _, _) in READS.items():
        m = spec[metric]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["workloads"] == (["fleet_mixed4.stream"] if kind == "crt.farm.call"
                                  else ["fleet_48k_44k1.scan"])
