"""Port debug.check_launch (tests/test_debug.py's three cases, and the same
reports as the JAX checker) and utils.profiling on the CPU: the trace, and
the recorder's rows of farm calls (the farms' card path with their C
entries stood in, fixture ``card``) and of scan requests (``ScanProgram``
with its C entries stood in)."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.debug import check_launch as jcheck_launch
from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch.configure import configure
from clownresampler_tpu_torch.debug import check_launch
from clownresampler_tpu_torch.lowlevel import make_device_state
from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu_torch.utils import profiling
from clownresampler_tpu_torch.utils.profiling import trace
from tests.test_torch_farm_program import card  # noqa: F401  (fixture)
from tests.test_torch_farm_program import HOST_STATS, HOST_STATS_CALLS
from tests.test_torch_scan_program import ENGINES as SCAN_ENGINES
from tests.test_torch_scan_program import _case, _program


def _both(rates, *args, **kwargs):
    """The port's report, after checking the JAX checker says the same."""
    got = check_launch(configure(*rates, max(rates)), fx.calculate_ratio(*rates), *args,
                       **kwargs)
    want = jcheck_launch(jconfigure(*rates, max(rates)), fx.calculate_ratio(*rates), *args,
                         **kwargs)
    assert (got.violations, got.n_frames) == (want.violations, want.n_frames)
    return got


@pytest.mark.parametrize("rates", [(48000, 44100), (8000, 44100), (44100, 8000)])
def test_torch_check_launch_legal_launch_clean(rates):
    cfg = configure(*rates, max(rates))
    n_out = 1024
    rows = ((n_out * fx.calculate_ratio(*rates)) >> 16) + 2 * cfg.integer_stretched_kernel_radius + 2
    report = _both(rates, 0, 0, n_out, rows)
    assert report.ok(), report.violations
    report.raise_if_violated()


def test_torch_check_launch_underpadded_input_detected():
    report = _both((44100, 8000), 0, 0, 1024, input_rows=100)
    assert not report.ok() and "input row" in report.violations[0]
    with pytest.raises(AssertionError, match="invariant violations"):
        report.raise_if_violated()


def test_torch_check_launch_table_overrun_detected():
    report = _both((8000, 44100), 0, 0, 64, input_rows=10_000, table_size=100)
    assert not report.ok() and "kernel index" in report.violations[0]


def test_torch_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        torch.arange(1000).sum()
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0
    assert len(prof.key_averages()) > 0


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

FARM, SCAN = "crt.farm.call", "crt.scan.request"
FARM_SPANS, FARM_COUNTERS = profiling.KINDS[FARM]
SCAN_SPANS, SCAN_COUNTERS = profiling.KINDS[SCAN]
# span -> the span it nests in
PARENT = {"crt.farm.stage": FARM, "crt.farm.launch": FARM, "crt.farm.to_host": FARM,
          "crt.farm.stage.wait": "crt.farm.stage", "crt.farm.stage.rows": "crt.farm.stage",
          "crt.farm.stage.host": "crt.farm.stage", "crt.farm.stage.kernel": "crt.farm.stage",
          "crt.farm.to_host.issue": "crt.farm.to_host",
          "crt.farm.to_host.wait": "crt.farm.to_host"}


def _closed(kind):
    return profiling._RINGS[kind].closed


def _new_rows(kind, before):
    return profiling.recent_calls(kind, _closed(kind) - before)


def test_torch_recorder_rows_nesting_and_counters():
    """The outermost span opens the row and closes it into the ring; a span
    nested in one of its own name (the row's opener too) adds nothing, a
    span or a counter with no row open records nothing, and each kind's
    columns take its own spans and counters only."""
    before = _closed(FARM), _closed(SCAN)
    with profiling.span("crt.farm.stage"):        # no row open
        profiling.count("plans_built", 5)
    assert (_closed(FARM), _closed(SCAN)) == before
    with profiling.span(FARM):
        with profiling.span("crt.farm.stage"):
            with profiling.span("crt.farm.stage"):
                profiling.count("plans_built", 2)
            with profiling.span(FARM):            # opens no second row
                profiling.count("pool_wait_ns", 11)
        with profiling.span("crt.scan.build"):    # another kind's span
            pass
        profiling.count("plans_built", 1)
    with profiling.span(SCAN):
        with profiling.span("crt.scan.build"):
            pass
        with profiling.span("crt.scan.run"):
            pass
    (farm,), (scan,) = _new_rows(FARM, before[0]), _new_rows(SCAN, before[1])
    assert set(farm) == set(FARM_SPANS + FARM_COUNTERS)
    assert farm[FARM] >= farm["crt.farm.stage"] > 0
    assert farm["crt.farm.stage.host"] == farm["crt.farm.launch"] == 0
    assert (farm["plans_built"], farm["pool_wait_ns"], farm["pool_late_ns"]) == (3, 11, 0)
    assert set(scan) == set(SCAN_SPANS + SCAN_COUNTERS)
    assert scan["scan_launches"] == 0
    assert scan[SCAN] >= scan["crt.scan.build"] + scan["crt.scan.run"]
    assert scan["crt.scan.build"] > 0 and scan["crt.scan.run"] > 0


def test_torch_recorder_ring_keeps_the_newest_rows():
    """Past RING_ROWS rows the ring keeps the newest, oldest first."""
    for i in range(profiling.RING_ROWS + 5):
        with profiling.span(FARM):
            profiling.count("plans_built", i)
    rows = profiling.recent_calls(FARM, profiling.RING_ROWS + 100)
    assert [r["plans_built"] for r in rows] == list(range(5, profiling.RING_ROWS + 5))
    assert [r["plans_built"] for r in profiling.recent_calls(FARM, 2)] == [
        profiling.RING_ROWS + 3, profiling.RING_ROWS + 4]
    assert profiling.recent_calls(FARM, 0) == []


def test_torch_recorder_switch_and_environment():
    """Off (set_tracing, or CLOWNRESAMPLER_TRACE=0 at import), a span and a
    counter record nothing."""
    before = _closed(FARM)
    profiling.set_tracing(False)
    try:
        assert not profiling.tracing()
        with profiling.span(FARM):
            profiling.count("plans_built", 1)
    finally:
        profiling.set_tracing(True)
    assert profiling.tracing() and _closed(FARM) == before
    code = ("from clownresampler_tpu_torch.utils import profiling as p\n"
            "with p.span('crt.farm.call'): pass\n"
            "print(p.tracing(), len(p.recent_calls('crt.farm.call', 5)))")
    for value, want in (("0", "False 0"), ("1", "True 1")):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                             env=dict(os.environ, CLOWNRESAMPLER_TRACE=value), timeout=300,
                             cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        assert out.stdout.split() == want.split(), out.stderr[-2000:]


def _check_farm_row(row, uploads):
    """Every span of a farm call present, each no longer than the span it
    nests in; the pool's counters of ``uploads`` host stages."""
    assert all(row[name] > 0 for name in FARM_SPANS), row
    for parent in set(PARENT.values()):
        assert sum(row[c] for c, p in PARENT.items() if p == parent) <= row[parent], parent
    assert (row["pool_wait_ns"], row["pool_late_ns"]) == tuple(uploads * v for v in HOST_STATS)


def _mixed_farm(rng):
    """Config 5's four ratio groups, two stereo streams each, and stream 5
    moved to 44.1k -> 8k: five groups; and a chunk list maker."""
    specs = [rates for rates in [(48000, 44100), (44100, 48000), (8000, 48000),
                                 (96000, 48000)] for _ in range(2)]
    farm = MixedStreamFarm(specs, 2, chunk_frames=128, max_radius=17, device="cpu")
    farm.process([rng.integers(-32768, 32768, size=(128, 2)).astype(np.int16) for _ in specs])
    assert farm.adjust_stream(5, 44100, 8000) and len(farm._groups) == 5
    return farm, lambda: [rng.integers(-32768, 32768, size=(128, 2)).astype(np.int16)
                          for _ in specs]


@pytest.mark.parametrize("mixed", [False, True], ids=["uniform", "mixed"])
def test_torch_farm_calls_one_row_each(card, mixed):
    """One row a farm call, uniform or mixed (groups summed): every span,
    the host pool's counters of each host stage (crt_farm_host_stats read
    once a stage) and the plans built, none once the farm is steady."""
    rng = np.random.default_rng(90)
    if mixed:
        farm, chunk = _mixed_farm(rng)
        groups = 5
    else:
        farm = UniformStreamFarm(6, 2, 48000, 44100, chunk_frames=128, device="cpu")
        chunk, groups = (lambda: rng.integers(-32768, 32768, (6, 128, 2)).astype(np.int16)), 1
    before = _closed(FARM)
    del HOST_STATS_CALLS[:]
    for _ in range(6):
        farm.process(chunk())
    rows = _new_rows(FARM, before)
    assert len(rows) == 6 and len(HOST_STATS_CALLS) == 6 * groups
    for row in rows:
        _check_farm_row(row, groups)
    assert rows[0]["plans_built"] > 0 and [r["plans_built"] for r in rows[3:]] == [0, 0, 0]
    farm.flush()                    # no call: no row
    assert _closed(FARM) == before + 6


def test_torch_farm_rows_off(card):
    """With the recorder off a farm call leaves no row and reads no pool
    counters."""
    farm = UniformStreamFarm(3, 2, 48000, 44100, chunk_frames=64, device="cpu")
    chunk = np.random.default_rng(91).integers(-32768, 32768, (3, 64, 2)).astype(np.int16)
    before = _closed(FARM)
    profiling.set_tracing(False)
    try:
        farm.process(chunk)
        farm.process(chunk)
    finally:
        profiling.set_tracing(True)
    assert _closed(FARM) == before and not HOST_STATS_CALLS
    farm.process(chunk)
    assert _closed(FARM) == before + 1 and len(HOST_STATS_CALLS) == 1


def test_torch_farm_rows_of_two_threads(card):
    """Two farms fed from two threads at once keep their rows apart: one
    whole row a call, though both threads are inside a call together."""
    farms = [UniformStreamFarm(b, 2, 48000, 44100, chunk_frames=64, device="cpu")
             for b in (3, 5)]
    together = threading.Barrier(2, timeout=60)
    for farm in farms:
        stage = farm._stage

        def meet(chunk, stage=stage):
            together.wait()
            return stage(chunk)

        farm._stage = meet
    rng = np.random.default_rng(92)
    chunks = [[rng.integers(-32768, 32768, (f.n_streams, 64, 2)).astype(np.int16)
               for _ in range(3)] for f in farms]
    errors, before = [], _closed(FARM)

    def feed(k):
        try:
            for c in chunks[k]:
                farms[k].process(c)
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=feed, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads), errors
    rows = _new_rows(FARM, before)
    assert len(rows) == 6
    for row in rows:
        _check_farm_row(row, 1)


def test_torch_mixed_call_opens_at_most_17_ranges(card):
    """Under a CPU torch.profiler a 5-group mixed call opens 17
    record_function ranges: the call, the launches, and each group's rows,
    host copy and copy-out wait; none without a profiler."""
    farm, chunk = _mixed_farm(np.random.default_rng(93))
    farm.process(chunk())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        farm.process(chunk())
    names = [e.name for e in prof.events() if e.name.startswith("crt.")]
    assert sorted(names) == sorted(
        [FARM, "crt.farm.launch"] + 5 * ["crt.farm.stage.rows", "crt.farm.stage.host",
                                         "crt.farm.to_host.wait"])
    assert len(names) <= 17 and set(names) <= profiling.RANGES


def test_torch_scan_program_spans(monkeypatch):
    """ScanProgram's construction and run, its C entries stood in, inside a
    request's row: each its own span, and the launches it queued counted
    (one for the tiled engine's three steps, one a step for the strided
    one); outside a row, nothing."""
    c = _case(SCAN_ENGINES["tiled"], lanes=8, n_in=96, k=3, seed=94)
    before = _closed(SCAN)
    _program(c, monkeypatch)
    assert _closed(SCAN) == before
    with profiling.span(SCAN):
        _program(c, monkeypatch)
    (row,) = _new_rows(SCAN, before)
    assert row["crt.scan.build"] > 0 and row["crt.scan.run"] > 0
    assert row["crt.scan.build"] + row["crt.scan.run"] <= row[SCAN]
    assert row["scan_launches"] == 1
    strided = _case(SCAN_ENGINES["strided"], lanes=8, n_in=96, k=3, seed=94)
    with profiling.span(SCAN):
        _program(strided, monkeypatch)
    assert _new_rows(SCAN, before + 1)[0]["scan_launches"] == 4      # three chunks, the flush
