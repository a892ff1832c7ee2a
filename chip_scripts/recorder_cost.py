"""The recorder's cost on a card, in one process: blocks of a perfbench
cell's calls with the recorder on and off in turns, and the span pattern
of a 5-group mixed call timed on this host's CPU alone.

    python3 chip_scripts/recorder_cost.py fleet_mixed4.stream 2147483659 [BLOCKS [CALLS]]

Builds the cell as ``perfbench/run.py`` does (``entries/<entry>.py``,
warmed up), then runs BLOCKS blocks of CALLS calls each, the recorder on in
even blocks and off in odd ones (``utils.profiling.set_tracing``), timing
every call on the host's clock (a farm call ends with its output in host
memory, a scan request with a synchronise). Prints one JSON line: the card,
each side's median call and quartiles in ms, the on-off difference of the
medians in us and as a share of the off median, and the span pattern's cost
in us a call (the 42 span ends and counters of a 5-group mixed call, on
minus off).
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pattern(profiling) -> None:
    """A 5-group mixed call's spans and counters, with nothing inside."""
    span, count = profiling.span, profiling.count
    with span("crt.farm.call"):
        for _ in range(5):
            with span("crt.farm.stage"):
                with span("crt.farm.stage.wait"):
                    pass
                with span("crt.farm.stage.rows"):
                    pass
                with span("crt.farm.stage.host"):
                    count("pool_wait_ns", 1)
                    count("pool_late_ns", 1)
                with span("crt.farm.stage.kernel"):
                    pass
        with span("crt.farm.launch"):
            pass
        for _ in range(5):
            with span("crt.farm.to_host"):
                with span("crt.farm.to_host.issue"):
                    pass
                with span("crt.farm.to_host.wait"):
                    pass


def main() -> int:
    cell_name, seed = sys.argv[1], int(sys.argv[2])
    blocks = int(sys.argv[3]) if len(sys.argv) > 3 else 10
    calls = int(sys.argv[4]) if len(sys.argv) > 4 else 100
    from perfbench import harness

    from clownresampler_tpu_torch.utils import profiling

    spec = harness.load_cell(cell_name)
    cell = harness.load_entry(spec["traffic"]["entry"]).build(
        spec["config"], spec["traffic"], seed=seed, device="cuda")
    cell.warm_up()
    times = {True: [], False: []}
    k = 0
    for b in range(blocks):
        on = b % 2 == 0
        profiling.set_tracing(on)
        for _ in range(calls):
            t0 = time.perf_counter()
            cell.issue(k)
            times[on].append(time.perf_counter() - t0)
            k += 1
    profiling.set_tracing(True)
    line = {"cell": cell_name, "seed": seed, "blocks": blocks, "calls": calls}
    if shutil.which("nvidia-smi"):
        line["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                       "--format=csv,noheader"], capture_output=True,
                                      text=True).stdout.strip()
    for on, label in ((True, "on"), (False, "off")):
        q1, med, q3 = statistics.quantiles(times[on], n=4)
        line[label] = {"median_ms": 1e3 * med, "q1_ms": 1e3 * q1, "q3_ms": 1e3 * q3}
    diff = statistics.median(times[True]) - statistics.median(times[False])
    line["on_minus_off_us"] = 1e6 * diff
    line["on_minus_off_share"] = diff / statistics.median(times[False])
    n = 2000
    spans_on = timeit.timeit(lambda: pattern(profiling), number=n) / n
    profiling.set_tracing(False)
    spans_off = timeit.timeit(lambda: pattern(profiling), number=n) / n
    profiling.set_tracing(True)
    line["pattern_us"] = {"on": 1e6 * spans_on, "off": 1e6 * spans_off,
                          "on_minus_off": 1e6 * (spans_on - spans_off)}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
