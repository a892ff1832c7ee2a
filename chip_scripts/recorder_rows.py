"""Every column of the port's recorder over one perfbench run of a cell.

    python3 chip_scripts/recorder_rows.py fleet_mixed4.stream 2147483659 [SECONDS]

Runs the cell once in this process (``perfbench.harness.run``, untraced),
then prints one JSON line: the result's end-to-end metrics and, for each
column of the cell's rows (``utils.profiling.recent_calls`` over the
window's calls), its median a call in ms (spans) or as counted (counters,
ns), and the median of each span's share of the span it nests in.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# span -> the span it nests in
PARENT = {"crt.farm.stage": "crt.farm.call", "crt.farm.launch": "crt.farm.call",
          "crt.farm.to_host": "crt.farm.call", "crt.farm.stage.wait": "crt.farm.stage",
          "crt.farm.stage.rows": "crt.farm.stage", "crt.farm.stage.host": "crt.farm.stage",
          "crt.farm.stage.kernel": "crt.farm.stage", "crt.farm.to_host.issue": "crt.farm.to_host",
          "crt.farm.to_host.wait": "crt.farm.to_host", "crt.scan.build": "crt.scan.request",
          "crt.scan.run": "crt.scan.request"}


def main() -> int:
    cell, seed = sys.argv[1], int(sys.argv[2])
    seconds = float(sys.argv[3]) if len(sys.argv) > 3 else 10.0
    from perfbench import harness

    result = harness.run(cell, seed, seconds, False, started=time.perf_counter(),
                         log=lambda line: None)
    from clownresampler_tpu_torch.utils import profiling

    kind = "crt.scan.request" if cell.endswith(".scan") else "crt.farm.call"
    spans, counters = profiling.KINDS[kind]
    rows = profiling.recent_calls(kind, result["attempted"])
    line = dict(cell=cell, seed=seed, correct=result["correct"], rows=len(rows),
                tracing=profiling.tracing(),
                metrics={k: m["value"] for k, m in result["metrics"].items()})
    if rows:
        line["median_ms"] = {n: 1e3 * statistics.median(r[n] for r in rows) for n in spans}
        line["median_count"] = {n: statistics.median(r[n] for r in rows) for n in counters}
        line["median_share_of_parent"] = {
            n: statistics.median(r[n] / r[PARENT[n]] for r in rows if r[PARENT[n]])
            for n in spans if n in PARENT}
        for parent in set(PARENT.values()) & set(spans):
            kids = [n for n in spans if PARENT.get(n) == parent]
            line.setdefault("children_share", {})[parent] = statistics.median(
                sum(r[n] for n in kids) / r[parent] for r in rows if r[parent])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
