"""The comparison's control: a cell's runs with the reference, computed a
step below the configuration's precision, put in the program's place.

    python3 perfbench/control.py --workload <cell> --seconds 2 --seeds 11 12 13

Each seed runs the cell as ``run.py`` does, for a short window; then every
output the comparison reads is replaced by the reference with the per-tap
truncation dropped (``lanczos16``'s ``truncate_once``) and the comparison
runs. It prints one JSON line a seed with the numbers compared and
``correct``, which must be false. Not part of the benchmark's runs.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--precision", default="truncate_once")
    args = parser.parse_args()

    from perfbench import harness

    for seed in args.seeds:
        started = time.perf_counter() if seed != args.seeds[0] else STARTED
        result = harness.run(args.workload, seed, args.seconds, False, started=started,
                             judge=lambda cell: cell.substitute(args.precision),
                             log=lambda line: None)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.precision,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "failed": result["failed"], "checked": result["checked"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
