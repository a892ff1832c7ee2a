"""Runs of perfbench cells on one card, sides in turns, a fresh process each.

    python3 chip_scripts/perfbench_ab.py --cells fleet_mixed4.stream \
        --seeds 2147483659 2147483671 --trace 0 \
        --side parent=archive_check/parent --side change=. \
        --side off=.:CLOWNRESAMPLER_TRACE=0

A side is ``label=directory[:NAME=VALUE...]``: ``perfbench/run.py`` run from
that checkout with those variables set. For each cell and seed every side
runs once, the order rotating from seed to seed (with two sides: A B, B A,
...). Each result line goes to ``chiprun_out/perfbench_ab.jsonl`` with its
side, cell, seed and trace; at the end each side's median, quartiles and
spread (interquartile range over the median, ``statistics.quantiles``) of
every metric are printed per cell, with the card's name and power limit.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "perfbench_ab.jsonl")


def parse_side(text: str) -> tuple:
    label, rest = text.split("=", 1)
    directory, *pairs = rest.split(":")
    return label, os.path.join(ROOT, directory), dict(p.split("=", 1) for p in pairs)


def run(side: tuple, cell: str, seed: int, seconds: float, trace: int) -> dict:
    label, directory, env = side
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
                          str(seed), "--seconds", str(seconds), "--trace", str(trace)],
                         cwd=directory, env={**os.environ, **env}, capture_output=True,
                         text=True, timeout=900)
    line = dict(side=label, cell=cell, seed=seed, trace=trace, rc=out.returncode,
                wall_s=time.perf_counter() - t0)
    if out.returncode == 0:
        line["result"] = json.loads(out.stdout.strip().splitlines()[-1])
    else:
        line["stderr"] = out.stderr[-2000:]
    return line


def summary(lines: list) -> dict:
    """{cell: {side: {metric: (median, q1, q3, spread, n)}}} of the runs
    that gave a result."""
    values: dict = {}
    for ln in lines:
        for name, m in ln.get("result", {}).get("metrics", {}).items():
            values.setdefault(ln["cell"], {}).setdefault(ln["side"], {}).setdefault(
                name, []).append(m["value"])
    out: dict = {}
    for cell, sides in values.items():
        for side, metrics in sides.items():
            for name, v in metrics.items():
                med = statistics.median(v)
                q1, _, q3 = statistics.quantiles(v, n=4) if len(v) > 1 else (med, med, med)
                out.setdefault(cell, {}).setdefault(side, {})[name] = (
                    med, q1, q3, (q3 - q1) / med if med else None, len(v))
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cells", nargs="+", required=True)
    parser.add_argument("--seeds", nargs="+", type=int, required=True)
    parser.add_argument("--side", action="append", required=True, type=parse_side)
    parser.add_argument("--seconds", type=float, default=10)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
        print("card:", smi.strip(), flush=True)
    lines = []
    for cell in args.cells:
        for k, seed in enumerate(args.seeds):
            order = args.side[k % len(args.side):] + args.side[:k % len(args.side)]
            for side in order:
                line = run(side, cell, seed, args.seconds, args.trace)
                lines.append(line)
                with open(OUT, "a") as f:
                    f.write(json.dumps(line) + "\n")
                r = line.get("result", {})
                print(line["side"], cell, seed, "rc", line["rc"], "correct", r.get("correct"),
                      {n: m["value"] for n, m in r.get("metrics", {}).items()},
                      line.get("stderr", "")[-300:], flush=True)
    print(json.dumps(summary(lines)))
    return 0 if all(ln["rc"] == 0 and ln["result"]["correct"] for ln in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
