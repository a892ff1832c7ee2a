"""The four uniform-ratio entries of one tree, timed as chip_smoke.py times them.

    python3 chip_scripts/entry_ab.py TREE LABEL [--after-checks]

Imports chip_smoke.py and the port from TREE (a checkout, e.g. a `git archive`
of the parent commit) and prints one JSON line: the tiled (48 kHz -> 44.1 kHz,
8192 frames x 2048 lanes), general (44.1 kHz -> 8 kHz, 4096 x 2048), strided
(96 kHz -> 48 kHz, 8192 x 2048) and wide (44.1 kHz -> 132 Hz, 64 x 1024)
entries' whole-entry ms by chip_smoke.cuda_ms, each three times in turns, and
the host's time to issue 20 calls of each (no synchronise). With
--after-checks the process first runs chip_smoke.check_kernels, as
chip_smoke.py does before its timings. Run it parent, change, change, parent
in one call to compare two trees on one card.
"""
import json
import os
import subprocess
import sys
import time

tree, label = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(tree))
os.chdir(os.path.abspath(tree))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402
from clownresampler_tpu_torch.ops import resample as rs  # noqa: E402

_build.library("resample")
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
if "--after-checks" in sys.argv:
    cs.check_kernels(gen)
c = cs.launch_case(48000, 44100, 2048, 8192, gen)
g = cs.launch_case(44100, 8000, 2048, 4096, gen)
s = cs.launch_case(96000, 48000, 2048, 8192, gen)
w = cs.launch_case(44100, 132, 1024, 64, gen, f0=0x4321)
entries = {
    "tiled": lambda: rs.resample_uniform_lanes_tiled(
        c["table"], c["x"], c["state"], max_taps=c["max_taps"], n_out=8192, d=c["plan"]["d"],
        cand=c["plan"]["cand"], table_strided=c["table_strided"])[0],
    "general": lambda: rs.resample_uniform_lanes_general(
        g["table"], g["x"], g["state"], max_taps=g["max_taps"], n_out=4096,
        table_strided=g["table_strided"])[0],
    "strided": lambda: rs.resample_strided_phases(
        s["table"], s["x"], s["state"], max_taps=s["max_taps"], n_out=8192, d=s["d"])[0],
    "wide": lambda: rs.resample_wide_taps(
        w["table"], w["x"], w["state"], max_taps=w["max_taps"], n_out=64, d=w["d"],
        table_strided=w["table_strided"])[0],
}
ms = {k: [] for k in entries}
issue_us = {k: [] for k in entries}
for _ in range(3):
    for name, fn in entries.items():
        ms[name].append(cs.cuda_ms(fn))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [fn() for _ in range(20)]
        issue_us[name].append(1e6 * (time.perf_counter() - t0) / 20)
        torch.cuda.synchronize()
        del outs
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
print(json.dumps(dict(tree=label, after_checks="--after-checks" in sys.argv, nvidia_smi=smi,
                      entry_ms=ms, host_issue_us=issue_us)), flush=True)
