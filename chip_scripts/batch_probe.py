"""A short first run of batch_mac_kernel on one CUDA card.

    python3 chip_scripts/batch_probe.py [--quick]

Builds the kernels, prints ptxas's registers and spills of the batch
library, holds every chip_smoke.BATCH_CASES launch against its plain version
(every leaf exact); then, unless --quick, config 5's fleet (chip_smoke.FLEET:
1024 stereo streams, 8192 input and 16,384 output frames) as one
resample_batch call: exact against its plain version on the card, its
sharded form on the (2, 4) mesh equal to it, the entry's time (CUDA events,
three times) beside the plain version's and its bound, and the device
launches of one call (torch.profiler, after the timings). Exits 1 if
anything disagrees.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch import parallel  # noqa: E402
from clownresampler_tpu_torch.batch import resample_batch  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402

t0 = time.time()
_build.library("batch")
print("build", round(_build.BUILD_LOG["seconds"], 2), flush=True)
for ln in _build.BUILD_LOG["ptxas"]["batch"].splitlines():
    if any(k in ln for k in ("registers", "spill", "Compiling entry")):
        print(ln.strip())
gen = torch.Generator(device="cuda").manual_seed(1)
bad = []
for case in cs.BATCH_CASES:
    try:
        err = cs.run_batch_case(case, gen)
        torch.cuda.synchronize()
    except AssertionError as e:
        err = str(e)
    print(f"{case[0]:50s} err {err} {'OK' if err == 0 else 'FAIL'}", flush=True)
    if err != 0:
        bad.append(case[0])
if "--quick" not in sys.argv:
    fleet = cs.run_fleet_batch(np.random.default_rng(cs.SEED))
    print("fleet", cs.check_fleet_batch(fleet), flush=True)
    case = fleet["case"]
    sharded = parallel.sharded_resample_batch(cs.shard_mesh(*cs.FLEET["mesh"]), *case["args"],
                                              **case["kw"])
    same = all(torch.equal(g, w) for g, w in zip(cs._batch_leaves(sharded),
                                                 cs._batch_leaves(fleet["out"])))
    print("sharded equal", same, flush=True)
    if not same:
        bad.append("sharded")
    del sharded
    peaks = cs.card_peaks()
    for _ in range(3):
        print("fleet", cs.time_batch_kernel(fleet, peaks), flush=True)
    names, dev_ms = cs.device_launches(lambda: resample_batch(*case["args"], **case["kw"]))
    print("fleet launches", names, dev_ms)
print("seconds", time.time() - t0)
sys.exit(1 if bad else 0)
