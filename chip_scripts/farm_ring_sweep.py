"""farm_stage_kernel's ring at the headline, timed at several stage counts and tiles.

    python3 chip_scripts/farm_ring_sweep.py [STAGES ...]

Builds the kernels (ops/_build.py), prints the ring's registers and spills,
then times crt_farm_stage on the headline farm's steady stage (chip_smoke
FARM_STAGE_CASES[0]) for each ring stage count given (by default 2, 3, 4, 6
and 8) and each tile (streams x frames) whose stages fit in shared memory,
the layout from _build.farm_ring_layout, each held exact against the plain
version. One JSON line a measurement, the card's name and power limit beside
it, the layout the farm takes marked.
"""
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch.farm import farm_stage_reference  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402

TILES = ((32, 64), (16, 128), (32, 128), (16, 256), (8, 256), (64, 64))
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, check=True).stdout.strip()
stage_counts = [int(a) for a in sys.argv[1:]] or [2, 3, 4, 6, 8]
_build.library("farm")
# ptxas's report exists where this process built the library.
lines = _build.BUILD_LOG["ptxas"].get("farm", "").splitlines()
ring = next((i for i, ln in enumerate(lines) if "farm_stage_kernelILi2E" in ln), None)
if ring is not None:
    print(json.dumps({"ring_ptxas": [ln.strip() for ln in lines[ring + 1 : ring + 4]
                                     if "registers" in ln or "spill" in ln]}), flush=True)

gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
_, b, c, capacity, n, keep, consumed, _ = cs.FARM_STAGE_CASES[0]
rand = lambda *shape: torch.randint(-32768, 32768, shape, generator=gen, dtype=torch.int32,
                                    device="cuda")
src, dst, chunk = rand(capacity, b * c), rand(capacity, b * c), rand(b, n, c).to(torch.int16)
want = torch.empty_like(dst)
farm_stage_reference(src, want, chunk, keep=keep, consumed=consumed)
base = _build.farm_stage_args(src, dst, chunk, streams=b, channels=c, n_in=n, keep=keep,
                              consumed=consumed)
if base["path"] != _build.FARM_STAGE_RING:
    sys.exit(f"the headline stage took path {base['path']}, not the ring")
bound = 1e3 * (6 * n * b * c + 8 * keep * b * c + 4 * (capacity - keep - n) * b * c) / \
    cs.card_peaks()["hbm_bytes_per_s"]
chosen = _build.farm_ring_layout(c)

for stages in stage_counts:
    for tile in TILES:
        layout = _build.farm_ring_layout(c, stages, tile)
        if layout["shared_bytes"] > _build.MAX_SHARED_BYTES:
            continue
        shared = layout.pop("shared_bytes")
        dst.fill_(-7)
        ms = cs._entry_ms("crt_farm_stage", dict(base, **layout))
        if not torch.equal(dst, want):
            sys.exit(f"the ring at {stages} stages, tile {tile} != the plain version")
        print(json.dumps(dict(stages=stages, tile=list(tile), shared_bytes=shared, ms=ms,
                              bound_ms=bound, bound_share=bound / ms,
                              farm_takes=layout == {k: chosen[k] for k in layout},
                              nvidia_smi=smi)), flush=True)
