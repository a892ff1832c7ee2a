"""Whole-entry times of the tiled and wide entries before and after a farm
has run the farm library's host threads in the process.

    for k in 1 2 3 4; do python3 chip_scripts/entry_noise_probe.py; done

One JSON line a run: each entry timed three times (chip_smoke.cuda_ms, 20
calls each) before any farm, after a dropping headline farm's 4 calls, and
after 4 more calls kept (the host threads' copy into fresh arrays)."""
import json, os, sys
sys.path.insert(0, os.getcwd())
import numpy as np, torch
import chip_smoke as cs
import clownresampler_tpu_torch as crt
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs

_build.library("resample")
gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
c = cs.launch_case(*cs.HEADLINE["rates"], cs.HEADLINE["lanes"], cs.HEADLINE["n_out"], gen)
targs = dict(max_taps=c["max_taps"], n_out=c["n_out"], d=c["plan"]["d"], cand=c["plan"]["cand"],
             table_strided=c["table_strided"])
w = cs.launch_case(44100, 132, 1024, 64, gen, f0=0x4321)
wargs = dict(max_taps=w["max_taps"], n_out=64, d=w["d"], table_strided=w["table_strided"])
fns = dict(tiled=lambda: rs.resample_uniform_lanes_tiled(c["table"], c["x"], c["state"], **targs)[0],
           wide=lambda: rs.resample_wide_taps(w["table"], w["x"], w["state"], **wargs)[0])
res = {}
res["before"] = {k: [cs.cuda_ms(f) for _ in range(3)] for k, f in fns.items()}
f = cs.FARM
rng = np.random.default_rng(cs.SEED)
chunks = [rng.integers(-32768, 32768, size=(f["streams"], f["chunk"], f["channels"]), dtype=np.int16)
          for _ in range(4)]
farm = crt.UniformStreamFarm(f["streams"], f["channels"], *f["rates"], chunk_frames=f["chunk"],
                             device="cuda")
for ch in chunks:
    farm.process(ch)
torch.cuda.synchronize()
res["after_farm"] = {k: [cs.cuda_ms(f) for _ in range(3)] for k, f in fns.items()}
kept = [farm.process(ch) for ch in chunks]     # keeper: the pool's copy into fresh arrays too
torch.cuda.synchronize()
res["after_keeper"] = {k: [cs.cuda_ms(f) for _ in range(3)] for k, f in fns.items()}
print(json.dumps(res), flush=True)
