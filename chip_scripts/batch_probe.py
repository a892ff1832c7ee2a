"""A short first run of batch_mac_kernel on one CUDA card.

    python3 chip_scripts/batch_probe.py [--quick] [--sweep] [--mix] [--host] [--skip-checks]

Builds the kernels, prints ptxas's registers, shared memory and spills of the
batch library, holds every chip_smoke.BATCH_CASES launch against its plain
version (every leaf exact) and checks that the cases took every
chip_smoke.BATCH_PATHS path; then, unless --quick, config 5's fleet
(chip_smoke.FLEET: 1024 stereo streams, 8192 input and 16,384 output frames)
as one resample_batch call: exact against its plain version on the card,
its sharded form on the (2, 4) mesh equal to it, the entry's time (CUDA
events, three times) at the fleet, at chip_smoke.BATCH and at the
oracle-scan step, each beside its plain version and bound, and the device
launches of one call (torch.profiler, after the timings). --sweep also times
the three entries at other grid sizes (ops/_build.py BATCH_GRID_BLOCKS, which
only the host's plan reads: no rebuild), each output held against the
default plan's. --mix times the fleet's entry at the sweep's
grid sizes with every quota 0 (zeros alone), every quota 10^6 (every stream
to its natural count or n_out) and FLEET's own quotas, each against its
plain version once, and the C entry alone back to back (no host work
between launches) beside torch's zero_ of the same output. --host profiles
the host's issue of 200 fleet calls (cProfile, no synchronise between
them; the top 25 functions by own time). --skip-checks leaves out the cases and the sharded
check. Exits 1 if anything disagrees.
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

# The BATCH_GRID_BLOCKS --sweep and --mix time.
SWEEP = (1024, 2048, 4096, 8192, 16384)


def sweep(fleet: dict, gen) -> None:
    small = cs.batch_case(np.random.default_rng(cs.SEED), cs.BATCH)
    step, step_call = cs.oracle_step_case(gen)
    calls = dict(fleet=lambda: resample_batch(*fleet["case"]["args"], **fleet["case"]["kw"]),
                 batch=lambda: resample_batch(*small["args"], **small["kw"]), step=step_call)
    want = {name: call()[0] for name, call in calls.items()}
    default = _build.BATCH_GRID_BLOCKS
    try:
        for blocks in SWEEP:
            _build.BATCH_GRID_BLOCKS = blocks
            row = {}
            for name, call in calls.items():
                if not torch.equal(call()[0], want[name]):
                    raise AssertionError(f"{blocks} grid blocks changed the {name} output")
                row[name] = round(cs.cuda_ms(lambda: call()[0]), 5)
            print("sweep", dict(grid_blocks=blocks, **row), flush=True)
    finally:
        _build.BATCH_GRID_BLOCKS = default


def mix(fleet: dict) -> None:
    from clownresampler_tpu_torch.batch import resample_batch_reference

    table, x, totals, states, quotas = fleet["case"]["args"]
    kw = fleet["case"]["kw"]
    default = _build.BATCH_GRID_BLOCKS
    try:
        for name, q in (("zeros", torch.zeros_like(quotas)),
                        ("all live", torch.full_like(quotas, 10**6)), ("fleet", quotas)):
            args = (table, x, totals, states, q)
            want = resample_batch_reference(*args, **kw)[0]
            row = {}
            for blocks in SWEEP:
                _build.BATCH_GRID_BLOCKS = blocks
                if not torch.equal(resample_batch(*args, **kw)[0], want):
                    raise AssertionError(f"mix {name}, {blocks} blocks: != plain version")
                row[blocks] = (round(cs.cuda_ms(lambda: resample_batch(*args, **kw)[0]), 5),
                               round(cs.batch_kernel_ms(dict(args=args, kw=kw)), 5))
            del want
            print("mix", name, "produced", int(resample_batch(*args, **kw)[1].sum()),
                  "(entry ms, C entry ms) by grid blocks", row, flush=True)
        out = torch.empty((x.shape[0], kw["n_out"], x.shape[2]), dtype=torch.int32,
                          device=x.device)
        print("mix torch zero_ of the output ms", cs.cuda_ms(lambda: out.zero_()), flush=True)
    finally:
        _build.BATCH_GRID_BLOCKS = default


def host_profile(fleet: dict) -> None:
    import cProfile
    import pstats

    case = fleet["case"]
    call = lambda: resample_batch(*case["args"], **case["kw"])
    for _ in range(20):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call()
    issue = (time.perf_counter() - t0) / 200
    torch.cuda.synchronize()
    print("host issue us a fleet call (no profiler)", 1e6 * issue, flush=True)
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(200):
        call()
    prof.disable()
    torch.cuda.synchronize()
    pstats.Stats(prof, stream=sys.stdout).sort_stats("tottime").print_stats(25)


def main() -> int:
    t0 = time.time()
    _build.library("batch")
    print("build", round(_build.BUILD_LOG["seconds"], 2), flush=True)
    ptxas = _build.BUILD_LOG["ptxas"].get("batch")
    if ptxas is None:
        print("ptxas: the batch library was built earlier in this checkout (remove "
              "clownresampler_tpu_torch/ops/_build/ to see its registers and spills)")
    for ln in (ptxas or "").splitlines():
        if any(k in ln for k in ("registers", "spill", "Compiling entry")):
            print(ln.strip())
    gen = torch.Generator(device="cuda").manual_seed(1)
    bad, paths = [], set()
    for case in () if "--skip-checks" in sys.argv else cs.BATCH_CASES:
        try:
            err = cs.run_batch_case(case, gen, paths)
            torch.cuda.synchronize()
        except AssertionError as e:
            err = str(e)
        print(f"{case[0]:50s} err {err} {'OK' if err == 0 else 'FAIL'}", flush=True)
        if err != 0:
            bad.append(case[0])
    print("paths taken", sorted(paths), "missed", sorted(cs.BATCH_PATHS - paths), flush=True)
    if paths != cs.BATCH_PATHS and "--skip-checks" not in sys.argv:
        bad.append("paths")
    if "--quick" not in sys.argv:
        fleet = cs.run_fleet_batch(np.random.default_rng(cs.SEED))
        print("fleet", cs.check_fleet_batch(fleet), flush=True)
        case = fleet["case"]
        if "--mix" in sys.argv:
            mix(fleet)
        if "--host" in sys.argv:
            host_profile(fleet)
    if "--quick" not in sys.argv and "--skip-checks" not in sys.argv:
        sharded = parallel.sharded_resample_batch(cs.shard_mesh(*cs.FLEET["mesh"]),
                                                  *case["args"], **case["kw"])
        same = all(torch.equal(g, w) for g, w in zip(cs._batch_leaves(sharded),
                                                     cs._batch_leaves(fleet["out"])))
        print("sharded equal", same, flush=True)
        if not same:
            bad.append("sharded")
        del sharded
    if "--quick" not in sys.argv:
        peaks = cs.card_peaks()
        for _ in range(3):
            print("timing", cs.time_batch_kernel(fleet, peaks, gen), flush=True)
        if "--sweep" in sys.argv:
            sweep(fleet, gen)
        names, dev_ms = cs.device_launches(lambda: resample_batch(*case["args"], **case["kw"]))
        print("fleet launches", names, dev_ms)
    print("seconds", time.time() - t0)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
