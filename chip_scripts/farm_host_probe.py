"""The host half of a farm call on one CUDA card: where it goes, and the ways
a chunk may reach the card.

    python3 chip_scripts/farm_host_probe.py [--fresh-runs NAME,...]  # everything
    python3 chip_scripts/farm_host_probe.py --fresh NAME              # one, alone

Prints one JSON line a probe (also appended to chiprun_out/farm_host_probe.jsonl),
each with the card's name and power limit:

* ``host_facts``: ``chip_smoke.host_facts`` (torch's thread count, the CPUs
  this process may use, the card's NUMA node and its CPUs, the machine's
  nodes, transparent huge pages) with ``nvidia-smi topo -m``, the node the
  farm's pinned input lies on (/proc/self/numa_maps), numpy's huge-page advice;
* ``host_pass_threads``: the parent's host pass (torch's ``copy_`` of a headline
  chunk into a pinned buffer) at 1, 2, 4, 8, 16 threads and torch's default,
  each on chunks not touched for a while (``cold``: eight chunks in turn, 292 MB),
  the same chunk again (``warm``) and a chunk written just before (``written``);
  numpy's copy; the farm library's host copy (``crt_farm_host_stage`` with no
  card address) as it ships and in VARIANTS, builds of its source with other
  thread counts or plain stores;
* ``host_pass_held_outputs``: the pass while the process holds 0, 8 and 16
  fresh 67 MB arrays (a caller keeping its outputs);
* ``chunk_to_card``: a headline chunk onto the card, from the call's start to the
  upload's end (a synchronise), for the parent (pass + pinned upload), (a) the
  upload straight from the caller's pageable array, (b) the caller's array
  registered for the call (cudaHostRegister; its cost apart), (c) the farm
  library's host threads with each piece's upload issued as it lands
  (``crt_farm_host_stage``), as it ships and in VARIANTS;
* ``keeper_to_host``: the keeping caller's ``_to_host`` cut into the lease, the
  de-interleave and download issue, the wait, ``np.empty`` and the copy into it;
  and the ways to a fresh array while 8 outputs are held: the parent's pinned
  scratch + threaded copy, a pageable download straight into it, into a
  ``torch.empty`` array, into an array registered for the copy;
* ``mixed_split``: config 5's call cut into ``np.stack``, each group's host pass,
  issue, launches and delivery;
* ``candidate_farm``: the headline farm with each candidate as its
  ``_write_rows`` (CANDIDATES: the parent's torch copy, a, b and the tree's
  own, which is c), at the caller that keeps every output, the one that drops
  each, and the one that drops with a synchronise after the staging (the
  chunk's way onto the card), in turns, every output against the first's;
* with no argument, last, each candidate again in a fresh process (``--fresh``),
  in turns (``--fresh-runs`` names them; by default CANDIDATES there and back).

About 2 minutes of command.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import mmap
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from clownresampler_tpu_torch import farm as fm  # noqa: E402
from clownresampler_tpu_torch.ops import _build  # noqa: E402

OUT = os.path.join(ROOT, "chiprun_out", "farm_host_probe.jsonl")
# The parent's torch copy into the pinned input, (a) the pageable upload,
# (b) the registered array, and the farm's own _write_rows as the tree ships
# it (c: the farm library's host threads; in the parent's tree the torch copy)
# and on the pool of VARIANTS' bound_threads.
CANDIDATES = ("torch_copy", "direct", "registered", "shipped", "bound_threads")
SOURCE = os.path.join(_build.CSRC, "farm_kernels.cu")
# Builds of the farm library's source with crt_farm_host_stage's constants
# (8 threads, 8 pieces, 16-byte streaming stores) changed: {name: patches}.
VARIANTS = {
    "threads_8_pieces_4": [("HOST_PIECES = 8;", "HOST_PIECES = 4;")],
    "threads_8_pieces_16": [("HOST_PIECES = 8;", "HOST_PIECES = 16;")],
    "threads_8_pieces_32": [("HOST_PIECES = 8;", "HOST_PIECES = 32;")],
    "threads_4_pieces_8": [("HOST_THREADS = 8;", "HOST_THREADS = 4;")],
    "plain_stores": [("_mm_stream_si128(", "_mm_storeu_si128(")],
    # Pool thread w bound to the w-th CPU this process may use (the issuing
    # thread left unbound), as the pool was first built.
    "bound_threads": [("threads.emplace_back([this, w, g = generation] { work(w, g); });",
                       "threads.emplace_back([this, w, g = generation] { work(w, g); });\n"
                       "                cpu_set_t one;\n"
                       "                CPU_ZERO(&one);\n"
                       "                for (int c = 0, k = 0; c < CPU_SETSIZE; ++c) {\n"
                       "                    if (CPU_ISSET(c, &set) && k++ == w) CPU_SET(c, &one);\n"
                       "                }\n"
                       "                pthread_setaffinity_np(threads.back().native_handle(),\n"
                       "                                       sizeof(one), &one);")],
}
SMI = None


def show(name, **fields):
    line = json.dumps({"probe": name, "nvidia_smi": SMI, **fields})
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def smi(*query):
    return subprocess.run(["nvidia-smi", *query], capture_output=True, text=True).stdout.strip()


def read(path):
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError as e:
        return f"unreadable: {e}"


def pages_of(address):
    """numa_maps's line for the mapping that holds ``address`` (None where the
    kernel has no numa_maps)."""
    if not os.path.exists("/proc/self/numa_maps"):
        return None
    start = None
    for ln in open("/proc/self/maps"):
        lo, hi = (int(x, 16) for x in ln.split()[0].split("-"))
        if lo <= address < hi:
            start = lo
            break
    for ln in open("/proc/self/numa_maps"):
        if start is not None and int(ln.split()[0], 16) == start:
            return ln.strip()
    return None


def build_variants() -> dict:
    """{variant: its crt_farm_host_stage}, every nvcc at once (a build whose
    patched source was built before is loaded again)."""
    text = open(SOURCE).read()
    work = os.path.join(_build.BUILD_DIR, "probe_host_stage")
    os.makedirs(work, exist_ok=True)
    jobs = {}
    for name, patches in VARIANTS.items():
        src = text
        for old, new in patches:
            if old not in src:
                raise SystemExit(f"variant {name}: {old!r} not in {SOURCE}")
            src = src.replace(old, new)
        digest = hashlib.sha256(src.encode()).hexdigest()[:16]
        cu, so = (os.path.join(work, f"{name}-{digest}{ext}") for ext in (".cu", ".so"))
        if os.path.exists(so):
            jobs[name] = (so, None)
            continue
        with open(cu, "w") as f:
            f.write(src)
        jobs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, cu, "-o", f"{so}.tmp"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    entries = {}
    for name, (so, proc) in jobs.items():
        if proc is not None:
            _, err = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"variant {name} failed to build:\n{err}")
            os.replace(f"{so}.tmp", so)
        fn = ctypes.CDLL(so).crt_farm_host_stage
        fn.argtypes = [ctypes.c_void_p if a in _build.POINTER_ARGS
                       else ctypes.c_longlong if a in _build.LONG_ARGS else ctypes.c_int
                       for a in _build.ENTRY_ARGS["crt_farm_host_stage"]]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


class Host:
    """The host entries the probes call: the farm library's copy and host
    stage (as shipped, and its VARIANTS where built), the CUDA runtime's
    registration."""

    def __init__(self, variants=False):
        self.stream = torch.cuda.current_stream().cuda_stream
        self.copy = _build.entry_function("crt_farm_copy")
        self.stages = {"shipped": _build.entry_function("crt_farm_host_stage"),
                       **(build_variants() if variants else {})}
        self.cudart = torch.cuda.cudart()

    def stage(self, dst, src, nbytes, card=None, variant="shipped"):
        """crt_farm_host_stage of one row: src[0, nbytes) to dst, and on to
        the card address ``card`` piece by piece (None: the copy alone)."""
        srcs = np.array([src], np.uint64)
        _build.raise_on_launch(self.stages[variant](dst, srcs.ctypes.data, 1, nbytes, card, 0,
                                                    self.stream), "crt_farm_host_stage")

    def register(self, ptr, nbytes, read_only=False):
        err = self.cudart.cudaHostRegister(ptr, nbytes, 8 if read_only else 0)
        _build.raise_on_launch(int(getattr(err, "value", err)), "crt_farm_copy")

    def unregister(self, ptr):
        err = self.cudart.cudaHostUnregister(ptr)
        _build.raise_on_launch(int(getattr(err, "value", err)), "crt_farm_copy")

    def upload(self, dst, src, nbytes):
        _build.raise_on_launch(self.copy(dst, src, nbytes, 0, self.stream), "crt_farm_copy")


def headline_chunks(seed=cs.SEED):
    f = cs.FARM
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, size=(f["streams"], f["chunk"], f["channels"]),
                         dtype=np.int16) for _ in range(f["chunks"])]


def med(xs):
    return statistics.median(xs)


# ---------------------------------------------------------------------------
# Part 1: why the host pass swings, where the keeper's delivery goes
# ---------------------------------------------------------------------------

def host_facts():
    pinned = torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
    pinned.fill_(1)
    try:
        from numpy._core import multiarray as ma
    except ImportError:
        from numpy.core import multiarray as ma
    meminfo = {ln.split(":")[0]: ln.split(":")[1].strip() for ln in open("/proc/meminfo")
               if ln.split(":")[0] in ("MemTotal", "MemFree", "MemAvailable", "AnonHugePages",
                                       "Hugepagesize", "HugePages_Total")}
    show("host_facts", **cs.host_facts(),
         torch_interop_threads=torch.get_num_interop_threads(),
         affinity=sorted(os.sched_getaffinity(0)),
         omp_num_threads=os.environ.get("OMP_NUM_THREADS"),
         smi_bus_id=smi("--query-gpu=pci.bus_id", "--format=csv,noheader"), topo=smi("topo", "-m"),
         thp_khugepaged_defrag=read("/sys/kernel/mm/transparent_hugepage/khugepaged/defrag"),
         numpy_madvise_hugepage=getattr(ma, "_get_madvise_hugepage", lambda: None)(),
         numa_balancing=read("/proc/sys/kernel/numa_balancing"),
         kernel=read("/proc/version"), numa_maps=os.path.exists("/proc/self/numa_maps"),
         pinned_pages=pages_of(pinned.data_ptr()), meminfo=meminfo,
         cpu_model=next((ln.split(":")[1].strip() for ln in open("/proc/cpuinfo")
                         if ln.startswith("model name")), None),
         parallel_info=[ln for ln in torch.__config__.parallel_info().splitlines()
                        if ln.strip()][:12])


def time_pass(fn, chunks, mode, gap_ms=0.0):
    """Median ms of fn(chunk) over the chunks but the first: ``cold`` takes
    each chunk in turn, ``warm`` the same chunk again, ``written`` a chunk
    overwritten just before; each after ``gap_ms`` of sleep."""
    times = []
    for k, ch in enumerate(chunks):
        src = chunks[0] if mode == "warm" else ch
        if mode == "written":
            np.copyto(src, chunks[(k + 1) % len(chunks)])
        if gap_ms:
            time.sleep(gap_ms / 1e3)
        t0 = time.perf_counter()
        fn(src)
        times.append(1e3 * (time.perf_counter() - t0))
    return med(times[1:])


def host_pass_threads(host, chunks):
    pinned = torch.empty(chunks[0].size, dtype=torch.int16, pin_memory=True)
    view = pinned.view(chunks[0].shape)
    default = torch.get_num_threads()
    torch_copy = lambda ch: view.copy_(torch.from_numpy(ch))
    rows = {}
    for threads in (1, 2, 4, 8, 16, default):
        torch.set_num_threads(threads)
        rows[f"torch_{threads}"] = {m: time_pass(torch_copy, chunks, m)
                                    for m in ("cold", "warm", "written")}
    torch.set_num_threads(default)
    rows["numpy_copyto"] = {"cold": time_pass(
        lambda ch: np.copyto(pinned.numpy().reshape(ch.shape), ch), chunks, "cold")}
    for variant in host.stages:
        fn = lambda ch, v=variant: host.stage(pinned.data_ptr(), ch.ctypes.data, ch.nbytes,
                                              variant=v)
        rows[f"host_stage_{variant}"] = {m: time_pass(fn, chunks, m) for m in ("cold", "warm")}
        if not np.array_equal(pinned.numpy(), chunks[0].reshape(-1)):
            raise AssertionError(f"host stage {variant} disagrees")
    # After an idle gap (threads asleep), as between a farm's calls.
    gaps = {}
    for gap in (0.0, 1.0, 3.0, 10.0):
        gaps[f"torch_{default}_gap_{gap}ms"] = time_pass(torch_copy, chunks, "cold", gap)
        gaps[f"host_stage_shipped_gap_{gap}ms"] = time_pass(
            lambda ch: host.stage(pinned.data_ptr(), ch.ctypes.data, ch.nbytes), chunks, "cold",
            gap)
    rows["after_idle_gap"] = gaps
    show("host_pass_threads", bytes=chunks[0].nbytes, default_threads=default, ms=rows,
         gbytes_per_s_cold={k: chunks[0].nbytes / v["cold"] / 1e6 for k, v in rows.items()
                            if "cold" in v})
    return pinned


def host_pass_held_outputs(chunks, pinned):
    view = pinned.view(chunks[0].shape)
    fn = lambda ch: view.copy_(torch.from_numpy(ch))
    held, rows = [], {}
    emit = cs.FARM["streams"] * cs.HEADLINE["n_out"] * cs.FARM["channels"]
    for count in (0, 8, 16):
        while len(held) < count:
            a = np.empty(emit, np.int32)
            a.fill(len(held))
            held.append(a)
        rows[str(count)] = time_pass(fn, chunks, "cold")
    show("host_pass_held_outputs", held_67mb_arrays_ms=rows, pinned_pages=pages_of(
        pinned.data_ptr()))


def chunk_to_card(host, chunks):
    """A chunk from the call's start to its upload's end on the card."""
    nbytes = chunks[0].nbytes
    pinned = torch.empty(chunks[0].size, dtype=torch.int16, pin_memory=True)
    card = torch.empty(chunks[0].size, dtype=torch.int16, device="cuda")
    view = pinned.view(chunks[0].shape)

    def landed(fn):
        times, host_ms = [], []
        for ch in chunks:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(ch)
            host_ms.append(1e3 * (time.perf_counter() - t0))
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        if not torch.equal(card[:5].cpu(), torch.from_numpy(chunks[-1].reshape(-1)[:5].copy())):
            raise AssertionError("upload disagrees")
        return dict(landed_ms=med(times[1:]), host_return_ms=med(host_ms[1:]))

    res = {}

    def parent(ch):
        view.copy_(torch.from_numpy(ch))
        host.upload(card.data_ptr(), pinned.data_ptr(), nbytes)

    res["parent_torch_copy_then_upload"] = landed(parent)
    res["a_pageable_upload"] = landed(lambda ch: host.upload(card.data_ptr(), ch.ctypes.data,
                                                             nbytes))
    split = {"register": [], "upload": [], "unregister": []}

    def registered(ch):
        t0 = time.perf_counter()
        host.register(ch.ctypes.data, nbytes)
        t1 = time.perf_counter()
        host.upload(card.data_ptr(), ch.ctypes.data, nbytes)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.unregister(ch.ctypes.data)
        split["register"].append(1e3 * (t1 - t0))
        split["upload"].append(1e3 * (t2 - t1))
        split["unregister"].append(1e3 * (time.perf_counter() - t2))

    res["b_registered_upload"] = dict(landed(registered),
                                      **{k + "_ms": med(v[1:]) for k, v in split.items()})
    res["c_host_stage"] = {variant: landed(lambda ch, v=variant: host.stage(
        pinned.data_ptr(), ch.ctypes.data, nbytes, card.data_ptr(), v))
        for variant in host.stages}
    res["pinned_upload_alone_ms"] = cs._entry_ms("crt_farm_copy", dict(
        dst=card.data_ptr(), src=pinned.data_ptr(), nbytes=nbytes, device=0,
        stream=host.stream), reps=5)
    show("chunk_to_card", bytes=nbytes, **res)


def keeper_to_host(host, chunks):
    """The keeping caller's _to_host, cut; then the ways to a fresh array."""
    f = cs.FARM
    farm = fm.UniformStreamFarm(f["streams"], f["channels"], *f["rates"], chunk_frames=f["chunk"],
                                device="cuda")
    cuts = []

    def to_host(lanes_out, n_out):
        t = [time.perf_counter()]
        shape, dtype = (farm.n_streams, n_out, farm.channels), np.int32
        result, address, owned = farm._results.lease(shape, dtype)
        t.append(time.perf_counter())
        program = farm._programs[0][3]
        program.unstage(n_out, address)
        t.append(time.perf_counter())
        program.wait()
        t.append(time.perf_counter())
        if not owned:
            scratch, result = result, np.empty(shape, dtype)
            t.append(time.perf_counter())
            torch.from_numpy(result).copy_(torch.from_numpy(scratch))
            t.append(time.perf_counter())
        names = ("lease", "unstage_and_download_issue", "wait", "np_empty", "copy_into_fresh")
        cuts.append(dict(owned=owned, **{n + "_ms": 1e3 * (b - a)
                                         for n, a, b in zip(names, t, t[1:])}))
        return result

    farm._to_host = to_host
    kept = []
    for ch in chunks:
        kept.append(farm.process(ch))
    del kept, farm

    # The ways to a fresh array, 8 outputs held as the keeper holds them.
    numel = f["streams"] * cs.HEADLINE["n_out"] * f["channels"]
    card = torch.randint(-(1 << 20), 1 << 20, (numel,), dtype=torch.int32, device="cuda")
    want = card[:9].cpu().numpy()
    scratch = torch.empty(numel, dtype=torch.int32, pin_memory=True)
    stream = host.stream

    def via_scratch():
        host.copy(scratch.data_ptr(), card.data_ptr(), 4 * numel, 0, stream)
        torch.cuda.current_stream().synchronize()
        result = np.empty(numel, np.int32)
        torch.from_numpy(result).copy_(scratch)
        return result

    def pageable_download():
        result = np.empty(numel, np.int32)
        host.upload(result.ctypes.data, card.data_ptr(), 4 * numel)
        torch.cuda.current_stream().synchronize()
        return result

    def torch_empty_then_scratch():
        host.copy(scratch.data_ptr(), card.data_ptr(), 4 * numel, 0, stream)
        torch.cuda.current_stream().synchronize()
        result = torch.empty(numel, dtype=torch.int32)
        result.copy_(scratch)
        return result.numpy()

    def registered_fresh():
        result = np.empty(numel, np.int32)
        host.register(result.ctypes.data, 4 * numel)
        host.upload(result.ctypes.data, card.data_ptr(), 4 * numel)
        torch.cuda.current_stream().synchronize()
        host.unregister(result.ctypes.data)
        return result

    def prefault_then_pageable():
        result = np.empty(numel, np.int32)
        torch.from_numpy(result).zero_()
        host.upload(result.ctypes.data, card.data_ptr(), 4 * numel)
        torch.cuda.current_stream().synchronize()
        return result

    def populated(nbytes):
        mm = mmap.mmap(-1, nbytes, flags=mmap.MAP_PRIVATE | mmap.MAP_ANONYMOUS
                       | mmap.MAP_POPULATE)
        return np.frombuffer(mm, np.int32)

    def populated_then_scratch():
        host.copy(scratch.data_ptr(), card.data_ptr(), 4 * numel, 0, stream)
        torch.cuda.current_stream().synchronize()
        result = populated(4 * numel)
        torch.from_numpy(result).copy_(scratch)
        return result

    def populate_alone():
        result = populated(4 * numel)
        result[:9] = want
        return result

    def first_touch_alone():
        result = np.empty(numel, np.int32)
        torch.from_numpy(result).zero_()
        result[:9] = want
        return result

    ways = {}
    for name, fn in (("parent_pinned_scratch_then_fresh_array", via_scratch),
                     ("pinned_scratch_then_populated_array", populated_then_scratch),
                     ("populated_array_alone", populate_alone),
                     ("fresh_array_zeroed_by_threads_alone", first_touch_alone),
                     ("pageable_download_into_fresh_array", pageable_download),
                     ("pinned_scratch_then_torch_empty_array", torch_empty_then_scratch),
                     ("fresh_array_registered_for_the_download", registered_fresh),
                     ("fresh_array_zeroed_by_threads_then_pageable_download",
                      prefault_then_pageable)):
        for held_count in (0, 8):
            held, times = [], []
            for _ in range(held_count + 3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                got = fn()
                times.append(1e3 * (time.perf_counter() - t0))
                if not np.array_equal(got[:9], want):
                    raise AssertionError(name)
                held.append(got)
                if len(held) > held_count:
                    held.pop(0)
            ways[f"{name}_holding_{held_count}"] = dict(
                median_ms=med(times[1:]), first_ms=times[0], last_ms=times[-1])
            del held, got
    show("keeper_to_host", calls=cuts,
         steady_scratch_calls=[c for c in cuts[1:] if not c["owned"]],
         fresh_array_ways=ways)


def mixed_split():
    m = cs.MIXED
    specs = [rates for rates in m["groups"] for _ in range(m["per_group"])]
    rng = np.random.default_rng(cs.SEED)
    chunks = [rng.integers(-32768, 32768, size=(len(specs), m["chunk"], m["channels"]),
                           dtype=np.int16) for _ in range(m["chunks"])]
    res = {}
    for mode in ("keep", "drop"):
        farm = fm.MixedStreamFarm(specs, m["channels"], chunk_frames=m["chunk"],
                                  max_radius=m["max_radius"], device="cuda")
        calls = []
        stack = np.stack

        def timed_stack(*a, **k):
            t0 = time.perf_counter()
            out = stack(*a, **k)
            calls[-1]["np_stack_ms"] = calls[-1].get("np_stack_ms", 0) + 1e3 * (
                time.perf_counter() - t0)
            return out

        def wrap(group, name):
            fn = getattr(group, name)

            def timed(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                calls[-1][name + "_ms"] = calls[-1].get(name + "_ms", 0) + 1e3 * (
                    time.perf_counter() - t0)
                return out
            setattr(group, name, timed)

        for group, _ in farm._groups:
            for name in ("_write_rows", "_to_host", "_launch"):
                wrap(group, name)
            for *_, program in group._programs:
                wrap(program, "stage")
        np.stack = timed_stack
        kept = []
        try:
            for ch in chunks:
                torch.cuda.synchronize()
                calls.append({})
                t0 = time.perf_counter()
                out = farm.process(list(ch))
                calls[-1]["call_ms"] = 1e3 * (time.perf_counter() - t0)
                if mode == "keep":
                    kept.append(out)
                del out
        finally:
            np.stack = stack
        for c in calls:
            c["host_pass_ms"] = c.get("_write_rows_ms", 0) - c.get("stage_ms", 0)
        res[mode] = dict(steady={k: med(c.get(k, 0.0) for c in calls[1:])
                                 for k in calls[1]}, calls=calls)
        del kept, farm
    show("mixed_split", groups=m["groups"], per_group=m["per_group"], chunk=m["chunk"], **res)


# ---------------------------------------------------------------------------
# Part 2: the candidates as the farm's _write_rows
# ---------------------------------------------------------------------------

def candidate(name, host, farm):
    """A replacement for ``farm._write_rows`` (C-contiguous int16 chunks only)
    and a function to run after each call (the registered candidate's
    unregister)."""
    shipped = farm._write_rows
    registered = []

    def wait():
        for *_, program in farm._programs:
            program.wait()

    def torch_copy(chunk):
        b, n, c = chunk.shape
        wait()
        block = farm._input_array[: b * n * c].reshape(b, n, c)
        torch.from_numpy(block).copy_(torch.from_numpy(chunk))
        for _, lo, _, program in farm._programs:
            program.stage(farm._input.data_ptr() + 2 * lo * n * c, n, farm._fill)

    def direct(chunk):
        b, n, c = chunk.shape
        wait()
        for _, lo, _, program in farm._programs:
            program.stage(chunk.ctypes.data + 2 * lo * n * c, n, farm._fill)

    def register(chunk):
        wait()
        if chunk.nbytes:
            host.register(chunk.ctypes.data, chunk.nbytes)
            registered.append(chunk.ctypes.data)
        direct(chunk)

    def after():
        if registered:
            wait()
            host.unregister(registered.pop())

    if name == "bound_threads":    # the farm's own route on the pool so built
        for *_, program in farm._programs:
            program._calls["crt_farm_host_stage"] = host.stages["bound_threads"]
        return shipped, after
    write = dict(torch_copy=torch_copy, direct=direct, registered=register,
                 shipped=shipped)[name]
    return write, after


def candidate_farm(host, chunks, names, modes=("keep", "drop", "drop_waited"), label=""):
    f = cs.FARM
    want, rows = None, []
    for name in names:
        for mode in modes:
            farm = fm.UniformStreamFarm(f["streams"], f["channels"], *f["rates"],
                                        chunk_frames=f["chunk"], device="cuda")
            write, after = candidate(name, host, farm)
            farm._write_rows = write
            process = farm.process

            def call(farm, chunk, process=process, after=after):
                out = process(chunk)
                after()
                return out

            expect = want if mode != "keep" and want is not None else None
            r = cs.drive_farm(farm, chunks, call, split=True, expect=expect,
                              wait_staging=mode == "drop_waited")
            if mode == "keep":
                if want is None:
                    want = r["outs"]
                elif not all(np.array_equal(a, b) for a, b in zip(r["outs"], want)):
                    raise AssertionError(f"candidate {name} disagrees with the first")
            rate = cs._rate(r)
            split = r["steady_split_ms"]
            rows.append(dict(candidate=name, mode=mode, ms_per_process=rate["ms_per_process"],
                             ms_per_call=rate["ms_per_call"], steady_split_ms=split,
                             chunk_to_card_ms=split.get("stage_ms", 0) + split.get(
                                 "stage_wait_ms", 0) if mode == "drop_waited" else None))
            del r, farm
    show("candidate_farm" + label, rows=rows, exact=True)


def main():
    global SMI
    SMI = smi("--query-gpu=name,power.limit", "--format=csv,noheader").splitlines()[0]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    _build.library("farm")
    if "--fresh" in sys.argv:
        name = sys.argv[sys.argv.index("--fresh") + 1]
        candidate_farm(Host(variants=name in VARIANTS), headline_chunks(), (name,),
                       label="_fresh")
        return 0
    t0 = time.time()
    failed = []

    def guarded(fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # report, go on with the other probes, fail at the end
            failed.append(fn.__name__)
            show(fn.__name__ + "_failed", error=f"{type(e).__name__}: {e}")
            return None

    host = Host(variants=True)
    guarded(host_facts)
    chunks = headline_chunks()
    pinned = guarded(host_pass_threads, host, chunks)
    if pinned is not None:
        guarded(host_pass_held_outputs, chunks, pinned)
    del pinned
    chunks = headline_chunks()     # the passes above overwrote some
    guarded(chunk_to_card, host, chunks)
    guarded(keeper_to_host, host, chunks)
    guarded(mixed_split)
    guarded(candidate_farm, host, chunks, CANDIDATES + CANDIDATES[::-1])
    print("seconds in process", round(time.time() - t0, 1), flush=True)
    fresh = sys.argv[sys.argv.index("--fresh-runs") + 1].split(",") if (
        "--fresh-runs" in sys.argv) else CANDIDATES + CANDIDATES[::-1]
    for name in fresh:
        rc = subprocess.run([sys.executable, __file__, "--fresh", name]).returncode
        if rc:
            failed.append(f"fresh {name} rc={rc}")
    print("seconds", round(time.time() - t0, 1), "failed", failed, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
