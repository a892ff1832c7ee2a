"""A farm's chunk on its way to the card, against the JAX farms.

On a card a farm takes its chunk by one of three routes, each counted in
``ROUTES`` as ``("farm_input", route)``:

* ``direct``: a C-contiguous int16 chunk (read-only or not) is read where the
  caller holds it: the farm library's host threads copy each program's stream
  range into the pinned input and upload it piece by piece
  (``crt_farm_host_stage``); the farm makes no pass of its own before that;
* ``converted``: any other chunk is converted into the pinned input as
  ``np.ascontiguousarray(chunk, dtype=np.int16)`` converts it, and uploaded
  from there (``crt_farm_copy``);
* ``stacked``: a mixed farm's group takes its streams' chunks, each converted
  as ``np.asarray(chunk, np.int16)`` converts it, straight into the group's
  pinned input through the same host threads, a vacated slot as zeros.

Here the farms take the card's path on CPU tensors with every C entry stood
in over the same pointers (fixture ``card``), and are held, with inputs made
from a numpy seed and exact equality, against the JAX package's farms: every
route, short and empty chunks, flush, ``adjust`` and ``adjust_stream``,
snapshots taken right after ``process`` and restored in both packages, the
sharded farm at dp 1-4 with uneven stream splits; the stand-in's log shows the
bytes read at each address passed, and the caller's chunk is never written
and may be overwritten as soon as ``process`` returns.
``tests/test_torch_cuda_farm_host_path.py`` holds the card's twins.
"""

import collections
import os
import re
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

from clownresampler_tpu import checkpoint as jckpt
from clownresampler_tpu.farm import MixedStreamFarm as JMixed
from clownresampler_tpu.farm import UniformStreamFarm as JFarm
from clownresampler_tpu_torch import checkpoint as ckpt
from clownresampler_tpu_torch import farm as farm_mod
from clownresampler_tpu_torch.farm import MixedStreamFarm, UniformStreamFarm
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.parallel import ShardedMixedStreamFarm, ShardedStreamFarm, make_mesh
from tests.test_torch_farm_program import card  # noqa: F401  (fixture)
from tests.test_torch_farm_program import _CardMixedFarm, _view

RATES = (48000, 44100)
CHUNK = 96
SIZES = (96, 33, 0, 96, 5)      # full, short, empty, full, short; then the flush
MIXED_GROUPS = [(48000, 44100), (96000, 48000), (8000, 48000)]


def _base(seed, b, c, sizes=SIZES):
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16) for n in sizes]


# What a caller may hand a farm, made from an int16 chunk, and its route.
FORMS = {
    "int16": (lambda x: x.copy(), "direct"),
    "read_only": (lambda x: _read_only(x.copy()), "direct"),
    "int32_wrapping": (lambda x: x.astype(np.int32) * 3, "converted"),
    "float64": (lambda x: x.astype(np.float64) + 0.75, "converted"),
    "strided_view": (lambda x: np.repeat(x, 2, axis=1)[:, ::2], "converted"),
    "fortran_int16": (lambda x: np.asfortranarray(x), "converted"),
}


def _read_only(x):
    x.flags.writeable = False
    return x


def _jax_run(farm, chunks):
    outs = [np.asarray(farm.process(c)) for c in chunks]
    return outs + [np.asarray(farm.flush())]


def _same(got, want, what):
    assert len(got) == len(want), what
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.shape, w.shape)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} call {k}")


def _card_farm(b, c, rates=RATES, **kw):
    farm = UniformStreamFarm(b, c, *rates, chunk_frames=CHUNK, device="cpu",
                             device_staging=True, **kw)
    assert farm._on_card
    return farm


# ---------------------------------------------------------------------------
# The uniform farm: every route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("form", list(FORMS))
def test_torch_farm_host_path_route_matches_jax_farm(card, form):
    """Each form of chunk takes its route, reaches the pinned input as
    ``np.ascontiguousarray(chunk, dtype=np.int16)`` would make it, and the
    farm's every output equals the JAX farm's on the same chunks."""
    make, route = FORMS[form]
    chunks = [make(x) for x in _base(61, 5, 2)]
    want = _jax_run(JFarm(5, 2, *RATES, chunk_frames=CHUNK, interpret=True), chunks)
    rs.ROUTES.clear()
    farm = _card_farm(5, 2)
    got = [farm.process(c) for c in chunks] + [farm.flush()]
    _same(got, want, form)
    fed = sum(1 for c in chunks if c.shape[1])
    # An empty chunk of int16 is C-contiguous whatever made it: it goes direct.
    routes = collections.Counter(
        ("farm_input", "direct" if c.dtype == np.int16 and c.flags.c_contiguous else "converted")
        for c in chunks)
    assert {k: v for k, v in rs.ROUTES.items() if k[0] == "farm_input"} == routes
    assert routes[("farm_input", route)] >= fed
    assert rs.ROUTES[("farm_stage", "cuda")] == len(chunks) + 1
    entry = "crt_farm_host_stage" if route == "direct" else "crt_farm_copy"
    uploads = [a for name, a in card if name == entry and a.get("card", a.get("dst")) ==
               farm._programs[0][3].chunk.data_ptr()]
    assert len(uploads) == fed


@pytest.mark.parametrize("clamp", [False, True], ids=["int32", "clamp_s16"])
def test_torch_farm_host_path_adjust_and_snapshot_in_both_packages(card, clamp):
    """Straight from the caller's chunks with a pitch bend mid-stream, a
    snapshot right after ``process`` restored in the port (on the card's
    path) and in the JAX package: every farm goes on bit for bit with the
    JAX farm."""
    chunks = _base(62, 4, 2, (96,) * 5)
    jfarm = JFarm(4, 2, *RATES, chunk_frames=CHUNK, interpret=True, clamp_s16=clamp,
                  max_radius=17)
    farm = _card_farm(4, 2, clamp_s16=clamp, max_radius=17)
    _same([farm.process(c) for c in chunks[:2]],
          [np.asarray(jfarm.process(c)) for c in chunks[:2]], "before")
    assert farm.adjust(44100, 8000) and jfarm.adjust(44100, 8000)
    _same([farm.process(chunks[2])], [np.asarray(jfarm.process(chunks[2]))], "adjusted")
    snap = ckpt.save_farm(farm)
    assert farm._programs[0][3].slide > 0      # a slide parked: the snapshot applies it
    restored = ckpt.load_farm(snap, device="cpu")
    in_port = ckpt.load_farm(snap, mesh=make_mesh(dp=1, devices=["cpu"]))
    in_jax = jckpt.load_farm(dict(snap, interpret=True, device_staging=False))
    want = _jax_run(jfarm, chunks[3:])
    for name, f in (("farm", farm), ("restored", restored), ("restored on the mesh", in_port),
                    ("restored in jax", in_jax)):
        _same(_jax_run(f, chunks[3:]), want, name)


@pytest.mark.parametrize("dp,b", [(1, 7), (2, 7), (3, 7), (4, 7), (4, 10)])
def test_torch_sharded_farm_host_path_reads_each_range_at_its_address(card, dp, b):
    """A sharded farm's programs each take their stream range straight from
    the caller's chunk: one host stage a program, its one row the range's
    address in the chunk, landing at the range's place in the pinned input
    and on the program's card buffer byte for byte; outputs equal the JAX
    farm's."""
    chunks = _base(63 + dp, b, 2, (96, 40, 96))
    want = _jax_run(JFarm(b, 2, *RATES, chunk_frames=CHUNK, interpret=True), chunks)
    rs.ROUTES.clear()
    farm = ShardedStreamFarm(make_mesh(dp=dp, devices=["cpu"] * dp), b, 2, *RATES,
                             chunk_frames=CHUNK)
    got = []
    for chunk in chunks:
        del card[:]
        got.append(farm.process(chunk))
        n = chunk.shape[1]
        stages = [a for name, a in card if name == "crt_farm_host_stage" and a["card"]]
        assert len(stages) == len(farm._programs)
        for a, (_, lo, hi, program) in zip(stages, farm._programs):
            size = 2 * (hi - lo) * n * 2
            assert list(a["sources"]) == [chunk.ctypes.data + 2 * lo * n * 2]
            assert (a["rows"], a["row_bytes"]) == (1, size)
            assert a["pinned"] == farm._input.data_ptr() + 2 * lo * n * 2
            assert a["card"] == program.chunk.data_ptr()
            np.testing.assert_array_equal(
                _view(a["card"], (size,), np.uint8), chunk[lo:hi].reshape(-1).view(np.uint8))
    got.append(farm.flush())
    _same(got, want, f"dp {dp}")
    assert rs.ROUTES[("farm_input", "direct")] == len(chunks)


def test_torch_farm_host_path_leaves_the_callers_chunk(card):
    """The caller's chunk is never written, and may be overwritten as soon
    as ``process`` returns (here with another chunk's samples, also after a
    call that emits nothing): the farm goes on as the JAX farm fed the
    chunks as they were."""
    chunks = _base(64, 3, 2, (10, 96, 96, 7))
    want = _jax_run(JFarm(3, 2, 44100, 8000, chunk_frames=CHUNK, interpret=True),
                    [c.copy() for c in chunks])
    farm = _card_farm(3, 2, rates=(44100, 8000))
    got = []
    for k, chunk in enumerate(chunks):
        kept = chunk.copy()
        got.append(farm.process(chunk))
        assert np.array_equal(chunk, kept), k
        chunk[...] = chunks[(k + 1) % len(chunks)][:, : chunk.shape[1]] if (
            chunks[(k + 1) % len(chunks)].shape[1] >= chunk.shape[1]) else -1
    assert got[0].shape[1] == 0          # the first call emitted nothing
    got.append(farm.flush())
    _same(got, want, "overwritten after process")


def test_torch_farm_host_path_two_farms_from_two_threads(card):
    """Two farms fed at once from two host threads (one thread a card, say)
    share no state on their way to the card: each one's outputs equal the
    JAX farm's on its own chunks, every output kept."""
    jobs = [(_base(66, 3, 2, (96,) * 6), RATES), (_base(67, 4, 1, (96,) * 6), (44100, 8000))]
    want = [_jax_run(JFarm(c[0].shape[0], c[0].shape[2], *rates, chunk_frames=CHUNK,
                           interpret=True), c) for c, rates in jobs]
    farms = [_card_farm(c[0].shape[0], c[0].shape[2], rates=rates) for c, rates in jobs]
    got, errors, start = [None, None], [], threading.Barrier(2)

    def feed(k):
        try:
            start.wait()
            got[k] = [farms[k].process(c) for c in jobs[k][0]] + [farms[k].flush()]
        except Exception as e:  # re-raised below, in the test's thread
            errors.append(e)

    threads = [threading.Thread(target=feed, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for k in range(2):
        _same(got[k], want[k], f"farm {k}")


# crt_farm_host_stage's host code, compiled with g++ against a stand-in of
# the few CUDA runtime names it uses (the upload a memcpy), and driven by four
# threads at once, each checking every byte that landed in its pinned buffer
# and on its "card" after each of 100 calls.
_HOST_STAGE_STAND_IN = """
#include <cstddef>
#include <cstring>
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorMemoryAllocation = 2,
       cudaErrorOperatingSystem = 304 };
enum { cudaMemcpyHostToDevice = 1 };
static cudaError_t cudaMemcpyAsync(void* d, const void* s, size_t n, int, cudaStream_t) {
    std::memcpy(d, s, n);
    return cudaSuccess;
}
struct DeviceGuard { int err = 0; explicit DeviceGuard(int) {} };
"""
_HOST_STAGE_DRIVER = """
#include <cstdio>
int main() {
    const int rows = 37;
    const long long rb = 4096 + 18;
    std::vector<int> bad(4, 0);
    std::vector<std::thread> ts;
    for (int t = 0; t < 4; ++t) ts.emplace_back([&, t] {
        std::vector<std::vector<char>> src(rows, std::vector<char>(rb));
        std::vector<const char*> ptr(rows);
        for (int r = 0; r < rows; ++r) {
            for (long long i = 0; i < rb; ++i) src[r][i] = char(t * 31 + r * 7 + i);
            ptr[r] = r % 5 == 3 ? nullptr : src[r].data();
        }
        std::vector<char> pinned(rows * rb), card(rows * rb);
        for (int it = 0; it < 100; ++it) {
            std::memset(card.data(), 1, card.size());
            if (crt_farm_host_stage(pinned.data(), ptr.data(), rows, rb, card.data(), 0,
                                    nullptr) != 0) bad[t] += 1000;
            for (int r = 0; r < rows; ++r) for (long long i = 0; i < rb; ++i) {
                const char want = ptr[r] ? src[r][i] : 0;
                if (pinned[r * rb + i] != want || card[r * rb + i] != want) { ++bad[t]; break; }
            }
        }
    });
    for (auto& t : ts) t.join();
    for (int t = 0; t < 4; ++t) std::printf("%d ", bad[t]);
    return 0;
}
"""


def _run_host_stage(tmp_path, main: str) -> str:
    """crt_farm_host_stage's and crt_farm_host_stats' host code
    (farm_kernels.cu) and ``main`` (the program's main), compiled with g++ and run: its
    standard output."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the host stage's C++")
    with open(os.path.join(_build.CSRC, "farm_kernels.cu")) as f:
        source = f.read()
    host = source.index("// ---- The host side")
    parts = [_HOST_STAGE_STAND_IN,
             source[source.index("#include <sched.h>"):source.index('#include "mac_common.cuh"')],
             "namespace {", source[host:source.index("}  // namespace", host)], "}",
             'extern "C" {', source[source.index("int crt_farm_host_stage("):
                                    source.index("// Block the host until the stream")], "}",
             main]
    cpp, exe = tmp_path / "host_stage.cpp", tmp_path / "host_stage"
    cpp.write_text("\n".join(parts))
    subprocess.run([gxx, "-std=c++17", "-O1", "-pthread", str(cpp), "-o", str(exe)], check=True,
                   capture_output=True, timeout=120)
    return subprocess.run([str(exe)], check=True, capture_output=True, text=True,
                          timeout=120).stdout


def test_torch_farm_host_stage_takes_one_call_at_a_time(tmp_path):
    """Four host threads calling crt_farm_host_stage at once (farms fed from
    several threads) each get exactly their own rows, zeros for null rows, in
    their pinned buffer and on their card address: the entry's host code
    (farm_kernels.cu, compiled with g++) runs one job at a time on its pool."""
    out = _run_host_stage(tmp_path, _HOST_STAGE_DRIVER)
    assert out.split() == ["0"] * 4, out


# Two threads, each 30 jobs of its own size: after each job its counters
# (crt_farm_host_stats) must be non-negative and within the job's wall time,
# and must read the same again once the other thread has run a job.
_HOST_STATS_DRIVER = """
#include <cstdio>
int main() {
    std::atomic<int> jobs{0};
    std::vector<int> bad(2, 0);
    std::vector<long long> late_max(2, 0);
    std::vector<std::thread> ts;
    for (int t = 0; t < 2; ++t) ts.emplace_back([&, t] {
        const int rows = 64 + 32 * t;
        const long long rb = 16384 + 64;
        std::vector<char> src(rows * rb, char(t + 1)), pinned(rows * rb), card(rows * rb);
        std::vector<const char*> ptr(rows);
        for (int r = 0; r < rows; ++r) ptr[r] = src.data() + r * rb;
        for (int it = 0; it < 30; ++it) {
            const long long t0 = now_ns();
            if (crt_farm_host_stage(pinned.data(), ptr.data(), rows, rb, card.data(), 0,
                                    nullptr) != 0) bad[t] += 1000;
            const long long wall = now_ns() - t0;
            long long mine[2], again[2];
            if (crt_farm_host_stats(mine) != 0) bad[t] += 1000;
            for (long long v : mine) if (v < 0 || v > wall) ++bad[t];
            late_max[t] = std::max(late_max[t], mine[1]);
            jobs.fetch_add(1);
            while (jobs.load() < 2 * (it + 1)) std::this_thread::yield();
            crt_farm_host_stats(again);
            if (again[0] != mine[0] || again[1] != mine[1]) ++bad[t];
        }
    });
    for (auto& t : ts) t.join();
    std::printf("%d %d %lld %lld", bad[0], bad[1], late_max[0], late_max[1]);
    return 0;
}
"""


def test_torch_farm_host_stats_are_each_threads_own(tmp_path):
    """crt_farm_host_stats gives the calling thread's last job's counters:
    pool_wait_ns and pool_late_ns non-negative and no longer than the job,
    unchanged by another thread's job in between (farm_kernels.cu's host
    code, compiled with g++, two threads taking turns)."""
    bad0, bad1, *late = _run_host_stage(tmp_path, _HOST_STATS_DRIVER).split()
    assert (bad0, bad1) == ("0", "0"), (bad0, bad1)
    assert all(int(v) >= 0 for v in late)


def test_torch_farm_host_path_delivers_past_the_pool_by_the_host_threads(card):
    """A caller that keeps every output: past the pool's buffers each result
    is a fresh array that the farm library's host threads fill from the
    pool's scratch (the host stage with no card address), never written
    again; every output equals the JAX farm's."""
    chunks = _base(65, 3, 2, (96,) * (farm_mod.RESULT_POOL_BUFFERS + 3))
    want = _jax_run(JFarm(3, 2, *RATES, chunk_frames=CHUNK, interpret=True), chunks)
    farm = _card_farm(3, 2)
    kept = []
    for k, chunk in enumerate(chunks):
        del card[:]
        kept.append(farm.process(chunk))
        copies = [(a["pinned"], list(a["sources"])) for name, a in card
                  if name == "crt_farm_host_stage" and a["card"] is None]
        if k < farm_mod.RESULT_POOL_BUFFERS:
            assert not copies
        else:
            assert copies == [(kept[-1].ctypes.data, [farm._results._scratch.data_ptr()])]
    kept.append(farm.flush())
    _same(kept, want, "kept")


def test_torch_farm_host_path_pieces_cover_the_chunk():
    """crt_farm_host_stage's pieces (the C entry's rule, mirrored by
    _build.farm_host_pieces) cover every byte once, in whole 64-byte units
    but the last, at most FARM_HOST_PIECES of them, the CUDA source's
    HOST_PIECES; its arguments refuse what the entry cannot take."""
    for nbytes in (1, 63, 64, 513, 8 * 64, 36_519_936, 2 * 5 * 33 * 2):
        pieces = _build.farm_host_pieces(nbytes)
        assert pieces[0][0] == 0 and pieces[-1][1] == nbytes
        assert all(a < b for a, b in pieces) and len(pieces) <= _build.FARM_HOST_PIECES
        assert all(b == c for (_, b), (c, _) in zip(pieces, pieces[1:]))
        assert all(b % 64 == 0 for _, b in pieces[:-1])
    assert _build.farm_host_pieces(0) == []
    with open(os.path.join(_build.CSRC, "farm_kernels.cu")) as f:
        source = f.read()
    assert re.search(r"constexpr int HOST_PIECES = (\d+);", source).group(1) == str(
        _build.FARM_HOST_PIECES)
    sources = np.array([4096, 0], np.uint64)
    args = _build.farm_host_stage_args(64, sources, 10, 128, 0, 7)
    assert (args["rows"], args["row_bytes"], args["srcs"]) == (2, 10, sources.ctypes.data)
    assert set(args) == set(_build.ENTRY_ARGS["crt_farm_host_stage"])
    with pytest.raises(ValueError, match="bad farm host stage"):
        _build.farm_host_stage_args(64, sources, 0, 128, 0, 7)
    with pytest.raises(ValueError, match="bad farm host stage"):
        _build.farm_host_stage_args(64, sources.astype(np.int64), 10, 128, 0, 7)


# ---------------------------------------------------------------------------
# The mixed farm: each group's streams stacked straight into its pinned input
# ---------------------------------------------------------------------------

def _mixed_data(seed, streams, frames):
    rng = np.random.default_rng(seed)
    return [rng.integers(-32768, 32768, size=(frames, 2)).astype(np.int16)
            for _ in range(streams)]


def _run_mixed(farm, data, sizes, move=None, snap_after=None):
    """Every stream's whole output; ``move`` (call, stream, rates) re-rates a
    stream before that call; ``snap_after`` saves a snapshot after that call
    (returned as well)."""
    outs, cursor, snap = [], 0, None
    for k, size in enumerate(sizes):
        if move and move[0] == k:
            assert farm.adjust_stream(move[1], *move[2])
        outs.append(farm.process([d[cursor : cursor + size] for d in data]))
        cursor += size
        if snap_after == k:
            snap = ckpt.save_mixed_farm(farm) if isinstance(farm, MixedStreamFarm) else None
    outs.append(farm.flush())
    return [np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(len(data))], snap


@pytest.mark.parametrize("sharded", [0, 2, 3], ids=["unsharded", "dp2", "dp3"])
def test_torch_mixed_farm_host_path_matches_jax_mixed_farm(card, sharded):
    """Config 5's groups on the card's path: each group's streams go
    straight into its pinned input, one host stage a program with one row a
    stream at that stream's chunk, the slot that ``adjust_stream`` vacated
    fed zeros (a 0 address); every stream equals the JAX mixed farm's."""
    specs = [rates for rates in MIXED_GROUPS for _ in range(3)]
    data = _mixed_data(70 + sharded, len(specs), 96 * 3 + 40)
    sizes, move = (96, 96, 40, 96), (2, 4, (44100, 8000))
    want, _ = _run_mixed(JMixed(specs, 2, chunk_frames=CHUNK, interpret=True, max_radius=17),
                         data, sizes, move)
    rs.ROUTES.clear()
    if sharded:
        farm = ShardedMixedStreamFarm(make_mesh(dp=sharded, devices=["cpu"] * sharded), specs, 2,
                                      chunk_frames=CHUNK, max_radius=17)
    else:
        farm = _CardMixedFarm(specs, 2, chunk_frames=CHUNK, max_radius=17, device="cpu")
    got, _ = _run_mixed(farm, data, sizes, move)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")
    stages = [a for name, a in card if name == "crt_farm_host_stage" and a["card"]]
    calls_after_move = len(sizes) - move[0]
    vacated = [a for a in stages if 0 in list(a["sources"])]
    assert len(vacated) == calls_after_move      # one program holds the vacated slot
    for a in vacated:
        j = list(a["sources"]).index(0)
        assert not a["landed"][j].any()
    assert all(a["row_bytes"] in (96 * 4, 40 * 4) for a in stages)
    groups = len(MIXED_GROUPS)
    assert rs.ROUTES[("farm_input", "stacked")] == groups * move[0] + (groups + 1) * (
        len(sizes) - move[0])
    assert not {k for k in rs.ROUTES if k[0] == "farm_input"} - {("farm_input", "stacked")}


def test_torch_mixed_farm_host_path_converts_each_chunk_and_snapshots(card):
    """Per-stream chunks of other types and layouts (int32, float64, a
    strided view, a list) reach the pinned input as ``np.asarray(chunk,
    np.int16)`` makes them; a snapshot right after ``process`` restores in
    both packages and each goes on with the JAX mixed farm."""
    specs = [rates for rates in MIXED_GROUPS for _ in range(2)]
    data = _mixed_data(75, len(specs), 96 * 4)
    forms = [lambda x: x, lambda x: x.astype(np.int32), lambda x: x.astype(np.float64) - 0.5,
             lambda x: np.repeat(x, 2, axis=0)[::2], lambda x: x.tolist(), lambda x: x]

    def feed(farm, k):
        return farm.process([forms[i % len(forms)](d[96 * k : 96 * (k + 1)])
                             for i, d in enumerate(data)])

    jfarm = JMixed(specs, 2, chunk_frames=CHUNK, interpret=True, max_radius=17)
    farm = _CardMixedFarm(specs, 2, chunk_frames=CHUNK, max_radius=17, device="cpu")
    for k in range(2):
        got, want = feed(farm, k), feed(jfarm, k)
        for i in range(len(specs)):
            np.testing.assert_array_equal(got[i], np.asarray(want[i]), err_msg=f"{k} {i}")
    snap = ckpt.save_mixed_farm(farm)
    in_jax = jckpt.load_mixed_farm(dict(snap, interpret=True, groups=[
        dict(g, farm=dict(g["farm"], interpret=True)) for g in snap["groups"]]))
    restored = ckpt.load_mixed_farm(snap, device="cpu")

    def finish(f):
        outs = [feed(f, 2), feed(f, 3), f.flush()]
        return [np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(len(specs))]

    want = finish(jfarm)
    for name, f in (("farm", farm), ("restored", restored), ("restored in jax", in_jax)):
        for i, (g, w) in enumerate(zip(finish(f), want)):
            np.testing.assert_array_equal(g, w, err_msg=f"{name} stream {i}")


def test_torch_mixed_farm_host_path_refuses_chunks_of_other_shapes(card):
    """A stream's chunk of another length or channel count is refused
    before any group is staged, as the JAX mixed farm refuses it; the farm
    then goes on as the JAX farm that never saw the bad call."""
    specs = [(48000, 44100)] * 2 + [(96000, 48000)] * 2
    good = _mixed_data(76, 4, 50)
    farm = _CardMixedFarm(specs, 2, chunk_frames=CHUNK, device="cpu")
    jfarm = JMixed(specs, 2, chunk_frames=CHUNK, interpret=True)
    for bad in (np.zeros((49, 2), np.int16), np.zeros((50, 1), np.int16)):
        with pytest.raises(ValueError):
            farm.process(good[:3] + [bad])
        with pytest.raises((ValueError, AssertionError)):
            jfarm.process(good[:3] + [bad])
    assert not [name for name, _ in card if name == "crt_farm_host_stage"]
    for g, w in zip(farm.process(good), jfarm.process(good)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_torch_farm_host_path_keeps_the_plain_versions_on_the_cpu():
    """On the CPU the farms take no route into pinned memory: no pinned
    buffer, no host entry, no ``farm_input`` count, outputs as the JAX
    farms'."""
    chunks = _base(77, 3, 2)
    rs.ROUTES.clear()
    for staging in (False, True):
        farm = UniformStreamFarm(3, 2, *RATES, chunk_frames=CHUNK, device="cpu",
                                 device_staging=staging)
        assert not farm._on_card and not hasattr(farm, "_input")
        got = [farm.process(c) for c in chunks] + [farm.flush()]
        _same(got, _jax_run(JFarm(3, 2, *RATES, chunk_frames=CHUNK, interpret=True), chunks),
              f"device_staging={staging}")
    specs = [(48000, 44100), (96000, 48000)]
    data = _mixed_data(78, 2, 96)
    mixed = MixedStreamFarm(specs, 2, chunk_frames=CHUNK, device="cpu")
    got, _ = _run_mixed(mixed, data, (96,))
    want, _ = _run_mixed(JMixed(specs, 2, chunk_frames=CHUNK, interpret=True), data, (96,))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert not {k for k in rs.ROUTES if k[0] == "farm_input"}
    assert farm_mod._on_card(torch.device("cpu")) is False
