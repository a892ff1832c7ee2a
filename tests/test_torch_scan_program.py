"""The port's whole-stream scan as one device program vs the JAX package.

On a card ``resample_scan_fused`` is a ``ScanProgram``: per step the
engine's scan-mode launch -- tiled_mac_kernel for the tiled and general
engines, strided_mac_kernel, wide_mac_kernel and its fold once per launch
offset --, which reads its window from the chunks in place, works out the
step's bookkeeping and masks the frames past ``produced`` in its stores (the
scan modes' own tests are in tests/test_torch_scan_inplace.py and
tests/test_torch_scan_inplace_strided_wide.py). On the CPU, with inputs made
from a numpy seed, this file holds against the JAX package's
``resample_scan_fused`` (Pallas in interpret mode, as tests/test_scan.py runs
it), with exact equality of outputs, produced, state and backlog:

* ``resample_scan_fused_reference`` (the plain version, a loop of torch ops);
* a step-by-step composition of a staged [halo | chunk] buffer, the
  bookkeeping in exact integers and the engines' plain versions with
  ``n_valid`` -- what the kernels compute, piece by piece;
* ``ScanProgram`` itself with its C entries stood in by functions that read
  and write the same pointers, so the argument lists it builds (every
  per-step pointer) are exercised without a card.

The ``cuda`` tests run the kernels against the plain versions on a card.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.lowlevel import make_device_state as jmake_state
from clownresampler_tpu.lowlevel import resample_scan as jresample_scan
from clownresampler_tpu.lowlevel import resample_scan_fused as jresample_scan_fused
from clownresampler_tpu.models import lanczos_kernel_table as jtable
from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch import lowlevel
from clownresampler_tpu_torch.configure import configure
from clownresampler_tpu_torch.lowlevel import (
    DeviceState,
    ScanProgram,
    make_device_state,
    resample_scan_fused,
    resample_scan_fused_reference,
    resample_scan_tiled,
)
from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.ops.convolve import ConfigScalars

ENGINES = {"tiled": (48000, 44100), "strided": (96000, 48000), "general": (44100, 8000),
           "wide": (44100, 1000)}


def _case(rates, *, lanes=128, n_in=256, k=2, seed=81, dtype=np.int16, f0=0, flush=True,
          n_out=None, device="cpu", taps=None):
    """K random chunks (and a zero chunk, the flush), the geometry, and both
    packages' initial states; ``taps`` a reserve other than the radius's."""
    cfg = configure(*rates, max(rates))
    inc = fx.calculate_ratio(*rates)
    r = cfg.integer_stretched_kernel_radius
    data = np.random.default_rng(seed).integers(-32768, 32768, size=(k, n_in, lanes))
    if flush:
        data = np.concatenate([data, np.zeros((1, n_in, lanes), data.dtype)])
    taps = taps or fx.round_up(2 * r, 8)
    dev = torch.device(device)
    return dict(
        rates=rates, chunks=data.astype(dtype), inc=inc, r=r, taps=taps, cfg=cfg,
        n_out=n_out or fx.round_up(((n_in + 2 * r) << 16) // inc + 16, 128),
        state=make_device_state(0, f0, cfg, inc, dev),
        jstate=jmake_state(0, f0, jconfigure(*rates, max(rates)), inc),
        table=table_tensor(DEFAULT_MODEL.table(), dev),
        tstr=table_tensor(DEFAULT_MODEL.strided_table(cfg.kernel_step_size, taps), dev),
        device=dev)


def _plain(result):
    out, prod, st, back = result
    return (out.cpu().numpy(), prod.cpu().numpy(), int(st.position_integer),
            int(st.position_fractional), bool(back))


def _scan_args(c):
    return dict(max_taps=c["taps"], n_out=c["n_out"], radius=c["r"], increment=c["inc"],
                table_strided=c["tstr"])


def _reference(c):
    return _plain(resample_scan_fused_reference(
        c["table"], torch.from_numpy(c["chunks"]).to(c["device"]), c["state"], **_scan_args(c)))


def _jax(c, fused=True):
    """The JAX package's fused scan on the CPU (Pallas in interpret mode), or
    its oracle scan."""
    args = (jnp.asarray(jtable()), jnp.asarray(c["chunks"]), c["jstate"])
    kw = dict(max_taps=c["taps"], n_out=c["n_out"], radius=c["r"])
    if fused:
        out, prod, st, back = jresample_scan_fused(*args, increment=c["inc"], interpret=True, **kw)
    else:
        out, prod, st, back = jresample_scan(*args, **kw)
    return (np.asarray(out), np.asarray(prod), int(st.position_integer),
            int(st.position_fractional), bool(back))


ENGINE_REFERENCES = {
    "tiled": lambda table, x, st, d, cand, tstr, **kw: rs.resample_uniform_lanes_tiled_reference(
        table, x, st, d=d, cand=cand, table_strided=tstr, **kw),
    "general": lambda table, x, st, d, cand, tstr, **kw:
        rs.resample_uniform_lanes_general_reference(table, x, st, table_strided=tstr, **kw),
    "strided": lambda table, x, st, d, cand, tstr, **kw: rs.resample_strided_reference(
        table, x, st, d=d, **kw),
    "wide": lambda table, x, st, d, cand, tstr, **kw: rs.resample_wide_taps_reference(
        table, x, st, d=d, table_strided=tstr, **kw),
}


def _composed(c):
    """The scan as the device program's kernels compute it, piece by piece,
    in plain versions: per step [halo | chunk widened] staged into one of two
    buffers whose tail rows stay zero (the halo from the other buffer, as the
    JAX scan slices it), the bookkeeping and each launch's state in exact
    integers (_bookkeeping_int64), then the engine's plain version per launch
    offset with ``n_valid``."""
    kind, d, cand, step = lowlevel._scan_engine(c["inc"], c["taps"], c["n_out"])
    chunks = torch.from_numpy(c["chunks"]).to(c["device"])
    k, n_in, lanes = chunks.shape
    r, n_out, cfg = c["r"], c["n_out"], c["state"].cfg
    buffers = torch.zeros((2, 2 * r + n_in + c["taps"] + 8, lanes), dtype=torch.int32,
                          device=c["device"])
    p, f = int(c["state"].position_integer) + r, int(c["state"].position_fractional)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=c["device"])
    outs, produced, over = [], [], []
    for s in range(k):
        cur, prev = buffers[s % 2], buffers[(s + 1) % 2]
        cur[: 2 * r + n_in] = torch.cat([prev[n_in : n_in + 2 * r], chunks[s].to(torch.int32)])
        assert not cur[2 * r + n_in :].any()
        prod, ov, launch_states, (p, f) = _bookkeeping_int64(p, f, c["inc"], n_in, n_out, step)
        outs.append(torch.cat([
            ENGINE_REFERENCES[kind](
                c["table"], cur, DeviceState(i32(p0), i32(f0), cfg), d, cand, c["tstr"],
                max_taps=c["taps"], n_out=min(step, n_out - o), n_valid=i32(prod),
                frame_offset=o)[0]
            for (p0, f0), o in zip(launch_states, range(0, n_out, step))]))
        produced.append(i32(prod))
        over.append(bool(ov))
    return _plain((torch.stack(outs), torch.stack(produced),
                   DeviceState(i32(p - r), i32(f), cfg), any(over)))


def _assert_same(got, want, what):
    np.testing.assert_array_equal(got[0], want[0], err_msg=f"{what}: outputs")
    np.testing.assert_array_equal(got[1], want[1], err_msg=f"{what}: produced")
    assert got[1].dtype == want[1].dtype and got[0].dtype == want[0].dtype, what
    assert got[2:] == want[2:], what


# ---------------------------------------------------------------------------
# Against the JAX package's fused scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.int32], ids=["int16", "int32"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_torch_scan_program_plain_versions_match_jax_fused(engine, dtype):
    """Every engine, int16 and int32 chunks, two chunks and the zero flush."""
    c = _case(ENGINES[engine], dtype=dtype, f0=0x1234)
    assert lowlevel._scan_engine(c["inc"], c["taps"], c["n_out"])[0] == engine
    want = _jax(c)
    assert not want[4]
    _assert_same(_reference(c), want, f"{engine} reference")
    _assert_same(_composed(c), want, f"{engine} composed")


@pytest.mark.parametrize("engine", ["tiled", "general"])
def test_torch_scan_program_single_chunk_matches_jax_fused(engine):
    """K = 1: the first step's zero halo and nothing else."""
    c = _case(ENGINES[engine], k=1, flush=False, seed=82)
    want = _jax(c)
    _assert_same(_reference(c), want, "reference")
    _assert_same(_composed(c), want, "composed")


@pytest.mark.parametrize("engine", ["tiled", "strided", "general"])
def test_torch_scan_program_six_lanes_match_jax(engine):
    """Lanes that are no multiple of 4 (the stage kernel's element-wise
    path): 6 lanes against the JAX package's oracle scan, which its fused
    scan is held to (its Pallas engines take lanes in multiples of 128)."""
    c = _case(ENGINES[engine], lanes=6, n_in=128, seed=83)
    want = _jax(c, fused=False)
    _assert_same(_reference(c), want, "reference")
    _assert_same(_composed(c), want, "composed")


def test_torch_scan_program_backlog_matches_jax_fused():
    """8k -> 44.1k makes ~5.5 frames per input frame: at half the proper
    n_out every scan reports the backlog, and produced stops at n_out."""
    full = _case((8000, 44100), n_in=128, seed=84)
    c = _case((8000, 44100), n_in=128, seed=84, n_out=fx.round_up(full["n_out"] // 2, 128))
    want = _jax(c)
    assert want[4] and want[1].max() == c["n_out"]
    _assert_same(_reference(c), want, "reference")
    _assert_same(_composed(c), want, "composed")


@pytest.mark.parametrize("engine,n_in", [("general", 16), ("wide", 128), ("strided", 8)])
def test_torch_scan_program_chunks_shorter_than_the_halo_match_jax_fused(engine, n_in):
    """n_in < 2*radius: the halo spans more than the previous chunk, so it
    reaches into the previous halo (rows [n_in, n_in + 2r) of the previous
    buffer), exactly as in the JAX scan."""
    c = _case(ENGINES[engine], n_in=n_in, k=4, seed=85, f0=0x8421)
    assert n_in < 2 * c["r"]
    want = _jax(c)
    _assert_same(_reference(c), want, "reference")
    _assert_same(_composed(c), want, "composed")


# ---------------------------------------------------------------------------
# The bookkeeping alone: int64, as the kernel computes it
# ---------------------------------------------------------------------------

def _bookkeeping_int64(p, f, inc, n_in, n_out, step):
    """A scan step's bookkeeping in exact integers, as the scan-mode kernels
    compute it (mac_common.cuh scan_books, scan_launch) for launches at
    frame offsets 0, step, ...: (produced, over, the launches' states, next
    state)."""
    num = ((n_in - p) << 16) - f
    natural = (num + inc - 1) // max(inc, 1) if num > 0 else 0
    produced = min(natural, n_out)
    launch_states = []
    for o in range(0, n_out, step):
        t = f + o * inc
        launch_states.append([p + (t >> 16), t & 0xFFFF])
    t = f + produced * inc
    p_after = p + (t >> 16)
    return (produced, int(natural > n_out), launch_states,
            [p_after - min(p_after, n_in), t & 0xFFFF])


RATIOS = [(48000, 44100), (44100, 48000), (8000, 44100), (96000, 48000), (44100, 8000),
          (44100, 1000), (192000, 44100), (44100, 262)]


def _kernel_step_int64(p, f, inc, n_in, n_out):
    """mac_common.cuh scan_books in exact integers, C truncating division:
    (produced, over, next state)."""
    num = (n_in - p) * 65536 - f
    natural = (num + inc - 1) // max(inc, 1) if num > 0 else 0   # num, inc > 0: floor = trunc
    produced = min(natural, n_out)
    t = f + produced * inc
    p_after = p + (t >> 16)
    return produced, int(natural > n_out), [p_after - min(p_after, n_in), t & 0xFFFF]


def _kernel_walk(p, f, inc, n_in, n_out, steps, tiles, grid):
    """tiled_mac_kernel's scan-mode walk (resample_kernels.cu), mirrored:
    ``grid`` persistent blocks over ``steps`` steps of ``tiles`` tiles each,
    block b from tile b of the launch on, then every grid-th; each block
    reads step 0's state (p, f) once and carries it to its tiles' steps by
    scan_enter, step by step. Returns ({(step, tile): (the block's state,
    produced)}, {step: [(produced, over, next state) as written]})."""
    seen, books = {}, {}

    def enter(state, at, k, first_tile):
        produced, over, nxt = _kernel_step_int64(*state, inc, n_in, n_out)
        for _ in range(at, k):
            state = nxt
            produced, over, nxt = _kernel_step_int64(*state, inc, n_in, n_out)
        if first_tile:
            books.setdefault(k, []).append((produced, over, nxt))
        return state, produced

    for block in range(grid):
        step, tile = divmod(block, tiles)
        if step >= steps:
            continue
        state, valid = enter((p, f), 0, step, tile == 0)
        while True:
            assert (step, tile) not in seen
            seen[(step, tile)] = (state, valid)
            nxt = tile + grid
            ahead = nxt // tiles
            nxt -= ahead * tiles
            if step + ahead >= steps:
                break
            if ahead:
                state, valid = enter(state, step, step + ahead, nxt == 0)
                step += ahead
            tile = nxt
    return seen, books


@pytest.mark.parametrize("rates", [(48000, 44100), (44100, 8000), (8000, 44100), (44100, 262)])
@pytest.mark.parametrize("steps,tiles,grid", [(1, 16, 528), (1, 1888, 528), (64, 1888, 528),
                                              (40, 2, 528), (9, 5, 7), (6, 3, 1)])
def test_torch_tiled_scan_walk_carries_each_steps_state(rates, steps, tiles, grid):
    """Every tile of every step is walked once, by a block whose carried
    state and produced count are the step's as _bookkeeping_int64 chains
    them over the steps, and each step's bookkeeping is written once, by the
    block of its first tile: K = 1, a launch of the scan cell's shape (1888
    tiles a step, 528 blocks), grids larger than a step's tiles (blocks that
    skip steps) and smaller; a backlog (8k -> 44.1k at half its n_out) and a
    ratio with a radius past the chunk."""
    inc = fx.calculate_ratio(*rates)
    n_in = 96
    n_out = max(fx.round_up(((n_in + 64) << 16) // inc, 8), 8)
    if rates == (8000, 44100):
        n_out //= 2
    p, f = 2 * configure(*rates, max(rates)).integer_stretched_kernel_radius, 0x2468
    seen, books = _kernel_walk(p, f, inc, n_in, n_out, steps, tiles, grid)
    assert set(seen) == {(s, t) for s in range(steps) for t in range(tiles)}
    state, want = [p, f], {}
    for s in range(steps):
        produced, over, _, nxt = _bookkeeping_int64(*state, inc, n_in, n_out, n_out)
        want[s] = (tuple(state), produced, over, nxt)
        state = nxt
    for (s, _), (st, valid) in seen.items():
        assert (tuple(st), valid) == want[s][:2], s
    assert books == {s: [w[1:]] for s, w in want.items()}
    if rates == (8000, 44100):
        assert all(w[2] for w in want.values())


@pytest.mark.parametrize("engine", list(ENGINES))
def test_torch_n_valid_masks_the_plain_versions(engine):
    """``n_valid`` zeroes exactly the frames n with n + frame_offset >=
    n_valid, in int32 and clamped int16, through the entry on the CPU."""
    c = _case(ENGINES[engine], lanes=8, n_in=2048 if engine == "wide" else 256, k=1,
              flush=False)
    kind, d, cand, _ = lowlevel._scan_engine(c["inc"], c["taps"], 64)
    x = torch.cat([torch.zeros((2 * c["r"], 8), dtype=torch.int32),
                   torch.from_numpy(c["chunks"][0].astype(np.int32)),
                   torch.zeros((c["taps"] + 8, 8), dtype=torch.int32)])
    st = DeviceState(c["r"], 5, c["state"].cfg)
    entry = {"tiled": lambda **kw: rs.resample_uniform_lanes_tiled(
                 c["table"], x, st, d=d, cand=cand, **kw),
             "general": lambda **kw: rs.resample_uniform_lanes_general(c["table"], x, st, **kw),
             "strided": lambda **kw: rs.resample_strided_phases(c["table"], x, st, d=d, **kw),
             "wide": lambda **kw: rs.resample_wide_taps(c["table"], x, st, d=d, **kw)}[kind]
    for clamp in (False, True):
        full, rows = entry(max_taps=c["taps"], n_out=32, clamp_s16=clamp)
        assert full[20:].any()
        for n_valid, offset, keep in ((20, 0, 20), (20, 8, 12), (100, 0, 32), (3, 8, 0)):
            got, got_rows = entry(max_taps=c["taps"], n_out=32, clamp_s16=clamp,
                                  n_valid=torch.tensor(n_valid, dtype=torch.int32),
                                  frame_offset=offset)
            assert got.dtype == full.dtype and torch.equal(got_rows, rows)
            assert torch.equal(got[:keep], full[:keep]) and not got[keep:].any()


# ---------------------------------------------------------------------------
# ScanProgram with its C entries stood in
# ---------------------------------------------------------------------------

def _view(ptr, shape, dtype=np.int32):
    """The memory at ``ptr`` as a writable numpy array."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).reshape(shape)


def _tensor(ptr, shape, dtype=np.int32):
    return torch.from_numpy(_view(ptr, shape, dtype))


def _cfg_at(a):
    """The ConfigScalars a C entry's arguments ``a`` point at."""
    scalar = lambda key: _tensor(a[key], ())
    return ConfigScalars(
        stretched_kernel_radius=scalar("radius"),
        integer_stretched_kernel_radius=scalar("int_radius"),
        stretched_kernel_radius_delta=scalar("delta"), kernel_step_size=scalar("step"),
        increment=torch.zeros((), dtype=torch.int32), increment_hi=scalar("inc_hi"),
        increment_lo=scalar("inc_lo"))


SCAN_ENTRIES = ("crt_tiled_scan", "crt_strided_scan", "crt_wide_scan")


def _scan_stand_in(name, calls):
    """A scan-mode C entry over the same pointers, for each of its ``steps``
    steps (crt_tiled_scan's; one for the others) j: the window from stream
    rows [max(src_first + j*n_in, 0), src_end + j*n_in) only -- nothing
    before the stream or past the step's chunk is read --, zeros elsewhere
    in its S rows; the bookkeeping in exact integers from the first step's
    state, chained over the steps as the kernel carries it, written at index
    j by the step's offset-0 launch only; the launch's state at its frame
    offset; the engine's plain version with n_valid, written to the output
    pointer's step j."""
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS[name], args))
        calls.append((name, a))
        lanes, n_in = a["L"], a["n_in"]
        elem = np.int16 if a["src_s16"] else np.int32
        assert a["S"] == a["src_end"] - a["src_first"] + a["T"] + 8 and a["src_end"] % n_in == 0
        p, f = (int(v) for v in _view(a["state_in"], (2,)))
        inc = (int(_view(a["inc_hi"], ())) << 16) + int(_view(a["inc_lo"], ()))
        offset = a.get("frame_offset", 0)
        n_out = a.get("n_out", a["N"])
        table = _tensor(a["table"], (a["table_size"],))
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)
        for j in range(a.get("steps", 1)):
            first, end = a["src_first"] + j * n_in, a["src_end"] + j * n_in
            x = np.zeros((a["S"], lanes), np.int32)
            lo = max(first, 0)
            x[lo - first : end - first] = _view(a["src"], (end, lanes), elem)[lo:end]
            produced, over, _, nxt = _bookkeeping_int64(p, f, inc, n_in, n_out, n_out)
            if offset == 0:
                _view(a["produced"] + 4 * j, ())[...] = produced
                _view(a["over"] + 4 * j, ())[...] = over
                _view(a["state_out"] + 8 * j, (2,))[...] = nxt
            t = f + offset * inc
            st = DeviceState(i32(p + (t >> 16)), i32(t & 0xFFFF), _cfg_at(a))
            kw = dict(max_taps=a["T"], n_out=a["N"], n_valid=i32(produced), frame_offset=offset)
            if a.get("tstr"):
                kw["table_strided"] = _tensor(a["tstr"], (a["tstr_rows"], a["T"]))
            if name == "crt_tiled_scan":
                assert _build.tiled_shared_bytes(a["frames_per_stage"], a["win_rows"], a["T"],
                                                 np.dtype(elem).itemsize) \
                    <= _build.MAX_SHARED_BYTES
                out, _ = rs.resample_uniform_lanes_general_reference(
                    table, torch.from_numpy(x), st, **kw)
            elif name == "crt_strided_scan":
                assert _build.strided_shared_bytes(a["T"], a["win_rows"],
                                                   np.dtype(elem).itemsize) \
                    <= _build.MAX_SHARED_BYTES
                out, _ = rs.resample_strided_reference(table, torch.from_numpy(x), st, d=a["d"],
                                                       **kw)
            else:
                assert a["partial"] and a["tap_sums"] == a["partial"] + 4 * a["N"] * a["K"] * lanes
                out, _ = rs.resample_wide_taps_reference(table, torch.from_numpy(x), st, d=0,
                                                         **kw)
            _tensor(a["out"] + 4 * j * a["N"] * lanes, (a["N"], lanes)).copy_(out)
            p, f = nxt
        return 0
    return entry


def _program(c, monkeypatch, chunks=None):
    """(result of a ScanProgram over the case on CPU tensors with the C
    entries stood in, the calls it made)."""
    calls = []
    entries = {name: _scan_stand_in(name, calls) for name in SCAN_ENTRIES}
    monkeypatch.setattr(_build, "entry_function", entries.__getitem__)
    monkeypatch.setattr(_build, "_check_cuda", lambda x: None)
    monkeypatch.setattr(_build, "_stream", lambda x: 0)
    if chunks is None:
        chunks = torch.from_numpy(c["chunks"])
    program = ScanProgram(c["table"], chunks, c["state"], **_scan_args(c))
    rs.ROUTES.clear()
    program.run()
    program.routes = dict(rs.ROUTES)
    with pytest.raises(RuntimeError, match="runs once"):
        program.run()
    return _plain(program.result()), calls, program


@pytest.mark.parametrize("dtype", [np.int16, np.int32], ids=["int16", "int32"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_torch_scan_program_argument_flow(monkeypatch, engine, dtype):
    """The program's launches, stood in, reproduce the plain version: the
    tiled and general engines make one crt_tiled_scan call a request, which
    takes every step with step 0's window and the whole request's outputs
    and bookkeeping arrays; the strided and wide engines one scan-mode call
    a step (here one wide launch a step), each with its step's window; all
    in stream rows at the chunks' own address and type, and no staging
    buffer; the program counts them."""
    c = _case(ENGINES[engine], lanes=12, n_in=96, k=3, seed=86, dtype=dtype, f0=0x4321)
    got, calls, program = _program(c, monkeypatch)
    _assert_same(got, _reference(c), engine)
    k, n_in, _ = c["chunks"].shape
    s16 = int(dtype == np.int16)
    entry = {"tiled": "crt_tiled_scan", "general": "crt_tiled_scan",
             "strided": "crt_strided_scan", "wide": "crt_wide_scan"}[engine]
    issues = 1 if engine in lowlevel.WHOLE_SCAN_KINDS else k
    assert [name for name, _ in calls] == [entry] * issues
    assert program.routes == {(lowlevel.SCAN_ROUTES[engine], "cuda"): issues}
    assert [(a["src_first"], a["src_end"]) for _, a in calls] == [
        (s * n_in - 2 * c["r"], (s + 1) * n_in) for s in range(issues)]
    if issues == 1:
        (a,) = (a for _, a in calls)
        assert a["steps"] == k and a["N"] == c["n_out"]
        assert (a["out"], a["produced"], a["over"], a["state_in"], a["state_out"]) == (
            program.outputs.data_ptr(), program.produced.data_ptr(), program.over.data_ptr(),
            program.states.data_ptr(), program.states[1].data_ptr())
    assert {(a["src_s16"], a["src"]) for _, a in calls} == {(s16, program.chunks.data_ptr())}
    # 12 int16 lanes are 24 bytes a row: 4-byte copies; 12 int32 lanes 16-byte ones.
    assert {a["copy"] for _, a in calls} == {
        _build.SCAN_COPY_WORDS if s16 else _build.SCAN_COPY_VEC}
    assert {a["vec"] for _, a in calls} == {1}
    assert not hasattr(program, "buffers") and (program.scratch is None) == (engine != "wide")


def test_torch_scan_program_several_wide_launches_a_step(monkeypatch):
    """The wide engine cuts n_out into launches of wide_launch_frames: with
    that at 48 frames a 128-frame step is three launches at offsets 0, 48,
    96, each with its launch state and its share of the output."""
    monkeypatch.setattr(lowlevel, "wide_launch_frames", lambda taps: 48)
    c = _case(ENGINES["wide"], lanes=8, n_in=4096, k=2, seed=87)
    want = _reference(c)
    _assert_same(_composed(c), want, "composed")
    got, calls, program = _program(c, monkeypatch)
    _assert_same(got, want, "program")
    assert program.launches == 3 and [name for name, _ in calls] == ["crt_wide_scan"] * 9
    assert [a["frame_offset"] for name, a in calls[:3]] == [0, 48, 96]
    assert [a["N"] for name, a in calls[:3]] == [48, 48, 32]
    assert {a["n_out"] for _, a in calls} == {128}
    # Each launch reads the step's state and writes its own frames; all three
    # get the step's bookkeeping pointers (the offset-0 launch writes them).
    book, out = program.states.data_ptr(), program.outputs.data_ptr()
    assert [(a["state_in"] - book, a["state_out"] - book, a["out"] - out) for _, a in calls] == [
        (8 * s, 8 * (s + 1), s * program.outputs[0].nbytes + o * 8 * 4)
        for s in range(3) for o in (0, 48, 96)]
    assert len({a["partial"] for _, a in calls}) == 1
    assert program.routes == {("scan_wide", "cuda"): 9}
    assert want[1].max() > 48        # some step's frames reach past the first launch


def test_torch_scan_program_odd_lanes_short_chunks_single_step(monkeypatch):
    """Six lanes (no 16-byte path), chunks shorter than the halo, a
    non-contiguous chunk stack, and K = 1."""
    c = _case(ENGINES["general"], lanes=6, n_in=16, k=5, seed=88)
    got, calls, _ = _program(c, monkeypatch)
    _assert_same(got, _reference(c), "short chunks")
    assert {a["vec"] for _, a in calls} == {0}
    wide = torch.from_numpy(np.repeat(c["chunks"], 2, axis=2))[:, :, ::2]
    assert not wide.is_contiguous()
    _assert_same(_program(c, monkeypatch, chunks=wide)[0], got, "non-contiguous")
    one = _case(ENGINES["tiled"], lanes=4, n_in=64, k=1, flush=False, seed=89)
    got, calls, _ = _program(one, monkeypatch)
    _assert_same(got, _reference(one), "K = 1")
    assert [name for name, _ in calls] == ["crt_tiled_scan"]


def test_torch_scan_program_backlog_and_checks(monkeypatch):
    """An undersized n_out raises the backlog flag from the device's
    ``over`` array; the set-up refuses what the plain version refuses."""
    full = _case((8000, 44100), lanes=4, n_in=64, seed=90)
    c = dict(full, n_out=fx.round_up(full["n_out"] // 2, 8))
    got, _, _ = _program(c, monkeypatch)
    assert got[4]
    _assert_same(got, _reference(c), "backlog")
    for bad, match in ((dict(c, n_out=60), "multiple of 8"),
                       (dict(c, taps=2008), "at most 1024 taps")):
        with pytest.raises(ValueError, match=match):
            ScanProgram(c["table"], torch.from_numpy(c["chunks"]), c["state"], **_scan_args(bad))
    with pytest.raises(ValueError, match="K >= 1"):
        ScanProgram(c["table"], torch.from_numpy(c["chunks"][0]), c["state"], **_scan_args(c))


def test_torch_scan_fused_on_the_cpu_is_the_plain_version():
    """``resample_scan_fused`` and ``resample_scan_tiled`` keep their
    signatures and, on CPU tensors, run the plain version."""
    c = _case(ENGINES["tiled"], lanes=8, n_in=64, seed=91)
    chunks = torch.from_numpy(c["chunks"])
    rs.ROUTES.clear()
    got = _plain(resample_scan_fused(c["table"], chunks, c["state"], **_scan_args(c)))
    assert set(rs.ROUTES) == {("tiled", "reference")}
    _assert_same(got, _reference(c), "fused")
    plan = rs.plan_uniform(c["inc"], c["n_out"])
    alias = resample_scan_tiled(c["table"], chunks, c["state"], max_taps=c["taps"],
                                n_out=c["n_out"], radius=c["r"], d=plan["d"], cand=plan["cand"])
    _assert_same(_plain(alias), got, "alias")


# ---------------------------------------------------------------------------
# On a card: the kernels against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.int16, np.int32], ids=["int16", "int32"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_torch_cuda_scan_program_matches_reference(cuda_device, engine, dtype):
    c = _case(ENGINES[engine], lanes=300, n_in=512, k=3, seed=92, dtype=dtype, f0=0x777,
              device=cuda_device)
    chunks = torch.from_numpy(c["chunks"]).to(cuda_device)
    rs.ROUTES.clear()
    got = _plain(resample_scan_fused(c["table"], chunks, c["state"], **_scan_args(c)))
    launches = 1 if engine in lowlevel.WHOLE_SCAN_KINDS else 4
    assert rs.ROUTES == {(lowlevel.SCAN_ROUTES[engine], "cuda"): launches}
    _assert_same(got, _reference(c), engine)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,n_in", [(6, 16), (2, 300), (128, 8)])
def test_torch_cuda_scan_program_odd_shapes_match_reference(cuda_device, lanes, n_in):
    c = _case(ENGINES["general"], lanes=lanes, n_in=n_in, k=5, seed=93, device=cuda_device)
    chunks = torch.from_numpy(c["chunks"]).to(cuda_device)
    got = _plain(resample_scan_fused(c["table"], chunks, c["state"], **_scan_args(c)))
    _assert_same(got, _reference(c), (lanes, n_in))


@pytest.mark.cuda
@pytest.mark.parametrize("engine", list(ENGINES))
def test_torch_cuda_n_valid_matches_plain(cuda_device, engine):
    c = _case(ENGINES[engine], lanes=300, n_in=2048 if engine == "wide" else 256, k=1,
              flush=False, device=cuda_device)
    kind, d, cand, _ = lowlevel._scan_engine(c["inc"], c["taps"], 64)
    x = torch.cat([torch.from_numpy(c["chunks"][0].astype(np.int32)).to(cuda_device),
                   torch.zeros((c["taps"] + 8, 300), dtype=torch.int32, device=cuda_device)])
    st = make_device_state(c["r"], 5, c["cfg"], c["inc"], cuda_device)
    entry, plain = {
        "tiled": (rs.resample_uniform_lanes_tiled, rs.resample_uniform_lanes_tiled_reference),
        "general": (rs.resample_uniform_lanes_general,
                    rs.resample_uniform_lanes_general_reference),
        "strided": (rs.resample_strided_phases, rs.resample_strided_reference),
        "wide": (rs.resample_wide_taps, rs.resample_wide_taps_reference)}[kind]
    extra = dict(d=d, cand=cand) if kind == "tiled" else (
        {} if kind == "general" else dict(d=d))
    for clamp in (False, True):
        for n_valid, offset in ((20, 0), (20, 8), (100, 0), (3, 8)):
            kw = dict(max_taps=c["taps"], n_out=32, clamp_s16=clamp, frame_offset=offset,
                      n_valid=torch.tensor([n_valid], dtype=torch.int32, device=cuda_device),
                      **extra)
            got, want = entry(c["table"], x, st, **kw), plain(c["table"], x, st, **kw)
            assert got[0].dtype == want[0].dtype and torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_torch_cuda_launch_keeps_current_device(cuda_device):
    """A launch on a tensor of another card than the current one makes that
    card current for the launch only (one card: the launch leaves the
    current device as it was)."""
    other = torch.device("cuda", torch.cuda.device_count() - 1)
    c = _case(ENGINES["tiled"], lanes=8, n_in=64, seed=95, device=other)
    chunks = torch.from_numpy(c["chunks"]).to(other)
    with torch.cuda.device(0):
        before = torch.cuda.current_device()
        got = _plain(resample_scan_fused(c["table"], chunks, c["state"], **_scan_args(c)))
        assert torch.cuda.current_device() == before == 0
    _assert_same(got, _reference(c), "other device")
