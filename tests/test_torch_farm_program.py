"""The port's farm call as one device program vs the JAX package.

On a card a farm call is a ``FarmProgram``: an upload, one launch of
farm_stage_kernel (the parked slide, the chunk widened and transposed, the
zero tail), the ratio class's launches written in place, one launch of
farm_unstage_kernel and a download into a pinned result. On the CPU, with
inputs made from a numpy seed and exact equality throughout, this file holds

* ``farm_stage_reference`` (through a ``FarmProgram`` on the CPU) against the
  JAX package's jitted ``_dev_stage``, ``_dev_shift`` and ``_dev_zero_rows``,
  applied in the order a call and the next call apply them;
* ``farm_unstage_reference`` against the JAX package's
  ``native.unstage_output`` and its int16 numpy de-interleave;
* the farms themselves with their C entries stood in by functions that read
  and write the same pointers, so the buffer swap, the row offsets and the
  prebound arguments are exercised without a card, against the CPU farms and
  the JAX farm;
* the results' ownership (no later call writes to an array a caller holds)
  and snapshots taken right after ``process``, restored in both packages.

The ``cuda`` tests run the two kernels and the farms on a card.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from clownresampler_tpu import checkpoint as jckpt
from clownresampler_tpu.farm import UniformStreamFarm as JFarm
from clownresampler_tpu.utils import native as jnative
from clownresampler_tpu_torch import checkpoint as ckpt
from clownresampler_tpu_torch import farm as farm_mod
from clownresampler_tpu_torch.farm import (
    DeviceTables,
    FarmProgram,
    MixedStreamFarm,
    ResultPool,
    UniformStreamFarm,
    farm_stage,
    farm_stage_reference,
    farm_unstage,
    farm_unstage_reference,
)
from clownresampler_tpu_torch.lowlevel import DeviceState
from clownresampler_tpu_torch.models import DEFAULT_MODEL
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.ops.convolve import ConfigScalars
from clownresampler_tpu_torch.parallel import (
    ShardedMixedStreamFarm,
    ShardedStreamFarm,
    make_mesh,
)

SHAPES = [(b, c) for b in (1, 6, 64) for c in (1, 2, 3, 16)]


def _chunk(rng, b, n, c):
    return rng.integers(-32768, 32768, size=(b, n, c)).astype(np.int16)


# ---------------------------------------------------------------------------
# farm_stage_reference against the JAX farm's device programs
# ---------------------------------------------------------------------------

class _JaxStaging:
    """The JAX farm's staging buffer driven by its three jitted programs."""

    def __init__(self, capacity, lanes, fill):
        self.st = (jnp.zeros((capacity, lanes), jnp.int32),)
        self.lanes, self.fill = lanes, fill

    def stage(self, chunk):
        self.st = JFarm._dev_stage(self.st, jnp.asarray(chunk), jnp.int32(self.fill),
                                   total_lanes=self.lanes)
        self.fill += chunk.shape[1]

    def shift(self, consumed):
        keep = self.fill - consumed
        self.st = JFarm._dev_shift(self.st, jnp.int32(consumed), jnp.int32(keep))
        self.fill = keep

    def zero_rows(self, n):
        self.st = JFarm._dev_zero_rows(self.st, jnp.int32(self.fill), jnp.int32(n))
        self.fill += n

    def rows(self):
        return np.asarray(self.st[0])


def _program(b, c, capacity, chunk_frames):
    return FarmProgram(DeviceTables(DEFAULT_MODEL, torch.device("cpu")), b, c, capacity,
                       chunk_frames, False)


def _check_rows(program, jax_staging, what):
    """The program's staged rows, the parked slide applied, are the JAX
    buffer's; the rows the slide leaves out of the view do not count."""
    got = program.rows().numpy()
    np.testing.assert_array_equal(got, jax_staging.rows()[: got.shape[0]], err_msg=what)


@pytest.mark.parametrize("b,c", SHAPES)
def test_torch_farm_stage_reference_matches_jax_device_programs(b, c):
    """A first call, a call that consumes nothing (appended in place), a
    parked slide done by the next call's stage, a short chunk, a chunk of
    length 0, a chunk that fills the capacity, and the flush's zero rows:
    after every step the staging equals the JAX farm's, every row of it."""
    rng = np.random.default_rng(1000 + 17 * b + c)
    halo, chunk_frames, tail = 5, 24, 11
    capacity = 2 * halo + chunk_frames + tail
    program, jst = _program(b, c, capacity, chunk_frames), _JaxStaging(capacity, b * c, halo)
    fill = halo
    for buf in program.buffers:      # the halo rows stay zero, what follows is rewritten
        buf[halo:] = -7
    # (chunk frames or None for the flush, rows the emit after it consumes)
    steps = [(7, 0), (9, 0), (24, 30), (3, 0), (0, 4), (chunk_frames, 20), (24, 24), (1, 11),
             (None, 9)]
    for k, (n, consumed) in enumerate(steps):
        if n is None:
            program.stage(torch.empty((b, 0, c), dtype=torch.int16), 0, fill)
            jst.zero_rows(halo)
            fill += halo
        else:
            chunk = _chunk(rng, b, n, c)
            parked = program.slide
            before = program.current
            program.stage(torch.from_numpy(chunk), n, fill)
            assert program.current == (before ^ 1 if parked else before) and not program.slide
            jst.stage(chunk)
            fill += n
        assert fill <= capacity
        _check_rows(program, jst, f"step {k}: staged")
        assert not program.rows()[fill:].any()
        if consumed:
            assert consumed <= fill
            program.slide = consumed
            jst.shift(consumed)
            fill -= consumed
            _check_rows(program, jst, f"step {k}: slide parked")
            np.testing.assert_array_equal(program.rows()[:fill].numpy(), jst.rows()[:fill])
    assert jst.fill == fill


def test_torch_farm_stage_reference_rows_and_refusals():
    """The pieces by hand: kept rows, the transposed chunk, the zero tail;
    in place nothing below ``keep`` is touched, and a consumed count is
    refused there."""
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.integers(-99, 99, size=(20, 6)).astype(np.int32))
    dst = torch.full_like(src, -1)
    chunk = torch.from_numpy(_chunk(rng, 2, 4, 3))
    farm_stage_reference(src, dst, chunk, keep=5, consumed=3)
    assert torch.equal(dst[:5], src[3:8])
    for t in range(4):
        assert dst[5 + t].tolist() == [*chunk[0, t].tolist(), *chunk[1, t].tolist()]
    assert not dst[9:].any() and dst.dtype == torch.int32
    kept = src.clone()
    farm_stage(src, src, chunk, keep=8, consumed=0)     # on the CPU: the plain version
    assert torch.equal(src[:8], kept[:8]) and torch.equal(src[8:12], dst[5:9])
    assert not src[12:].any()
    with pytest.raises(ValueError, match="in-place"):
        farm_stage_reference(src, src, chunk, keep=8, consumed=2)


# ---------------------------------------------------------------------------
# farm_unstage_reference against the JAX package's de-interleave
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,c", SHAPES)
def test_torch_farm_unstage_reference_matches_jax_native_unstage(b, c):
    """int32: the JAX package's native ``unstage_output`` (rows past n_out
    are the last launch's padding and stay behind); a stream range is the
    same rows of the whole."""
    rng = np.random.default_rng(2000 + 17 * b + c)
    n_out = 37
    lanes = rng.integers(-(1 << 30), 1 << 30, size=(n_out + 3, b * c)).astype(np.int32)
    want = jnative.unstage_output(lanes[:n_out], b, c)
    got = farm_unstage_reference(torch.from_numpy(lanes), n_out, c)
    assert got.is_contiguous() and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    lo, hi = b // 3, b - b // 4
    part = farm_unstage(torch.from_numpy(lanes), n_out, c, stream_lo=lo, streams=hi - lo)
    np.testing.assert_array_equal(part.numpy(), want[lo:hi])


@pytest.mark.parametrize("b,c", SHAPES)
def test_torch_farm_unstage_reference_matches_jax_int16_path(b, c):
    """int16 (``clamp_s16``): the JAX farm's numpy de-interleave
    (clownresampler_tpu/farm.py, ``_finish_emit``); ``out`` receives it."""
    rng = np.random.default_rng(3000 + 17 * b + c)
    n_out = 21
    lanes = rng.integers(-32768, 32768, size=(n_out, b * c)).astype(np.int16)
    want = np.ascontiguousarray(lanes[:, : b * c].reshape(-1, b, c).transpose(1, 0, 2))
    out = torch.full((b * n_out * c + 5,), -3, dtype=torch.int16)
    got = farm_unstage(torch.from_numpy(lanes), n_out, c, out=out)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(out[: want.size].numpy(), want.reshape(-1))
    assert (out[want.size :] == -3).all()


# ---------------------------------------------------------------------------
# The farms with their C entries stood in
# ---------------------------------------------------------------------------

def _view(ptr, shape, dtype=np.int32):
    """The memory at ``ptr`` as a writable numpy array."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    if nbytes == 0:
        return np.zeros(shape, dtype)
    return np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).reshape(shape)


def _tensor(ptr, shape, dtype=np.int32):
    return torch.from_numpy(_view(ptr, shape, dtype))


def _stage_stand_in(calls):
    """crt_farm_stage over the same pointers, in numpy; the path and the
    tile are the launcher's rule's."""
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS["crt_farm_stage"], args))
        calls.append(("crt_farm_stage", a))
        b, n, c, keep = a["streams"], a["n_in"], a["channels"], a["keep"]
        shape = (a["capacity"], b * c)
        dst = _view(a["dst"], shape)
        assert a["tile_streams"] % 2 == 0 and a["tile_frames"] >= 1
        assert a["path"] == _build.farm_stage_path(
            channels=c, streams=b, n_in=n, chunk_ptr=a["chunk"], src_ptr=a["src"],
            dst_ptr=a["dst"])
        if a["path"] == _build.FARM_STAGE_RING:
            layout = _build.farm_ring_layout(c)
            assert all(a[k] == layout[k] for k in ("tile_streams", "tile_frames", "stages", "slot"))
        else:
            assert (a["tile_streams"], a["tile_frames"]) == _build.farm_tile(c)
        if a["src"] != a["dst"]:
            dst[:keep] = _view(a["src"], shape)[a["consumed"] : a["consumed"] + keep]
        else:
            assert a["consumed"] == 0
        chunk = _view(a["chunk"], (b, n, c), np.int16)
        dst[keep : keep + n] = chunk.astype(np.int32).transpose(1, 0, 2).reshape(n, b * c)
        dst[keep + n :] = 0
        return 0
    return entry


def _unstage_stand_in(calls):
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS["crt_farm_unstage"], args))
        calls.append(("crt_farm_unstage", a))
        dtype = np.int16 if a["out_s16"] else np.int32
        n, c, s, lo = a["n_out"], a["channels"], a["streams"], a["stream_lo"]
        src = _view(a["src"], (n, a["L"]), dtype)[:, lo * c : (lo + s) * c]
        _view(a["dst"], (s, n, c), dtype)[...] = src.reshape(n, s, c).transpose(1, 0, 2)
        return 0
    return entry


def _copy_stand_in(calls):
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS["crt_farm_copy"], args))
        calls.append(("crt_farm_copy", a))
        ctypes.memmove(a["dst"], a["src"], a["nbytes"])
        return 0
    return entry


def _host_stage_stand_in(calls):
    """crt_farm_host_stage over the same pointers: the rows at the table's
    addresses (zeros for 0) laid end to end at the pinned address, then each
    piece of _build.farm_host_pieces copied on to the card address (none
    without one); logs the
    table it read as ``sources`` and the rows that landed as ``landed``."""
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS["crt_farm_host_stage"], args))
        rows, row_bytes = a["rows"], a["row_bytes"]
        sources = _view(a["srcs"], (rows,), np.uint64).copy()
        calls.append(("crt_farm_host_stage", dict(a, sources=sources)))
        pinned = _view(a["pinned"], (rows, row_bytes), np.uint8)
        for r, src in enumerate(sources):
            pinned[r] = 0 if src == 0 else _view(int(src), (row_bytes,), np.uint8)
        for lo, hi in _build.farm_host_pieces(rows * row_bytes) if a["card"] else ():
            ctypes.memmove(a["card"] + lo, a["pinned"] + lo, hi - lo)
        calls[-1][1]["landed"] = pinned.copy()
        return 0
    return entry


# What the stand-in of crt_farm_host_stats reports for every job,
# (pool_wait_ns, pool_late_ns), and its calls' arguments (apart from the
# device program's calls: the recorder makes them).
HOST_STATS = (7000, 3000)
HOST_STATS_CALLS = []


def _host_stats_stand_in():
    """crt_farm_host_stats: HOST_STATS written to the address passed."""
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS["crt_farm_host_stats"], args))
        HOST_STATS_CALLS.append(a)
        _view(a["out"], (2,), np.int64)[...] = HOST_STATS
        return 0
    return entry


def _sync_stand_in(calls):
    def entry(*args):
        calls.append(("crt_farm_sync", dict(zip(_build.ENTRY_ARGS["crt_farm_sync"], args))))
        return 0
    return entry


def _mac_stand_in(name, calls):
    """A MAC entry over the same pointers, as a farm calls it (the launch
    state by value, no ``n_valid``): its plain version, written to the
    output pointer."""
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS[name], args))
        calls.append((name, a))
        assert a["rows_out"] is None and a["n_valid"] is None and a["frame_offset"] == 0
        assert a["p0_ptr"] is None and a["f0_ptr"] is None and a["lane_offset"] == 0
        scalar = lambda key: _tensor(a[key], ())
        cfg = ConfigScalars(
            stretched_kernel_radius=scalar("radius"),
            integer_stretched_kernel_radius=scalar("int_radius"),
            stretched_kernel_radius_delta=scalar("delta"), kernel_step_size=scalar("step"),
            increment=torch.zeros((), dtype=torch.int32), increment_hi=scalar("inc_hi"),
            increment_lo=scalar("inc_lo"))
        st = DeviceState(a["p0_val"], a["f0_val"], cfg)
        x = _tensor(a["x"], (a["S"], a["L"]))
        table = _tensor(a["table"], (a["table_size"],))
        kw = dict(max_taps=a["T"], n_out=a["N"], clamp_s16=bool(a["clamp_s16"]))
        if a.get("tstr"):
            kw["table_strided"] = _tensor(a["tstr"], (a["tstr_rows"], a["T"]))
        if name == "crt_strided_mac":
            out, _ = rs.resample_strided_reference(table, x, st, d=a["d"], **kw)
        elif name == "crt_wide_mac":
            assert a["partial"] and a["tap_sums"] > a["partial"]
            out, _ = rs.resample_wide_taps_reference(table, x, st, d=0, **kw)
        else:
            out, _ = rs.resample_uniform_lanes_general_reference(table, x, st, **kw)
        _tensor(a["out"], (a["N"], a["lanes"]),
                np.int16 if a["clamp_s16"] else np.int32).copy_(out)
        return 0
    return entry


MAC_ENTRIES = ("crt_tiled_mac", "crt_strided_mac", "crt_wide_mac")


@pytest.fixture
def card(monkeypatch):
    """Farms built under this fixture on CPU tensors take the card's path:
    every C entry is stood in over the same pointers and logged (the list
    this returns; crt_farm_host_stats reports HOST_STATS and logs in
    HOST_STATS_CALLS), pinned memory is ordinary memory."""
    calls = []
    HOST_STATS_CALLS.clear()
    entries = {"crt_farm_stage": _stage_stand_in(calls),
               "crt_farm_unstage": _unstage_stand_in(calls),
               "crt_farm_copy": _copy_stand_in(calls), "crt_farm_sync": _sync_stand_in(calls),
               "crt_farm_host_stage": _host_stage_stand_in(calls),
               "crt_farm_host_stats": _host_stats_stand_in(),
               **{name: _mac_stand_in(name, calls) for name in MAC_ENTRIES}}
    monkeypatch.setattr(_build, "entry_function", entries.__getitem__)
    monkeypatch.setattr(_build, "_check_cuda", lambda x: None)
    monkeypatch.setattr(_build, "_stream", lambda x: 77)
    monkeypatch.setattr(farm_mod, "_on_card", lambda device: True)
    monkeypatch.setattr(farm_mod, "_pinned_empty", lambda numel, dtype: torch.empty(numel, dtype=dtype))
    return calls


def _run(farm, chunks):
    """Every call's output, kept until after the last call."""
    outs = [farm.process(c) for c in chunks]
    outs.append(farm.flush())
    return outs


def _chunks(seed, b, c, sizes):
    rng = np.random.default_rng(seed)
    return [_chunk(rng, b, n, c) for n in sizes]


def _same(got, want, what=""):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} call {k}")


ENGINES = {"tiled": (48000, 44100), "strided": (96000, 48000), "general": (44100, 8000),
           "wide": (44100, 1000)}
SIZES = (200, 256, 0, 31, 256, 3)


@pytest.mark.parametrize("clamp", [False, True], ids=["int32", "clamp_s16"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_torch_farm_program_argument_flow(card, engine, clamp):
    """The farm's card path, stood in, reproduces the CPU farm for every
    engine: chunks of full, short and zero length, outputs kept to the end."""
    rates = ENGINES[engine]
    chunk = 2048 if engine == "wide" else 256
    sizes = tuple(s * chunk // 256 for s in SIZES)
    chunks = _chunks(41, 5, 2, sizes)
    kw = dict(chunk_frames=chunk, device="cpu", clamp_s16=clamp)
    with pytest.MonkeyPatch.context() as plain:
        plain.setattr(farm_mod, "_on_card", lambda device: False)
        want = _run(UniformStreamFarm(5, 2, *rates, device_staging=True, **kw), chunks)
    rs.ROUTES.clear()
    farm = UniformStreamFarm(5, 2, *rates, device_staging=True, **kw)
    assert farm._on_card
    got = _run(farm, chunks)
    _same(got, want, engine)
    emits = sum(1 for o in got if o.shape[1])
    assert rs.ROUTES == {("farm_stage", "cuda"): len(chunks) + 1,
                         ("farm_unstage", "cuda"): emits, (engine, "cuda"): emits,
                         ("farm_input", "direct"): len(chunks)}
    assert {a["path"] for name, a in card if name == "crt_farm_stage"} == {0}   # 10 lanes
    assert {a["stream"] for _, a in card} == {77}


def test_torch_farm_program_call_sequence_and_buffer_swap(card):
    """One call is: wait, the chunk through the pinned input to the card
    (the host threads' copy and the uploads), stage, the launches, unstage,
    download, wait. The stage appends in place until an emit has consumed
    rows, then goes to the other buffer with the parked slide; the launches
    read the buffer the stage wrote."""
    chunks = _chunks(42, 4, 2, (100, 256, 256, 256))
    farm = UniformStreamFarm(4, 2, 48000, 44100, chunk_frames=256, device="cpu",
                             device_staging=True)
    program = farm._programs[0][3]
    buffers = [buf.data_ptr() for buf in program.buffers]
    fill, parked, current = farm._radius_bound, 0, 0
    for k, chunk in enumerate(chunks):
        del card[:]
        out = farm.process(chunk)
        names = [name for name, _ in card]
        assert names == ["crt_farm_sync", "crt_farm_host_stage", "crt_farm_stage",
                         "crt_tiled_mac", "crt_farm_unstage", "crt_farm_copy",
                         "crt_farm_sync"], (k, names)
        upload, stage, mac, unstage, download = (a for _, a in card[1:6])
        n = chunk.shape[1]
        assert upload["pinned"] == farm._input.data_ptr()
        assert list(upload["sources"]) == [chunk.ctypes.data]
        assert upload["rows"] * upload["row_bytes"] == chunk.nbytes
        assert upload["card"] == stage["chunk"] == program.chunk.data_ptr()
        if parked:
            current ^= 1
        assert (stage["src"], stage["dst"]) == (buffers[current ^ bool(parked)], buffers[current])
        assert (stage["keep"], stage["consumed"], stage["n_in"]) == (fill, parked, n)
        assert mac["x"] == stage["dst"] and mac["out"] == program.lanes_out.data_ptr()
        assert mac["N"] == -(-out.shape[1] // 8) * 8
        assert unstage["src"] == mac["out"] and unstage["n_out"] == out.shape[1]
        assert download["src"] == unstage["dst"] and download["nbytes"] == out.nbytes
        assert download["dst"] == out.ctypes.data
        parked = program.slide
        assert parked > 0
        fill = farm._fill
    assert len(program.plans) <= 2      # one plan a frame-count class


def test_torch_farm_program_row_offsets_of_several_launches(card, monkeypatch):
    """Emits longer than MAX_LAUNCH_OUTPUT_FRAMES go as several launches
    into one output at their row offsets, in order; the plan is built once a
    frame-count class and rebuilt after ``adjust``."""
    monkeypatch.setattr(farm_mod, "MAX_LAUNCH_OUTPUT_FRAMES", 40)
    chunks = _chunks(43, 3, 1, (256, 256, 256, 256))
    with pytest.MonkeyPatch.context() as plain:
        plain.setattr(farm_mod, "_on_card", lambda device: False)
        ref = UniformStreamFarm(3, 1, 48000, 44100, chunk_frames=256, device="cpu",
                                device_staging=True, max_radius=17)
        want = [ref.process(chunks[0]), ref.process(chunks[1])]
        assert ref.adjust(44100, 8000)
        want += [ref.process(chunks[2]), ref.process(chunks[3]), ref.flush()]
    farm = UniformStreamFarm(3, 1, 48000, 44100, chunk_frames=256, device="cpu",
                             device_staging=True, max_radius=17)
    program = farm._programs[0][3]
    got = [farm.process(chunks[0])]
    macs = [a for name, a in card if name == "crt_tiled_mac"]
    n_out = got[0].shape[1]
    assert len(macs) == -(-n_out // 40) > 3
    base, row = program.lanes_out.data_ptr(), 4 * 3
    assert [a["out"] for a in macs] == [base + 40 * i * row for i in range(len(macs))]
    assert [a["N"] for a in macs] == [40] * (len(macs) - 1) + [-(-(n_out % 40 or 40) // 8) * 8]
    assert len({(a["p0_val"], a["f0_val"]) for a in macs}) == len(macs)
    got.append(farm.process(chunks[1]))
    plans_before = dict(program.plans)
    assert farm.adjust(44100, 8000) and not program.plans
    got += [farm.process(chunks[2]), farm.process(chunks[3]), farm.flush()]
    assert not set(program.plans) & set(plans_before)
    _same(got, want, "adjusted")


def test_torch_farm_program_matches_jax_farm(card):
    """The card path, stood in, against the JAX package's farm (Pallas in
    interpret mode): 64 stereo streams, 48k -> 44.1k."""
    chunks = _chunks(44, 64, 2, (256, 256, 100))
    want = _run(JFarm(64, 2, 48000, 44100, chunk_frames=256, interpret=True), chunks)
    farm = UniformStreamFarm(64, 2, 48000, 44100, chunk_frames=256, device="cpu",
                             device_staging=True)
    _same(_run(farm, chunks), want, "jax")
    # 128 lanes: the ring where there are frames, 16-byte stores for the flush
    assert {(a["path"], a["n_in"] > 0) for name, a in card if name == "crt_farm_stage"} == {
        (_build.FARM_STAGE_RING, True), (_build.FARM_STAGE_VEC, False)}


def test_torch_farm_program_converts_chunks_as_ascontiguousarray(card):
    """Chunks that are not int16 or not contiguous reach the pinned input as
    ``np.ascontiguousarray(chunk, dtype=np.int16)`` would make them."""
    rng = np.random.default_rng(45)
    base = rng.integers(-70000, 70000, size=(3, 64, 4)).astype(np.int32)
    variants = [base, (base % 30000).astype(np.float64) + 0.25, base[:, :, ::2],
                np.asfortranarray(base.astype(np.int16)), (base % 30000).tolist()]
    for k, chunk in enumerate(variants):
        want = np.ascontiguousarray(chunk, dtype=np.int16)
        farm = UniformStreamFarm(3, want.shape[2], 48000, 44100, chunk_frames=64, device="cpu",
                                 device_staging=True)
        del card[:]
        farm.process(chunk)
        np.testing.assert_array_equal(farm._input_array[: want.size], want.reshape(-1),
                                      err_msg=str(k))
        stage = next(a for name, a in card if name == "crt_farm_stage")
        staged = _view(stage["dst"], (farm._capacity, farm._lanes))[stage["keep"] :][:64]
        np.testing.assert_array_equal(
            staged, want.astype(np.int32).transpose(1, 0, 2).reshape(64, -1), err_msg=str(k))
    with pytest.raises(ValueError, match="does not match the farm"):
        farm.process(np.zeros((3, 65, 2), np.int16))


def test_torch_farm_program_waits_before_it_reuses_the_input(card):
    """A call that emits nothing returns without waiting for its upload, so
    the next call waits for the card before it writes the pinned input, on
    every route into it."""
    farm = UniformStreamFarm(2, 2, 44100, 8000, chunk_frames=64, device="cpu",
                             device_staging=True)
    assert farm.process(_chunk(np.random.default_rng(46), 2, 10, 2)).shape == (2, 0, 2)
    assert [name for name, _ in card] == ["crt_farm_sync", "crt_farm_host_stage",
                                          "crt_farm_stage"]
    del card[:]
    assert farm.process(_chunk(np.random.default_rng(47), 2, 0, 2)).shape == (2, 0, 2)
    assert [name for name, _ in card] == ["crt_farm_sync", "crt_farm_stage"]   # nothing to upload
    del card[:]
    farm.process(_chunk(np.random.default_rng(48), 2, 10, 2).astype(np.int32))   # converted
    assert [name for name, _ in card][:3] == ["crt_farm_sync", "crt_farm_copy", "crt_farm_stage"]
    del card[:]
    farm.process(_chunk(np.random.default_rng(49), 2, 64, 2))
    assert [name for name, _ in card][:3] == ["crt_farm_sync", "crt_farm_host_stage",
                                              "crt_farm_stage"]


@pytest.mark.parametrize("dp,b", [(4, 16), (3, 8), (5, 3)])
def test_torch_sharded_farm_program_argument_flow(card, dp, b):
    """A sharded farm's card path: every shard uploads its stream range of
    the pinned input, stages, launches, unstages and downloads into its
    block of the result; equal to the unsharded CPU farm."""
    chunks = _chunks(49, b, 2, (256, 17, 256))
    with pytest.MonkeyPatch.context() as plain:
        plain.setattr(farm_mod, "_on_card", lambda device: False)
        want = _run(UniformStreamFarm(b, 2, 96000, 48000, chunk_frames=256, device="cpu"), chunks)
    mesh = make_mesh(dp=dp, devices=["cpu"] * dp)
    farm = ShardedStreamFarm(mesh, b, 2, 96000, 48000, chunk_frames=256)
    got = [farm.process(chunks[0])]
    shards = len(farm._programs)
    assert shards == min(dp, b)
    uploads = [a for name, a in card if name == "crt_farm_host_stage"]
    assert [a["pinned"] - farm._input.data_ptr() for a in uploads] == [
        2 * lo * 256 * 2 for _, lo, _, _ in farm._programs]
    assert [list(a["sources"]) for a in uploads] == [
        [chunks[0].ctypes.data + 2 * lo * 256 * 2] for _, lo, _, _ in farm._programs]
    downloads = [a for name, a in card if name == "crt_farm_copy"]
    assert [a["dst"] - got[0].ctypes.data for a in downloads] == [
        4 * lo * got[0].shape[1] * 2 for _, lo, _, _ in farm._programs]
    assert [name for name, _ in card].count("crt_strided_mac") == shards
    got += [farm.process(c) for c in chunks[1:]] + [farm.flush()]
    _same(got, want, f"dp {dp}")


def test_torch_mixed_farm_program_argument_flow(card):
    """Mixed farms on the card path, unsharded and sharded, with a stream
    moved by ``adjust_stream`` while its source group has a slide parked:
    the moved stream takes the rows that are current, and every stream
    equals the CPU mixed farm's."""
    specs = [(48000, 44100)] * 5 + [(96000, 48000)] * 4 + [(44100, 48000)] * 3
    rng = np.random.default_rng(50)
    data = [[_chunk(rng, 1, 128, 2)[0] for _ in specs] for _ in range(4)]

    def run(farm):
        outs = []
        for k, chunks in enumerate(data):
            if k == 2:
                assert any(f._programs[0][3].slide for f, _ in farm._groups)
                assert farm.adjust_stream(6, 44100, 8000)
                assert not farm._groups[-1][0]._programs[0][3].slide
            outs.append(farm.process(chunks))
        outs.append(farm.flush())
        return [np.concatenate([o[i] for o in outs]) for i in range(len(specs))]

    with pytest.MonkeyPatch.context() as plain:
        plain.setattr(farm_mod, "_on_card", lambda device: False)
        plain_farm = MixedStreamFarm(specs, 2, chunk_frames=128, max_radius=17, device="cpu")
        for f, _ in plain_farm._groups:      # the CPU default stages on the host
            assert not f._device_staging
        outs = []
        for k, chunks in enumerate(data):
            if k == 2:
                assert plain_farm.adjust_stream(6, 44100, 8000)
            outs.append(plain_farm.process(chunks))
        outs.append(plain_farm.flush())
        want = [np.concatenate([o[i] for o in outs]) for i in range(len(specs))]
    mesh = make_mesh(dp=2, devices=["cpu"] * 2)
    sharded = ShardedMixedStreamFarm(mesh, specs, 2, chunk_frames=128, max_radius=17)
    for i, (g, w) in enumerate(zip(run(sharded), want)):
        np.testing.assert_array_equal(g, w, err_msg=f"sharded stream {i}")
    kinds = {name for name, _ in card if name in MAC_ENTRIES}
    assert kinds == {"crt_tiled_mac", "crt_strided_mac"}     # 44.1k -> 8k is general: tiled entry
    assert len(sharded._groups) == 4


class _CardMixedFarm(MixedStreamFarm):
    """A mixed farm on the CPU whose groups stage in tensors (the CPU
    default is the host engine), so that they take the stood-in card path."""

    def _make_group_farm(self, n_streams, rates, max_radius=None):
        return UniformStreamFarm(n_streams, self.channels, *rates, chunk_frames=self.chunk_frames,
                                 model=self.model, max_radius=max_radius, device=self.device,
                                 clamp_s16=self.clamp_s16, device_staging=True)


def test_torch_mixed_farm_program_moves_a_stream_under_a_parked_slide(card):
    """The unsharded mixed farm on the card path: ``adjust_stream`` right
    after a call (the source's slide still parked) copies the current rows,
    and the source keeps its own parked slide."""
    specs = [(48000, 44100)] * 4 + [(8000, 48000)] * 2
    rng = np.random.default_rng(51)
    data = [[_chunk(rng, 1, 96, 2)[0] for _ in specs] for _ in range(3)]

    def run(farm, check=False):
        outs = [farm.process(data[0])]
        if check:
            source = farm._groups[0][0]._programs[0][3]
            parked = source.slide
            assert parked
        assert farm.adjust_stream(1, 44100, 48000)
        if check:
            solo = farm._groups[-1][0]
            assert source.slide == parked and not solo._programs[0][3].slide
            fill = solo._fill
            np.testing.assert_array_equal(solo._staging[:fill].numpy(),
                                          source.rows()[:fill, 2:4].numpy())
        outs += [farm.process(data[1]), farm.process(data[2]), farm.flush()]
        return [np.concatenate([o[i] for o in outs]) for i in range(len(specs))]

    with pytest.MonkeyPatch.context() as plain:
        plain.setattr(farm_mod, "_on_card", lambda device: False)
        want = run(MixedStreamFarm(specs, 2, chunk_frames=96, max_radius=8, device="cpu"))
    got = run(_CardMixedFarm(specs, 2, chunk_frames=96, max_radius=8, device="cpu"), check=True)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"stream {i}")


# ---------------------------------------------------------------------------
# Whose the results are
# ---------------------------------------------------------------------------

def test_torch_farm_results_are_the_callers(card):
    """Outputs a caller keeps are never written again; a buffer comes back
    to the pool only when the output and every view of it are gone, and is
    then reused."""
    chunks = _chunks(52, 4, 2, (256,) * 6)
    farm = UniformStreamFarm(4, 2, 48000, 44100, chunk_frames=256, device="cpu",
                             device_staging=True)
    kept = [farm.process(c) for c in chunks[:3]]
    copies = [o.copy() for o in kept]
    assert len({o.ctypes.data for o in kept}) == 3 and not farm._results._free
    view = kept[0][1]                       # as MixedStreamFarm hands streams out
    address = kept[0].ctypes.data
    del kept[0]
    assert not farm._results._free          # the view still holds the buffer
    out = farm.process(chunks[3])
    assert out.ctypes.data != address
    np.testing.assert_array_equal(view, copies[0][1])
    del view
    assert len(farm._results._free) == 1
    again = farm.process(chunks[4])
    assert again.ctypes.data == address and not farm._results._free
    for o, c in zip(kept, copies[1:]):
        np.testing.assert_array_equal(o, c)
    assert out.flags.writeable and out.flags.c_contiguous


def test_torch_result_pool_is_bounded_and_grows(monkeypatch):
    """At most RESULT_POOL_BUFFERS buffers are out or waiting; past them the
    scratch buffer is lent (not the caller's to keep); a buffer too small
    for a larger emit makes way for one that fits."""
    monkeypatch.setattr(farm_mod, "_pinned_empty", lambda numel, dtype: torch.empty(numel, dtype=dtype))
    pool, limit = ResultPool(), farm_mod.RESULT_POOL_BUFFERS
    leases = [pool.lease((2, 10, 2), np.int32) for _ in range(limit + 2)]
    assert [owned for _, _, owned in leases] == [True] * limit + [False] * 2
    assert all(a.shape == (2, 10, 2) and a.dtype == np.int32 and a.ctypes.data == address
               for a, address, _ in leases)
    assert leases[-1][1] == leases[-2][1]
    assert len({address for _, address, _ in leases}) == limit + 1
    del leases
    assert len(pool._free) == limit and pool._out == 0
    big, address, owned = pool.lease((2, 100, 2), np.int16)   # none fits: a small one goes
    assert owned and big.nbytes == 800 and big.ctypes.data == address
    assert len(pool._free) == limit - 1 and pool._out == 1
    empty, _, owned = pool.lease((3, 0, 2), np.int32)
    assert empty.shape == (3, 0, 2) and owned


def test_torch_farm_results_past_the_pool_are_fresh_arrays(card):
    """A caller that keeps every output gets pooled buffers first and then
    fresh arrays copied from the pool's scratch: none is written again."""
    chunks = _chunks(56, 2, 2, (128,) * (farm_mod.RESULT_POOL_BUFFERS + 3))
    farm = UniformStreamFarm(2, 2, 48000, 44100, chunk_frames=128, device="cpu",
                             device_staging=True)
    kept, copies = [], []
    for c in chunks:
        kept.append(farm.process(c))
        copies.append(kept[-1].copy())
    assert farm._results._out == farm_mod.RESULT_POOL_BUFFERS
    assert all(o.flags.owndata for o in kept[farm_mod.RESULT_POOL_BUFFERS :])
    _same(kept, copies, "kept")
    with pytest.MonkeyPatch.context() as plain:
        plain.setattr(farm_mod, "_on_card", lambda device: False)
        ref = UniformStreamFarm(2, 2, 48000, 44100, chunk_frames=128, device="cpu")
        _same(kept, [ref.process(c) for c in chunks], "reference")


@pytest.mark.parametrize("staging", ["host", "tensor"])
def test_torch_farm_cpu_outputs_do_not_alias(staging):
    """On the CPU every call returns a fresh array: outputs kept to the end
    equal their copies."""
    chunks = _chunks(53, 3, 2, (128,) * 4)
    farm = UniformStreamFarm(3, 2, 44100, 48000, chunk_frames=128, device="cpu",
                             device_staging=staging == "tensor")
    outs, copies = [], []
    for c in chunks:
        outs.append(farm.process(c))
        copies.append(outs[-1].copy())
    _same(outs, copies, staging)


# ---------------------------------------------------------------------------
# Snapshots taken right after process (a slide parked)
# ---------------------------------------------------------------------------

def _finish(farm, chunks):
    return np.concatenate([farm.process(c) for c in chunks] + [farm.flush()], axis=1)


@pytest.mark.parametrize("path", ["cpu", "card"])
def test_torch_farm_snapshot_right_after_process_restores_in_both_packages(path, request):
    """A farm saved right after ``process`` holds a parked slide; its
    snapshot has the slide applied, restores in the port (tensor and host
    staging) and in the JAX package, and every restored farm continues bit
    for bit with the farm that ran on."""
    if path == "card":
        request.getfixturevalue("card")
    chunks = _chunks(54, 64, 2, (300, 300, 300))
    a = UniformStreamFarm(64, 2, 48000, 44100, chunk_frames=300, device="cpu",
                          device_staging=True)
    a.process(chunks[0])
    assert a._programs[0][3].slide > 0
    snap = ckpt.save_farm(a)
    np.testing.assert_array_equal(snap["staging"][: a._fill, :128],
                                  a._staging[: a._fill].numpy())
    assert not snap["staging"][a._fill :].any()
    restored = ckpt.load_farm(snap, device="cpu")
    assert not restored._device_staging
    on_tensor = ckpt.load_farm(snap, mesh=make_mesh(dp=1, devices=["cpu"]))
    assert on_tensor._device_staging and len(on_tensor._programs) == 1
    in_jax = jckpt.load_farm(dict(snap, interpret=True, device_staging=False))
    want = _finish(a, chunks[1:])
    for name, farm in (("host", restored), ("tensor", on_tensor), ("jax", in_jax)):
        np.testing.assert_array_equal(_finish(farm, chunks[1:]), want, err_msg=name)


def test_torch_sharded_farm_snapshot_right_after_process(card):
    """The sharded farm's snapshot right after ``process`` is the unsharded
    farm's, and restores onto a mesh."""
    chunks = _chunks(55, 6, 2, (200, 200))
    mesh = make_mesh(dp=4, devices=["cpu"] * 4)
    sharded = ShardedStreamFarm(mesh, 6, 2, 44100, 48000, chunk_frames=200)
    plain = UniformStreamFarm(6, 2, 44100, 48000, chunk_frames=200, device="cpu",
                              device_staging=True)
    sharded.process(chunks[0])
    plain.process(chunks[0])
    snap = ckpt.save_farm(sharded)
    np.testing.assert_array_equal(snap["staging"], ckpt.save_farm(plain)["staging"])
    restored = ckpt.load_farm(snap, mesh=mesh)
    want = _finish(plain, chunks[1:])
    np.testing.assert_array_equal(_finish(sharded, chunks[1:]), want)
    np.testing.assert_array_equal(_finish(restored, chunks[1:]), want)


# ---------------------------------------------------------------------------
# The launchers' checks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("granule", [1, 2, 3, 6, 16, 100, 129, 1000, 4096])
def test_torch_farm_tile_shapes(granule):
    """A tile is an even count of streams of about 128 lanes and as many
    frames as keep it within 32 x 256 samples."""
    streams, frames = _build.farm_tile(granule)
    assert streams >= 2 and streams % 2 == 0 and frames >= 1
    assert streams * granule <= max(_build.FARM_TILE_LANES, 2 * granule)
    assert streams * granule * frames <= 2 * _build.FARM_TILE_LANES * _build.FARM_TILE_FRAMES
    assert 4 * (frames * (streams * granule | 1)) <= 48 * 1024


def test_torch_farm_launchers_refuse_what_the_kernels_cannot_take():
    """The launchers never fall back: CPU tensors are refused before any
    build; with the device check stood aside, so are bad geometry, a chunk
    of another type and a stream range past the lanes."""
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    src, dst, chunk = i32(40, 8), i32(40, 8), torch.zeros((4, 10, 2), dtype=torch.int16)
    kw = dict(streams=4, channels=2, n_in=10, keep=5, consumed=3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.farm_stage(src, dst, chunk, **kw)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.farm_unstage(i32(16, 8), i32(64), n_out=8, channels=2, stream_lo=0, streams=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "_check_cuda", lambda x: None)
        mp.setattr(_build, "_stream", lambda x: 0)
        args = _build.farm_stage_args(src, dst, chunk, **kw)
        assert (args["capacity"], args["path"], args["tile_streams"]) == (40, 1, 64)
        assert _build.farm_stage_args(src, src, chunk, **dict(kw, consumed=0))["src"] == args["src"]
        for bad in (dict(kw, consumed=2, keep=39), dict(kw, keep=35), dict(kw, streams=3),
                    dict(kw, n_in=-1)):
            with pytest.raises(ValueError, match="bad farm stage"):
                _build.farm_stage_args(src, dst, chunk, **bad)
        with pytest.raises(ValueError, match="bad farm stage"):
            _build.farm_stage_args(src, src, chunk, **kw)       # in place with rows consumed
        with pytest.raises(ValueError, match="contiguous int16"):
            _build.farm_stage_args(src, dst, chunk.to(torch.int32), **kw)
        with pytest.raises(ValueError, match="channels"):
            _build.farm_stage_args(src, dst, chunk, **dict(kw, channels=0))
        lanes = i32(16, 8)
        un = _build.farm_unstage_args(lanes, 4096, n_out=9, channels=2, stream_lo=1, streams=3)
        assert (un["words"], un["out_s16"], un["L"]) == (1, 0, 8)
        odd = _build.farm_unstage_args(lanes.to(torch.int16)[:, :3].contiguous(), 4096, n_out=9,
                                       channels=3, stream_lo=0, streams=1)
        assert (odd["words"], odd["out_s16"]) == (0, 1)
        with pytest.raises(ValueError, match="bad farm unstage"):
            _build.farm_unstage_args(lanes, 4096, n_out=9, channels=2, stream_lo=2, streams=3)
        with pytest.raises(ValueError, match="bad farm unstage"):
            _build.farm_unstage_args(lanes, 4096, n_out=17, channels=2, stream_lo=0, streams=4)
        with pytest.raises(ValueError, match="int32 or int16"):
            _build.farm_unstage_args(lanes.to(torch.int64), 4096, n_out=9, channels=2,
                                     stream_lo=0, streams=4)


# ---------------------------------------------------------------------------
# On a card: the kernels against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,c", SHAPES + [(1024, 2), (7, 6), (3, 200)])
def test_torch_cuda_farm_stage_matches_reference(cuda_device, b, c):
    """A slide into the other buffer, an in-place append, a chunk of length
    0 and a chunk to the capacity's end, from buffers full of other values."""
    gen = torch.Generator(device="cuda").manual_seed(60 + b + c)
    capacity, lanes = 150, b * c
    rand = lambda *shape: torch.randint(-32768, 32768, shape, generator=gen, dtype=torch.int32,
                                        device=cuda_device)
    for n, keep, consumed, in_place in ((70, 23, 41, False), (33, 50, 0, True), (0, 9, 100, False),
                                        (100, 50, 2, False), (1, 0, 0, True)):
        src = rand(capacity, lanes)
        dst = src if in_place else rand(capacity, lanes)
        chunk = rand(b, n, c).to(torch.int16)
        want_src = src.clone()
        want = want_src if in_place else dst.clone()
        farm_stage_reference(want_src, want, chunk, keep=keep, consumed=consumed)
        rs.ROUTES.clear()
        farm_stage(src, dst, chunk, keep=keep, consumed=consumed)
        assert rs.ROUTES == {("farm_stage", "cuda"): 1}
        assert torch.equal(dst, want), (n, keep, consumed, in_place)
        assert in_place or torch.equal(src, want_src)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int32, torch.int16], ids=["int32", "int16"])
@pytest.mark.parametrize("b,c", SHAPES + [(1024, 2), (7, 6), (3, 200)])
def test_torch_cuda_farm_unstage_matches_reference(cuda_device, b, c, dtype):
    """Whole farms and stream ranges, odd frame counts, into the card's
    memory and into pinned host memory."""
    gen = torch.Generator(device="cuda").manual_seed(70 + b + c)
    for n_out in (1, 37, 96):
        lanes = torch.randint(-32768, 32768, (n_out + 3, b * c), generator=gen,
                              dtype=torch.int32, device=cuda_device).to(dtype)
        for lo, hi in ((0, b), (b // 3, b - b // 4)):
            if hi <= lo:
                continue
            want = farm_unstage_reference(lanes, n_out, c, lo, hi - lo)
            rs.ROUTES.clear()
            got = farm_unstage(lanes, n_out, c, lo, hi - lo)
            assert rs.ROUTES == {("farm_unstage", "cuda"): 1}
            assert got.dtype == dtype and torch.equal(got, want), (n_out, lo, hi)
            pinned = torch.full((want.numel() + 4,), -5, dtype=dtype).pin_memory()
            farm_unstage(lanes, n_out, c, lo, hi - lo, out=pinned)
            torch.cuda.synchronize()
            assert torch.equal(pinned[: want.numel()], want.cpu().view(-1))
            assert (pinned[want.numel() :] == -5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("clamp", [False, True], ids=["int32", "clamp_s16"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_torch_cuda_farm_matches_cpu_farm(cuda_device, engine, clamp):
    """The farm on the card, unsharded and on a four-shard mesh of it,
    against the CPU farm: outputs kept to the end, a snapshot right after a
    call restored on the card."""
    rates = ENGINES[engine]
    chunk = 2048 if engine == "wide" else 256
    sizes = tuple(s * chunk // 256 for s in SIZES)
    chunks = _chunks(80, 37, 2, sizes)
    kw = dict(chunk_frames=chunk, clamp_s16=clamp)
    want = _run(UniformStreamFarm(37, 2, *rates, device="cpu", **kw), chunks)
    rs.ROUTES.clear()
    farm = UniformStreamFarm(37, 2, *rates, device=cuda_device, **kw)
    got = [farm.process(c) for c in chunks[:2]]
    restored = ckpt.load_farm(ckpt.save_farm(farm), device=cuda_device)
    tail = [restored.process(c) for c in chunks[2:]] + [restored.flush()]
    got += [farm.process(c) for c in chunks[2:]] + [farm.flush()]
    _same(got, want, engine)
    _same(tail, want[2:], f"{engine} restored")
    assert set(rs.ROUTES) == {("farm_stage", "cuda"), ("farm_unstage", "cuda"), (engine, "cuda"),
                              ("farm_input", "direct")}
    mesh = make_mesh(dp=4, devices=[cuda_device] * 4)
    _same(_run(ShardedStreamFarm(mesh, 37, 2, *rates, **kw), chunks), want, f"{engine} sharded")
