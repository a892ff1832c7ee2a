"""The fused scan's tiled and general steps read straight from the chunks.

On a card a tiled or general ``resample_scan_fused`` step is one scan-mode
launch of tiled_mac_kernel: its window rows come from the (K, n_in, L) chunks
read as one stream -- step k's staged buffer is stream rows [k*n_in - 2r,
(k+1)*n_in) with zeros before the stream and past the chunk -- and its
bookkeeping is folded into the launch. On the CPU, with inputs made from a
numpy seed, this file holds the plain versions of that step
(``scan_stream_rows_reference``, ``scan_inplace_step_reference``) and the
program with its C entry stood in against the JAX package's
``resample_scan_fused`` (Pallas in interpret mode) and the staged plain
version (a staged [halo | chunk] buffer + the engine), with exact equality
of outputs, produced, backlog and the final state. The ``cuda`` tests run
the kernel against its plain version on a card. The strided and wide
engines' scan modes have theirs in
tests/test_torch_scan_inplace_strided_wide.py.
"""

import numpy as np
import pytest
import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch import lowlevel
from clownresampler_tpu_torch.configure import configure
from clownresampler_tpu_torch.lowlevel import (
    ScanProgram,
    make_device_state,
    resample_scan_fused,
    scan_inplace_step,
    scan_inplace_step_reference,
    scan_stream_rows_reference,
)
from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.ops.convolve import ConfigScalars
from tests import oracle
from tests.test_torch_scan_program import (
    ENGINES,
    _assert_same,
    _bookkeeping_int64,
    _case,
    _composed,
    _jax,
    _kernel_step_int64,
    _plain,
    _program,
    _reference,
    _scan_args,
)

INPLACE = ["tiled", "general"]
DTYPES = [np.int16, np.int32]
DTYPE_IDS = ["int16", "int32"]


def _stepped(c):
    """The scan as one scan_inplace_step a step (on the CPU its plain
    version), the state carried between steps."""
    chunks = torch.from_numpy(c["chunks"]).to(c["device"])
    cfg, r = c["state"].cfg, c["r"]
    state = torch.stack([c["state"].position_integer + r, c["state"].position_fractional])
    outs, produced, over = [], [], []
    for k in range(chunks.shape[0]):
        out, prod, ov, state = scan_inplace_step(
            c["table"], chunks, k, state, cfg, radius=r, max_taps=c["taps"], n_out=c["n_out"],
            increment=c["inc"], table_strided=c["tstr"])
        outs.append(out)
        produced.append(prod)
        over.append(ov)
    return _plain((torch.stack(outs), torch.stack(produced),
                   lowlevel.DeviceState(state[0] - r, state[1], cfg), torch.stack(over).any()))


def _all_plain_versions(c, want, what):
    _assert_same(_reference(c), want, f"{what}: fused reference")
    _assert_same(_stepped(c), want, f"{what}: scan_inplace_step_reference")
    _assert_same(_composed(c), want, f"{what}: staged plain version")


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's fused scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where", ["below", "at", "above"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("engine", INPLACE)
def test_torch_scan_inplace_one_chunk_matches_jax_fused(engine, dtype, where):
    """K = 1 chunk and the zero flush, n_in below, at and above 2*radius
    (tiled r = 4, general r = 17): step 0's window is the zero halo, the
    chunk and the zero rows, the flush's reaches back into the chunk (and,
    below 2*radius, before the stream)."""
    r = {"tiled": 4, "general": 17}[engine]
    n_in = {"below": r, "at": 2 * r, "above": 96}[where]
    c = _case(ENGINES[engine], n_in=n_in, k=1, seed=301, dtype=dtype, f0=0x2468)
    assert c["r"] == r and lowlevel._scan_engine(c["inc"], c["taps"], c["n_out"])[0] == engine
    want = _jax(c)
    assert want[1].sum() > 0
    _all_plain_versions(c, want, f"{engine} n_in {n_in}")


@pytest.mark.parametrize("engine,n_in", [("general", 16), ("general", 34), ("tiled", 3)])
def test_torch_scan_inplace_halo_over_several_chunks_matches_jax_fused(engine, n_in):
    """n_in <= 2*radius over K = 5 chunks and the flush: step k's window
    reaches back over several chunks and, at k = 0, before the stream."""
    c = _case(ENGINES[engine], n_in=n_in, k=5, seed=302, f0=0x8421)
    assert n_in <= 2 * c["r"]
    _all_plain_versions(c, _jax(c), f"{engine} n_in {n_in}")


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("lanes", [6, 10])
@pytest.mark.parametrize("engine", INPLACE)
def test_torch_scan_inplace_odd_lanes_match_jax(engine, lanes, dtype):
    """Lanes that are no multiple of 8 (the kernel's 4-byte and element
    copies), against the JAX package's oracle scan, which its fused scan is
    held to (its Pallas engines take lanes in multiples of 128)."""
    c = _case(ENGINES[engine], lanes=lanes, n_in=64, k=3, seed=303, dtype=dtype, f0=0x1357)
    _all_plain_versions(c, _jax(c, fused=False), f"{engine} {lanes} lanes")


def test_torch_scan_inplace_backlog_matches_jax_fused():
    """8k -> 44.1k (tiled, d = 0) at half the proper n_out: every step is
    over, produced stops at n_out and the backlog flag is raised."""
    full = _case((8000, 44100), n_in=128, seed=304)
    c = _case((8000, 44100), n_in=128, seed=304, n_out=fx.round_up(full["n_out"] // 2, 128))
    want = _jax(c)
    assert want[4] and want[1].max() == c["n_out"]
    _all_plain_versions(c, want, "backlog")


def _golden_case(device="cpu"):
    """The fixture's first 8192 stereo frames as 8 int16 chunks, 44.1k -> 8k."""
    pcm = oracle.pcm_fixture()[:8192]
    cfg = configure(44100, 8000, 44100)
    inc = fx.calculate_ratio(44100, 8000)
    r = cfg.integer_stretched_kernel_radius
    taps = fx.round_up(2 * r, 8)
    dev = torch.device(device)
    return dict(chunks=np.ascontiguousarray(pcm.reshape(8, 1024, 2)), inc=inc, r=r, taps=taps,
                n_out=fx.round_up(((1024 + 2 * r) << 16) // inc + 16, 8),
                state=make_device_state(0, 0, cfg, inc, dev),
                table=table_tensor(DEFAULT_MODEL.table(), dev), tstr=None, device=dev)


def test_torch_scan_inplace_reproduces_golden_prefix(monkeypatch):
    """The golden fixture through the step's plain version and through the
    program with its C entry stood in: everything the scan emits equals the
    C golden's prefix (the scan holds back a radius tail)."""
    c = _golden_case()
    golden = oracle.golden("golden_44100_8000.raw").reshape(-1, 2)
    stepped = _stepped(c)
    got = np.concatenate([stepped[0][i, : stepped[1][i]] for i in range(8)])
    np.testing.assert_array_equal(got, golden[: got.shape[0]])
    assert got.shape[0] > 1200
    program_result, calls, _ = _program(c, monkeypatch)
    _assert_same(program_result, stepped, "stood-in program")
    assert {a["copy"] for _, a in calls} == {_build.SCAN_COPY_WORDS}


# ---------------------------------------------------------------------------
# The stream window and the folded bookkeeping
# ---------------------------------------------------------------------------

def test_torch_scan_stream_rows_are_the_staged_buffer():
    """scan_stream_rows_reference equals the staged [halo | chunk | zeros]
    buffer the staged plain version builds step by step, for n_in below and
    above 2*radius; rows past the step's chunk are zero although the next
    chunk follows in memory."""
    rng = np.random.default_rng(305)
    for n_in, r in ((5, 7), (3, 3), (40, 7)):
        chunks = torch.from_numpy(rng.integers(1, 30000, size=(6, n_in, 3)).astype(np.int16))
        prev = torch.zeros((2 * r + n_in + 9, 3), dtype=torch.int32)
        for k in range(6):
            got = scan_stream_rows_reference(chunks, k, r, 9)
            staged = torch.cat([prev[n_in : n_in + 2 * r], chunks[k].to(torch.int32)])
            assert got.dtype == torch.int32 and got.shape == (2 * r + n_in + 9, 3)
            assert torch.equal(got[: 2 * r + n_in], staged) and not got[2 * r + n_in :].any()
            prev = torch.cat([staged, torch.zeros((9, 3), dtype=torch.int32)])


@pytest.mark.parametrize("seed", range(5))
def test_torch_scan_inplace_bookkeeping_equals_int64_form(seed):
    """100 random states a seed over the domain the scan admits: the
    kernel's folded bookkeeping (int64) equals the staged plain version's
    int64 form and the port's int32 step scalars (lowlevel._step_scalars,
    which the plain step returns)."""
    rng = np.random.default_rng(950 + seed)
    for trial in range(100):
        n_in = int(rng.integers(1, 1 << 14))
        n_out = 8 * int(rng.integers(1, (1 << 14) // 8 + 1))
        inc = (fx.calculate_ratio(*((48000, 44100), (44100, 8000), (8000, 44100))[trial % 3])
               if trial % 2 else int(rng.integers(1, 1 << 28)))
        p = int(rng.integers(0, 2 * n_in + 40)) if trial % 5 else int(rng.integers(0, 40))
        f = int(rng.integers(0, 1 << 16))
        want = _kernel_step_int64(p, f, inc, n_in, n_out)
        staged = _bookkeeping_int64(p, f, inc, n_in, n_out, n_out)
        assert want == (staged[0], staged[1], staged[3])
        cfg = ConfigScalars.from_fields((0, 0, 0, 0, inc & 0x7FFFFFFF, *fx.split_increment(inc)),
                                        "cpu")
        natural, produced, nxt = lowlevel._step_scalars(
            torch.tensor(p, dtype=torch.int32), torch.tensor(f, dtype=torch.int32), cfg, n_in,
            n_out)
        assert all(t.dtype == torch.int32 for t in (natural, produced, nxt))
        assert (int(produced), int(natural > n_out), nxt.tolist()) == want, (p, f, inc, n_in,
                                                                             n_out)


# ---------------------------------------------------------------------------
# The C entry's arguments: window, base pointer and copy path
# ---------------------------------------------------------------------------

def test_torch_scan_copy_path():
    """16-byte copies where every row and the stream start on 16 bytes, 4-byte
    where on 4, else element loads."""
    path = _build.scan_copy_path
    assert path(elem_bytes=2, lanes=2048, ptr=1 << 20) == _build.SCAN_COPY_VEC
    assert path(elem_bytes=4, lanes=4, ptr=64) == _build.SCAN_COPY_VEC
    assert path(elem_bytes=2, lanes=6, ptr=64) == _build.SCAN_COPY_WORDS
    assert path(elem_bytes=2, lanes=2048, ptr=68) == _build.SCAN_COPY_WORDS
    assert path(elem_bytes=4, lanes=6, ptr=64) == _build.SCAN_COPY_WORDS
    assert path(elem_bytes=4, lanes=8, ptr=4) == _build.SCAN_COPY_WORDS
    assert path(elem_bytes=2, lanes=5, ptr=64) == _build.SCAN_COPY_ELEMENTS
    assert path(elem_bytes=2, lanes=2048, ptr=66) == _build.SCAN_COPY_ELEMENTS


def _offset_chunks(c, offset):
    """The case's chunks as a contiguous view ``offset`` elements into a
    16-byte aligned buffer."""
    data = torch.from_numpy(c["chunks"])
    flat = torch.zeros(data.numel() + 8, dtype=data.dtype)
    assert flat.data_ptr() % 16 == 0
    view = flat[offset : offset + data.numel()].view(data.shape)
    view.copy_(data)
    return view


@pytest.mark.parametrize("dtype,lanes,offset,copy", [
    (np.int16, 8, 0, _build.SCAN_COPY_VEC), (np.int16, 6, 0, _build.SCAN_COPY_WORDS),
    (np.int16, 5, 0, _build.SCAN_COPY_ELEMENTS), (np.int16, 8, 2, _build.SCAN_COPY_WORDS),
    (np.int16, 8, 1, _build.SCAN_COPY_ELEMENTS), (np.int32, 8, 0, _build.SCAN_COPY_VEC),
    (np.int32, 6, 0, _build.SCAN_COPY_WORDS), (np.int32, 8, 1, _build.SCAN_COPY_WORDS)],
    ids=["s16-vec", "s16-words", "s16-elements", "s16-off4", "s16-off2", "s32-vec",
         "s32-words", "s32-off4"])
def test_torch_scan_inplace_argument_flow(monkeypatch, dtype, lanes, offset, copy):
    """The program over chunks at an offset from 16 bytes, its C entry stood
    in: its one launch reads the stream at the chunks' own address (never
    offset before it), with step 0's window [-2r, n_in) -- step k's is that
    shifted by k*n_in --, the copy path the host picked, the request's
    steps and the bases of its state, output and bookkeeping arrays; the
    result is the plain version's."""
    c = _case(ENGINES["general"], lanes=lanes, n_in=24, k=3, seed=306, dtype=dtype, f0=0x0F0F)
    chunks = _offset_chunks(c, offset)
    got, calls, program = _program(c, monkeypatch, chunks=chunks)
    _assert_same(got, _reference(c), f"{dtype} {lanes} lanes offset {offset}")
    k, n_in, r = chunks.shape[0], chunks.shape[1], c["r"]
    assert program.chunks.data_ptr() == chunks.data_ptr()
    (a,) = (a for _, a in calls)
    assert (a["src"], a["src_first"], a["src_end"], a["copy"], a["S"], a["steps"]) == (
        chunks.data_ptr(), -2 * r, n_in, copy, 2 * r + n_in + c["taps"] + 8, k)
    book = program.states.data_ptr()
    assert (a["state_in"] - book, a["state_out"] - book) == (0, 8)
    assert (a["out"], a["produced"], a["over"]) == (
        program.outputs.data_ptr(), program.produced.data_ptr(), program.over.data_ptr())
    assert a["vec"] == int(lanes % 4 == 0)
    assert not hasattr(program, "buffers")


@pytest.mark.parametrize("engine", INPLACE)
def test_torch_scan_stage_plan_sizes_each_stage_to_its_window(engine):
    """The scan's plan holds exactly the window its frames reach at the
    scan's own increment, the most frames whose two stages fit two blocks'
    share of shared memory; int16 rows take half the bytes, so a stage holds
    at least as many frames as with int32 rows; the kernel takes the planned
    frames (stage_frames)."""
    c = _case(ENGINES[engine], n_in=256, k=1)
    for elem in (2, 4):
        frames, rows = rs.scan_stage_plan(c["taps"], c["inc"], elem)
        assert rows == rs.stage_window_rows(c["inc"], frames, c["taps"])
        assert rs.stage_frames(c["inc"], frames, c["taps"], rows) == frames
        assert _build.tiled_shared_bytes(frames, rows, c["taps"], elem) <= rs.TILED_SHARED_BUDGET
        if frames < 64:
            more = rs.stage_window_rows(c["inc"], 2 * frames, c["taps"])
            assert (_build.tiled_shared_bytes(2 * frames, more, c["taps"], elem)
                    > rs.TILED_SHARED_BUDGET)
    assert rs.scan_stage_plan(c["taps"], c["inc"], 2)[0] >= rs.scan_stage_plan(
        c["taps"], c["inc"], 4)[0]
    # Config 7's step: 16 frames of 123 int16 rows, where the general entry's
    # int32 stage of 107 rows takes 8; a window too wide for any stage is read
    # from the chunks directly.
    inc7 = fx.calculate_ratio(44100, 8000)
    assert rs.scan_stage_plan(40, inc7, 2) == (16, 123)
    assert rs.stage_frames(inc7, *rs.stage_plan(40, rs.GENERAL_MIN_INCREMENT)[:1], 40, 107) == 8
    assert rs.scan_stage_plan(248, fx.calculate_ratio(44100, 1100), 2) == (8, 0)


def test_torch_scan_inplace_step_on_the_cpu_is_the_plain_version():
    """On CPU tensors scan_inplace_step is its plain version, counted as
    such under its engine's scan route, for every engine."""
    c = _case(ENGINES["general"], lanes=4, n_in=64, k=2, seed=307)
    chunks = torch.from_numpy(c["chunks"])
    state = torch.tensor([c["r"] + 1, 0x4444], dtype=torch.int32)
    kw = dict(radius=c["r"], max_taps=c["taps"], n_out=c["n_out"], increment=c["inc"])
    rs.ROUTES.clear()
    got = scan_inplace_step(c["table"], chunks, 1, state, c["state"].cfg, **kw)
    assert rs.ROUTES == {("scan_inplace", "reference"): 1}
    want = scan_inplace_step_reference(c["table"], chunks, 1, state, c["state"].cfg, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    for engine in ("strided", "wide"):
        s = _case(ENGINES[engine], lanes=4, n_in=512, k=1)
        kw = dict(radius=s["r"], max_taps=s["taps"], n_out=s["n_out"], increment=s["inc"])
        args = (s["table"], torch.from_numpy(s["chunks"]), 1,
                torch.tensor([s["r"] + 3, 0x1357], dtype=torch.int32), s["state"].cfg)
        rs.ROUTES.clear()
        got = scan_inplace_step(*args, **kw)
        assert rs.ROUTES == {(lowlevel.SCAN_ROUTES[engine], "reference"): 1}
        for g, w in zip(got, scan_inplace_step_reference(*args, **kw)):
            assert g.dtype == torch.int32 and torch.equal(g, w)


def test_torch_tiled_scan_launcher_refuses_what_the_kernel_cannot_take():
    """The scan-mode launcher never falls back: CPU tensors are refused
    before any build; with the device check stood aside, so are chunks of
    another type, non-contiguous chunks, a step outside the chunks and
    bookkeeping tensors of the wrong size."""
    c = _case(ENGINES["general"], lanes=8, n_in=64, k=2)
    chunks = torch.from_numpy(c["chunks"])
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    outs = (i32(c["n_out"], 8), i32(1), i32(1), i32(2))
    kw = dict(radius=c["r"], max_taps=c["taps"], frames_per_stage=16, win_rows=100)
    args = (c["table"], None, i32(2), c["state"].cfg)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.tiled_scan(chunks, *args, *outs, step=0, **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "_check_cuda", lambda x: None)
        mp.setattr(_build, "_stream", lambda x: 0)
        got = _build.tiled_scan_args(chunks, *args, *outs, step=2, **kw)
        assert (got["src_first"], got["src_end"], got["src_s16"]) == (128 - 2 * c["r"], 192, 1)
        with pytest.raises(ValueError, match="int16 or int32"):
            _build.tiled_scan_args(chunks.to(torch.int64), *args, *outs, step=0, **kw)
        with pytest.raises(ValueError, match="contiguous"):
            _build.tiled_scan_args(chunks.transpose(1, 2), *args, *outs, step=0, **kw)
        with pytest.raises(ValueError, match="bad scan step"):
            _build.tiled_scan_args(chunks, *args, *outs, step=3, **kw)
        with pytest.raises(ValueError, match="must have 2 elements"):
            _build.tiled_scan_args(chunks, c["table"], None, i32(3), c["state"].cfg, *outs,
                                   step=0, **kw)
        with pytest.raises(ValueError, match="shared memory"):
            _build.tiled_scan_args(chunks, *args, *outs, step=0,
                                   **dict(kw, win_rows=1000))
        # Several steps: (steps, n_out, L) outputs and bookkeeping of as many;
        # steps past the three chunks refused.
        many = (i32(2, c["n_out"], 8), i32(2), i32(2), i32(4))
        got = _build.tiled_scan_args(chunks, *args, *many, step=0, **kw)
        assert (got["steps"], got["N"], got["src_first"]) == (2, c["n_out"], -2 * c["r"])
        with pytest.raises(ValueError, match="bad scan step"):
            _build.tiled_scan_args(chunks, *args, *many, step=2, **kw)
        with pytest.raises(ValueError, match="must have 4 elements"):
            _build.tiled_scan_args(chunks, *args, *many[:3], i32(2), step=0, **kw)


# ---------------------------------------------------------------------------
# On a card: the scan mode against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("engine,dtype,lanes,n_in,offset", [
    ("general", torch.int16, 2048, 512, 0), ("general", torch.int32, 300, 512, 0),
    ("general", torch.int16, 6, 16, 0), ("general", torch.int16, 5, 64, 0),
    ("general", torch.int16, 512, 256, 2), ("tiled", torch.int16, 512, 3, 0),
    ("tiled", torch.int32, 8, 256, 1)])
def test_torch_cuda_scan_inplace_step_matches_plain(cuda_device, engine, dtype, lanes, n_in,
                                                     offset):
    """Each step of a scan (step 0, the later ones and the flush) through
    the kernel's scan mode against its plain version on the same inputs:
    outputs, produced, over and the next state, exact."""
    c = _case(ENGINES[engine], lanes=lanes, n_in=n_in, k=3, seed=308, f0=0x3C3C,
              device=cuda_device)
    data = torch.from_numpy(c["chunks"]).to(cuda_device, dtype)
    flat = torch.zeros(data.numel() + 8, dtype=dtype, device=cuda_device)
    chunks = flat[offset : offset + data.numel()].view(data.shape)
    chunks.copy_(data)
    state = torch.tensor([c["r"] + 2, 0x1234], dtype=torch.int32, device=cuda_device)
    kw = dict(radius=c["r"], max_taps=c["taps"], n_out=c["n_out"], increment=c["inc"],
              table_strided=c["tstr"])
    for k in range(chunks.shape[0]):
        got = scan_inplace_step(c["table"], chunks, k, state, c["state"].cfg, **kw)
        want = scan_inplace_step_reference(c["table"], chunks, k, state, c["state"].cfg, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (k, engine, lanes)
        state = want[3]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", INPLACE)
def test_torch_cuda_scan_inplace_program_matches_reference(cuda_device, engine):
    """The whole program on the card: one scan-mode launch a request,
    nothing staged, against the plain scan."""
    c = _case(ENGINES[engine], lanes=1000, n_in=200, k=4, seed=309, f0=0x5A5A,
              device=cuda_device)
    chunks = torch.from_numpy(c["chunks"]).to(cuda_device)
    rs.ROUTES.clear()
    got = _plain(resample_scan_fused(c["table"], chunks, c["state"],
                                     max_taps=c["taps"], n_out=c["n_out"], radius=c["r"],
                                     increment=c["inc"], table_strided=c["tstr"]))
    assert rs.ROUTES == {("scan_inplace", "cuda"): 1}
    _assert_same(got, _reference(c), engine)
    program = ScanProgram(c["table"], chunks, c["state"], max_taps=c["taps"], n_out=c["n_out"],
                          radius=c["r"], increment=c["inc"], table_strided=c["tstr"])
    assert program.kind == engine and not hasattr(program, "buffers")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("rates,lanes,n_in,k,backlog", [
    (ENGINES["tiled"], 2048, 1024, 6, False),         # many tiles a step
    (ENGINES["general"], 300, 512, 4, False),
    (ENGINES["tiled"], 5, 256, 3, False),             # odd lanes
    ((8000, 44100), 64, 128, 4, True),                # a backlog
    (ENGINES["general"], 6, 16, 5, False),            # n_in < 2r
    (ENGINES["general"], 128, 512, 1, False),         # K = 1
    (ENGINES["tiled"], 128, 64, 600, False),          # 2 tiles a step: blocks skip steps
], ids=["wide-steps", "general", "odd-lanes", "backlog", "short-chunks", "k1", "tiny-steps"])
def test_torch_cuda_scan_one_launch_matches_steps(cuda_device, rates, lanes, n_in, k, backlog,
                                                   dtype):
    """A tiled or general request as one scan-mode launch against the same
    steps as K one-step launches (scan_inplace_step, each from the state the
    previous one wrote) and against the plain version: every output sample,
    each step's produced, over and next state, exact."""
    c = _case(rates, lanes=lanes, n_in=n_in, k=k, flush=k > 1, seed=310, dtype=dtype,
              f0=0x2D2D, device=cuda_device)
    if backlog:
        c = dict(c, n_out=fx.round_up(c["n_out"] // 2, 8))
    assert lowlevel._scan_engine(c["inc"], c["taps"], c["n_out"])[0] in lowlevel.WHOLE_SCAN_KINDS
    chunks = torch.from_numpy(c["chunks"]).to(cuda_device)
    program = ScanProgram(c["table"], chunks, c["state"], **_scan_args(c))
    rs.ROUTES.clear()
    program.run()
    assert rs.ROUTES == {("scan_inplace", "cuda"): 1}
    state = program.states[0].clone()
    for j in range(chunks.shape[0]):
        out, prod, over, state = scan_inplace_step(
            c["table"], chunks, j, state, c["state"].cfg, radius=c["r"], max_taps=c["taps"],
            n_out=c["n_out"], increment=c["inc"], table_strided=c["tstr"])
        assert torch.equal(program.outputs[j], out), j
        assert (int(program.produced[j]), int(program.over[j])) == (int(prod), int(over)), j
        assert torch.equal(program.states[j + 1], state), j
    got = _plain(program.result())
    assert got[4] == backlog
    _assert_same(got, _reference(c), (rates, lanes, n_in, k))
