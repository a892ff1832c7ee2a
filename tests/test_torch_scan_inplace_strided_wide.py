"""The fused scan's strided and wide steps read straight from the chunks.

On a card a strided ``resample_scan_fused`` step is one scan-mode launch of
strided_mac_kernel (C entry crt_strided_scan) and a wide step one launch of
wide_mac_kernel and its fold per launch offset (crt_wide_scan): each reads
its window rows from the (K, n_in, L) chunks read as one stream -- step k's
staged buffer is stream rows [k*n_in - 2r, (k+1)*n_in) with zeros before the
stream and past the chunk -- and derives its launch state and the step's
bookkeeping from the step's state; no staging buffer exists. On the CPU,
with inputs made from a numpy seed, this file holds the plain versions of
those steps (``scan_inplace_step_reference``, through ``scan_inplace_step``),
the plain fused scan and the staged composition against the JAX package's
``resample_scan_fused`` (Pallas in interpret mode) or, for lane counts its
Pallas engines do not take, its oracle scan, with exact equality; the
bookkeeping with a frame offset in exact integers against the port's int32
functions; the strided stage plan by element size; and the program and the
launchers with the C entries stood in over the same pointers. The ``cuda``
tests run the scan modes against their plain versions on a card.
"""

import numpy as np
import pytest
import torch

from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch import lowlevel
from clownresampler_tpu_torch.lowlevel import (
    ScanProgram,
    resample_scan_fused,
    scan_inplace_step,
    scan_inplace_step_reference,
)
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.ops.convolve import ConfigScalars
from tests.test_torch_scan_inplace import _offset_chunks, _stepped
from tests.test_torch_scan_program import (
    _assert_same,
    _bookkeeping_int64,
    _case,
    _composed,
    _jax,
    _plain,
    _program,
    _reference,
)

STRIDED_D2, STRIDED_D3, WIDE = (96000, 48000), (132300, 44100), (44100, 1000)
DTYPES = [np.int16, np.int32]
DTYPE_IDS = ["int16", "int32"]


def _all_plain_versions(c, want, what):
    _assert_same(_reference(c), want, f"{what}: fused reference")
    _assert_same(_stepped(c), want, f"{what}: scan_inplace_step_reference")
    _assert_same(_composed(c), want, f"{what}: staged plain version")


def _engine(c):
    return lowlevel._scan_engine(c["inc"], c["taps"], c["n_out"])


# ---------------------------------------------------------------------------
# The plain versions against the JAX package's fused scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rates,taps,live", [(STRIDED_D2, None, 12), (STRIDED_D3, None, None),
                                             (STRIDED_D2, 40, 12)],
                         ids=["d2", "d3", "d2-reserve40"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_torch_scan_strided_steps_match_jax_fused(rates, taps, live, dtype):
    """The strided engine at d = 2 and d = 3, and at d = 2 with a 40-tap
    reserve over its 12 live taps, int16 and int32 chunks, two chunks and
    the zero flush."""
    c = _case(rates, lanes=128, n_in=192, k=2, seed=401, dtype=dtype, f0=0, taps=taps)
    kind, d, _, _ = _engine(c)
    assert kind == "strided" and d == rates[0] // rates[1]
    if live:
        assert 2 * c["r"] == live and c["taps"] == (taps or 16)
    want = _jax(c)
    assert want[1].sum() > 0 and not want[4]
    _all_plain_versions(c, want, f"strided {rates} taps {c['taps']}")


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_torch_scan_wide_steps_match_jax_fused(dtype):
    """The wide engine (44.1k -> 1000, 272 taps), int16 and int32 chunks, two
    chunks and the zero flush."""
    c = _case(WIDE, lanes=128, n_in=1024, k=2, seed=402, dtype=dtype, f0=0x2468)
    assert _engine(c)[0] == "wide"
    want = _jax(c)
    assert want[1].sum() > 0
    _all_plain_versions(c, want, f"wide {dtype}")


@pytest.mark.parametrize("engine", ["strided", "wide"])
def test_torch_scan_strided_wide_one_chunk_matches_jax_fused(engine):
    """K = 1 without the flush: the first step's zero halo, the chunk and the
    zero rows, nothing else."""
    c = _case({"strided": STRIDED_D2, "wide": WIDE}[engine], n_in=512, k=1, flush=False,
              seed=403, f0=0x1111)
    want = _jax(c)
    assert want[1].sum() > 0
    _all_plain_versions(c, want, f"{engine} one chunk")


@pytest.mark.parametrize("rates,n_in", [(STRIDED_D2, 5), (STRIDED_D3, 16), (WIDE, 128)],
                         ids=["strided-d2", "strided-d3", "wide"])
def test_torch_scan_strided_wide_chunks_shorter_than_the_halo_match_jax_fused(rates, n_in):
    """n_in < 2*radius over K = 4 chunks and the flush: a step's window
    reaches back over several chunks and, early on, before the stream."""
    c = _case(rates, lanes=128, n_in=n_in, k=4, seed=404, f0=0x8421)
    assert n_in < 2 * c["r"]
    _all_plain_versions(c, _jax(c), f"{rates} n_in {n_in}")


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("lanes", [5, 6])
@pytest.mark.parametrize("engine", ["strided", "wide"])
def test_torch_scan_strided_wide_odd_lanes_match_jax(engine, lanes, dtype):
    """Lanes that are no multiple of 4 (the kernels' 4-byte and element
    copies and per-lane stores), against the JAX package's oracle scan,
    which its fused scan is held to (its Pallas engines take lanes in
    multiples of 128)."""
    c = _case({"strided": STRIDED_D2, "wide": WIDE}[engine], lanes=lanes,
              n_in={"strided": 96, "wide": 512}[engine], k=2, seed=405, dtype=dtype, f0=0x1357)
    _all_plain_versions(c, _jax(c, fused=False), f"{engine} {lanes} lanes")


def test_torch_scan_strided_backlog_matches_jax_fused():
    """96k -> 48k at 64 output frames a step, where 128 are due: the steps
    are over, produced stops at n_out and the backlog flag is raised (the
    JAX package's strided engine takes n_out in multiples of 64)."""
    c = _case(STRIDED_D2, n_in=256, seed=406, n_out=64)
    want = _jax(c)
    assert want[4] and want[1].max() == c["n_out"]
    _all_plain_versions(c, want, "strided backlog")


# ---------------------------------------------------------------------------
# The bookkeeping with a frame offset
# ---------------------------------------------------------------------------

def _launch_int64(p, f, inc, n_in, n_out, offset):
    """mac_common.cuh scan_launch in exact integers, C truncating division:
    (produced, over, next state, the launch's state at ``offset``, the frames
    of the launch that keep their values)."""
    num = (n_in - p) * 65536 - f
    natural = (num + inc - 1) // max(inc, 1) if num > 0 else 0   # num, inc > 0: floor = trunc
    produced = min(natural, n_out)
    t = f + produced * inc
    p_after = p + (t >> 16)
    t_launch = f + offset * inc
    return (produced, int(natural > n_out), [p_after - min(p_after, n_in), t & 0xFFFF],
            [p + (t_launch >> 16), t_launch & 0xFFFF], produced - offset)


@pytest.mark.parametrize("seed", range(5))
def test_torch_scan_launch_bookkeeping_with_offset_equals_int64_form(seed):
    """100 random states a seed over the domain the scan admits (n_in <
    2^14, n_out <= 2^14, fractions below 2^16, real and random increments,
    launch offsets in [0, n_out)): the kernels' int64 bookkeeping at a frame
    offset equals the staged plain version's int64 form and the port's int32
    functions -- the step's scalars (lowlevel._step_scalars) and the launch
    state at the offset (fixedpoint.positions_from_state, as the wide plain
    step derives it)."""
    rng = np.random.default_rng(1200 + seed)
    ratios = [(96000, 48000), (132300, 44100), (44100, 1000), (44100, 262), (529200, 44100)]
    for trial in range(100):
        n_in = int(rng.integers(1, 1 << 14))
        n_out = 8 * int(rng.integers(1, (1 << 14) // 8 + 1))
        step = n_out if trial % 3 else 8 * int(rng.integers(1, n_out // 8 + 1))
        offset = int(rng.integers(0, n_out // step)) * step
        inc = (fx.calculate_ratio(*ratios[trial % len(ratios)]) if trial % 2
               else int(rng.integers(1, 1 << 28)))
        p = int(rng.integers(0, 2 * n_in + 40)) if trial % 5 else int(rng.integers(0, 40))
        f = int(rng.integers(0, 1 << 16))
        want = _launch_int64(p, f, inc, n_in, n_out, offset)
        staged = _bookkeeping_int64(p, f, inc, n_in, n_out, step)
        assert want[:3] == (staged[0], staged[1], staged[3])
        assert want[3] == staged[2][offset // step]
        cfg = ConfigScalars.from_fields((0, 0, 0, 0, inc & 0x7FFFFFFF, *fx.split_increment(inc)),
                                        "cpu")
        i32 = lambda v: torch.tensor(v, dtype=torch.int32)
        natural, produced, nxt = lowlevel._step_scalars(i32(p), i32(f), cfg, n_in, n_out)
        launch = fx.positions_from_state(i32(p), i32(f), cfg.increment_hi, cfg.increment_lo,
                                         offset)
        got = (int(produced), int(natural > n_out), nxt.tolist(), [int(v) for v in launch],
               int(produced) - offset)
        assert got == want, (p, f, inc, n_in, n_out, offset)


# ---------------------------------------------------------------------------
# The strided stage plan by element size
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d,taps", [(2, 16), (2, 40), (3, 24), (12, 152), (4, 1024)])
def test_torch_strided_stage_plan_by_element_size(d, taps):
    """Every frame's window lies inside its stage: a tile of F frames reads
    rows [r0, r0 + (F - 1)*d + taps), whatever r0, and clamping only shortens
    that; the stages fit two blocks' share of shared memory (else the card's
    limit); int16 rows take half the bytes, so a stage holds at least as many
    frames as with int32 rows; a window too wide for any stage reads the
    stream directly (0 rows)."""
    plans = {}
    for elem in (2, 4):
        frames, rows = rs.strided_stage_plan(d, taps, elem)
        plans[elem] = frames, rows
        if rows == 0:
            assert frames == rs.STRIDED_STAGE_FRAMES[-1]
            assert _build.strided_shared_bytes(taps, 7 * d + taps, elem) > _build.MAX_SHARED_BYTES
            continue
        assert rows == (frames - 1) * d + taps
        assert _build.strided_shared_bytes(taps, rows, elem) <= _build.MAX_SHARED_BYTES
        rng = np.random.default_rng(d * taps + elem)
        for _ in range(20):
            r0, s = int(rng.integers(-3 * d, 50)), int(rng.integers(taps, 400))
            first = min(max(r0, 0), s - taps)
            last = min(max(r0 + (frames - 1) * d, 0), s - taps)
            assert first <= last and last + taps - first <= rows
    assert plans[2][0] >= plans[4][0]
    # The int16 stage is half the int32 one's bytes at the same window.
    f4, rows4 = plans[4]
    if rows4:
        header = 4 * (-(-taps // 4) * 4 + 4)
        assert (_build.strided_shared_bytes(taps, rows4, 2) - header) * 2 == (
            _build.strided_shared_bytes(taps, rows4, 4) - header)


def test_torch_strided_scan_plan_at_the_main_path():
    """The 96k -> 48k scan step (16 taps): 32 frames of 78 rows a stage, two
    stages and the taps in 40,016 bytes with int16 rows, where int32 rows
    take 79,952. At 529.2k -> 44.1k (d = 12, 152 taps) int16 rows stage 16
    frames a tile where int32 rows would read the stream directly."""
    assert rs.strided_stage_plan(2, 16, 2) == rs.strided_stage_plan(2, 16, 4) == (32, 78)
    assert _build.strided_shared_bytes(16, 78, 2) == 40016
    assert _build.strided_shared_bytes(16, 78, 4) == _build.strided_shared_bytes(16, 78) == 79952
    assert rs.strided_stage_plan(12, 152, 2) == (16, 332)
    assert rs.strided_stage_plan(12, 152, 4) == (8, 0)


# ---------------------------------------------------------------------------
# The program and the launchers with the C entries stood in
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine,dtype,lanes,offset,copy", [
    ("strided", np.int16, 8, 0, _build.SCAN_COPY_VEC),
    ("strided", np.int16, 6, 0, _build.SCAN_COPY_WORDS),
    ("strided", np.int16, 5, 0, _build.SCAN_COPY_ELEMENTS),
    ("strided", np.int16, 8, 1, _build.SCAN_COPY_ELEMENTS),
    ("strided", np.int32, 8, 1, _build.SCAN_COPY_WORDS),
    ("wide", np.int16, 8, 2, _build.SCAN_COPY_WORDS),
    ("wide", np.int16, 5, 0, _build.SCAN_COPY_ELEMENTS),
    ("wide", np.int32, 4, 0, _build.SCAN_COPY_VEC)],
    ids=["strided-s16-vec", "strided-s16-words", "strided-s16-elements", "strided-s16-off2",
         "strided-s32-off4", "wide-s16-off4", "wide-s16-elements", "wide-s32-vec"])
def test_torch_scan_strided_wide_argument_flow(monkeypatch, engine, dtype, lanes, offset, copy):
    """The program over chunks at an offset from 16 bytes, its C entries stood
    in over the same pointers: each step's launch reads the stream at the
    chunks' own address (never offset before it) with the step's window, the
    copy path the host picked and the step's pointers; no staging buffer is
    allocated and no other entry is called; the result is the plain
    version's."""
    c = _case({"strided": STRIDED_D2, "wide": WIDE}[engine], lanes=lanes,
              n_in={"strided": 40, "wide": 400}[engine], k=3, seed=407, dtype=dtype, f0=0x0F0F)
    chunks = _offset_chunks(c, offset)
    got, calls, program = _program(c, monkeypatch, chunks=chunks)
    _assert_same(got, _reference(c), f"{engine} {dtype} {lanes} lanes offset {offset}")
    k, n_in, r = chunks.shape[0], chunks.shape[1], c["r"]
    entry = {"strided": "crt_strided_scan", "wide": "crt_wide_scan"}[engine]
    assert program.chunks.data_ptr() == chunks.data_ptr()
    assert [name for name, _ in calls] == [entry] * k
    assert [(a["src"], a["src_first"], a["src_end"], a["copy"], a["S"]) for _, a in calls] == [
        (chunks.data_ptr(), s * n_in - 2 * r, (s + 1) * n_in, copy,
         2 * r + n_in + c["taps"] + 8) for s in range(k)]
    book = program.states.data_ptr()
    assert [(a["state_in"] - book, a["state_out"] - book) for _, a in calls] == [
        (8 * s, 8 * (s + 1)) for s in range(k)]
    assert [a["out"] - program.outputs.data_ptr() for _, a in calls] == [
        s * program.outputs[0].nbytes for s in range(k)]
    assert [a["produced"] - program.produced.data_ptr() for _, a in calls] == [
        4 * s for s in range(k)]
    assert {a["vec"] for _, a in calls} == {int(lanes % 4 == 0)}
    assert program.routes == {(lowlevel.SCAN_ROUTES[engine], "cuda"): k}
    assert not hasattr(program, "buffers")
    assert sorted(_build.LIBRARIES) == ["batch", "farm", "resample", "strided", "wide"]
    if engine == "strided":
        frames, rows = rs.strided_stage_plan(2, c["taps"], chunks.element_size())
        assert {(a["d"], a["frames_per_tile"], a["win_rows"]) for _, a in calls} == {
            (2, frames, rows)}
        assert program.scratch is None
    else:
        assert {(a["frame_offset"], a["n_out"], a["N"]) for _, a in calls} == {
            (0, c["n_out"], c["n_out"])}
        assert {a["partial"] for _, a in calls} == {program.scratch.data_ptr()}
        assert program.scratch.numel() == _build.wide_scratch_ints(c["taps"], c["n_out"], lanes)


def test_torch_scan_wide_launches_a_step_on_the_cpu(monkeypatch):
    """Several wide launches a step through scan_inplace_step's plain
    version (wide_launch_frames cut to 24): each launch offset's frames from
    its own launch state equal the one-launch scan's, and the offsets' frames
    past produced are zero."""
    c = _case(WIDE, lanes=8, n_in=4096, k=2, seed=408, f0=0x5A5A)
    want = _reference(c)
    assert want[1].max() > 48
    monkeypatch.setattr(lowlevel, "wide_launch_frames", lambda taps: 24)
    assert lowlevel._scan_engine(c["inc"], c["taps"], c["n_out"])[3] == 24
    _assert_same(_stepped(c), want, "stepped, launches of 24 frames")
    _assert_same(_reference(c), want, "fused reference, launches of 24 frames")
    _assert_same(_composed(c), want, "staged, launches of 24 frames")


def test_torch_strided_wide_scan_launchers_refuse_what_the_kernels_cannot_take():
    """The scan-mode launchers never fall back: CPU tensors are refused
    before any build; with the device check stood aside, so are chunks of
    another type, non-contiguous chunks, a step outside the chunks,
    bookkeeping tensors of the wrong size, stages past the card's shared
    memory, a wide launch past the step's frames and a wide scratch too
    small."""
    c = _case(STRIDED_D2, lanes=8, n_in=64, k=2)
    chunks = torch.from_numpy(c["chunks"])
    i32 = lambda *shape: torch.zeros(shape, dtype=torch.int32)
    outs = (i32(c["n_out"], 8), i32(1), i32(1), i32(2))
    strided = dict(radius=c["r"], max_taps=c["taps"], d=2, frames_per_tile=32, win_rows=78)
    args = (c["table"], i32(2), c["state"].cfg)
    w = _case(WIDE, lanes=8, n_in=512, k=2)
    wchunks = torch.from_numpy(w["chunks"])
    partial = i32(_build.wide_scratch_ints(w["taps"], 64, 8))
    wide = dict(radius=w["r"], max_taps=w["taps"], d=44, n_out=128, frame_offset=64)
    wargs = (w["table"], w["tstr"], i32(2), w["state"].cfg, partial)
    wouts = (i32(64, 8), i32(1), i32(1), i32(2))
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.strided_scan(chunks, *args, *outs, step=0, **strided)
    with pytest.raises(ValueError, match="CUDA tensors"):
        _build.wide_scan(wchunks, *wargs, *wouts, step=0, **wide)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(_build, "_check_cuda", lambda x: None)
        mp.setattr(_build, "_stream", lambda x: 0)
        got = _build.strided_scan_args(chunks, *args, *outs, step=1, **strided)
        assert (got["src_first"], got["src_end"], got["src_s16"]) == (64 - 2 * c["r"], 128, 1)
        assert _build.ordered_args("crt_strided_scan", got)
        with pytest.raises(ValueError, match="int16 or int32"):
            _build.strided_scan_args(chunks.to(torch.int64), *args, *outs, step=0, **strided)
        with pytest.raises(ValueError, match="contiguous"):
            _build.strided_scan_args(chunks.transpose(1, 2), *args, *outs, step=0, **strided)
        with pytest.raises(ValueError, match="bad scan step"):
            _build.strided_scan_args(chunks, *args, *outs, step=3, **strided)
        with pytest.raises(ValueError, match="must have 2 elements"):
            _build.strided_scan_args(chunks, c["table"], i32(3), c["state"].cfg, *outs, step=0,
                                     **strided)
        with pytest.raises(ValueError, match="shared memory"):
            _build.strided_scan_args(chunks, *args, *outs, step=0,
                                     **dict(strided, win_rows=1000))
        with pytest.raises(ValueError, match="bad strided launch"):
            _build.strided_scan_args(chunks, *args, *outs, step=0, **dict(strided, d=0))
        got = _build.wide_scan_args(wchunks, *wargs, *wouts, step=1, **wide)
        assert (got["N"], got["n_out"], got["frame_offset"], got["tstr_rows"]) == (
            64, 128, 64, w["tstr"].shape[0])
        assert _build.ordered_args("crt_wide_scan", got)
        with pytest.raises(ValueError, match="bad wide scan launch"):
            _build.wide_scan_args(wchunks, *wargs, *wouts, step=0, **dict(wide, frame_offset=72))
        with pytest.raises(ValueError, match="too small"):
            _build.wide_scan_args(wchunks, *wargs[:4], partial[:-1], *wouts, step=0, **wide)
        with pytest.raises(ValueError, match="bad scan taps"):
            _build.wide_scan_args(wchunks, w["table"], w["tstr"][:, :8].contiguous(), *wargs[2:],
                                  *wouts,
                                  step=0, **wide)


# ---------------------------------------------------------------------------
# On a card: the scan modes against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rates,dtype,lanes,n_in,offset,taps", [
    (STRIDED_D2, torch.int16, 2048, 512, 0, None), (STRIDED_D2, torch.int32, 300, 512, 0, None),
    (STRIDED_D2, torch.int16, 6, 5, 0, None), (STRIDED_D3, torch.int16, 5, 64, 0, None),
    (STRIDED_D2, torch.int16, 512, 256, 2, 40), (STRIDED_D2, torch.int16, 128, 256, 1, 1024),
    (WIDE, torch.int16, 512, 1024, 0, None), (WIDE, torch.int32, 6, 128, 0, None),
    (WIDE, torch.int16, 5, 512, 1, None), (WIDE, torch.int16, 300, 512, 2, None)])
def test_torch_cuda_strided_wide_scan_step_matches_plain(cuda_device, rates, dtype, lanes, n_in,
                                                          offset, taps):
    """Each step of a scan (step 0, the later ones and the flush) through the
    strided or wide scan mode against its plain version on the same inputs:
    outputs, produced, over and the next state, exact."""
    c = _case(rates, lanes=lanes, n_in=n_in, k=3, seed=409, f0=0x3C3C, device=cuda_device,
              taps=taps)
    data = torch.from_numpy(c["chunks"]).to(cuda_device, dtype)
    flat = torch.zeros(data.numel() + 8, dtype=dtype, device=cuda_device)
    chunks = flat[offset : offset + data.numel()].view(data.shape)
    chunks.copy_(data)
    state = torch.tensor([c["r"] + 2, 0x1234], dtype=torch.int32, device=cuda_device)
    kw = dict(radius=c["r"], max_taps=c["taps"], n_out=c["n_out"], increment=c["inc"],
              table_strided=None if taps else c["tstr"])
    for k in range(chunks.shape[0]):
        got = scan_inplace_step(c["table"], chunks, k, state, c["state"].cfg, **kw)
        want = scan_inplace_step_reference(c["table"], chunks, k, state, c["state"].cfg, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w), (k, rates, lanes)
        state = want[3]


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["strided", "wide"])
def test_torch_cuda_strided_wide_scan_program_matches_reference(cuda_device, engine):
    """The whole program on the card: one scan-mode launch a step, nothing
    staged, against the plain scan."""
    c = _case({"strided": STRIDED_D2, "wide": WIDE}[engine], lanes=1000, n_in=600, k=4,
              seed=410, f0=0x5A5A, device=cuda_device)
    chunks = torch.from_numpy(c["chunks"]).to(cuda_device)
    rs.ROUTES.clear()
    got = _plain(resample_scan_fused(c["table"], chunks, c["state"], max_taps=c["taps"],
                                     n_out=c["n_out"], radius=c["r"], increment=c["inc"],
                                     table_strided=c["tstr"]))
    assert rs.ROUTES == {(lowlevel.SCAN_ROUTES[engine], "cuda"): 5}
    _assert_same(got, _reference(c), engine)
    program = ScanProgram(c["table"], chunks, c["state"], max_taps=c["taps"], n_out=c["n_out"],
                          radius=c["r"], increment=c["inc"], table_strided=c["tstr"])
    assert program.kind == engine and not hasattr(program, "buffers")


@pytest.mark.cuda
def test_torch_cuda_wide_scan_several_launches_a_step(cuda_device, monkeypatch):
    """wide_launch_frames cut to 48: three wide launches a step on the card,
    each from its own launch state, against the plain scan."""
    monkeypatch.setattr(lowlevel, "wide_launch_frames", lambda taps: 48)
    c = _case(WIDE, lanes=300, n_in=4096, k=2, seed=411, f0=0x1234, device=cuda_device)
    chunks = torch.from_numpy(c["chunks"]).to(cuda_device)
    rs.ROUTES.clear()
    got = _plain(resample_scan_fused(c["table"], chunks, c["state"], max_taps=c["taps"],
                                     n_out=c["n_out"], radius=c["r"], increment=c["inc"],
                                     table_strided=c["tstr"]))
    launches = -(-c["n_out"] // 48)
    assert launches >= 3 and rs.ROUTES == {("scan_wide", "cuda"): 3 * launches}
    _assert_same(got, _reference(c), "wide, launches of 48 frames")
