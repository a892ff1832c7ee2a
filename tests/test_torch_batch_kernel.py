"""batch_mac_kernel's entry, ``ops.resample.resample_streams``, and the three
entries that reach it: ``lowlevel.resample_chunk``, ``batch.resample_batch``
and ``parallel.sharded_resample_batch`` (and ``lowlevel.resample_scan``, a
``resample_chunk`` a step).

On the CPU: the plain versions (the gather) are exact against the JAX
package's ``resample_batch`` and ``resample_chunk`` on the same seeded
inputs; a numpy mirror of the kernel's int64 bookkeeping equals the plain
version's int32 results at the quota and exhaustion edges; a mirror of the
kernel's stage plan shows that every staged window holds every tap row its
frames read; the entries' card route runs on CPU tensors with the C entry
stood in over the same pointers by an exact-integer mirror of the kernel,
against the plain version; and the routing: the CPU takes the gather, a card
the kernel and never ``convolve_frames``. ``cuda``-marked tests (skipped
without a card) hold every ``chip_smoke.BATCH_CASES`` launch against its
plain version and the sharded batch against the unsharded one.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from clownresampler_tpu import batch as jbatch
from clownresampler_tpu import lowlevel as jlowlevel
from clownresampler_tpu.configure import configure as jconfigure
from clownresampler_tpu.models import lanczos_kernel_table as jtable
from clownresampler_tpu_torch import fixedpoint as fx
from clownresampler_tpu_torch import lowlevel
from clownresampler_tpu_torch.batch import (
    resample_batch,
    resample_batch_reference,
    slice_states,
    stack_states,
)
from clownresampler_tpu_torch.configure import configure
from clownresampler_tpu_torch.lowlevel import (
    DeviceState,
    make_device_state,
    resample_chunk,
    resample_chunk_reference,
    resample_scan,
)
from clownresampler_tpu_torch.models import DEFAULT_MODEL, table_tensor
from clownresampler_tpu_torch.ops import _build
from clownresampler_tpu_torch.ops import resample as rs
from clownresampler_tpu_torch.ops.convolve import ConfigScalars
from clownresampler_tpu_torch.parallel import make_mesh, sharded_resample_batch

CPU = torch.device("cpu")
# Six streams over the four classes (tiled up and down, general, strided
# at d 2 and 6) and, apart, 44.1k -> 1000 (272 taps, a general ratio the
# farms route wide).
RATES = [(48000, 44100), (8000, 48000), (44100, 8000), (96000, 48000), (44100, 48000),
         (48000, 8000)]
WIDE_RATE = (44100, 1000)
N_IN, N_OUT = 128, 512
# Per stream: (p0, f0), the quota and the input frames. Streams 0 and 4 stop
# mid-stream on their quota (output-full), stream 1 (768 natural frames)
# on n_out under a quota past it, stream 2 has a quota of 0, streams 3 and
# 5 run out of input (exhausted; 5 is short).
STARTS = [(0, 0), (3, 0x8000), (7, 65535), (1, 1), (2, 0x1234), (0, 0xFFF0)]
QUOTAS = [50, 1 << 20, 0, 10**6, 37, 10**6]
TOTALS = [N_IN, N_IN, N_IN, N_IN, N_IN - 9, 20]
LEAVES = ("out", "produced", "consumed", "position_integer", "position_fractional",
          "exhausted")


def _table():
    return table_tensor(DEFAULT_MODEL.table(), CPU)


def _case(seed, channels, rates=RATES, starts=STARTS, quotas=QUOTAS, totals=TOTALS,
          max_taps=None):
    """Numpy inputs from ``seed`` (stream b's frames at its own radius, the
    rest of its rows random too: exactness does not need zero padding) and
    both packages' states."""
    rng = np.random.default_rng(seed)
    cfgs = [(configure(a, o, max(a, o)), jconfigure(a, o, max(a, o)), fx.calculate_ratio(a, o))
            for a, o in rates]
    r_max = max(c.integer_stretched_kernel_radius for c, _, _ in cfgs)
    taps = max_taps or fx.round_up(2 * r_max, 8)
    buf = rng.integers(-32768, 32768, size=(len(rates), N_IN + 2 * r_max, channels),
                       dtype=np.int16)
    states = [make_device_state(p0, f0, c, inc, CPU)
              for (c, _, inc), (p0, f0) in zip(cfgs, starts)]
    jstates = [jlowlevel.make_device_state(p0, f0, jc, inc)
               for (_, jc, inc), (p0, f0) in zip(cfgs, starts)]
    return dict(buf=buf, taps=taps, states=states, jstates=jstates,
                totals=np.asarray(totals, np.int32), quotas=np.asarray(quotas, np.int32))


def _args(c, dtype=np.int16):
    return (_table(), torch.from_numpy(c["buf"].astype(dtype)), torch.from_numpy(c["totals"]),
            stack_states(c["states"]), torch.from_numpy(c["quotas"]))


def _jax_batch(c):
    return jbatch.resample_batch(jnp.asarray(jtable()), jnp.asarray(c["buf"]),
                                 jnp.asarray(c["totals"]), jbatch.stack_states(c["jstates"]),
                                 jnp.asarray(c["quotas"]), max_taps=c["taps"], n_out=N_OUT)


def _leaves(result):
    out, produced, consumed, state, exhausted = result
    return [np.asarray(v) for v in (out, produced, consumed, state.position_integer,
                                    state.position_fractional, exhausted)]


def _assert_same(got, want, what=""):
    for name, g, w in zip(LEAVES, _leaves(got), _leaves(want)):
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
        assert g.shape == w.shape and g.dtype == w.dtype, (what, name, g.dtype, w.dtype)


# ---------------------------------------------------------------------------
# The plain versions against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.int16, np.int32], ids=["int16", "int32"])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_torch_plain_streams_match_jax_batch(channels, dtype):
    """resample_streams and resample_batch on the CPU equal JAX's
    resample_batch in every leaf: nonzero starts, quotas of 0, mid-stream
    and past n_out, an output-full upsampler and a short exhausted stream."""
    c = _case(300 + channels, channels)
    want = _jax_batch(c)
    kw = dict(max_taps=c["taps"], n_out=N_OUT)
    got = rs.resample_streams(*_args(c, dtype), **kw)
    _assert_same(got, want, "resample_streams")
    _assert_same(resample_batch(*_args(c, dtype), **kw), want, "resample_batch")
    produced, exhausted = got[1].numpy(), got[4].numpy()
    assert list(produced[:3]) == [50, N_OUT, 0] and produced[4] == 37
    assert list(exhausted) == [False, False, False, True, False, True]


def test_torch_plain_streams_with_a_272_tap_stream_match_jax():
    """The six streams and 44.1k -> 1000 in one batch at its 272-tap width:
    the narrow streams' windows are a few live taps of the 272."""
    c = _case(311, 2, rates=[*RATES, WIDE_RATE], starts=[*STARTS, (5, 0x4321)],
              quotas=[*QUOTAS, 10**6], totals=[*TOTALS, N_IN])
    assert c["taps"] == 272
    want = _jax_batch(c)
    got = rs.resample_streams(*_args(c), max_taps=c["taps"], n_out=N_OUT)
    _assert_same(got, want)
    assert int(got[1][-1]) > 0


@pytest.mark.parametrize("ints", [False, True], ids=["tensors", "ints"])
def test_torch_plain_two_d_call_matches_jax_chunk(ints):
    """A 2-D (S, C) input is one stream: resample_streams and resample_chunk
    equal JAX's resample_chunk, the input count and quota as ints or 0-dim
    tensors, the output (n_out, C) and every other leaf 0-dim."""
    c = _case(320, 3)
    table = jnp.asarray(jtable())
    for b in range(len(RATES)):
        total, quota = int(c["totals"][b]), int(c["quotas"][b])
        args = (total, quota) if ints else (torch.tensor(total, dtype=torch.int32),
                                            torch.tensor(quota, dtype=torch.int32))
        want = jlowlevel.resample_chunk(table, jnp.asarray(c["buf"][b]), total, c["jstates"][b],
                                        quota, max_taps=c["taps"], n_out=N_OUT)
        for fn in (rs.resample_streams, resample_chunk):
            got = fn(_table(), torch.from_numpy(c["buf"][b]), args[0], c["states"][b], args[1],
                     max_taps=c["taps"], n_out=N_OUT)
            _assert_same(got, want, f"{fn.__name__} stream {b}")
            assert got[0].shape == (N_OUT, 3) and got[1].dim() == 0


# ---------------------------------------------------------------------------
# The kernel's arithmetic, mirrored in exact integers
# ---------------------------------------------------------------------------

def _bookkeeping_int64(p0, f0, inc, total, quota, n_out):
    """batch_kernels.cu stream_call + write_results in exact integers:
    (produced, consumed, position_integer, position_fractional, exhausted)."""
    num = (total - p0) * 65536 - f0
    natural = (num + inc - 1) // max(inc, 1) if num > 0 else 0
    q = min(quota, n_out)
    produced = min(natural, q)
    t = f0 + produced * inc
    p_after = p0 + (t >> 16)
    consumed = min(p_after, total)
    return produced, consumed, p_after - consumed, t & 0xFFFF, natural < q


@pytest.mark.parametrize("seed", range(3))
def test_torch_batch_bookkeeping_int64_mirror_matches_int32(seed):
    """120 streams a seed at the edges the kernel's int64 bookkeeping must
    get right: quotas at the natural count and one either side, 0, n_out
    and past it; starts past the input (natural 0); real and random
    increments. The plain version's int32 results equal the mirror."""
    rng = np.random.default_rng(700 + seed)
    n_out, b = 1 << 14, 120
    ratios = [(48000, 44100), (8000, 48000), (44100, 8000), (96000, 48000), (44100, 132)]
    starts, incs, totals, quotas = [], [], [], []
    for i in range(b):
        inc = (fx.calculate_ratio(*ratios[i % len(ratios)]) if i % 2
               else int(rng.integers(1, 1 << 24)))
        total = int(rng.integers(1, 1 << 13))
        p0 = int(rng.integers(0, total + 40)) if i % 7 else total + int(rng.integers(0, 9))
        f0 = int(rng.integers(0, 1 << 16))
        natural = _bookkeeping_int64(p0, f0, inc, total, 1 << 30, 1 << 30)[0]
        quota = [natural - 1, natural, natural + 1, 0, n_out, n_out + 5,
                 int(rng.integers(0, n_out))][i % 7]
        starts.append((p0, f0))
        incs.append(inc)
        totals.append(total)
        quotas.append(max(quota, 0))
    state = DeviceState(
        torch.tensor([p for p, _ in starts], dtype=torch.int32),
        torch.tensor([f for _, f in starts], dtype=torch.int32),
        ConfigScalars(*(torch.tensor(v, dtype=torch.int32) for v in zip(*(
            (3 << 16, 3, 0, 1024, inc & 0x7FFFFFFF, *fx.split_increment(inc))
            for inc in incs)))))
    # The gather holds (streams, n_out, taps) ints: 20 streams a call.
    for lo in range(0, b, 20):
        _, produced, consumed, new, exhausted = resample_chunk_reference(
            _table(), torch.zeros((20, 2, 1), dtype=torch.int16),
            torch.tensor(totals[lo : lo + 20], dtype=torch.int32),
            slice_states(state, lo, lo + 20),
            torch.tensor(quotas[lo : lo + 20], dtype=torch.int32), max_taps=8, n_out=n_out)
        for i in range(20):
            k = lo + i
            want = _bookkeeping_int64(*starts[k], incs[k], totals[k], quotas[k], n_out)
            got = (int(produced[i]), int(consumed[i]), int(new.position_integer[i]),
                   int(new.position_fractional[i]), bool(exhausted[i]))
            assert got == want, (starts[k], incs[k], totals[k], quotas[k])


def _wrap32(v):
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _trunc_div(v, d: int):
    """C's truncating division of int64 values by a positive d."""
    return np.where(v < 0, -((-v) // d), v // d)


def _frames_int64(x, g, table, taps_bound, produced):
    """batch_kernels.cu frame_value for frames [0, produced) of one stream in
    exact integers: mac_common.cuh frame_window in int64, the live taps (at
    most taps_bound) from the clamped LUT, every tap row clamped into [0, S),
    the per-term truncation, the 17.15 reciprocal."""
    s = x.shape[0]
    n = np.arange(max(produced, 0), dtype=np.int64)
    t = g["f0"] + n * g["inc"]
    frac = t & 0xFFFF
    min_rel = (frac + g["delta"] + 0xFFFF) >> 16
    max_rel = (frac + g["radius"]) >> 16
    start = (g["step"] * ((min_rel << 16) - frac)) >> 16
    live = np.clip(g["int_radius"] + max_rel - min_rel, 0, taps_bound)
    row = g["p0"] + (t >> 16) + min_rel
    j = np.arange(taps_bound, dtype=np.int64)
    k = np.where(j < live[:, None],
                 table[np.clip(start[:, None] + j * g["step"], 0, table.shape[0] - 1)], 0)
    v = x[np.clip(row[:, None] + j, 0, s - 1)].astype(np.int64)
    acc = _wrap32(_trunc_div(_wrap32(v * k[..., None]), 65536).sum(axis=1))
    total = _wrap32(k.sum(axis=1))
    q = (1 << 31) // np.maximum(np.abs(total), 2)
    q = np.where(total < 0, -q, q)
    return _wrap32(_trunc_div(acc * q[:, None], 32768))


GEOMETRY = ("p0", "f0", "inc_hi", "inc_lo", "radius", "delta", "int_radius", "step")


def _view(ptr, shape, dtype=np.int32):
    """The memory at ``ptr`` as a writable numpy array."""
    nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return np.frombuffer((ctypes.c_char * nbytes).from_address(ptr), dtype=dtype).reshape(shape)


def _batch_stand_in(calls):
    """crt_batch_mac over the same pointers, by the exact-integer mirror:
    stream b's rows at x + b * stride_b elements, its ten leaves at index b."""
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS["crt_batch_mac"], args))
        calls.append(a)
        b, s, c, n_out = a["B"], a["S"], a["C"], a["N"]
        dt = np.int16 if a["x_s16"] else np.int32
        assert a["words"] in (0, 1) and a["T"] > 0
        assert a == dict(a, **_build.batch_tile(c, a["T"], np.dtype(dt).itemsize))
        leaf = lambda k: _view(a[k], (b,)).astype(np.int64)
        geo = dict(zip(GEOMETRY, map(leaf, ("p0_ptr", "f0_ptr", *GEOMETRY[2:]))))
        table = _view(a["table"], (a["table_size"],)).astype(np.int64)
        out = _view(a["out"], (b, n_out, c))
        results = [_view(a[k], (b,)) for k in ("produced", "consumed", "p_out", "f_out")]
        exhausted = _view(a["exhausted"], (b,), np.uint8)
        for i in range(b):
            g = {k: int(v[i]) for k, v in geo.items()}
            g["inc"] = g["inc_hi"] * 65536 + g["inc_lo"]
            got = _bookkeeping_int64(g["p0"], g["f0"], g["inc"], int(leaf("totals")[i]),
                                     int(leaf("quotas")[i]), n_out)
            for r, v in zip(results, got):
                r[i] = v
            exhausted[i] = got[4]
            x = _view(a["x"] + i * a["stride_b"] * np.dtype(dt).itemsize, (s, c), dt)
            out[i] = 0
            out[i, : max(got[0], 0)] = _frames_int64(x, g, table, a["T"], got[0])
        return 0
    return entry


@pytest.fixture
def card(monkeypatch):
    """The entries' card route on CPU tensors: plain_route answers False, the
    C entry is the stand-in, the CUDA-only checks stand aside. Yields the
    stand-in's calls."""
    calls = []
    monkeypatch.setattr(rs, "plain_route", lambda x, kind: False)
    monkeypatch.setattr(_build, "entry_function",
                        {"crt_batch_mac": _batch_stand_in(calls)}.__getitem__)
    monkeypatch.setattr(_build, "_check_cuda", lambda x: None)
    monkeypatch.setattr(_build, "_stream", lambda x: 0)
    return calls


@pytest.mark.parametrize("dtype", [np.int16, np.int32], ids=["int16", "int32"])
@pytest.mark.parametrize("channels", [1, 2, 3])
def test_torch_batch_entry_argument_flow(card, channels, dtype):
    """resample_streams as it runs on a card, the C entry stood in: the
    batch, a view of every other stream of a taller buffer (its stride
    between streams is not S x C), and the 2-D call with ints and 0-dim
    leaves, each equal to the plain version; one C call each."""
    c = _case(330 + channels, channels)
    kw = dict(max_taps=c["taps"], n_out=N_OUT)
    table, x, totals, states, quotas = _args(c, dtype)
    want = resample_chunk_reference(table, x, totals, states, quotas, **kw)
    _assert_same(rs.resample_streams(table, x, totals, states, quotas, **kw), want, "batch")
    tall = torch.zeros((2 * x.shape[0], x.shape[1] + 5, channels), dtype=x.dtype)
    tall[::2, 3 : 3 + x.shape[1]] = x
    view = tall[::2, 3 : 3 + x.shape[1]]
    assert view.stride(0) != x.shape[1] * channels
    _assert_same(rs.resample_streams(table, view, totals, states, quotas, **kw), want, "view")
    assert card[-1]["stride_b"] == view.stride(0)
    for b in range(len(RATES)):
        one = (x[b], int(c["totals"][b]), c["states"][b], int(c["quotas"][b]))
        got = rs.resample_streams(table, *one[:3], one[3], **kw)
        plain = resample_chunk_reference(table, *one[:3], one[3], **kw)
        _assert_same(got, plain, f"2-D stream {b}")
        assert card[-1]["B"] == 1 and got[1].dim() == 0
    assert len(card) == 2 + len(RATES)
    assert {a["x_s16"] for a in card} == {int(dtype == np.int16)}
    assert {a["words"] for a in card} == {int(dtype == np.int32 or channels % 2 == 0)}


def test_torch_batch_entry_argument_flow_wide_taps(card):
    """The 272-tap batch through the stood-in entry equals the plain version
    and JAX."""
    c = _case(341, 2, rates=[*RATES, WIDE_RATE], starts=[*STARTS, (5, 0x4321)],
              quotas=[*QUOTAS, 10**6], totals=[*TOTALS, N_IN])
    got = rs.resample_streams(*_args(c), max_taps=c["taps"], n_out=N_OUT)
    _assert_same(got, _jax_batch(c))
    assert card[0]["T"] == 272 and card[0]["B"] == len(RATES) + 1


def test_torch_batch_launcher_refuses_what_the_kernel_cannot_take(card):
    c = _case(350, 2)
    table, x, totals, states, quotas = _args(c)
    kw = dict(max_taps=c["taps"], n_out=N_OUT)
    leaves = (states.position_integer, states.position_fractional, states.cfg)
    with pytest.raises(ValueError, match="contiguous"):
        _build.batch_launch_args(x.transpose(1, 2), table, totals, quotas, *leaves, **kw)
    with pytest.raises(ValueError, match="int16 or int32"):
        _build.batch_launch_args(x.to(torch.int64), table, totals, quotas, *leaves, **kw)
    with pytest.raises(ValueError, match="quotas"):
        _build.batch_launch_args(x, table, totals, quotas[:-1], *leaves, **kw)
    with pytest.raises(ValueError, match="totals"):
        _build.batch_launch_args(x, table, totals.to(torch.int64), quotas, *leaves, **kw)
    with pytest.raises(ValueError, match="bad batch launch"):
        _build.batch_launch_args(x, table, totals, quotas, *leaves, max_taps=0, n_out=N_OUT)
    with pytest.raises(ValueError, match="exceeds"):
        rs.resample_streams(table, x, totals, states, quotas, max_taps=c["taps"],
                            n_out=lowlevel.MAX_CHUNK_OUTPUT_FRAMES + 8)
    assert not card


# ---------------------------------------------------------------------------
# The stage plan: every staged window holds its frames' taps
# ---------------------------------------------------------------------------

def _stage_plan(state, *, taps, n_out, produced, channels, elem_bytes, s):
    """batch_kernels.cu batch_mac_kernel's stages for one stream, mirrored:
    per block tile, its frames per stage (halved from the tile's until
    their window fits), each stage's first row and rows, whether it is
    staged; asserts that a staged window holds every tap row of its frames
    (which clamped staging then serves as the gather clamps them). Returns
    (staged, direct) stage counts."""
    tile = _build.batch_tile(channels, taps, elem_bytes)
    tf, w = tile["tile_frames"], tile["win_rows"]
    r = _build.BATCH_THREADS // tile["channel_tile"]
    row, _, live = rs._frame_windows(state, torch.arange(n_out, dtype=torch.int64))
    row, live = row.numpy(), live.numpy()
    end = row + live                       # the kernel's span uses the unclamped taps
    used = row + np.clip(live, 0, taps)    # rows the frames read
    counts = [0, 0]
    for n0 in range(0, n_out, tf):
        nb = min(tf, n_out - n0)
        live_frames = max(0, min(produced - n0, nb))
        span = lambda a, e: end[n0 + e - 1] - row[n0 + a]
        f = tf
        while f > r and live_frames > 0 and span(0, min(f, live_frames)) > w:
            f //= 2
        for s0 in range(0, live_frames, f):
            sf = min(f, live_frames - s0)
            first, rows = row[n0 + s0], span(s0, s0 + sf)
            staged = rows <= w
            counts[not staged] += 1
            if staged:
                frames = slice(n0 + s0, n0 + s0 + sf)
                assert (row[frames] >= first).all() and (used[frames] <= first + rows).all()
    return tuple(counts)


@pytest.mark.parametrize("rates", [*chip_smoke.MIXED["groups"], (44100, 8000), (48000, 8000),
                                   WIDE_RATE, (44100, 132)], ids=str)
def test_torch_batch_stage_windows_hold_every_tap(rates):
    """At config 5's ratios stereo int16 at 40 taps, every stage of every
    tile is staged; at 44.1k -> 132 (2008 taps) its stages read x directly;
    and from a nonzero start, at any channel count, every staged window
    holds its frames' tap rows."""
    cfg = configure(*rates, max(rates))
    inc = fx.calculate_ratio(*rates)
    taps = max(40, fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8))
    n_in = 8192
    for (p0, f0), channels, elem in (((0, 0), 2, 2), ((5, 0x9abc), 3, 2), ((1, 7), 2048, 4)):
        state = make_device_state(p0, f0, cfg, inc, CPU)
        produced = _bookkeeping_int64(p0, f0, inc, n_in, 1 << 30, 1 << 14)[0]
        staged, direct = _stage_plan(state, taps=taps, n_out=1 << 14, produced=produced,
                                     channels=channels, elem_bytes=elem, s=n_in + taps)
        if channels == 2 and taps == 40 and rates in chip_smoke.MIXED["groups"]:
            assert staged and not direct, (rates, staged, direct)
        if rates == (44100, 132):
            assert direct and not staged


def test_torch_batch_block_constants_match_the_kernel_source():
    with open(_build.os.path.join(_build.CSRC, "batch_kernels.cu")) as f:
        src = f.read()
    assert f"constexpr int BATCH_THREADS = {_build.BATCH_THREADS};" in src
    for c in (1, 2, 3, 128, 2048):
        t = _build.batch_tile(c, 40, 2)
        # The frames per stage halve from the tile's down to one a row of threads.
        r = _build.BATCH_THREADS // t["channel_tile"]
        assert t["tile_frames"] // r & (t["tile_frames"] // r - 1) == 0
        assert t["win_rows"] * t["channel_tile"] * 2 <= _build.BATCH_SHARED_BUDGET
        assert t["win_rows"] >= 40 or c >= 128


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------

def test_torch_batch_entries_take_the_gather_on_the_cpu():
    c = _case(360, 2)
    kw = dict(max_taps=c["taps"], n_out=N_OUT)
    for fn in (rs.resample_streams, resample_chunk, resample_batch, resample_batch_reference):
        rs.ROUTES.clear()
        fn(*_args(c), **kw)
        assert dict(rs.ROUTES) == {("batch", "oracle"): 1}, fn.__name__


def _no_gather(*args, **kwargs):
    raise AssertionError("the card route reached the gather")


def test_torch_batch_entries_take_the_kernel_on_a_card(card, monkeypatch):
    """With plain_route answering as a card does: resample_chunk,
    resample_batch, sharded_resample_batch (one launch a shard) and
    resample_scan (one a step) launch the kernel, never the gather, and
    equal their plain versions."""
    c = _case(370, 2)
    kw = dict(max_taps=c["taps"], n_out=N_OUT)
    args = _args(c)
    want = resample_batch_reference(*args, **kw)
    monkeypatch.setattr(lowlevel, "convolve_frames", _no_gather)
    monkeypatch.setattr(rs, "convolve_frames", _no_gather)
    rs.ROUTES.clear()
    for fn in (resample_chunk, resample_batch):
        _assert_same(fn(*args, **kw), want, fn.__name__)
    mesh = make_mesh(dp=2, sp=2, devices=["cpu"] * 4)
    _assert_same(sharded_resample_batch(mesh, *args, **kw), want, "sharded")
    assert dict(rs.ROUTES) == {("batch", "cuda"): 2 + 4} and len(card) == 6

    cfg = configure(44100, 8000, 44100)
    inc = fx.calculate_ratio(44100, 8000)
    r = cfg.integer_stretched_kernel_radius
    chunks = torch.from_numpy(np.random.default_rng(371).integers(
        -32768, 32768, size=(3, 256, 4), dtype=np.int16))
    scan_kw = dict(max_taps=fx.round_up(2 * r, 8), n_out=64, radius=r)
    state = make_device_state(0, 0x1111, cfg, inc, CPU)
    rs.ROUTES.clear()
    got = resample_scan(_table(), chunks, state, **scan_kw)
    assert dict(rs.ROUTES) == {("batch", "cuda"): 3}
    monkeypatch.undo()
    want = resample_scan(_table(), chunks, state, **scan_kw)
    for g, w in zip((got[0], got[1], got[3]), (want[0], want[1], want[3])):
        assert torch.equal(g, w)
    assert int(got[2].position_integer) == int(want[2].position_integer)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.BATCH_CASES, ids=[c[0] for c in chip_smoke.BATCH_CASES])
def test_torch_cuda_batch_case_matches_plain(cuda_device, case):
    gen = torch.Generator(device="cuda").manual_seed(21)
    assert chip_smoke.run_batch_case(case, gen) == 0


@pytest.mark.cuda
def test_torch_cuda_sharded_batch_equals_resample_batch(cuda_device):
    b = chip_smoke.batch_case(np.random.default_rng(22), chip_smoke.BATCH)
    want = resample_batch(*b["args"], **b["kw"])
    got = sharded_resample_batch(chip_smoke.shard_mesh(*chip_smoke.BATCH["mesh"]), *b["args"],
                                 **b["kw"])
    for g, w in zip(chip_smoke._batch_leaves(got), chip_smoke._batch_leaves(want)):
        assert g.shape == w.shape and torch.equal(g, w)
