"""batch_mac_kernel's entry, ``ops.resample.resample_streams``, and the three
entries that reach it: ``lowlevel.resample_chunk``, ``batch.resample_batch``
and ``parallel.sharded_resample_batch`` (and ``lowlevel.resample_scan``, a
``resample_chunk`` a step).

On the CPU: the plain versions (the gather) are exact against the JAX
package's ``resample_batch`` and ``resample_chunk`` on the same seeded
inputs; a numpy mirror of the kernel's int64 bookkeeping equals the plain
version's int32 results at the quota and exhaustion edges; mirrors of the
kernel's plan show that the host's range split covers every frame and
channel once and fills the card, that every staged window holds every tap
row its frames read, that a block's zero span splits into a head, a 16-byte
body and a tail that cover it exactly, that the copy path's alignment
rule matches the copies (its constants checked against the CUDA source),
that a flat window's 16-byte granules are copied only inside x, and that
``chip_smoke.BATCH_CASES`` take every path the chip run requires;
the entries' card route runs on CPU tensors with the C entry stood in over
the same pointers by an exact-integer mirror of the kernel that stores
block by block through the mirrored plan, against the plain version; and
the routing: the CPU takes the gather, a card the kernel and never
``convolve_frames``. ``cuda``-marked tests (skipped without a card) hold
every ``chip_smoke.BATCH_CASES`` launch against its plain version and the
sharded batch against the unsharded one.
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


def _blocks(a: dict):
    """batch_kernels.cu batch_mac_kernel's blocks of one stream, mirrored:
    (n0, n1, c0, cn) of grid (frame ranges, channel tiles)."""
    n_out, c, nr, ct = a["N"], a["C"], a["range_frames"], a["channel_tile"]
    return [(n0, min(n0 + nr, n_out), c0, min(ct, c - c0))
            for n0 in range(0, max(n_out, 1), nr) for c0 in range(0, c, ct)]


def _zero_split(base: int, a: int, e: int, c: int) -> tuple:
    """store_zeros' flat span of frames [a, e) (output indices from the
    stream's base), mirrored: the scalar head up to 16-byte alignment, the
    body of 16-byte stores and the scalar tail, each a (start, end) range."""
    e0, e1 = base + a * c, base + e * c
    h = min((e0 + 3) & ~3, e1)
    t = max(h, e1 & ~3)
    return (e0, h), (h, t), (t, e1)


def _flat_quads(base: int, a: int, e: int, c: int) -> np.ndarray:
    """store_frames' flat quads of frames [a, e): the output index of each
    quad's first int (16-byte aligned), its elements those inside the span."""
    la = a * c
    return base + np.arange(la - ((base + la) & 3), e * c, 4)


def _block_writes(a: dict, b: int, produced: int, block: tuple) -> tuple:
    """The output indices one block stores (live, zero), as store_frames and
    store_zeros store them: flat (one span) through the quads and the zero
    split, channel tiles frame by frame."""
    n_out, c = a["N"], a["C"]
    n0, n1, c0, cn = block
    base = b * n_out * c
    live_end = max(n0, min(produced, n1))
    rows = lambda f0, f1: (base + np.arange(f0, f1)[:, None] * c + c0
                           + np.arange(cn)[None]).reshape(-1)
    if cn != c:
        return rows(n0, live_end), rows(live_end, n1)
    zero = np.concatenate([np.arange(*r) for r in _zero_split(base, live_end, n1, c)])
    if c <= 4:
        # frames_by_thread: a thread stores a frame's C ints.
        return rows(n0, live_end), zero
    quads = _flat_quads(base, n0, live_end, c)
    assert not (quads % 4).any()
    live = (quads[:, None] + np.arange(4)[None]).reshape(-1)
    live = live[(live >= base + n0 * c) & (live < base + live_end * c)]
    return live, zero


def _batch_stand_in(calls):
    """crt_batch_mac over the same pointers, by the exact-integer mirror:
    stream b's rows at x + b * stride_b elements, its ten leaves at index b;
    each block's frames stored through the mirror of its stores, every
    output int exactly once."""
    def entry(*args):
        a = dict(zip(_build.ENTRY_ARGS["crt_batch_mac"], args))
        calls.append(a)
        b, s, c, n_out = a["B"], a["S"], a["C"], a["N"]
        dt = np.int16 if a["x_s16"] else np.int32
        assert a["T"] > 0 and a["out"] % 16 == 0
        assert a == dict(a, **_build.batch_plan(b, n_out, c))
        assert a["copy"] == _build.batch_copy_path(
            channels=c, elem_bytes=np.dtype(dt).itemsize, stride_b=a["stride_b"], ptr=a["x"])
        leaf = lambda k: _view(a[k], (b,)).astype(np.int64)
        geo = dict(zip(GEOMETRY, map(leaf, ("p0_ptr", "f0_ptr", *GEOMETRY[2:]))))
        table = _view(a["table"], (a["table_size"],)).astype(np.int64)
        out = _view(a["out"], (b * n_out * c,))
        results = [_view(a[k], (b,)) for k in ("produced", "consumed", "p_out", "f_out")]
        exhausted = _view(a["exhausted"], (b,), np.uint8)
        writes = np.zeros(b * n_out * c, np.int64)
        for i in range(b):
            g = {k: int(v[i]) for k, v in geo.items()}
            g["inc"] = g["inc_hi"] * 65536 + g["inc_lo"]
            got = _bookkeeping_int64(g["p0"], g["f0"], g["inc"], int(leaf("totals")[i]),
                                     int(leaf("quotas")[i]), n_out)
            for r, v in zip(results, got):
                r[i] = v
            exhausted[i] = got[4]
            x = _view(a["x"] + i * a["stride_b"] * np.dtype(dt).itemsize, (s, c), dt)
            frames = np.zeros(n_out * c, np.int64)
            frames[: max(got[0], 0) * c] = _frames_int64(x, g, table, a["T"], got[0]).reshape(-1)
            for block in _blocks(a):
                live, zero = _block_writes(a, i, got[0], block)
                out[live] = frames[live - i * n_out * c]
                out[zero] = 0
                np.add.at(writes, np.concatenate([live, zero]), 1)
        assert (writes == 1).all()
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
    words = _build.BATCH_COPY_WORDS if channels * np.dtype(dtype).itemsize % 4 == 0 else 0
    assert {a["copy"] for a in card} == {_build.BATCH_COPY_VEC | words}


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
# The kernel's plan: ranges, stages, zero spans, copy paths
# ---------------------------------------------------------------------------

# (B, n_out, C): config 5's fleet, BATCH, an oracle-scan step (2-D, C 2048),
# a 2-D mono call, the port's small batches, channel tiles, no frames.
PLAN_SHAPES = ((1024, 16384, 2), (256, 8192, 2), (1, 128, 2048), (1, 2048, 1), (7, 512, 3),
               (64, 4096, 2), (3, 100, 200), (1, 0, 2), (20000, 1024, 2))


@pytest.mark.parametrize("shape", PLAN_SHAPES, ids=str)
def test_torch_batch_range_split_fills_the_card_and_covers_once(shape):
    """batch_plan's grid covers every (frame, channel) of a stream exactly
    once, reaches BATCH_GRID_BLOCKS blocks where the launch has that many
    ranges of BATCH_MIN_RANGE_FRAMES, and takes no more ranges than that
    needs (each as long as it can be); at the fleet, four blocks a stream."""
    b, n_out, c = shape
    plan = _build.batch_plan(b, n_out, c)
    a = dict(plan, N=n_out, C=c)
    nr, ct = plan["range_frames"], plan["channel_tile"]
    assert nr % _build.BATCH_MIN_RANGE_FRAMES == 0 and 0 < ct <= _build.BATCH_CHANNEL_TILE
    counts = np.zeros((n_out, c), np.int64)
    blocks = _blocks(a)
    for n0, n1, c0, cn in blocks:
        counts[n0:n1, c0 : c0 + cn] += 1
    assert (counts == 1).all()
    # The C entry's grid: (ceil(N / NR) or 1, ceil(C / CT), B).
    ranges = max(1, -(-n_out // nr))
    assert len(blocks) == ranges * -(-c // ct)
    per_range = b * -(-c // ct)
    most = per_range * max(1, -(-n_out // _build.BATCH_MIN_RANGE_FRAMES))
    assert ranges * per_range >= min(_build.BATCH_GRID_BLOCKS, most)
    assert ranges <= max(1, -(-_build.BATCH_GRID_BLOCKS // per_range))
    if shape == (1024, 16384, 2):
        assert ranges == 4 and ct == 2
    if shape == (1, 128, 2048):
        assert ct == 64 and ranges > 1


def _stage_plan(state, *, taps, n_out, produced, channels, elem_bytes, s):
    """batch_mac_kernel's stages for one stream, mirrored: per block, its
    frames per stage (stage_frames) and each stage's window (stage_window);
    asserts that every frame's live taps fit the stage's tap stride, that a
    staged window holds every tap row of its frames and fits its stage's
    bytes beside their geometry. Returns (staged, direct) stage counts."""
    cfg = state.cfg
    g = dict(inc=(int(cfg.increment_hi) << 16) + int(cfg.increment_lo),
             int_radius=int(cfg.integer_stretched_kernel_radius),
             radius=int(cfg.stretched_kernel_radius),
             delta=int(cfg.stretched_kernel_radius_delta))
    row, _, live = rs._frame_windows(state, torch.arange(n_out, dtype=torch.int64))
    row, live = row.numpy(), np.clip(live.numpy(), 0, taps)
    tl = _build.batch_tap_stride(int_radius=g["int_radius"], radius=g["radius"],
                                 delta=g["delta"], max_taps=taps)
    assert (live <= tl).all()
    a = dict(_build.batch_plan(1024, n_out, channels), N=n_out, C=channels)
    counts = [0, 0]
    for n0, n1, _, cn in _blocks(a):
        live_end = max(n0, min(produced, n1))
        if live_end == n0:
            continue
        by_thread = cn == channels <= 4
        f, wb = _build.batch_stage_frames(increment=g["inc"], tap_stride=tl, channels=cn,
                                          frames=live_end - n0, elem_bytes=elem_bytes,
                                          by_thread=by_thread)
        if not f:
            counts[1] += 1
            continue
        for s0 in range(n0, live_end, f):
            frames = slice(s0, min(s0 + f, live_end))
            first = row[s0]
            rows = row[frames.stop - 1] - first + tl
            counts[0] += 1
            assert (row[frames] >= first).all()
            assert (row[frames] + live[frames] <= first + rows).all()
            assert 15 + rows * cn * elem_bytes <= wb
            assert wb + (0 if by_thread else 4 * f * (tl + 3)) <= _build.BATCH_STAGE_BYTES
    return tuple(counts)


@pytest.mark.parametrize("rates", [*chip_smoke.MIXED["groups"], (44100, 8000), (48000, 8000),
                                   WIDE_RATE, (44100, 132)], ids=str)
def test_torch_batch_stage_windows_hold_every_tap(rates):
    """At config 5's ratios stereo int16 at 40 taps, every stage of every
    block is staged; at 44.1k -> 132 (2008 taps) stereo is staged a frame a
    thread, three channels and channel tiles read x directly;
    and from a nonzero start, at any channel count (C = 2048 in channel
    tiles), every staged window holds its frames' tap rows."""
    cfg = configure(*rates, max(rates))
    inc = fx.calculate_ratio(*rates)
    taps = max(40, fx.round_up(2 * cfg.integer_stretched_kernel_radius, 8))
    n_in = 8192
    for (p0, f0), channels, elem in (((0, 0), 2, 2), ((5, 0x9abc), 3, 2), ((1, 7), 2048, 4),
                                     ((2, 3), 2048, 2)):
        state = make_device_state(p0, f0, cfg, inc, CPU)
        produced = _bookkeeping_int64(p0, f0, inc, n_in, 1 << 30, 1 << 14)[0]
        staged, direct = _stage_plan(state, taps=taps, n_out=1 << 14, produced=produced,
                                     channels=channels, elem_bytes=elem, s=n_in + taps)
        if channels == 2 and taps == 40 and rates in chip_smoke.MIXED["groups"]:
            assert staged and not direct, (rates, staged, direct)
        if rates == (44100, 132):
            # A thread a frame stages the stereo stream's 2008-tap windows;
            # the geometry of 8 frames beside a window does not fit.
            assert (staged and not direct) if channels == 2 else (direct and not staged)


@pytest.mark.parametrize("channels", [1, 2, 3, 64])
def test_torch_batch_zero_span_head_body_tail(channels):
    """store_zeros' split of a block's zero frames [produced, range end) x C
    into a scalar head, 16-byte body and scalar tail: the three cover the
    span exactly, in order; the body starts and ends on 16 bytes of the
    output and the head and tail are under a quad -- at odd produced counts,
    odd streams and n_out, and empty spans. And store_frames' flat quads
    start on 16 bytes and cover the live span."""
    seen = set()
    for n_out in (16384, 37, 1):
        for b in (0, 1, 3):
            base = b * n_out * channels
            for a, e in ((0, n_out), (1, n_out), (n_out // 3 | 1, n_out), (n_out, n_out),
                         (0, 0), (n_out // 2, n_out // 2 + 1)):
                if not 0 <= a <= e <= n_out:
                    continue
                (h0, h1), (b0, b1), (t0, t1) = _zero_split(base, a, e, channels)
                assert (h0, t1) == (base + a * channels, base + e * channels)
                assert h0 <= h1 == b0 <= b1 == t0 <= t1
                assert b0 % 4 == 0 and b1 % 4 == 0 or b0 == b1
                assert h1 - h0 < 4 and t1 - t0 < 4
                seen.add(("head", h1 > h0))
                seen.add(("body", b1 > b0))
                quads = _flat_quads(base, a, e, channels)
                assert not (quads % 4).any()
                if e > a:
                    assert quads[0] <= base + a * channels < quads[0] + 4
                    assert quads[-1] < base + e * channels <= quads[-1] + 4
    # At C a multiple of 4 every span starts on 16 bytes: no head.
    assert seen == {("head", channels % 4 != 0), ("head", False), ("body", True),
                    ("body", False)}


def test_torch_batch_block_constants_match_the_kernel_source():
    with open(_build.os.path.join(_build.CSRC, "batch_kernels.cu")) as f:
        src = f.read()
    for name in ("BATCH_THREADS", "BATCH_MAX_TILE", "BATCH_MIN_TILE", "BATCH_MAX_THREAD_TILE",
                 "BATCH_STAGE_BYTES", "BATCH_COPY_PLAIN", "BATCH_COPY_VEC", "BATCH_COPY_WORDS"):
        assert f"constexpr int {name} = {getattr(_build, name)};" in src, name
    # Two stages a block, within what a block takes without opting in to more.
    assert 2 * _build.BATCH_STAGE_BYTES <= 48 * 1024 and _build.BATCH_STAGE_BYTES % 16 == 0
    # The geometry gives a stage's frames to 256 / F threads each, within a warp.
    assert _build.BATCH_THREADS // _build.BATCH_MIN_TILE <= 32
    for tile in (_build.BATCH_MAX_TILE, _build.BATCH_MAX_THREAD_TILE):
        assert tile & (tile - 1) == 0 and tile >= _build.BATCH_MIN_TILE


# (C, bytes a sample, stride between streams, address, path bits): flat
# blocks copy granules at any alignment; channel tiles only when every row
# segment is whole 16-byte granules; clamped rows go as 4-byte words where
# every row segment is whole words at 4-byte aligned addresses.
VEC, WORDS = _build.BATCH_COPY_VEC, _build.BATCH_COPY_WORDS
COPY_PATHS = (
    (2, 2, 16452, 0x1000, VEC | WORDS),
    (3, 2, 3 * 1025, 0x1002, VEC),
    (1, 2, 1025, 0x1002, VEC),
    (64, 4, 64 * 7, 0x1004, VEC | WORDS),
    (2048, 2, 2048 * 556, 0x1000, VEC | WORDS),
    (2048, 4, 2048 * 300, 0x1000, VEC | WORDS),
    (2048, 2, 2048 * 556, 0x1002, _build.BATCH_COPY_PLAIN),
    (2048, 2, 2048 * 556 + 2, 0x1000, WORDS),
    (100, 2, 100 * 300, 0x1000, WORDS),
    (100, 4, 100 * 300, 0x1000, VEC | WORDS),
    (99, 2, 99 * 300, 0x1000, _build.BATCH_COPY_PLAIN),
)


@pytest.mark.parametrize("case", COPY_PATHS, ids=str)
def test_torch_batch_copy_path_by_alignment(case):
    """batch_copy_path against the kernel's copies: with channel tiles, VEC
    only where every tile's row segment (channel_tile samples, or the last
    tile's) starts on 16 bytes of every stream and is whole granules; WORDS
    only where every row segment starts on 4 bytes and is whole words."""
    c, es, stride_b, ptr, want = case
    assert _build.batch_copy_path(channels=c, elem_bytes=es, stride_b=stride_b, ptr=ptr) == want
    ct = _build.batch_plan(1, 64, c)["channel_tile"]
    for bit, unit in ((VEC, 16), (WORDS, 4)):
        if not want & bit or (bit == VEC and ct == c):
            continue
        for b in range(3):
            for c0 in range(0, c, ct):
                cn = min(ct, c - c0)
                for r in (0, 1, 7):
                    assert (ptr + ((b * stride_b) + r * c + c0) * es) % unit == 0
                    assert cn * es % unit == 0


# (x's offset into its allocation in samples, B, S, C, stream, rows [first,
# end), whether the granules that cover the rows lie inside x): a window at
# x's first row when x starts off 16 bytes, or ending in the last granule of
# an x whose end is off 16 bytes, would read bytes outside it.
GRANULE_CASES = (
    (0, 2, 9, 1, 0, 0, 5, True),
    (1, 2, 9, 1, 0, 0, 5, False),
    (1, 2, 9, 1, 0, 7, 12, True),
    (0, 2, 9, 1, 1, 3, 9, False),
    (0, 2, 8, 1, 1, 3, 8, True),
    (2, 3, 40, 2, 1, 0, 40, True),
    (3, 1, 64, 3, 0, 2, 60, True),
)


@pytest.mark.parametrize("case", GRANULE_CASES, ids=str)
def test_torch_batch_flat_granules_stay_inside_x(case):
    """batch_kernels.cu granules_inside_x, mirrored (chip_smoke's path
    mirror reads it): the 16-byte granules that cover a flat window's bytes
    hold them, and lie inside x's B streams exactly when the case says."""
    off, b, s, c, i, first, end, want = case
    xb = torch.zeros(b * s * c + off, dtype=torch.int16)[off:].view(b, s, c)
    assert xb.data_ptr() % 16 == 2 * off % 16
    assert chip_smoke._granules_inside_x(xb, i, first, end) == want
    lo = xb.data_ptr() + (i * s + first) * c * 2
    hi = xb.data_ptr() + (i * s + end) * c * 2
    assert lo & ~15 <= lo < hi <= (hi + 15) & ~15


def test_torch_batch_cases_take_every_path(monkeypatch):
    """chip_smoke.BATCH_CASES, built on the CPU and run through the plain
    version, take every one of chip_smoke.BATCH_PATHS by the plan's mirror
    (batch_case_paths), as the chip run requires of the kernel's launches."""
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    gen = torch.Generator().manual_seed(1)
    paths = set()
    for _, spec in chip_smoke.BATCH_CASES:
        table, x, totals, state, quota, kw = chip_smoke.batch_case_inputs(spec, gen)
        got = resample_chunk_reference(table, x, totals, state, quota, **kw)
        paths |= chip_smoke.batch_case_paths(x, state, got[1], **kw)
    assert paths == chip_smoke.BATCH_PATHS, sorted(chip_smoke.BATCH_PATHS - paths)


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
