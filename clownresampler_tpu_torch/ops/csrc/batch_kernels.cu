// Hand-written Hopper (sm_90a) kernel for B independent streams, one chunk call each.
//
// batch_mac_kernel has no Pallas counterpart: it replaces the code XLA
// compiles for the JAX package's resample_chunk (clownresampler_tpu/lowlevel.py:94,
// its gather convolve_frames, clownresampler_tpu/ops/convolve.py:80) under
// jax.vmap (batch.resample_batch) and shard_map (parallel.sharded_resample_batch).
// One launch computes, for every stream b of a (B, S, C) stream-major input,
// what one LowLevel_Resample call returns (clownresampler.h:1058-1092):
//  - Frames. Output frame n < produced of stream b and channel c is
//        acc = sum_t trunc(x[b][row + t][c] * k[t] / 2^16),  out = trunc(acc * q / 2^15)
//    with the frame's window, masked LUT taps and one 17.15 reciprocal from
//    the stream's own state and configuration (mac_common.cuh frame_window,
//    reciprocal_q31), every tap row clamped into [0, S) as the gather clamps
//    it; frames from `produced` on are stored as 0.
//  - Bookkeeping, by thread 0 of the stream's first block, in int64: the
//    natural frame count (the position check, 1063), produced = min(natural,
//    quota, n_out), the state after the produced frames with the
//    carry/rewind (1063-1068, 1084-1088), consumed, and exhausted = natural
//    < min(quota, n_out).
// Every per-stream scalar is read by pointer from device memory: no host sync.
//
// What bounds it on the H100: bytes. At config 5's fleet (1024 stereo int16
// streams, 8192 input frames, 16,384 output frames each) it writes 134 MB, of
// which the zero frames past each stream's `produced` are about 106 MB, and
// reads about 12.5 MB of input rows; the taps are 5-12 live a frame, 0.011 ms
// of operations on the CUDA cores (the per-term truncation rules out tensor
// cores). What the design does about it:
//  - A block takes a long range of one stream: grid (frame ranges, channel
//    tiles, B). The host sizes the ranges from B, N and C alone so that a
//    launch has about 4096 blocks (ops/_build.py batch_plan; at the fleet
//    four ranges of 4096 frames a stream); only the card knows `produced`.
//    The stream's call is worked out once a block, with no barrier: every
//    thread reads the ten leaves and does the int64 division.
//  - The block's frames from `produced` on are zero. When the block takes
//    all C channels ("flat": C <= the channel tile) they are one contiguous
//    span of the output, stored as 16-byte streaming stores between a scalar
//    head up to 16-byte alignment and a scalar tail; with channel tiles
//    (wide C) each frame's part is a row of 4-channel 16-byte stores when C
//    is a multiple of 4.
//  - The live frames go through shared memory in stages: two stages, the
//    next stage's window rows in flight (cp.async) while this stage's frames
//    run. The copy takes whole 16-byte granules when the host says the slab
//    allows it (flat: one contiguous byte range, its granules covering it,
//    the first row's offset in the first granule kept, where those granules
//    lie inside x's streams; channel tiles: rows whose every segment is
//    16-byte aligned), else 4-byte words or element loads; a window
//    reaching rows outside [0, S) takes words or element loads, each row
//    clamped, so it holds what the gather reads there. The frames a stage
//    takes follow the stream's increment and live-tap bound, which only the
//    card holds.
//  - Flat blocks of C <= 4 (the fleet's stereo; its own instantiation,
//    NC = C): a thread takes a frame and all its channels, so the frame's
//    geometry (frame_window, the live taps, their 17.15 reciprocal) is
//    worked out once, in registers, each tap's LUT value serves the C
//    channels, and the frame's C ints are one store (8 bytes for stereo, 16
//    for four channels). Its stage is its window alone (up to 2048 frames).
//  - Any other C (NC = 0): 4 output ints a thread (flat: quads of the span,
//    16-byte aligned; channel tiles: 4 channels of a frame), so a frame's
//    channels are spread over threads. Each frame's geometry is worked out
//    once into the stage's shared memory (its window row, live taps and
//    reciprocal), and the tap loop reads taps and rows from there, no global
//    load and no clamp; the next stage's geometry follows this one's MACs.
//  - A stream whose stage does not fit (taps in the thousands, or a fast
//    increment) reads x directly, so any max_taps is one launch.
//
// Built by ops/_build.py with nvcc into a shared library with a plain C
// interface; the Python side (ops/_build.batch_launch_args) checks devices,
// dtypes, shapes, strides and alignment before it passes pointers, and the
// entry returns cudaGetLastError().

#include <algorithm>

#include "mac_common.cuh"

namespace {

constexpr int BATCH_THREADS = 256;
// Blocks an SM should hold at once: registers for four (64 a thread), as the
// two stages' 48 KB of shared memory allow four. (Six or eight, at 40 or 32
// registers, measured slower on the H100: PERF.md.)
constexpr int BATCH_MIN_BLOCKS = 4;
// Frames of a stage: at most BATCH_MAX_TILE; a stream whose stage of
// BATCH_MIN_TILE frames does not fit the stage bytes reads x directly.
constexpr int BATCH_MAX_TILE = 512;
constexpr int BATCH_MIN_TILE = 8;
// Frames of a stage when a thread takes a frame (flat, C <= 4): at most this many.
constexpr int BATCH_MAX_THREAD_TILE = 2048;
// Bytes of each of a block's two stages: 2 x 24 KB, the most dynamic shared
// memory a block takes without opting in to more, and four blocks an SM.
constexpr int BATCH_STAGE_BYTES = 24576;
// How a stage's window may be copied (ops/_build.py batch_copy_path), bits:
// VEC, as 16-byte granules where every row lies inside [0, S); WORDS, as
// 4-byte words with each row clamped (every row segment whole words at
// 4-byte aligned addresses); neither (PLAIN): element by element.
constexpr int BATCH_COPY_PLAIN = 0;
constexpr int BATCH_COPY_VEC = 1;
constexpr int BATCH_COPY_WORDS = 2;

struct BatchParams {
    const void* x;                    // (B, S, C) int16 or int32, each stream's (S, C) contiguous
    long long stride_b;               // elements from one stream to the next
    int S, C;
    // Per-stream (B,) int32 leaves in device memory.
    const int *totals, *quotas, *p0, *f0;
    const int *inc_hi, *inc_lo, *radius, *delta, *int_radius, *step;
    const int* table;
    int table_size;
    int T, N;                         // max_taps, n_out
    int CT, NR;                       // channels a block, frames a block
    int copy;                         // BATCH_COPY_VEC | BATCH_COPY_WORDS, or PLAIN
    int* out;                         // (B, N, C) int32, 16-byte aligned
    int *produced, *consumed, *p_out, *f_out;
    unsigned char* exhausted;
};

// Stream b's phase and window geometry (LaunchGeometry, mac_common.cuh).
__device__ __forceinline__ LaunchGeometry stream_geometry(const BatchParams& P, int b) {
    LaunchGeometry g;
    g.p0 = __ldg(P.p0 + b);
    g.f0 = __ldg(P.f0 + b);
    g.inc = static_cast<long long>(__ldg(P.inc_hi + b)) * 65536 + __ldg(P.inc_lo + b);
    g.radius = __ldg(P.radius + b);
    g.delta = __ldg(P.delta + b);
    g.int_radius = __ldg(P.int_radius + b);
    g.step = __ldg(P.step + b);
    return g;
}

// Stream b's call (lowlevel.resample_chunk_reference), in int64: the natural
// count is ceil(((N - p0) * 2^16 - f0) / inc), 0 when that is not positive.
struct StreamCall {
    long long total, natural, quota, produced;
};

__device__ __forceinline__ StreamCall stream_call(const BatchParams& P, const LaunchGeometry& g,
                                                  int b) {
    StreamCall s;
    s.total = __ldg(P.totals + b);
    const long long num = (s.total - g.p0) * 65536 - g.f0;
    s.natural = num > 0 ? (num + g.inc - 1) / (g.inc > 1 ? g.inc : 1) : 0;
    s.quota = min(static_cast<long long>(__ldg(P.quotas + b)), static_cast<long long>(P.N));
    s.produced = min(s.natural, s.quota);
    return s;
}

// Stream b's results: the produced frames advance the phase, then the
// unified carry/rewind, delta = min(position, N), covers both exits.
__device__ __forceinline__ void write_results(const BatchParams& P, const LaunchGeometry& g,
                                              const StreamCall& s, int b) {
    const long long t = g.f0 + s.produced * g.inc;
    const long long p_after = g.p0 + (t >> 16);
    const long long consumed = min(p_after, s.total);
    P.produced[b] = static_cast<int>(s.produced);
    P.consumed[b] = static_cast<int>(consumed);
    P.p_out[b] = static_cast<int>(p_after - consumed);
    P.f_out[b] = static_cast<int>(t & 0xFFFF);
    P.exhausted[b] = s.natural < s.quota ? 1 : 0;
}

// A block: stream b, channels [c0, c0 + cn); flat when cn == C, its frames
// then one contiguous span of the output. base: the output index of the
// stream's frame 0, channel 0.
struct BatchBlock {
    int b, c0, cn;
    bool flat;
    long long base;
};

// The most live taps a frame of the stream has, at most T: frame_window's
// min_rel and max_rel are both nondecreasing in the phase's fraction, so
// taps <= int_radius + max_rel(0xFFFF) - min_rel(0). A stage's window rows
// and its taps a frame are sized by it.
__device__ __forceinline__ int tap_stride(const LaunchGeometry& g, int T) {
    const int most = g.int_radius + ((0xFFFF + g.radius) >> 16) - ((g.delta + 0xFFFF) >> 16);
    return max(1, min(most, T));
}

// Bytes of a stage's window of `rows` rows x cn channels: whole 16-byte
// granules and one more, for a first row that starts inside its granule.
template <typename SrcT>
__device__ __forceinline__ long long window_bytes(long long rows, int cn) {
    return (rows * cn * static_cast<long long>(sizeof(SrcT)) + 15) / 16 * 16 + 16;
}

// Frames a stage takes (ops/_build.py batch_stage_frames mirrors it): the
// most of BATCH_MAX_TILE -- BATCH_MAX_THREAD_TILE by_thread --, /2, ...,
// BATCH_MIN_TILE (no more than the live frames need) whose window -- at most
// ceil((F - 1) * inc / 2^16) + TL rows, as a frame's first row is p0 +
// ceil((f0 + n*inc + delta) / 2^16) -- and geometry (TL taps and three ints
// a frame; none by_thread, where a thread keeps its frame's in registers)
// fit the BATCH_STAGE_BYTES of a stage; *wb is the window's bytes. 0: none
// fits (read x directly).
template <typename SrcT>
__device__ __forceinline__ int stage_frames(const LaunchGeometry& g, int TL, int cn, int frames,
                                            bool by_thread, int* wb) {
    int F = by_thread ? BATCH_MAX_THREAD_TILE : BATCH_MAX_TILE;
    while (F > BATCH_MIN_TILE && F / 2 >= frames) F >>= 1;
    for (; F >= BATCH_MIN_TILE; F >>= 1) {
        const long long w = window_bytes<SrcT>((((F - 1) * g.inc + 0xFFFF) >> 16) + TL, cn);
        if (w + (by_thread ? 0 : 4LL * F * (TL + 3)) <= BATCH_STAGE_BYTES) {
            *wb = static_cast<int>(w);
            return F;
        }
    }
    return 0;
}

// A stage's window: input rows [first, first + rows) of the block's
// channels, from byte `off` of the stage on (rows x cn elements), copied as
// `mode` says: BATCH_COPY_VEC (16-byte granules; every row inside [0, S),
// and a flat window's granules, which round its byte range out to 16 bytes,
// inside x's B streams), BATCH_COPY_WORDS (4-byte words, each row clamped
// into [0, S)) or BATCH_COPY_PLAIN (element loads, each row clamped).
struct Window {
    int first, rows, off, mode;
};

// Whether the 16-byte granules that cover bytes [lo, hi) lie inside x's
// B = gridDim.z streams, so that a flat window's copy reads no byte of
// another allocation.
template <typename SrcT>
__device__ __forceinline__ bool granules_inside_x(const BatchParams& P, const SrcT* lo,
                                                  const SrcT* hi) {
    const uintptr_t x0 = reinterpret_cast<uintptr_t>(P.x);
    const uintptr_t x1 = reinterpret_cast<uintptr_t>(
        static_cast<const SrcT*>(P.x) + (gridDim.z - 1LL) * P.stride_b +
        static_cast<long long>(P.S) * P.C);
    return (reinterpret_cast<uintptr_t>(lo) & ~uintptr_t{15}) >= x0 &&
           ((reinterpret_cast<uintptr_t>(hi) + 15) & ~uintptr_t{15}) <= x1;
}

template <typename SrcT>
__device__ __forceinline__ Window stage_window(const BatchParams& P, const LaunchGeometry& g,
                                               const BatchBlock& k, const SrcT* xs, int a, int e,
                                               int TL) {
    Window w;
    w.first = frame_window(g, a).row;
    w.rows = frame_window(g, e - 1).row - w.first + TL;
    const SrcT* const row0 = xs + static_cast<long long>(w.first) * P.C;
    w.mode = (P.copy & BATCH_COPY_VEC) && w.first >= 0 && w.first + w.rows <= P.S &&
                     (!k.flat || granules_inside_x(P, row0, row0 + w.rows * P.C))
                 ? BATCH_COPY_VEC
                 : P.copy & BATCH_COPY_WORDS;
    w.off = w.mode == BATCH_COPY_VEC && k.flat
                ? static_cast<int>(reinterpret_cast<uintptr_t>(row0) & 15)
                : 0;
    return w;
}

// Start the copy of window w into `win` (a stage's start, 16-byte aligned).
template <typename SrcT>
__device__ __forceinline__ void copy_window(const BatchParams& P, const BatchBlock& k,
                                            const SrcT* xs, const Window& w, unsigned char* win) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(win));
    constexpr int ES = sizeof(SrcT);
    if (w.mode == BATCH_COPY_VEC && k.flat) {
        // One contiguous byte range: the granules that cover it.
        const char* src =
            reinterpret_cast<const char*>(xs + static_cast<long long>(w.first) * P.C) - w.off;
        const int granules = (w.off + w.rows * P.C * ES + 15) / 16;
        for (int i = threadIdx.x; i < granules; i += BATCH_THREADS) {
            cp_async16(dst + 16 * i, src + 16 * i, true);
        }
    } else if (w.mode == BATCH_COPY_VEC) {
        // Rows of cn channels, each segment whole 16-byte granules (batch_copy_path).
        const int per_row = k.cn * ES / 16;
        for (int i = threadIdx.x; i < w.rows * per_row; i += BATCH_THREADS) {
            const int r = i / per_row, j = i - r * per_row;
            cp_async16(dst + 16 * i,
                       reinterpret_cast<const char*>(
                           xs + static_cast<long long>(w.first + r) * P.C + k.c0) + 16 * j,
                       true);
        }
    } else if (w.mode == BATCH_COPY_WORDS) {
        // Rows of whole 4-byte words, each row clamped: a window at the
        // buffer's edges still copies asynchronously.
        const int per_row = k.cn * ES / 4;
        for (int i = threadIdx.x; i < w.rows * per_row; i += BATCH_THREADS) {
            const int r = i / per_row, j = i - r * per_row;
            cp_async4(dst + 4 * i,
                      reinterpret_cast<const char*>(
                          xs + static_cast<long long>(clamp_row(w.first + r, P.S - 1)) * P.C +
                          k.c0) + 4 * j,
                      true);
        }
    } else {
        SrcT* v = reinterpret_cast<SrcT*>(win);
#pragma unroll 4
        for (int i = threadIdx.x; i < w.rows * k.cn; i += BATCH_THREADS) {
            const int r = i / k.cn, c = i - r * k.cn;
            v[i] = __ldg(xs + static_cast<long long>(clamp_row(w.first + r, P.S - 1)) * P.C +
                         k.c0 + c);
        }
    }
    cp_async_commit();
}

// One of mac_frames' two stages: the window (from byte 0), then its frames'
// taps kv [F][TL], window rows relative to its first row rl [F], live
// counts lv [F] and reciprocals q [F].
struct StageView {
    unsigned char* win;
    int *kv, *rl, *lv, *q;
};

__device__ __forceinline__ StageView stage_view(unsigned char* stage, int wb, int F, int TL) {
    StageView v;
    v.win = stage;
    v.kv = reinterpret_cast<int*>(stage + wb);
    v.rl = v.kv + F * TL;
    v.lv = v.rl + F;
    v.q = v.lv + F;
    return v;
}

// A stage's geometry, frames [a, a + nb) of its F: each frame's live taps
// (at most TL) from the LUT into kv[f][TL], its window row relative to the
// stage's first row, its live count and its 17.15 reciprocal. Under 256
// frames, 256 / F threads share a frame, its taps split between them and
// their sum reduced by shuffles; else a thread takes every 256th frame.
__device__ __forceinline__ void stage_geometry(const BatchParams& P, const LaunchGeometry& g,
                                               int a, int nb, int F, int TL, int first,
                                               const StageView& s) {
    int *const kv = s.kv, *const rl = s.rl, *const lv = s.lv, *const q = s.q;
    const int tpf = max(1, BATCH_THREADS / F);
    const int part = threadIdx.x % tpf;
    for (int f = threadIdx.x / tpf; f < F; f += BATCH_THREADS / tpf) {
        const FrameWindow w = frame_window(g, a + f);
        const int live = f < nb ? min(max(w.taps, 0), TL) : 0;
        int sum = 0;
        for (int j = part; j < live; j += tpf) {
            const int v =
                __ldg(P.table + min(max(w.kernel_start + j * g.step, 0), P.table_size - 1));
            kv[f * TL + j] = v;
            sum += v;
        }
        for (int o = tpf / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (f < nb && part == 0) {
            q[f] = reciprocal_q31(sum);
            rl[f] = w.row - first;
            lv[f] = live;
        }
    }
}

// Frames [a, e) of the block, each output int value(n, cc) (cc: the channel
// less c0). Flat: quads of the span [a*C, e*C) aligned to 16 bytes of the
// output, one 16-byte store each, the partial quads at the span's ends by
// element; channel tiles: 4 channels of a frame a thread, one 16-byte store
// when C is a multiple of 4.
template <typename Value>
__device__ __forceinline__ void store_frames(const BatchParams& P, const BatchBlock& k, int a,
                                             int e, Value value) {
    if (k.flat) {
        const int C = P.C, la = a * C, le = e * C;
        const int l0 = la - static_cast<int>((k.base + la) & 3);
        for (int l = l0 + 4 * static_cast<int>(threadIdx.x); l < le; l += 4 * BATCH_THREADS) {
            const int s = max(l, la);
            int n = s / C, c = s - n * C;
            int v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                v[j] = 0;
                if (l + j >= s && l + j < le) {
                    v[j] = value(n, c);
                    if (++c == C) {
                        c = 0;
                        ++n;
                    }
                }
            }
            int* o = P.out + k.base + l;
            if (l >= la && l + 4 <= le) {
                __stcs(reinterpret_cast<int4*>(o), make_int4(v[0], v[1], v[2], v[3]));
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (l + j >= la && l + j < le) o[j] = v[j];
                }
            }
        }
        return;
    }
    const int qpf = (k.cn + 3) / 4;
    const bool vec = P.C % 4 == 0;
    for (int i = threadIdx.x; i < (e - a) * qpf; i += BATCH_THREADS) {
        const int f = i / qpf, c = 4 * (i - f * qpf);
        const int n = a + f;
        int v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = c + j < k.cn ? value(n, c + j) : 0;
        int* o = P.out + k.base + static_cast<long long>(n) * P.C + k.c0 + c;
        if (vec) {
            __stcs(reinterpret_cast<int4*>(o), make_int4(v[0], v[1], v[2], v[3]));
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                if (c + j < k.cn) o[j] = v[j];
            }
        }
    }
}

// The value of every output int for store_frames: 0.
struct ZeroValue {
    __device__ __forceinline__ int operator()(int, int) const { return 0; }
};

// Frames [a, e) of the block stored as 0. Flat: one contiguous span, a
// scalar head up to 16-byte alignment, 16-byte streaming stores, a scalar
// tail.
__device__ __forceinline__ void store_zeros(const BatchParams& P, const BatchBlock& k, int a,
                                            int e) {
    if (a >= e) return;
    if (!k.flat) {
        store_frames(P, k, a, e, ZeroValue{});
        return;
    }
    const long long e0 = k.base + static_cast<long long>(a) * P.C;
    const long long e1 = k.base + static_cast<long long>(e) * P.C;
    const long long h = min((e0 + 3) & ~3LL, e1), t = max(h, e1 & ~3LL);
    for (long long i = e0 + threadIdx.x; i < h; i += BATCH_THREADS) P.out[i] = 0;
    int4* const q = reinterpret_cast<int4*>(P.out);
    for (long long i = h / 4 + threadIdx.x; i < t / 4; i += BATCH_THREADS) {
        __stcs(q + i, make_int4(0, 0, 0, 0));
    }
    for (long long i = t + threadIdx.x; i < e1; i += BATCH_THREADS) P.out[i] = 0;
}

// Frame n of channel c when its window is not staged: its live taps (at most
// T) from the clamped LUT and x directly, each row clamped into [0, S).
template <typename SrcT>
__device__ __forceinline__ int direct_value(const BatchParams& P, const LaunchGeometry& g,
                                            const SrcT* xs, int n, int c) {
    const FrameWindow w = frame_window(g, n);
    const int live = min(max(w.taps, 0), P.T);
    int acc = 0, sum = 0;
    for (int j = 0; j < live; ++j) {
        const int k = __ldg(P.table + min(max(w.kernel_start + j * g.step, 0), P.table_size - 1));
        const long long row = clamp_row(w.row + j, P.S - 1);
        acc = macc_trunc(acc, static_cast<int>(__ldg(xs + row * P.C + c)), k);
        sum += k;
    }
    return mul_shift15(acc, reciprocal_q31(sum));
}

// The value of output int (frame n, channel c0 + c) for store_frames, read
// from x directly.
template <typename SrcT>
struct DirectValue {
    const BatchParams& P;
    const LaunchGeometry& g;
    const SrcT* xs;
    int c0;
    __device__ __forceinline__ int operator()(int n, int c) const {
        return direct_value<SrcT>(P, g, xs, n, c0 + c);
    }
};

// The value of output int (frame n, channel c) for store_frames from a
// stage whose first frame is a: the frame's taps and row from the stage's
// geometry, its samples from the window (v0: its first row), no global load
// and no clamp.
template <typename SrcT>
struct StagedValue {
    const SrcT* v0;
    StageView s;
    int a, cn, TL;
    __device__ __forceinline__ int operator()(int n, int c) const {
        const int f = n - a;
        const SrcT* v = v0 + s.rl[f] * cn + c;
        const int* kk = s.kv + f * TL;
        const int live = s.lv[f];
        int acc = 0;
#pragma unroll 4
        for (int j = 0; j < live; ++j) acc = macc_trunc(acc, static_cast<int>(v[j * cn]), kk[j]);
        return mul_shift15(acc, s.q[f]);
    }
};

// Frames [a, e) of a flat block of NC <= 4 channels from a staged window
// (v0: input row `first`): a thread takes a frame and all its channels, so
// the frame's geometry (frame_window, its live taps, their reciprocal) is
// worked out once, in registers, and each tap's LUT value serves the NC
// channels; the frame's NC ints are one store (8 bytes for stereo, 16 for
// four channels).
template <int NC, typename SrcT>
__device__ __forceinline__ void frames_by_thread(const BatchParams& P, const LaunchGeometry& g,
                                                 const BatchBlock& k, const SrcT* v0, int first,
                                                 int a, int e) {
    for (int n = a + threadIdx.x; n < e; n += BATCH_THREADS) {
        const FrameWindow w = frame_window(g, n);
        const int live = min(max(w.taps, 0), P.T);
        const SrcT* v = v0 + (w.row - first) * NC;
        int acc[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = 0;
        int sum = 0, idx = w.kernel_start;
#pragma unroll 4
        for (int j = 0; j < live; ++j, idx += g.step, v += NC) {
            const int kj = __ldg(P.table + min(max(idx, 0), P.table_size - 1));
            sum += kj;
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[c] = macc_trunc(acc[c], static_cast<int>(v[c]), kj);
        }
        const int q = reciprocal_q31(sum);
        int* o = P.out + k.base + static_cast<long long>(n) * NC;
        if (NC == 2) {
            __stcs(reinterpret_cast<int2*>(o), make_int2(mul_shift15(acc[0], q),
                                                         mul_shift15(acc[NC - 1], q)));
        } else if (NC == 4) {
            __stcs(reinterpret_cast<int4*>(o),
                   make_int4(mul_shift15(acc[0], q), mul_shift15(acc[1 % NC], q),
                             mul_shift15(acc[2 % NC], q), mul_shift15(acc[NC - 1], q)));
        } else {
#pragma unroll
            for (int c = 0; c < NC; ++c) o[c] = mul_shift15(acc[c], q);
        }
    }
}

// A flat block's live frames [n0, n_end) at NC <= 4 channels: stages of F
// frames, each its window alone in shared memory (stage i at
// smem + i * BATCH_STAGE_BYTES), the next stage's window in flight while
// this one's frames run (frames_by_thread). One barrier a stage: the next
// copy into a stage is issued after the barrier that follows the last reads
// of it.
template <int NC, typename SrcT>
__device__ __forceinline__ void mac_frames_by_thread(const BatchParams& P,
                                                     const LaunchGeometry& g,
                                                     const BatchBlock& k, const SrcT* xs,
                                                     int TL, int n0, int n_end,
                                                     unsigned char* smem) {
    int wb = 0;
    const int F = stage_frames<SrcT>(g, TL, NC, n_end - n0, true, &wb);
    if (F == 0) {
        store_frames(P, k, n0, n_end, DirectValue<SrcT>{P, g, xs, 0});
        return;
    }
    const int stages = (n_end - n0 + F - 1) / F;
    Window w = stage_window(P, g, k, xs, n0, min(n0 + F, n_end), TL);
    copy_window(P, k, xs, w, smem);
    for (int t = 0, i = 0;; ++t, i ^= 1) {
        cp_async_wait_all();
        __syncthreads();
        const int a = n0 + t * F, e = min(a + F, n_end);
        const bool more = t + 1 < stages;
        Window nw{};
        if (more) {
            nw = stage_window(P, g, k, xs, e, min(e + F, n_end), TL);
            copy_window(P, k, xs, nw, smem + (i ^ 1) * BATCH_STAGE_BYTES);
        }
        const unsigned char* const win = smem + i * BATCH_STAGE_BYTES + w.off;
        frames_by_thread<NC, SrcT>(P, g, k, reinterpret_cast<const SrcT*>(win), w.first, a, e);
        if (!more) break;
        w = nw;
    }
}

// The block's live frames [n0, n_end) through two stages of shared memory
// (stage i at smem + i * BATCH_STAGE_BYTES: the window, then kv [F][TL],
// rows [F], live counts [F], reciprocals [F]). While stage t's MACs run, stage t + 1's
// window is in flight; its geometry follows them. One barrier a stage.
template <typename SrcT>
__device__ __forceinline__ void mac_frames(const BatchParams& P, const LaunchGeometry& g,
                                           const BatchBlock& k, int n0, int n_end,
                                           unsigned char* smem) {
    const SrcT* const xs = static_cast<const SrcT*>(P.x) + k.b * P.stride_b;
    const int TL = tap_stride(g, P.T);
    int wb = 0;
    const int F = stage_frames<SrcT>(g, TL, k.cn, n_end - n0, false, &wb);
    if (F == 0) {
        store_frames(P, k, n0, n_end, DirectValue<SrcT>{P, g, xs, k.c0});
        return;
    }
    const int stages = (n_end - n0 + F - 1) / F;
    Window w = stage_window(P, g, k, xs, n0, min(n0 + F, n_end), TL);
    copy_window(P, k, xs, w, smem);
    stage_geometry(P, g, n0, min(F, n_end - n0), F, TL, w.first, stage_view(smem, wb, F, TL));
    for (int t = 0;; ++t) {
        cp_async_wait_all();
        __syncthreads();
        const StageView cur = stage_view(smem + (t & 1) * BATCH_STAGE_BYTES, wb, F, TL);
        const StageView nxt = stage_view(smem + (~t & 1) * BATCH_STAGE_BYTES, wb, F, TL);
        const int a = n0 + t * F, e = min(a + F, n_end);
        const bool more = t + 1 < stages;
        Window nw{};
        if (more) {
            nw = stage_window(P, g, k, xs, e, min(e + F, n_end), TL);
            copy_window(P, k, xs, nw, nxt.win);
        }
        store_frames(P, k, a, e,
                     StagedValue<SrcT>{reinterpret_cast<const SrcT*>(cur.win + w.off), cur, a,
                                       k.cn, TL});
        if (!more) break;
        stage_geometry(P, g, e, min(F, n_end - e), F, TL, nw.first, nxt);
        w = nw;
    }
}

// Block (frame range, channel tile, b): frames [n0, n0 + NR) x channels
// [c0, c0 + CT) of stream b; the live frames first, then the zeros (so the
// first window's loads do not queue behind the block's stores; measured
// faster on the H100, PERF.md). NC 1-4:
// C = NC, every block flat, a thread a frame (mac_frames_by_thread); NC 0:
// any other C, the frames' geometry in shared memory (mac_frames). Each is
// its own instantiation, so the main path's registers are its own.
template <typename SrcT, int NC>
__global__ void __launch_bounds__(BATCH_THREADS, BATCH_MIN_BLOCKS)
batch_mac_kernel(const BatchParams P) {
    extern __shared__ int4 smem4[];
    const int b = blockIdx.z;
    const LaunchGeometry g = stream_geometry(P, b);
    const StreamCall s = stream_call(P, g, b);
    if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) write_results(P, g, s, b);
    BatchBlock k;
    k.b = b;
    k.c0 = blockIdx.y * P.CT;
    k.cn = min(P.CT, P.C - k.c0);
    k.flat = NC > 0 || k.cn == P.C;
    k.base = static_cast<long long>(b) * P.N * P.C;
    const int n0 = blockIdx.x * P.NR;
    const int n1 = min(n0 + P.NR, P.N);
    const int live_end = max(n0, min(static_cast<int>(s.produced), n1));
    if (live_end > n0) {
        unsigned char* const smem = reinterpret_cast<unsigned char*>(smem4);
        if constexpr (NC > 0) {
            const SrcT* const xs = static_cast<const SrcT*>(P.x) + b * P.stride_b;
            mac_frames_by_thread<NC, SrcT>(P, g, k, xs, tap_stride(g, P.T), n0, live_end, smem);
        } else {
            mac_frames<SrcT>(P, g, k, n0, live_end, smem);
        }
    }
    store_zeros(P, k, live_end, n1);
}

template <typename SrcT>
int launch_batch(const BatchParams& P, int B, cudaStream_t stream) {
    const dim3 grid(std::max(1, (P.N + P.NR - 1) / P.NR), (P.C + P.CT - 1) / P.CT, B);
    constexpr int smem = 2 * BATCH_STAGE_BYTES;
    switch (P.CT >= P.C ? P.C : 0) {
        case 1: batch_mac_kernel<SrcT, 1><<<grid, BATCH_THREADS, smem, stream>>>(P); break;
        case 2: batch_mac_kernel<SrcT, 2><<<grid, BATCH_THREADS, smem, stream>>>(P); break;
        case 3: batch_mac_kernel<SrcT, 3><<<grid, BATCH_THREADS, smem, stream>>>(P); break;
        case 4: batch_mac_kernel<SrcT, 4><<<grid, BATCH_THREADS, smem, stream>>>(P); break;
        default: batch_mac_kernel<SrcT, 0><<<grid, BATCH_THREADS, smem, stream>>>(P);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B streams' chunk calls in one launch. x is (B, S, C) int16 (x_s16) or
// int32 with each stream's rows contiguous, stride_b elements apart; the
// ten per-stream leaves are (B,) int32; out is (B, N, C) int32 (16-byte
// aligned; any other is refused), the four result leaves (B,) int32 and
// exhausted (B,) bytes. A block takes channel_tile channels of range_frames
// frames of one stream, with two stages of BATCH_STAGE_BYTES of shared
// memory, its windows copied as `copy` says (ops/_build.py batch_plan,
// batch_copy_path). Returns a cudaError_t.
int crt_batch_mac(const void* x, int x_s16, int B, int S, int C, long long stride_b,
                  const int* totals, const int* quotas, const int* p0_ptr, const int* f0_ptr,
                  const int* inc_hi, const int* inc_lo, const int* radius, const int* delta,
                  const int* int_radius, const int* step, const int* table, int table_size,
                  int T, int N, int channel_tile, int range_frames, int copy,
                  int* out, int* produced, int* consumed, int* p_out, int* f_out,
                  unsigned char* exhausted, int device, void* stream) {
    if (reinterpret_cast<uintptr_t>(out) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const BatchParams P{x, stride_b, S, C, totals, quotas, p0_ptr, f0_ptr, inc_hi, inc_lo,
                        radius, delta, int_radius, step, table, table_size, T, N,
                        channel_tile, range_frames, copy, out, produced, consumed,
                        p_out, f_out, exhausted};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return x_s16 ? launch_batch<int16_t>(P, B, s) : launch_batch<int32_t>(P, B, s);
}

}  // extern "C"
