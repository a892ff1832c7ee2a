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
//  - Bookkeeping, by thread 0 of block (0, 0, b), in int64: the natural frame
//    count (the position check, 1063), produced = min(natural, quota, n_out),
//    the state after the produced frames with the carry/rewind (1063-1068,
//    1084-1088), consumed, and exhausted = natural < min(quota, n_out).
// Every per-stream scalar is read by pointer from device memory: no host sync.
//
// What bounds it on the H100: bytes. At config 5's fleet (1024 stereo int16
// streams, 8192 input frames, 16,384 output frames each) it reads 34 MB and
// writes 134 MB, 0.050 ms at 3.35 TB/s, against ~535 M tap operations, 0.032
// ms on the CUDA cores (the per-term truncation rules out tensor cores). What
// the design does about it:
//  - Grid (frame tiles, channel tiles, B); threads span (frame, channel) with
//    the channel fastest, so a stereo stream packs 128 frames into a block's
//    row of threads and the stores of consecutive threads are consecutive.
//  - Early exit: a block whose tile starts at or past its stream's `produced`
//    stores zeros and does no MAC.
//  - Staging: the block copies the union of a stage's windows -- one span of
//    rows of its channels, contiguous for a stream-major slab -- into shared
//    memory with cp.async (4-byte words; int16 slabs that are not word-aligned
//    take plain loads), and every frame reads its taps from there. The host
//    sizes the window (rows, from max_taps and the tile's frames at an
//    increment of BATCH_STAGE_INCREMENT); the frames a stage takes follow the
//    stream's own increment, which only the card holds: the tile's frames,
//    halved until their window fits. A stage whose window still does not fit
//    (taps in the thousands, or a fast increment) reads x directly, so any
//    max_taps is one launch.
//  - The output is written once, 4 bytes a thread, coalesced.
//
// Built by ops/_build.py with nvcc into a shared library with a plain C
// interface; the Python side (ops/_build.batch_launch_args) checks devices,
// dtypes, shapes and strides before it passes pointers, and the entry returns
// cudaGetLastError().

#include <algorithm>

#include "mac_common.cuh"

namespace {

constexpr int BATCH_THREADS = 256;

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
    int CT, TF, W;                    // channels a block, frames a block, staged rows a stage
    int words;                        // rows stage as 4-byte words (cp.async)
    int* out;                         // (B, N, C) int32
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

// Rows [first, first + rows) of the stream's channels [c0, c0 + cn) into
// win (rows x CT elements), each row clamped into [0, S) as the gather
// clamps a tap's row; returns when the rows are in shared memory.
template <typename SrcT>
__device__ __forceinline__ void stage_rows(const BatchParams& P, const SrcT* xs, int first,
                                           int rows, int c0, int cn, SrcT* win) {
    if (P.words) {
        constexpr int PER = 4 / sizeof(SrcT);    // elements a word
        const int wpr = cn / PER;                // words a row
        const int total = rows * wpr;
        for (int i = threadIdx.x; i < total; i += BATCH_THREADS) {
            const int r = i / wpr, w = i - r * wpr;
            const SrcT* src = xs + static_cast<long long>(clamp_row(first + r, P.S - 1)) * P.C +
                              c0 + w * PER;
            cp_async4(static_cast<unsigned>(__cvta_generic_to_shared(win + r * P.CT + w * PER)),
                      src, true);
        }
        cp_async_commit();
        cp_async_wait_all();
        return;
    }
    const int total = rows * cn;
    for (int i = threadIdx.x; i < total; i += BATCH_THREADS) {
        const int r = i / cn, c = i - r * cn;
        win[r * P.CT + c] =
            __ldg(xs + static_cast<long long>(clamp_row(first + r, P.S - 1)) * P.C + c0 + c);
    }
}

// Frame n of channel c0 + cl: its live taps (at most T) from the staged
// window (win, whose row 0 is input row `first`) or, when win is null, from
// x directly, each row clamped into [0, S); then normalised.
template <typename SrcT>
__device__ __forceinline__ int frame_value(const BatchParams& P, const LaunchGeometry& g,
                                           const SrcT* xs, const SrcT* win, int first, long long n,
                                           int c0, int cl) {
    const FrameWindow w = frame_window(g, n);
    const int live = min(max(w.taps, 0), P.T);
    int acc = 0, sum = 0;
    if (win) {
        const SrcT* v = win + (w.row - first) * P.CT + cl;
#pragma unroll 4
        for (int j = 0; j < live; ++j) {
            const int k = __ldg(P.table + min(max(w.kernel_start + j * g.step, 0),
                                              P.table_size - 1));
            acc = macc_trunc(acc, static_cast<int>(v[j * P.CT]), k);
            sum += k;
        }
    } else {
        const SrcT* v = xs + c0 + cl;
        for (int j = 0; j < live; ++j) {
            const int k = __ldg(P.table + min(max(w.kernel_start + j * g.step, 0),
                                              P.table_size - 1));
            const long long row = clamp_row(w.row + j, P.S - 1);
            acc = macc_trunc(acc, static_cast<int>(__ldg(v + row * P.C)), k);
            sum += k;
        }
    }
    return mul_shift15(acc, reciprocal_q31(sum));
}

// Block (tile, channel tile, b): frames [n0, n0 + TF) x channels [c0, c0 +
// CT) of stream b. Thread t takes channel c0 + t % CT of frames n0 + t / CT,
// + R, ..., R = BATCH_THREADS / CT frames at a time.
template <typename SrcT>
__global__ void __launch_bounds__(BATCH_THREADS)
batch_mac_kernel(const BatchParams P) {
    extern __shared__ int4 smem4[];
    SrcT* const win = reinterpret_cast<SrcT*>(smem4);
    __shared__ int s_produced;
    const int b = blockIdx.z;
    const LaunchGeometry g = stream_geometry(P, b);
    if (threadIdx.x == 0) {
        const StreamCall s = stream_call(P, g, b);
        s_produced = static_cast<int>(s.produced);
        if (blockIdx.x == 0 && blockIdx.y == 0) write_results(P, g, s, b);
    }
    __syncthreads();

    const int n0 = blockIdx.x * P.TF;
    const int nb = min(P.TF, P.N - n0);
    const int c0 = blockIdx.y * P.CT;
    const int cn = min(P.CT, P.C - c0);
    const int R = BATCH_THREADS / P.CT;
    const int cl = threadIdx.x % P.CT, fr = threadIdx.x / P.CT;
    const bool active = fr < R && cl < cn;
    int* const out = P.out + (static_cast<long long>(b) * P.N + n0) * P.C + c0 + cl;
    const SrcT* const xs = static_cast<const SrcT*>(P.x) + b * P.stride_b;
    // The tile's frames that keep their values; the rest are stored as 0.
    const int live_frames = max(0, min(s_produced - n0, nb));

    // Rows from frame a's window start to frame e - 1's window end (tile
    // frames): window starts and ends only grow with n, so this holds every
    // tap row of frames [a, e).
    const auto span = [&](int a, int e) {
        const FrameWindow wa = frame_window(g, n0 + a), we = frame_window(g, n0 + e - 1);
        return static_cast<long long>(we.row) + we.taps - wa.row;
    };
    int F = P.TF;
    while (F > R && live_frames > 0 && span(0, min(F, live_frames)) > P.W) F >>= 1;

    for (int s0 = 0; s0 < live_frames; s0 += F) {
        const int sf = min(F, live_frames - s0);
        const int first = frame_window(g, n0 + s0).row;
        const long long rows = span(s0, s0 + sf);
        const bool staged = rows <= P.W;
        if (staged) stage_rows<SrcT>(P, xs, first, static_cast<int>(rows), c0, cn, win);
        __syncthreads();
        if (active) {
            for (int f = s0 + fr; f < s0 + sf; f += R) {
                out[static_cast<long long>(f) * P.C] =
                    frame_value<SrcT>(P, g, xs, staged ? win : nullptr, first, n0 + f, c0, cl);
            }
        }
        __syncthreads();
    }
    if (active) {
        for (int f = live_frames + fr; f < nb; f += R) out[static_cast<long long>(f) * P.C] = 0;
    }
}

template <typename SrcT>
int launch_batch(const BatchParams& P, int B, cudaStream_t stream) {
    const int smem = (P.W * P.CT * static_cast<int>(sizeof(SrcT)) + 15) / 16 * 16;
    const dim3 grid(std::max(1, (P.N + P.TF - 1) / P.TF), std::max(1, (P.C + P.CT - 1) / P.CT),
                    B);
    batch_mac_kernel<SrcT><<<grid, BATCH_THREADS, smem, stream>>>(P);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B streams' chunk calls in one launch. x is (B, S, C) int16 (x_s16) or
// int32 with each stream's rows contiguous, stride_b elements apart; the
// ten per-stream leaves are (B,) int32; out is (B, N, C) int32, the four
// result leaves (B,) int32 and exhausted (B,) bytes. Returns a cudaError_t.
int crt_batch_mac(const void* x, int x_s16, int B, int S, int C, long long stride_b,
                  const int* totals, const int* quotas, const int* p0_ptr, const int* f0_ptr,
                  const int* inc_hi, const int* inc_lo, const int* radius, const int* delta,
                  const int* int_radius, const int* step, const int* table, int table_size,
                  int T, int N, int channel_tile, int tile_frames, int win_rows, int words,
                  int* out, int* produced, int* consumed, int* p_out, int* f_out,
                  unsigned char* exhausted, int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const BatchParams P{x, stride_b, S, C, totals, quotas, p0_ptr, f0_ptr, inc_hi, inc_lo,
                        radius, delta, int_radius, step, table, table_size, T, N,
                        channel_tile, tile_frames, win_rows, words, out, produced, consumed,
                        p_out, f_out, exhausted};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return x_s16 ? launch_batch<int16_t>(P, B, s) : launch_batch<int32_t>(P, B, s);
}

}  // extern "C"
