// Hand-written Hopper (sm_90a) kernels for tap widths past 1024.
//
// wide_mac_kernel and its fold epilogue wide_fold_kernel replace the Pallas
// kernels _kernel_wide_taps and _kernel_wide_taps_pipelined
// (clownresampler_tpu/ops/pallas_resample.py:1074, :1158) together with the
// launch precompute they read (precompute_launch, :61): a wide entry is these
// two launches. The TPU kernels keep x in HBM, DMA each 8-frame group's union
// window into VMEM (double-buffered in the pipelined form) and put the tap
// axis on the sequential grid. What carries over is the split of the tap
// axis: the reference's tap sum is a plain sum of independently truncated
// terms, so it may be cut into pieces, summed separately and folded, exactly
// (|x| <= 2^15 and k <= 2^16 bound each term by 2^15, and T <= 6016 keeps
// every partial and total sum under 2^28).
//
// What bounds it on the H100: at the 44.1k -> 132 launch (64 frames x 1024
// lanes, 2008 taps, d = increment >> 16 = 334) both the integer work, 4
// operations a live tap and lane (0.031 ms at the card's int32 rate), and
// the ~94 MB of input (0.028 ms), each row of which ~T/d = 6 frames read.
// Read per frame, those rows would cross L2 six times; a per-frame tap
// matrix adds N*T*4 bytes and a load a tap. So the work is cut by input rows
// instead of by frames:
//  - Runs: the launch's input span, from frame 0's window to the last
//    frame's, is cut into runs of WIDE_RUN_ROWS consecutive rows. A work
//    item is one run x 128 lanes. Persistent blocks walk the items (lane
//    tile fastest) and double-buffer each run's rows (32 KB) in shared
//    memory with cp.async, so each input row is read from device memory
//    once, and the next run's copy runs under this run's MACs.
//  - Every frame whose window meets the run (worked out in closed form,
//    wide_first_frame) takes the meeting taps from the staged rows, one warp
//    a frame, 4 lanes a thread, one 16-byte shared load a tap. The taps of
//    the run's first WIDE_AHEAD_FRAMES frames are gathered from the LUT
//    (flat, kernel_start + j*step, or the strided table's row) by cp.async
//    with the run's rows, a stage ahead (wide_gather_taps), so no LUT load is
//    on the MAC loop's path (it was 0.013 of the 0.063 ms MAC launch at
//    44.1k -> 132 on the H100, PERF.md); a further frame's taps the warp
//    reads itself. No (N, T) tap matrix exists.
//  - The frame's partial sum for the run goes to slot k = run - (the
//    frame's first run) of an (N, K, lanes) int32 scratch, and the sum of
//    the taps it used to an (N, K) one: each (frame, run) pair that meets
//    is written once by one warp, with no atomics, and the fold reads
//    exactly the slots its geometry says were written, so the scratch needs
//    no zeroing and the result does not depend on the order.
//  - wide_fold_kernel sums each frame's slots and tap sums, takes q from
//    the tap total (reciprocal_q31) and writes the normalised (and, for
//    int16, clamped) output and the frame's unclamped row.
// One launch with the fold inside -- thread block clusters of blocks, each
// a piece of a frame group's union window, their sums met through
// distributed shared memory -- measured slower on the H100 at both the
// entry's and the wide scan step's shapes (PERF.md, PR 15): a group's union
// window is read again by the next group (1.16-1.63x the bytes), and a
// cluster's fixed costs (its geometry, a pipeline fill, two cluster
// barriers) outweigh the fold's launch at the scan step's 0.006 ms of work.
// Geometry (read_geometry, frame_window, the masked LUT taps) is computed
// inside both kernels from the launch state and ConfigScalars by pointer: no
// host sync and no precompute launch.
//
// Scan mode (SCAN, the C entry crt_wide_scan): a launch of a step of the
// whole-stream scan with the wide engine (lowlevel.ScanProgram; one launch a
// step unless n_out passes wide_launch_frames), in place of the engine's
// Pallas kernels and the staging, bookkeeping and halo slice XLA compiles
// around them in the JAX scan (clownresampler_tpu/lowlevel.py:378-412). Each
// run's rows come from the (K, n_in, L) chunks read as one stream
// (mac_common.cuh load_stream_rows), int16 when the chunks are, so a run
// takes 16 KB of shared memory; wide_compute widens them at the tap. Both
// kernels derive the launch's state from the step's state and the launch's
// frame offset and the step's produced count (scan_launch), so no launch
// reads a count that another block of it writes, and no staged buffer or
// launch-state array exists.

#include <algorithm>

#include "mac_common.cuh"

namespace {

constexpr int WIDE_THREADS = 256;                 // 8 warps
constexpr int WIDE_WARPS = WIDE_THREADS / 32;
constexpr int WIDE_RUN_ROWS = 64;                 // ops/_build.WIDE_RUN_ROWS
constexpr int WIDE_FOLD_THREADS = 256;

struct WideParams {
    const int* x;
    int S, L, lane_offset, lanes;
    GeometryArgs geo;                 // launch state and ConfigScalars
    TapTable tt;                      // flat LUT, or its strided form (tstr_rows, T)
    int N, T, K;                      // frames, taps, partial slots per frame
    int vec;                          // x, L, lane_offset, lanes 4-lane aligned: 16-byte path
    int* partial;                     // (N, K, lanes) partial sums
    int* tap_sums;                    // (N, K) the slots' sums of taps
    void* out;
    int* rows_out;                    // null: the rows are not written
    const int* n_valid;               // frames from *n_valid - frame_offset on are stored
    int frame_offset;                 // as 0 (valid_frames); null: every frame is kept
    ScanSource scan;                  // scan mode only (x null, S the staged buffer's rows)
};

// The launch's input span: runs of WIDE_RUN_ROWS rows from a0, the first
// frame's clamped window row.
struct WideSpan {
    int a0, runs, row_max;
};

__device__ __forceinline__ int wide_row(const LaunchGeometry& g, const WideSpan& s, int n) {
    return clamp_row(frame_window(g, n).row, s.row_max);
}

__device__ __forceinline__ WideSpan wide_span(const WideParams& P, const LaunchGeometry& g) {
    WideSpan s;
    s.row_max = max(P.S - P.T, 0);
    s.a0 = wide_row(g, s, 0);
    const int end = wide_row(g, s, P.N - 1) + P.T;
    s.runs = (end - s.a0 + WIDE_RUN_ROWS - 1) / WIDE_RUN_ROWS;
    return s;
}

// First frame in [0, N] whose clamped window row exceeds `bound`, in closed
// form (ops/_build.wide_first_frame): frame n's row, p0 + (t >> 16) +
// min_rel with t = f0 + n*inc (frame_window), is p0 + ceil((t + delta) /
// 2^16), so for 0 <= bound < row_max the row passes bound from n = floor(x
// / inc) + 1 on, x = (bound - p0) * 2^16 - f0 - delta (from 0 if x < 0).
__device__ __forceinline__ int wide_first_frame(const WideParams& P, const LaunchGeometry& g,
                                                const WideSpan& s, long long bound) {
    if (bound < 0) return 0;
    if (bound >= s.row_max) return P.N;
    const long long x = (bound - g.p0) * 65536 - g.f0 - g.delta;
    const long long n = x < 0 ? 0 : (g.inc > 0 ? x / g.inc + 1 : P.N);
    return static_cast<int>(n < P.N ? n : P.N);
}

// The frames [n_lo, n_hi) that may meet run `run`: row + T > b0 (a superset
// of the windows reaching the run) and row < b0 + WIDE_RUN_ROWS.
__device__ __forceinline__ int2 wide_run_frames(const WideParams& P, const LaunchGeometry& g,
                                                const WideSpan& s, int run) {
    const int b0 = s.a0 + run * WIDE_RUN_ROWS;
    return make_int2(wide_first_frame(P, g, s, static_cast<long long>(b0) - P.T),
                     wide_first_frame(P, g, s, b0 + WIDE_RUN_ROWS - 1));
}

// Frames of an item whose taps are gathered ahead into shared memory
// (ops/_build.WIDE_AHEAD_FRAMES; a run meets about (WIDE_RUN_ROWS + T) / d
// of them: 7 at 44.1k -> 132, 8 at 44.1k -> 1000); a warp fetches the taps
// of any further frame itself.
constexpr int WIDE_AHEAD_FRAMES = 16;

// Start the gather of item `run`'s frames' taps into `taps`
// (WIDE_AHEAD_FRAMES rows of WIDE_RUN_ROWS), by cp.async, with the run's
// rows: row f, entry i is frame frames.x + f's tap for run row b0 + i (j =
// b0 + i - row), zero where j is not a live tap; warp w fills the rows of
// frames frames.x + w, + 8, ... before frames.y and `valid` (the only rows
// wide_compute reads).
__device__ __forceinline__ void wide_gather_taps(const WideParams& P, const LaunchGeometry& g,
                                                 const WideSpan& s, int run, int2 frames,
                                                 int valid, int* taps) {
    const int b0 = s.a0 + run * WIDE_RUN_ROWS, tx = threadIdx.x & 31;
    const int n_end = min(min(frames.y, valid), frames.x + WIDE_AHEAD_FRAMES);
    for (int n = frames.x + (threadIdx.x >> 5); n < n_end; n += WIDE_WARPS) {
        const FrameWindow w = frame_window(g, n);
        const int row = clamp_row(w.row, s.row_max);
        const int live = min(max(w.taps, 0), P.T);
        const int* srow = tap_row(P.tt, w.kernel_start);
        for (int i = tx; i < WIDE_RUN_ROWS; i += 32) {
            const int j = b0 + i - row;
            const bool ok = j >= 0 && j < live;
            const int* src = P.tt.table;
            if (ok) {
                src = srow ? srow + j
                           : P.tt.table + min(max(w.kernel_start + j * g.step, 0),
                                              P.tt.table_size - 1);
            }
            cp_async4(static_cast<unsigned>(__cvta_generic_to_shared(
                          taps + (n - frames.x) * WIDE_RUN_ROWS + i)),
                      src, ok);
        }
    }
}

// The MACs of one item: run `run` (rows [b0, b0 + WIDE_RUN_ROWS)) x lanes
// [lane0, lane0 + TILE_LANES), its rows staged in `win` (int32 rows of x, or
// the scan's int16 or int32 stream rows, widened a quad at a time as a tap
// reads them). Warp w takes the frames n_lo + w, n_lo + w + 8, ... < n_hi;
// the first WIDE_AHEAD_FRAMES frames' taps arrived with the rows (`taps`,
// wide_gather_taps), a further frame's the warp's 32 threads read from the
// LUT at once into the warp's `warp_taps` row. The tap loop reads them 4 at
// a time as a broadcast. The items of lane tile 0 also write each slot's
// sum of taps. Frames from `valid` on (valid_frames; in scan mode the step's
// produced count) are left out: the fold stores them as 0 and reads no
// slot.
template <typename SrcT>
__device__ __forceinline__ void wide_compute(const WideParams& P, const LaunchGeometry& g,
                                             const WideSpan& s, int run, int lane0,
                                             int2 frames, const SrcT* win, const int* taps,
                                             int* warp_taps, int valid) {
    const int tx = threadIdx.x & 31;
    const int lane = lane0 + 4 * tx;
    const int b0 = s.a0 + run * WIDE_RUN_ROWS;
    int* const kw = warp_taps + (threadIdx.x >> 5) * WIDE_RUN_ROWS;
    const int n_end = min(frames.y, valid);
    for (int n = frames.x + (threadIdx.x >> 5); n < n_end; n += WIDE_WARPS) {
        const FrameWindow w = frame_window(g, n);
        const int row = clamp_row(w.row, s.row_max);
        const int live = min(max(w.taps, 0), P.T);
        const int j0 = max(0, b0 - row);
        const int j1 = min(live, b0 + WIDE_RUN_ROWS - row);
        if (j0 >= j1) continue;   // warp-uniform
        // k[t]: the tap for run row t (zero outside the frame's live taps);
        // the MACs take rows [t0, t1), whole quads from an aligned t0.
        const int* k;
        int tsum = 0;
        if (n < frames.x + WIDE_AHEAD_FRAMES) {
            k = taps + (n - frames.x) * WIDE_RUN_ROWS;
            if (lane0 == 0) tsum = k[tx] + k[tx + 32];
        } else {
            const int* srow = tap_row(P.tt, w.kernel_start);
            for (int i = tx; i < WIDE_RUN_ROWS; i += 32) {
                const int j = b0 + i - row;
                const int v = j >= 0 ? lut_tap(P.tt, srow, w.kernel_start, g.step, j, live) : 0;
                kw[i] = v;
                tsum += v;
            }
            __syncwarp();
            k = kw;
        }
        const int t0 = (row + j0 - b0) & ~3, t1 = row + j1 - b0;
        const auto* wp = reinterpret_cast<const typename Quad<SrcT>::type*>(win) + tx;
        int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        const auto tap = [&](int t, int kt) {
            const int4 v = Quad<SrcT>::widen(wp[t * TILE_COLS]);
            a0 = macc_trunc(a0, v.x, kt);
            a1 = macc_trunc(a1, v.y, kt);
            a2 = macc_trunc(a2, v.z, kt);
            a3 = macc_trunc(a3, v.w, kt);
        };
        int t = t0;
        for (; t + 4 <= t1; t += 4) {
            const int4 kk = *reinterpret_cast<const int4*>(k + t);
            tap(t, kk.x);
            tap(t + 1, kk.y);
            tap(t + 2, kk.z);
            tap(t + 3, kk.w);
        }
        for (; t < t1; ++t) tap(t, k[t]);
        __syncwarp();   // the next frame rewrites kw
        const int slot = run - (row - s.a0) / WIDE_RUN_ROWS;
        if (lane0 == 0) {
            for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(0xffffffffu, tsum, o);
            if (tx == 0) P.tap_sums[static_cast<size_t>(n) * P.K + slot] = tsum;
        }
        if (lane >= P.lanes) continue;
        int* o = P.partial + (static_cast<size_t>(n) * P.K + slot) * P.lanes + lane;
        if (P.vec) {
            *reinterpret_cast<int4*>(o) = make_int4(a0, a1, a2, a3);
            continue;
        }
        o[0] = a0;
        if (lane + 1 < P.lanes) o[1] = a1;
        if (lane + 2 < P.lanes) o[2] = a2;
        if (lane + 3 < P.lanes) o[3] = a3;
    }
}

// Persistent blocks walk the items (run x lane tile, lane tile fastest). Two
// stages: while a block computes one run, the copy of its next run's rows
// and of its first frames' taps is in flight (cp.async); each thread works
// out a run's frames itself (wide_run_frames, closed form). One barrier per
// item. SrcT and SCAN: the runs' rows are int32 rows of x (SCAN
// false: the wide entry), or the scan's int16 or int32 stream rows (a launch
// of a wide scan step: its launch state comes from the step's state and its
// frame offset, and block 0 of the step's offset-0 launch writes the step's
// bookkeeping; scan_launch).
template <typename SrcT, bool SCAN>
__global__ void __launch_bounds__(WIDE_THREADS)
wide_mac_kernel(const WideParams P) {
    extern __shared__ int4 smem4[];
    __shared__ __align__(16) int s_ahead[2][WIDE_AHEAD_FRAMES * WIDE_RUN_ROWS];
    __shared__ __align__(16) int s_taps[WIDE_WARPS * WIDE_RUN_ROWS];
    int* const smem = reinterpret_cast<int*>(smem4);
    LaunchGeometry g = read_geometry(P.geo);
    const int valid = SCAN ? scan_launch(P.scan, g, blockIdx.x == 0 && threadIdx.x == 0)
                           : valid_frames(P.n_valid, P.frame_offset);
    const WideSpan s = wide_span(P, g);
    const int lane_tiles = (P.lanes + TILE_LANES - 1) / TILE_LANES;
    const int items = s.runs * lane_tiles;
    int item = blockIdx.x;
    if (item >= items) return;
    auto win = [&](int b) {
        return reinterpret_cast<SrcT*>(smem + b * window_ints<SrcT>(WIDE_RUN_ROWS));
    };
    // Start item it's copies into stage b; returns its run's frames.
    auto load = [&](int it, int b) {
        const int run = it / lane_tiles;
        const int2 frames = wide_run_frames(P, g, s, run);
        const int b0 = s.a0 + run * WIDE_RUN_ROWS;
        const int rows = min(WIDE_RUN_ROWS, P.S - b0), lane0 = (it - run * lane_tiles) * TILE_LANES;
        if constexpr (SCAN) {
            load_stream_rows<WIDE_THREADS>(P.scan, P.L, P.scan.first + b0, rows, lane0, win(b));
        } else {
            load_rows_async<WIDE_THREADS>(P.x, P.L, P.lane_offset, P.lanes, P.vec, b0, rows,
                                          lane0, win(b));
        }
        wide_gather_taps(P, g, s, run, frames, valid, s_ahead[b]);
        return frames;
    };

    int2 frames = load(item, 0);
    cp_async_commit();
    for (int b = 0;; b ^= 1) {
        cp_async_wait_all();
        __syncthreads();
        const int next = item + gridDim.x;
        const int2 next_frames = next < items ? load(next, b ^ 1) : frames;
        cp_async_commit();
        const int run = item / lane_tiles;
        wide_compute(P, g, s, run, (item - run * lane_tiles) * TILE_LANES, frames, win(b),
                     s_ahead[b], s_taps, valid);
        if (next >= items) break;
        item = next;
        frames = next_frames;
    }
}

// grid (ceil(lanes / WIDE_FOLD_THREADS), N): out[n][l] = finish(mul_shift15(
// sum of frame n's slots, q[n])), q[n] the reciprocal of the sum of its
// slots' tap sums (its live taps); rows_out[n] its unclamped row (when the
// caller wants it). A frame from valid_frames on (in scan mode the step's
// produced count, which the fold works out as the MAC kernel does) is stored
// as 0, its slots unread.
template <typename OutT, bool SCAN>
__global__ void __launch_bounds__(WIDE_FOLD_THREADS)
wide_fold_kernel(const WideParams P) {
    const int n = blockIdx.y;
    const int l = blockIdx.x * WIDE_FOLD_THREADS + threadIdx.x;
    LaunchGeometry g = read_geometry(P.geo);
    const int valid = SCAN ? scan_launch(P.scan, g, false)
                           : valid_frames(P.n_valid, P.frame_offset);
    const WideSpan s = wide_span(P, g);
    const FrameWindow w = frame_window(g, n);
    if (blockIdx.x == 0 && threadIdx.x == 0 && P.rows_out) P.rows_out[n] = w.row;
    if (l >= P.lanes) return;
    OutT* const o = static_cast<OutT*>(P.out) + static_cast<size_t>(n) * P.lanes + l;
    if (n >= valid) {
        *o = 0;
        return;
    }
    const int row = clamp_row(w.row, s.row_max);
    const int live = min(max(w.taps, 0), P.T);
    const int slots = live > 0 ? (row + live - 1 - s.a0) / WIDE_RUN_ROWS -
                                 (row - s.a0) / WIDE_RUN_ROWS + 1
                               : 0;
    const int* p = P.partial + static_cast<size_t>(n) * P.K * P.lanes + l;
    const int* ts = P.tap_sums + static_cast<size_t>(n) * P.K;
    // Sixteen independent loads in flight; the sums are exact in any order.
    int acc[16] = {}, taps[16] = {};
    int k = 0;
    for (; k + 16 <= slots; k += 16) {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
            acc[i] += __ldcs(p + static_cast<size_t>(k + i) * P.lanes);
            taps[i] += __ldg(ts + k + i);
        }
    }
    for (; k < slots; ++k) {
        acc[0] += __ldcs(p + static_cast<size_t>(k) * P.lanes);
        taps[0] += __ldg(ts + k);
    }
    int a = 0, t = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
        a += acc[i];
        t += taps[i];
    }
    *o = finish<OutT>(mul_shift15(a, reciprocal_q31(t)));
}

// The MAC kernel on a persistent grid (persistent_grid, mac_common.cuh), at
// most one block per item of the span bound `runs_bound` (the kernel walks
// the span it computes, whatever the bound), then the fold.
template <typename OutT, typename SrcT = int32_t, bool SCAN = false>
int launch_wide(const WideParams& P, int runs_bound, int device, cudaStream_t stream) {
    static PersistentGrid cache;
    const int smem = 2 * window_ints<SrcT>(WIDE_RUN_ROWS) * static_cast<int>(sizeof(int));
    int blocks = 0;
    int err = persistent_grid(cache, wide_mac_kernel<SrcT, SCAN>, WIDE_THREADS, smem, device,
                              &blocks);
    if (err != 0) return err;
    const int lane_tiles = (P.lanes + TILE_LANES - 1) / TILE_LANES;
    const long long items = static_cast<long long>(lane_tiles) * runs_bound;
    const int grid = static_cast<int>(std::max<long long>(1, std::min<long long>(items, blocks)));
    wide_mac_kernel<SrcT, SCAN><<<grid, WIDE_THREADS, smem, stream>>>(P);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    const dim3 fold_grid((P.lanes + WIDE_FOLD_THREADS - 1) / WIDE_FOLD_THREADS, P.N);
    wide_fold_kernel<OutT, SCAN><<<fold_grid, WIDE_FOLD_THREADS, 0, stream>>>(P);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crt_wide_mac(const int* x, int S, int L, int lane_offset, int lanes, const int* p0_ptr,
                 int p0_val, const int* f0_ptr, int f0_val, const int* inc_hi, const int* inc_lo,
                 const int* radius, const int* delta, const int* int_radius, const int* step,
                 const int* table, int table_size, const int* tstr, int tstr_rows, int N, int T,
                 int K, int runs_bound, int vec, int* partial, int* tap_sums,
                 void* out, int* rows_out, int clamp_s16, const int* n_valid, int frame_offset,
                 int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const GeometryArgs geo{p0_ptr, p0_val, f0_ptr, f0_val, inc_hi, inc_lo,
                           radius, delta, int_radius, step};
    const WideParams P{x, S, L, lane_offset, lanes, geo, {table, table_size, tstr, tstr_rows, T},
                       N, T, K, vec, partial, tap_sums, out, rows_out, n_valid,
                       frame_offset};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return clamp_s16 ? launch_wide<int16_t>(P, runs_bound, device, s)
                     : launch_wide<int32_t>(P, runs_bound, device, s);
}

// One launch of a step of the whole-stream scan with the wide engine, in scan
// mode: frames [frame_offset, frame_offset + N) of the step's n_out. Window
// row i is row src_first + i of the (K * n_in, L) stream at src (int16 when
// src_s16, else int32) when that row lies in [0, src_end), else 0; S is the
// rows of the staged buffer the step stands for (2r + n_in + taps + 8);
// state_in (2,) is the step's (p, f), from which each kernel derives the
// launch's state at frame_offset; the launch's frames go to out (N, L)
// int32, zero from the step's produced count on, and the offset-0 launch
// writes produced, over and the next state. partial and tap_sums as for
// crt_wide_mac; copy is a SCAN_COPY_* path, vec 1 when L is a multiple of 4
// and partial 16-byte aligned. Returns a cudaError_t.
int crt_wide_scan(const void* src, int src_s16, long long src_first, long long src_end,
                  int n_in, int S, int L, int copy, int vec, const int* state_in,
                  const int* inc_hi, const int* inc_lo, const int* radius, const int* delta,
                  const int* int_radius, const int* step, const int* table, int table_size,
                  const int* tstr, int tstr_rows, int N, int T, int K, int runs_bound,
                  int n_out, int frame_offset, int* partial, int* tap_sums, void* out,
                  int* produced, int* over, int* state_out, int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const GeometryArgs geo{state_in, 0, state_in + 1, 0, inc_hi, inc_lo,
                           radius, delta, int_radius, step};
    const WideParams P{nullptr, S, L, 0, L, geo, {table, table_size, tstr, tstr_rows, T},
                       N, T, K, vec, partial, tap_sums, out, nullptr, nullptr, 0,
                       {src, src_first, src_end, copy, n_in, n_out, frame_offset, produced, over,
                        state_out}};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return src_s16 ? launch_wide<int32_t, int16_t, true>(P, runs_bound, device, s)
                   : launch_wide<int32_t, int32_t, true>(P, runs_bound, device, s);
}

}  // extern "C"
