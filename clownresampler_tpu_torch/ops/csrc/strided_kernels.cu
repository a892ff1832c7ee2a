// Hand-written Hopper (sm_90a) kernel for exact integer strides.
//
// strided_mac_kernel replaces the Pallas kernels _kernel_strided and
// _kernel_strided_partial (clownresampler_tpu/ops/pallas_resample.py:664,
// :720) together with their setup (_strided_setup, :753, and the launch
// precompute it calls): a strided entry is this one launch. With a zero
// fractional increment the phase fraction is constant, so one tap vector k0
// and one 17.15 reciprocal q0 serve every frame of a launch, and frame n's
// window starts at row r0 + n*d (clownresampler.h:1076-1078). The TPU kernels
// re-view x as (S/d, d*L) so that Mosaic sees stride-1 aligned loads, fold the
// d phases in VMEM and (the partial form) split the phases across grid steps
// for the v5e's VMEM; none of that is needed here.
//
// What bounds it on the H100: at the 96k -> 48k farm launch (d 2, 16 taps of
// which 12 are live, 8192 frames x 2048 lanes) the bytes (the input read
// once, the output written once) and the integer work (~5 operations a live
// tap and lane; the per-term truncation rules out tensor cores) take the same
// time, so the copy has to overlap the compute and the tap loop may spend
// little beyond those 5 operations. What the design does about it:
//  - Geometry inside: every block reads the launch state and ConfigScalars
//    by pointer (read_geometry), takes frame 0's window (frame_window: r0,
//    kernel_start, the live tap count) and builds k0 from the flat LUT and
//    q0 = reciprocal_q31(sum k0) itself. No host sync, no precompute launch.
//  - Live taps only, in registers: k0 is one vector for the launch, so each
//    thread holds it in registers, and the tap loop is unrolled over the live
//    count rounded up to 4 (a switch inside the kernel, 4-40 taps; the zero
//    taps of the rounding are exact, trunc(x*0) = 0). A launch that reserves
//    40 taps for 12 live ones does the work of 12. Past 40 live taps a
//    generic loop reads k0 from shared memory.
//  - 4 lanes a thread: 16-byte shared loads, 16- (int32) or 8-byte (int16)
//    stores; odd lane slices and 2-lane launches take 4-byte copies and
//    per-lane stores inside the kernel.
//  - Overlap: persistent blocks walk tiles of F frames x 128 lanes (lane tile
//    fastest) and double-buffer each tile's window, (F - 1)*d + live rows,
//    with cp.async, so the next tile's copy runs under this tile's MACs.
//    F comes from ops/resample.strided_stage_plan; a launch whose window
//    does not fit shared memory (taps up to lowlevel.FAST_KERNEL_MAX_TAPS)
//    reads x directly.
//
// Scan mode (SCAN, the C entry crt_strided_scan): a step of the whole-stream
// scan with the strided engine (lowlevel.ScanProgram), as one launch. It
// replaces the engine's Pallas kernel together with the staging, bookkeeping
// and halo slice XLA compiles around it in the JAX scan
// (clownresampler_tpu/lowlevel.py:378-412). A staged tile copies its window
// from the (K, n_in, L) chunks read as one stream (mac_common.cuh
// load_stream_rows), still int16 when they are, so a stage takes half the
// shared memory; strided_taps widens a quad of lanes as a tap reads it; a
// window too wide to stage reads the stream directly, zero outside the step's
// live rows. Every block works out the step's produced count from its state
// (scan_launch) and masks its stores by it, and block 0 writes produced,
// over and the next step's state. At the 96k -> 48k step (2048 lanes, 12 of
// 16 taps live) that reads 33.6 MB of int16 rows and writes no staging
// buffer, where the stage pass read them, wrote 67.4 MB of int32 rows and
// this kernel read those back.
//
// Padding frames (past the caller's natural count, results discarded) have
// their window start clamped into the buffer, row(n) = clamp(r0 + n*d, 0,
// S - T), exactly as ops/resample.launch_rows clamps the other classes'
// rows; the clamp is monotone, so a tile's rows still span at most
// (F - 1)*d + live.

#include <algorithm>

#include "mac_common.cuh"

namespace {

constexpr int STRIDED_THREADS = 256;              // 8 warps
constexpr int STRIDED_WARPS = STRIDED_THREADS / 32;
constexpr int STRIDED_MAX_UNROLL = 40;            // live taps held in registers

struct StridedParams {
    const int* x;
    int S, L, lane_offset, lanes;
    GeometryArgs geo;                 // launch state and ConfigScalars
    TapTable tt;                      // the flat LUT
    int N, T, d;                      // frames, reserved taps, stride
    int F, W;                         // frames per tile, staged rows per stage (0: unstaged)
    int vec;                          // x, L, lane_offset, lanes 4-lane aligned: 16-byte path
    void* out;
    int* rows_out;                    // null: the rows are not written
    const int* n_valid;               // frames from *n_valid - frame_offset on are stored
    int frame_offset;                 // as 0 (valid_frames); null: every frame is kept
    ScanSource scan;                  // scan mode only (x null, S the staged buffer's rows)
};

// Shared memory, in ints: k0 padded to a multiple of 4, the tap sum (and 3
// ints of padding, keeping what follows 16-byte aligned), two stages of W
// rows x TILE_LANES of SrcT (int32 rows of x; the scan's int16 or int32
// stream rows).
__host__ __device__ inline int strided_header_ints(int T) { return (T + 3) / 4 * 4 + 4; }

template <typename SrcT>
__host__ __device__ inline int strided_shared_ints(int T, int W) {
    return strided_header_ints(T) + 2 * window_ints<SrcT>(W);
}

// The launch-wide geometry every block computes (frame 0's window).
struct StridedLaunch {
    long long r0;                     // frame 0's unclamped window row
    int live, q, row_max;
};

// Window start of frame n, clamped so that [row, row + T) lies inside x.
__device__ __forceinline__ int strided_row(const StridedLaunch& s, int n, int d) {
    const long long r = s.r0 + static_cast<long long>(n) * d;
    return static_cast<int>(r < 0 ? 0 : (r > s.row_max ? s.row_max : r));
}

// A tile: frames [n0, n0 + nb) x lanes [lane0, lane0 + TILE_LANES); its
// frames read input rows [first, first + rows), staged when they fit W.
struct StridedTile {
    int n0, nb, lane0, first, rows;
    bool staged;
};

__device__ __forceinline__ StridedTile strided_tile(const StridedParams& P,
                                                    const StridedLaunch& s, int tile,
                                                    int lane_tiles, int reads) {
    StridedTile t;
    const int stage = tile / lane_tiles;
    t.lane0 = (tile - stage * lane_tiles) * TILE_LANES;
    t.n0 = stage * P.F;
    t.nb = min(P.F, P.N - t.n0);
    t.first = strided_row(s, t.n0, P.d);
    t.rows = strided_row(s, t.n0 + t.nb - 1, P.d) - t.first + reads;
    t.staged = t.rows <= P.W;
    return t;
}

// One frame's four lanes from its window, `reads` rows from w0 (quads of
// SrcT, `stride` quads a row, widened as a tap reads them): taps from
// registers (TT > 0, unrolled) or from shared memory (TT == 0, `reads` =
// live).
template <int TT, typename SrcT>
__device__ __forceinline__ void strided_taps(const typename Quad<SrcT>::type* w0, int stride,
                                             const int (&k)[TT ? TT : 1], const int* s_k,
                                             int reads, int& a0, int& a1, int& a2, int& a3) {
    using Q = Quad<SrcT>;
    if (TT) {
#pragma unroll
        for (int j = 0; j < TT; ++j) {
            const int4 v = Q::widen(w0[j * stride]);
            a0 = macc_trunc(a0, v.x, k[j]);
            a1 = macc_trunc(a1, v.y, k[j]);
            a2 = macc_trunc(a2, v.z, k[j]);
            a3 = macc_trunc(a3, v.w, k[j]);
        }
        return;
    }
    int j = 0;
    for (; j + 4 <= reads; j += 4) {
        const int4 kk = *reinterpret_cast<const int4*>(s_k + j);
        const int kj[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int4 v = Q::widen(w0[(j + i) * stride]);
            a0 = macc_trunc(a0, v.x, kj[i]);
            a1 = macc_trunc(a1, v.y, kj[i]);
            a2 = macc_trunc(a2, v.z, kj[i]);
            a3 = macc_trunc(a3, v.w, kj[i]);
        }
    }
    for (; j < reads; ++j) {
        const int4 v = Q::widen(w0[j * stride]);
        a0 = macc_trunc(a0, v.x, s_k[j]);
        a1 = macc_trunc(a1, v.y, s_k[j]);
        a2 = macc_trunc(a2, v.z, s_k[j]);
        a3 = macc_trunc(a3, v.w, s_k[j]);
    }
}

// The MACs of one tile: warp w takes frames w, w + 8, ...; thread tx of a
// warp takes lanes lane0 + 4tx .. + 3. The blocks of lane tile 0 write the
// unclamped rows (when the caller wants them). A frame from `valid` on
// (valid_frames; in scan mode the step's produced count) skips its taps and
// is stored as 0.
template <int TT, typename OutT, typename SrcT, bool SCAN>
__device__ __forceinline__ void strided_compute(const StridedParams& P, const StridedLaunch& s,
                                                const StridedTile& t, const int (&k)[TT ? TT : 1],
                                                const int* s_k, const SrcT* win, int valid) {
    const int tx = threadIdx.x & 31;
    const int lane = t.lane0 + 4 * tx;
    if (lane >= P.lanes) return;
    for (int f = threadIdx.x >> 5; f < t.nb; f += STRIDED_WARPS) {
        const int n = t.n0 + f;
        const int row = strided_row(s, n, P.d);
        if (t.lane0 == 0 && tx == 0 && P.rows_out) {
            P.rows_out[n] = static_cast<int>(s.r0 + static_cast<long long>(n) * P.d);
        }
        int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        if (n >= valid) {
            // masked: the zeros are stored below
        } else if (t.staged) {
            const auto* w0 = reinterpret_cast<const typename Quad<SrcT>::type*>(win) +
                             (row - t.first) * TILE_COLS + tx;
            strided_taps<TT, SrcT>(w0, TILE_COLS, k, s_k, s.live, a0, a1, a2, a3);
        } else if constexpr (SCAN) {
            // A window too wide to stage, read from the stream a row at a
            // time; rows outside the step's live range read as zero.
            const int nl = min(4, P.lanes - lane);
            for (int j = 0; j < s.live; ++j) {
                stream_tap<SrcT>(P.scan, P.L, row + j, lane, nl, s_k[j], a0, a1, a2, a3);
            }
        } else {
            // A window too wide to stage: device memory, k0 from shared memory.
            const int* xr = P.x + static_cast<size_t>(row) * P.L + P.lane_offset + lane;
            const int live_lanes = min(4, P.lanes - lane);
            for (int j = 0; j < s.live; ++j, xr += P.L) {
                const int kj = s_k[j];
                if (P.vec) {
                    const int4 v = __ldg(reinterpret_cast<const int4*>(xr));
                    a0 = macc_trunc(a0, v.x, kj);
                    a1 = macc_trunc(a1, v.y, kj);
                    a2 = macc_trunc(a2, v.z, kj);
                    a3 = macc_trunc(a3, v.w, kj);
                    continue;
                }
                a0 = macc_trunc(a0, __ldg(xr), kj);
                if (live_lanes > 1) a1 = macc_trunc(a1, __ldg(xr + 1), kj);
                if (live_lanes > 2) a2 = macc_trunc(a2, __ldg(xr + 2), kj);
                if (live_lanes > 3) a3 = macc_trunc(a3, __ldg(xr + 3), kj);
            }
        }
        store_lanes<OutT>(P.out, P.lanes, P.vec, n, lane, s.q, a0, a1, a2, a3);
    }
}

// A persistent block's walk over the tiles with TT register taps (0: the
// generic loop). Two stages: while a block computes one tile, the copy of
// its next tile's window is in flight (cp.async; in scan mode from the
// stream, window row r being stream row scan.first + r). One barrier per
// tile.
template <int TT, typename OutT, typename SrcT, bool SCAN>
__device__ __forceinline__ void strided_run(const StridedParams& P, const StridedLaunch& s,
                                            const int* s_k, int* stages, int valid) {
    const int lane_tiles = (P.lanes + TILE_LANES - 1) / TILE_LANES;
    const int tiles = lane_tiles * ((P.N + P.F - 1) / P.F);
    int tile = blockIdx.x;
    if (tile >= tiles) return;
    int k[TT ? TT : 1];
#pragma unroll
    for (int j = 0; j < (TT ? TT : 1); ++j) k[j] = TT ? s_k[j] : 0;
    const int reads = TT ? TT : s.live;
    auto win = [&](int b) { return reinterpret_cast<SrcT*>(stages + b * window_ints<SrcT>(P.W)); };
    auto load = [&](const StridedTile& t, SrcT* w) {
        if (!t.staged) return;
        if constexpr (SCAN) {
            load_stream_rows<STRIDED_THREADS>(P.scan, P.L, P.scan.first + t.first, t.rows,
                                              t.lane0, w);
        } else {
            load_rows_async<STRIDED_THREADS>(P.x, P.L, P.lane_offset, P.lanes, P.vec, t.first,
                                             t.rows, t.lane0, w);
        }
    };

    StridedTile cur = strided_tile(P, s, tile, lane_tiles, reads);
    load(cur, win(0));
    cp_async_commit();
    for (int b = 0;; b ^= 1) {
        cp_async_wait_all();
        __syncthreads();
        const int next = tile + gridDim.x;
        StridedTile nxt{};
        if (next < tiles) {
            nxt = strided_tile(P, s, next, lane_tiles, reads);
            load(nxt, win(b ^ 1));
        }
        cp_async_commit();
        strided_compute<TT, OutT, SrcT, SCAN>(P, s, cur, k, s_k, win(b), valid);
        if (next >= tiles) break;
        cur = nxt;
        tile = next;
    }
}

// SrcT and SCAN: the window's rows are int32 rows of x (SCAN false: the
// strided entry), or the scan's int16 or int32 stream rows (a strided scan
// step, whose launch state is the step's state and whose block 0 writes the
// step's bookkeeping: scan_launch).
template <typename OutT, typename SrcT, bool SCAN>
__global__ void __launch_bounds__(STRIDED_THREADS, 2)
strided_mac_kernel(const StridedParams P) {
    extern __shared__ int4 smem4[];
    int* const smem = reinterpret_cast<int*>(smem4);
    const int kpad = strided_header_ints(P.T) - 4;
    int* const s_k = smem;
    int* const s_sum = smem + kpad;
    int* const stages = smem + strided_header_ints(P.T);

    // The launch's geometry: frame 0's window, k0 (zero past the live taps
    // and up to kpad) and its sum, reduced by shuffles and a shared add.
    LaunchGeometry g = read_geometry(P.geo);
    const int valid = SCAN ? scan_launch(P.scan, g, blockIdx.x == 0 && threadIdx.x == 0)
                           : valid_frames(P.n_valid, P.frame_offset);
    const FrameWindow w0 = frame_window(g, 0);
    StridedLaunch s;
    s.r0 = static_cast<long long>(w0.row);
    s.live = min(max(w0.taps, 0), P.T);
    s.row_max = max(P.S - P.T, 0);
    if (threadIdx.x == 0) *s_sum = 0;
    __syncthreads();
    int sum = 0;
    for (int j = threadIdx.x; j < kpad; j += STRIDED_THREADS) {
        const int v = lut_tap(P.tt, nullptr, w0.kernel_start, g.step, j, s.live);
        s_k[j] = v;
        sum += v;
    }
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if ((threadIdx.x & 31) == 0 && sum) atomicAdd(s_sum, sum);
    __syncthreads();
    s.q = reciprocal_q31(*s_sum);

    // Unrolled over the live taps rounded up to 4, when that fits the
    // reserved width (the rounding's rows must lie inside x).
    const int rounded = (s.live + 3) / 4 * 4;
    switch (rounded <= P.T ? rounded : 0) {
        case 4: return strided_run<4, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case 8: return strided_run<8, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case 12: return strided_run<12, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case 16: return strided_run<16, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case 20: return strided_run<20, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case 24: return strided_run<24, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case 28: return strided_run<28, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case 32: return strided_run<32, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case 36: return strided_run<36, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        case STRIDED_MAX_UNROLL:
            return strided_run<STRIDED_MAX_UNROLL, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
        default: return strided_run<0, OutT, SrcT, SCAN>(P, s, s_k, stages, valid);
    }
}

// Persistent grid (persistent_grid, mac_common.cuh), at most one block per tile.
template <typename OutT, typename SrcT = int32_t, bool SCAN = false>
int launch_strided(const StridedParams& P, int device, cudaStream_t stream) {
    static PersistentGrid cache;
    const int smem = strided_shared_ints<SrcT>(P.T, P.W) * static_cast<int>(sizeof(int));
    int blocks = 0;
    const int err = persistent_grid(cache, strided_mac_kernel<OutT, SrcT, SCAN>, STRIDED_THREADS,
                                    smem, device, &blocks);
    if (err != 0) return err;
    const int lane_tiles = (P.lanes + TILE_LANES - 1) / TILE_LANES;
    const long long tiles = static_cast<long long>(lane_tiles) * ((P.N + P.F - 1) / P.F);
    const int grid = static_cast<int>(std::min<long long>(tiles, blocks));
    strided_mac_kernel<OutT, SrcT, SCAN><<<grid, STRIDED_THREADS, smem, stream>>>(P);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crt_strided_mac(const int* x, int S, int L, int lane_offset, int lanes, const int* p0_ptr,
                    int p0_val, const int* f0_ptr, int f0_val, const int* inc_hi,
                    const int* inc_lo, const int* radius, const int* delta,
                    const int* int_radius, const int* step, const int* table, int table_size,
                    int N, int T, int d, int frames_per_tile, int win_rows, int vec, void* out,
                    int* rows_out, int clamp_s16, const int* n_valid, int frame_offset,
                    int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const GeometryArgs geo{p0_ptr, p0_val, f0_ptr, f0_val, inc_hi, inc_lo,
                           radius, delta, int_radius, step};
    const StridedParams P{x, S, L, lane_offset, lanes, geo, {table, table_size, nullptr, 0, T},
                          N, T, d, frames_per_tile, win_rows, vec, out, rows_out, n_valid,
                          frame_offset};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return clamp_s16 ? launch_strided<int16_t>(P, device, s)
                     : launch_strided<int32_t>(P, device, s);
}

// One step of the whole-stream scan with the strided engine, in scan mode:
// window row i is row src_first + i of the (K * n_in, L) stream at src
// (int16 when src_s16, else int32) when that row lies in [0, src_end), else
// 0; S is the rows of the staged buffer the step stands for (2r + n_in +
// taps + 8: clamped windows stay put); state_in (2,) is the step's (p, f)
// and its launch state; the step's N frames go to out (N, L) int32, zero
// from produced on, and produced, over and the next state to their
// pointers. copy is a SCAN_COPY_* path, vec 1 when out's rows take 16-byte
// stores. Returns a cudaError_t.
int crt_strided_scan(const void* src, int src_s16, long long src_first, long long src_end,
                     int n_in, int S, int L, int copy, int vec, const int* state_in,
                     const int* inc_hi, const int* inc_lo, const int* radius, const int* delta,
                     const int* int_radius, const int* step, const int* table, int table_size,
                     int N, int T, int d, int frames_per_tile, int win_rows, void* out,
                     int* produced, int* over, int* state_out, int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const GeometryArgs geo{state_in, 0, state_in + 1, 0, inc_hi, inc_lo,
                           radius, delta, int_radius, step};
    const StridedParams P{nullptr, S, L, 0, L, geo, {table, table_size, nullptr, 0, T},
                          N, T, d, frames_per_tile, win_rows, vec, out, nullptr, nullptr, 0,
                          {src, src_first, src_end, copy, n_in, N, 0, produced, over, state_out}};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return src_s16 ? launch_strided<int32_t, int16_t, true>(P, device, s)
                   : launch_strided<int32_t, int32_t, true>(P, device, s);
}

}  // extern "C"
