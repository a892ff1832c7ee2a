// Hand-written Hopper (sm_90a) kernel for the resampler's multiply-accumulate.
//
// tiled_mac_kernel computes, for every output frame n and lane l of a launch,
//
//     acc      = sum_t trunc(x[rows[n] + t][l] * kv[n][t] / 2^16)
//     out[n,l] = trunc(acc * q[n] / 2^15)            (optionally clamped to s16)
//
// bit-exactly as the C reference's inner loop does (clownresampler.h:1008-1033),
// where rows[n] is frame n's first input row, kv[n] its masked LUT taps and
// q[n] their 17.15 reciprocal. x is lane-major (S, L) int32 with streams x
// channels on the fast axis, which is the coalesced one here.
//
// It serves two entries, each as one launch with its geometry inside:
// the tiled entry, replacing the Pallas kernel _kernel_tiled
// (clownresampler_tpu/ops/pallas_resample.py:201), and the general entry,
// replacing _kernel_general (:475); both together with the launch's XLA
// precompute (precompute_launch, :61). Neighbouring frames' windows overlap
// (at 44.1k -> 8k, d = 5 and 40 taps, a frame shares ~34 of its 40 rows with
// the next), so a block stages the union of a tile's windows (F frames x 128
// lanes) in shared memory once and every frame reads its taps from there:
// the input is read from device memory about once, not once per frame.
// What bounds it is bytes at the tiled headline (taps 8) and integer
// instructions at the general one (taps 40, 4 a tap and lane), so
// the design keeps the instruction slots for the taps: each frame's geometry
// (window row, masked taps, reciprocal; mac_common.cuh) is computed once per
// tile into shared memory, the tap loop has no global load and no clamp and
// is unrolled for the main path's widths, a thread takes 4 lanes with
// 16-byte shared loads and 16- (int32) or 8-byte (int16) stores, and
// persistent blocks double-buffer their windows with cp.async so that the
// next tile's copy overlaps this tile's compute. The frames per stage follow
// the increment, which only the card holds (stage_frames). The TPU kernels'
// Bresenham eps/cand split, sublane roll and phase-shifted tap columns exist
// only for Mosaic's aligned loads; here each frame indexes the staged window
// at its own row. Launch state and configuration come by pointer from device
// memory: no host sync.
//
// The per-term truncation rules out tensor cores: the MACs are int32 work on
// the CUDA cores.
//
// Scan mode (SCAN): the steps of the whole-stream scan with the tiled or
// general engine (lowlevel.ScanProgram), as one launch. It replaces the engine's
// Pallas kernel together with the staging, bookkeeping and halo slice XLA
// compiles around it in the JAX scan (clownresampler_tpu/lowlevel.py:378-412),
// which concatenates [halo | chunk | zeros] in device memory. The chunks are
// one contiguous (K, n_in, L) tensor, so step k's staged buffer is exactly
// stream rows [k*n_in - 2r, (k+1)*n_in) with zeros before row 0 and past the
// chunk (for n_in < 2r too: the halo is the same stream window). A block
// copies its tile's window rows straight from the int16 (or int32) stream
// into shared memory, still int16, zero-filled outside the step's live rows,
// and widens a quad of lanes when a tap reads it: the step reads the chunk
// once and writes no staging buffer, where a separate stage pass read it,
// wrote it widened to int32 and the MAC read that back (at config 7: 33.6 MB
// read instead of 33.6 + 67.4 + 67.4 MB moved), and a stage's rows take half
// the shared memory. The host knows the scan's increment, so it sizes each
// stage to the window its frames reach (ops.resample.scan_stage_plan: at
// config 7 16 frames of 123 rows, where the int32 entry takes 8 of 79), and
// the shared memory left holds more blocks an SM. A launch takes K steps
// (one for scan_inplace_step, every step of a request for ScanProgram): its
// tiles are (step, stage, lane tile), lane tile fastest, and the persistent
// blocks walk them all, so one tile's compute overlaps the next tile's copy
// across the steps too and only the launch's last round runs on part of the
// grid, where a launch a step paid that tail, an unoverlapped first copy a
// block and a launch gap K times. Each block reads step 0's state once and
// carries its own step's state forward by the scan's recurrence
// (scan_books, mac_common.cuh, shared with the strided and wide kernels'
// scan modes), over the steps it skips too, so no block waits on another;
// it masks its stores by the step's produced count, and the block of a
// step's first tile writes the step's produced, over and next state.
//
// Built by ops/_build.py with nvcc into a shared library with a plain C
// interface; the Python wrappers check devices, dtypes, shapes and strides
// before they pass pointers, and every entry returns cudaGetLastError().
// The tap arithmetic (macc_trunc, mul_shift15, finish), the window
// geometry, the masked LUT taps, the cp.async staging, the scan mode's
// stream copies and bookkeeping, the output stores and the persistent grid
// are in mac_common.cuh, shared with strided_kernels.cu and wide_kernels.cu.

#include <algorithm>

#include "mac_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// tiled_mac_kernel: one launch per tiled or general entry, its geometry included
// ---------------------------------------------------------------------------

constexpr int TILED_THREADS = 256;                // 8 warps
constexpr int TILED_WARPS = TILED_THREADS / 32;

struct TiledParams {
    const int* x;
    int S, L, lane_offset, lanes;
    GeometryArgs geo;                 // launch state and ConfigScalars
    TapTable tt;                      // flat LUT, or its strided form (tstr_rows, T)
    int N, T;                         // frames, taps
    int F, W;                         // most frames per stage, staged window rows per stage
    int vec;                          // x, L, lane_offset, lanes 4-lane aligned: 16-byte path
    void* out;
    int* rows_out;                    // null: the rows are not written
    const int* n_valid;               // frames from *n_valid - frame_offset on are stored
    int frame_offset;                 // as 0 (valid_frames); null: every frame is kept
    ScanSource scan;                  // scan mode only (x null, S the staged buffer's rows)
};

// Scan mode: move a block's step state -- g's position holds step `at`'s
// state -- to step k >= at by the scan's recurrence, one step at a time;
// returns step k's produced count. The block that walks step k's first
// tile (`first_tile`) writes the step's bookkeeping.
__device__ __forceinline__ int scan_enter(const ScanSource& s, LaunchGeometry& g, int at, int k,
                                          bool first_tile) {
    ScanBooks b = scan_books(s, g.p0, g.f0, g.inc);
    for (; at < k; ++at) {
        g.p0 = b.p_next;
        g.f0 = b.f_next;
        b = scan_books(s, g.p0, g.f0, g.inc);
    }
    if (first_tile && threadIdx.x == 0) write_books(s, k, b);
    return static_cast<int>(b.produced);
}

// One stage of a block's shared memory, in ints: the staged window
// [W][TILE_LANES] of SrcT, the masked taps [F][T], the clamped rows [F], q
// [F], the live tap counts [F].
template <typename SrcT>
__host__ __device__ inline int tiled_stage_ints(int F, int T, int W) {
    return window_ints<SrcT>(W) + F * (T + 3);
}

// Frames per stage: the most of F, F/2, ..., 8 whose window -- at most
// ceil((frames - 1) * inc / 2^16) + T rows, since a frame's first row is
// p0 + ceil((f0 + n*inc + delta) / 2^16) -- fits the W rows a stage holds; 8
// when none does (those tiles read x directly). Every block takes the same.
__device__ __forceinline__ int stage_frames(const LaunchGeometry& g, int F, int T, int W) {
    while (F > 8 && (((F - 1) * g.inc + 0xFFFF) >> 16) + T > W) F >>= 1;
    return F;
}

// A tile: frames [n0, n0 + nb) x lanes [lane0, lane0 + TILE_LANES). Its
// frames' clamped windows span input rows [first, first + rows); staged
// when that span fits the W rows a stage holds, else read from x directly.
struct Tile {
    int n0, nb, lane0, first, rows;
    bool staged;
};

__device__ __forceinline__ Tile tiled_tile(const TiledParams& P, const LaunchGeometry& g,
                                           int tile, int lane_tiles, int F, int T, int row_max) {
    Tile t;
    const int stage = tile / lane_tiles;
    t.lane0 = (tile - stage * lane_tiles) * TILE_LANES;
    t.n0 = stage * F;
    t.nb = min(F, P.N - t.n0);
    t.first = clamp_row(frame_window(g, t.n0).row, row_max);
    const int last = clamp_row(frame_window(g, t.n0 + t.nb - 1).row, row_max);
    t.rows = last - t.first + T;
    t.staged = last >= t.first && t.rows <= P.W;
    return t;
}

// Start the asynchronous copy of a staged tile's window rows into `win` (in
// scan mode from the stream, window row r of step j being stream row
// scan.first + j*n_in + r).
template <typename SrcT, bool SCAN>
__device__ __forceinline__ void tiled_load_window(const TiledParams& P, const Tile& t, int step,
                                                  SrcT* win) {
    if (!t.staged) return;
    if constexpr (SCAN) {
        const ScanSource s = scan_step_source(P.scan, step);
        load_stream_rows<TILED_THREADS>(s, P.L, s.first + t.first, t.rows, t.lane0, win);
    } else {
        load_rows_async<TILED_THREADS>(P.x, P.L, P.lane_offset, P.lanes, P.vec, t.first, t.rows,
                                       t.lane0, win);
    }
}

// The tile's geometry (the launch precompute, ops/resample.py): each frame's
// masked taps, 17.15 reciprocal, clamped window row and live tap count (at
// most T; its taps past that are zero), into shared memory;
// the unclamped rows to rows_out (by the blocks of lane tile 0, when the
// caller wants them). 256 / F
// threads share a frame: its taps are split between them and their sum is
// reduced by shuffles. (One warp doing every frame's geometry measured
// slower: the others wait out its latency.)
__device__ __forceinline__ void tiled_geometry(const TiledParams& P, const LaunchGeometry& g,
                                               const Tile& t, int F, int T, int row_max, int* kv,
                                               int* rl, int* q, int* lv) {
    const int tpf = TILED_THREADS / F;
    const int f = threadIdx.x / tpf, part = threadIdx.x % tpf;
    const bool live = f < t.nb;
    const FrameWindow w = frame_window(g, t.n0 + f);
    int sum = 0;
    if (live) {
        const int* srow = tap_row(P.tt, w.kernel_start);
        for (int j = part; j < T; j += tpf) {
            const int v = lut_tap(P.tt, srow, w.kernel_start, g.step, j, w.taps);
            kv[f * T + j] = v;
            sum += v;
        }
    }
    for (int o = tpf / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (live && part == 0) {
        q[f] = reciprocal_q31(sum);
        rl[f] = clamp_row(w.row, row_max);
        lv[f] = min(max(w.taps, 0), T);
        if (t.lane0 == 0 && P.rows_out) P.rows_out[t.n0 + f] = w.row;
    }
}

// The multiply-accumulate of one tile: warp w takes frames w, w + 8, ...;
// thread tx of a warp takes lanes lane0 + 4tx .. + 3. A staged tile reads
// each tap's row as one 16-byte shared load and its tap value as a
// broadcast; the taps of the main path's widths (TT) are unrolled. A frame
// stops at its live taps (from 24 taps up, in fours): a reserve or a width
// rounded up to 8 adds taps that are zero, and a zero tap adds nothing. A
// frame from `valid` on (valid_frames) skips its taps and is stored as 0: its
// sum stays 0, and 0 normalises and clamps to 0. A window of int16 rows (scan
// mode) is widened a quad at a time as its taps read it. In scan mode `book`
// is the stage's (step, produced count): the launch's output rows are the
// steps' (N, lanes) frames one after another, row step*N + n for frame n of
// the step (every row index is under 2^31: _build.tiled_scan_args checks),
// and `valid` is unused.
template <int TT, typename OutT, typename SrcT, bool SCAN>
__device__ __forceinline__ void tiled_compute(const TiledParams& P, const Tile& t, int T,
                                              const SrcT* win, const int* kv, const int* rl,
                                              const int* q, const int* lv, int valid,
                                              const int* book) {
    using Q = Quad<SrcT>;
    const int tx = threadIdx.x & 31;
    const int lane = t.lane0 + 4 * tx;
    if (lane >= P.lanes) return;
    int n0 = t.n0;                    // the output row of the tile's first frame
    if constexpr (SCAN) {
        const int base = book[0] * P.N;
        n0 += base;
        valid = book[1] + base;
    }
    for (int f = threadIdx.x >> 5; f < t.nb; f += TILED_WARPS) {
        const int* k = kv + f * T;
        const int live = lv[f];
        int a0 = 0, a1 = 0, a2 = 0, a3 = 0;
        if (n0 + f >= valid) {
            // masked: the zeros are stored below
        } else if (t.staged) {
            const typename Q::type* w = reinterpret_cast<const typename Q::type*>(win) +
                                        (rl[f] - t.first) * TILE_COLS + tx;
            if (TT) {
#pragma unroll
                for (int j = 0; j < TT; j += 4) {
                    if (TT >= 24 && j >= live) break;
                    const int4 kk = *reinterpret_cast<const int4*>(k + j);
                    const int kj[4] = {kk.x, kk.y, kk.z, kk.w};
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int4 v = Q::widen(w[(j + i) * TILE_COLS]);
                        a0 = macc_trunc(a0, v.x, kj[i]);
                        a1 = macc_trunc(a1, v.y, kj[i]);
                        a2 = macc_trunc(a2, v.z, kj[i]);
                        a3 = macc_trunc(a3, v.w, kj[i]);
                    }
                }
            } else {
                for (int j = 0; j < live; ++j) {
                    const int4 v = Q::widen(w[j * TILE_COLS]);
                    const int kj = k[j];
                    a0 = macc_trunc(a0, v.x, kj);
                    a1 = macc_trunc(a1, v.y, kj);
                    a2 = macc_trunc(a2, v.z, kj);
                    a3 = macc_trunc(a3, v.w, kj);
                }
            }
        } else if constexpr (SCAN) {
            // A window past the stage's rows, read from the stream a row at a
            // time; rows outside the step's live range read as zero.
            const int nl = min(4, P.lanes - lane);
            const ScanSource s = scan_step_source(P.scan, book[0]);
            for (int j = 0; j < live; ++j) {
                stream_tap<SrcT>(s, P.L, rl[f] + j, lane, nl, k[j], a0, a1, a2, a3);
            }
        } else if (P.vec) {
            // A window past the stage's rows (taps too wide to stage, or an
            // increment too large for the stage): device memory, 16 bytes a
            // tap (all four lanes live: lanes is a multiple of 4).
            const int4* xr = reinterpret_cast<const int4*>(
                P.x + static_cast<size_t>(rl[f]) * P.L + P.lane_offset + lane);
            for (int j = 0; j < live; ++j, xr += P.L / 4) {
                const int4 v = __ldg(xr);
                const int kj = k[j];
                a0 = macc_trunc(a0, v.x, kj);
                a1 = macc_trunc(a1, v.y, kj);
                a2 = macc_trunc(a2, v.z, kj);
                a3 = macc_trunc(a3, v.w, kj);
            }
        } else {
            const int* xr = P.x + static_cast<size_t>(rl[f]) * P.L + P.lane_offset + lane;
            const int nl = min(4, P.lanes - lane);
            for (int j = 0; j < live; ++j, xr += P.L) {
                const int kj = k[j];
                a0 = macc_trunc(a0, __ldg(xr), kj);
                if (nl > 1) a1 = macc_trunc(a1, __ldg(xr + 1), kj);
                if (nl > 2) a2 = macc_trunc(a2, __ldg(xr + 2), kj);
                if (nl > 3) a3 = macc_trunc(a3, __ldg(xr + 3), kj);
            }
        }
        store_lanes<OutT>(P.out, P.lanes, P.vec, n0 + f, lane, q[f], a0, a1, a2, a3);
    }
}

// Persistent blocks walk the tiles (lane tile fastest, so the blocks in
// flight share their stages' rows in L2; in scan mode then stage, then
// step). Two stages of shared memory: while a block computes one tile, the
// copy of its next tile's window is in flight (cp.async), and its geometry
// follows the compute. One barrier per tile. SrcT and SCAN: the window's
// rows are int32 rows of x (SCAN false: the tiled and general entries), or
// the scan's int16 or int32 stream rows. Scan mode is held to 64 registers
// (4 blocks an SM where its stages' shared memory allows: the scan cell's
// request ran 1.4% faster than at 80 registers and 3 blocks, with no
// spills).
template <int TT, typename OutT, typename SrcT, bool SCAN>
__global__ void __launch_bounds__(TILED_THREADS, SCAN ? 4 : 2)
tiled_mac_kernel(const TiledParams P) {
    extern __shared__ int4 smem4[];
    int* const smem = reinterpret_cast<int*>(smem4);
    const int T = TT ? TT : P.T;
    LaunchGeometry g = read_geometry(P.geo);
    int valid = SCAN ? 0 : valid_frames(P.n_valid, P.frame_offset);
    const int F = stage_frames(g, P.F, T, P.W);
    const int stage_ints = tiled_stage_ints<SrcT>(F, T, P.W);
    const int row_max = max(P.S - T, 0);
    const int lane_tiles = (P.lanes + TILE_LANES - 1) / TILE_LANES;
    const int tiles = lane_tiles * ((P.N + F - 1) / F);     // a step's, in scan mode
    int tile = blockIdx.x;
    // Scan mode: `tile` is a tile of step `step`, whose state g's position
    // holds; each stage's (step, produced count) is in `books`, written by
    // thread 0 as the stage's tile is taken and read after the barrier (in
    // shared memory, not in registers live across the compute, which is
    // what holds scan mode to 64 registers).
    int step = 0;
    int* books = nullptr;
    if constexpr (SCAN) {
        __shared__ int stage_books[4];
        books = stage_books;
        step = tile / tiles;
        tile -= step * tiles;
        if (step >= P.scan.steps) return;
        valid = scan_enter(P.scan, g, 0, step, tile == 0);
        if (threadIdx.x == 0) {
            books[0] = step;
            books[1] = valid;
        }
    } else {
        if (tile >= tiles) return;
    }

    // Stage b: window at smem + b * stage_ints, then taps, rows, q, live.
    auto win = [&](int b) { return reinterpret_cast<SrcT*>(smem + b * stage_ints); };
    auto taps = [&](int b) { return smem + b * stage_ints + window_ints<SrcT>(P.W); };
    auto rows = [&](int b) { return taps(b) + F * T; };
    auto recip = [&](int b) { return rows(b) + F; };
    auto live = [&](int b) { return recip(b) + F; };

    Tile cur = tiled_tile(P, g, tile, lane_tiles, F, T, row_max);
    tiled_load_window<SrcT, SCAN>(P, cur, step, win(0));
    cp_async_commit();
    tiled_geometry(P, g, cur, F, T, row_max, taps(0), rows(0), recip(0), live(0));
    for (int b = 0;; b ^= 1) {
        cp_async_wait_all();
        __syncthreads();
        int next = tile + gridDim.x;
        bool more;
        if constexpr (SCAN) {
            step = books[2 * b];
            const int ahead = next / tiles;
            next -= ahead * tiles;
            more = step + ahead < P.scan.steps;
            if (more) {
                int produced = books[2 * b + 1];
                if (ahead) {
                    produced = scan_enter(P.scan, g, step, step + ahead, next == 0);
                    step += ahead;
                }
                if (threadIdx.x == 0) {
                    books[2 * (b ^ 1)] = step;
                    books[2 * (b ^ 1) + 1] = produced;
                }
            }
        } else {
            more = next < tiles;
        }
        Tile nxt{};
        if (more) {
            nxt = tiled_tile(P, g, next, lane_tiles, F, T, row_max);
            tiled_load_window<SrcT, SCAN>(P, nxt, step, win(b ^ 1));
        }
        cp_async_commit();
        tiled_compute<TT, OutT, SrcT, SCAN>(P, cur, T, win(b), taps(b), rows(b), recip(b),
                                            live(b), valid, SCAN ? books + 2 * b : nullptr);
        if (!more) break;
        tiled_geometry(P, g, nxt, F, T, row_max, taps(b ^ 1), rows(b ^ 1), recip(b ^ 1),
                       live(b ^ 1));
        cur = nxt;
        tile = next;
    }
}

// Persistent grid: as many blocks as fit on the card at this shared memory
// size (persistent_grid, mac_common.cuh), at most one per tile of 8 frames
// (the fewest frames a stage takes; blocks past the tiles exit) of every
// step of the launch.
template <int TT, typename OutT, typename SrcT, bool SCAN>
int launch_tiled(const TiledParams& P, int device, cudaStream_t stream) {
    static PersistentGrid cache;
    const int smem =
        2 * tiled_stage_ints<SrcT>(P.F, TT ? TT : P.T, P.W) * static_cast<int>(sizeof(int));
    int blocks = 0;
    const int err = persistent_grid(cache, tiled_mac_kernel<TT, OutT, SrcT, SCAN>, TILED_THREADS,
                                    smem, device, &blocks);
    if (err != 0) return err;
    const int lane_tiles = (P.lanes + TILE_LANES - 1) / TILE_LANES;
    long long tiles = static_cast<long long>(lane_tiles) * ((P.N + 7) / 8);
    if constexpr (SCAN) tiles *= P.scan.steps;
    const int grid = static_cast<int>(std::min<long long>(tiles, blocks));
    tiled_mac_kernel<TT, OutT, SrcT, SCAN><<<grid, TILED_THREADS, smem, stream>>>(P);
    return static_cast<int>(cudaGetLastError());
}

template <typename OutT, typename SrcT = int32_t, bool SCAN = false>
int launch_tiled_taps(const TiledParams& P, int device, cudaStream_t stream) {
    switch (P.T) {
        case 8: return launch_tiled<8, OutT, SrcT, SCAN>(P, device, stream);
        case 16: return launch_tiled<16, OutT, SrcT, SCAN>(P, device, stream);
        case 24: return launch_tiled<24, OutT, SrcT, SCAN>(P, device, stream);
        case 32: return launch_tiled<32, OutT, SrcT, SCAN>(P, device, stream);
        case 40: return launch_tiled<40, OutT, SrcT, SCAN>(P, device, stream);
        default: return launch_tiled<0, OutT, SrcT, SCAN>(P, device, stream);
    }
}

}  // namespace

extern "C" {

int crt_tiled_mac(const int* x, int S, int L, int lane_offset, int lanes, const int* p0_ptr,
                  int p0_val, const int* f0_ptr, int f0_val, const int* inc_hi,
                  const int* inc_lo, const int* radius, const int* delta,
                  const int* int_radius, const int* step, const int* table, int table_size,
                  const int* tstr, int tstr_rows, int N, int T, int frames_per_stage,
                  int win_rows, int vec, void* out, int* rows_out, int clamp_s16,
                  const int* n_valid, int frame_offset, int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const GeometryArgs geo{p0_ptr, p0_val, f0_ptr, f0_val, inc_hi, inc_lo,
                           radius, delta, int_radius, step};
    const TiledParams P{x, S, L, lane_offset, lanes, geo, {table, table_size, tstr, tstr_rows, T},
                        N, T, frames_per_stage, win_rows, vec, out, rows_out, n_valid,
                        frame_offset};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return clamp_s16 ? launch_tiled_taps<int16_t>(P, device, s)
                     : launch_tiled_taps<int32_t>(P, device, s);
}

// `steps` steps of the whole-stream scan in scan mode, as one launch: window
// row i of the launch's step j is row src_first + j*n_in + i of the (K *
// n_in, L) stream at src (int16 when src_s16, else int32) when that row lies
// in [0, src_end + j*n_in), else 0; S is the rows of the staged buffer a step
// stands for (2r + n_in + taps + 8: clamped windows stay put); state_in (2,)
// is the first step's (p, f); step j's frames go to out + j*N*L, (N, L)
// int32, zero from its produced count on, and its produced, over and next
// state to produced[j], over[j] and state_out[2j..2j+1]. copy is a
// SCAN_COPY_* path, vec 1 when out's rows take 16-byte stores. Returns a
// cudaError_t.
int crt_tiled_scan(const void* src, int src_s16, long long src_first, long long src_end,
                   int n_in, int S, int L, int copy, int vec, const int* state_in,
                   const int* inc_hi, const int* inc_lo, const int* radius, const int* delta,
                   const int* int_radius, const int* step, const int* table, int table_size,
                   const int* tstr, int tstr_rows, int N, int T, int frames_per_stage,
                   int win_rows, int steps, void* out, int* produced, int* over,
                   int* state_out, int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const GeometryArgs geo{state_in, 0, state_in + 1, 0, inc_hi, inc_lo,
                           radius, delta, int_radius, step};
    const TiledParams P{nullptr, S, L, 0, L, geo, {table, table_size, tstr, tstr_rows, T},
                        N, T, frames_per_stage, win_rows, vec, out, nullptr, nullptr, 0,
                        {src, src_first, src_end, copy, n_in, N, 0, produced, over, state_out,
                         steps}};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return src_s16 ? launch_tiled_taps<int32_t, int16_t, true>(P, device, s)
                   : launch_tiled_taps<int32_t, int32_t, true>(P, device, s);
}

const char* crt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
