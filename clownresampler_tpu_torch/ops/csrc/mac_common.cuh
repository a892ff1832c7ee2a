// Arithmetic shared by the resampler's hand-written kernels (sm_90a).
//
// Every kernel computes, for output frame n and lane l,
//
//     acc      = sum_t trunc(x[row + t][l] * k[t] / 2^16)
//     out[n,l] = trunc(acc * q / 2^15)            (optionally clamped to s16)
//
// bit-exactly as the C reference's inner loop does (clownresampler.h:1008-1033).
// The helpers below are that arithmetic, the per-frame window geometry and the
// masked LUT taps that the launch precompute computes (ops/resample.py), read
// from the launch state and ConfigScalars by pointer (GeometryArgs), and the
// staging the kernels share: cp.async copies of 128-lane row tiles into
// shared memory, the scan mode's copies from the chunks read as one stream
// and its per-launch bookkeeping (scan_launch), and 16-byte output stores.
// Each source that includes this
// header is its own translation unit and shared library (ops/_build.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One tap: acc + trunc((x * k) / 2^16). |x| <= 32768 and k in [-9651, 65536],
// so the product spans exactly [-2^31, 2^31); it is formed with wrapping
// unsigned arithmetic (no signed-overflow UB), and 0xFFFF for a negative
// product is the bias that turns the arithmetic shift (floor) into
// truncation toward zero. The bias goes in as (p >>> 31) * 0xFFFF + p, one
// multiply-add, so a tap is four operations: multiply, sign shift,
// multiply-add, shift-add (written as (p >> 31) & 0xFFFF the bias costs
// three). It is exact: for p >= 0 it adds nothing, and for p < 0, p + 0xFFFF
// cannot overflow and floor((p + 0xFFFF) / 2^16) = ceil(p / 2^16), which is
// p / 2^16 truncated toward zero.
__device__ __forceinline__ int macc_trunc(int acc, int x, int k) {
    const int p = static_cast<int>(static_cast<unsigned>(x) * static_cast<unsigned>(k));
    unsigned sign;
    asm("shr.b32 %0, %1, 31;" : "=r"(sign) : "r"(p));
    int t;
    asm("mad.lo.s32 %0, %1, 65535, %2;" : "=r"(t) : "r"(sign), "r"(p));
    return acc + (t >> 16);
}

// C (acc * q) / 2^15 with a 64-bit product; C division truncates toward zero.
__device__ __forceinline__ int mul_shift15(int acc, int q) {
    const long long p = static_cast<long long>(acc) * static_cast<long long>(q);
    return static_cast<int>(p / 32768);
}

// A uniform-ratio launch's phase and window geometry, read once per block.
// The launch state and the configuration scalars live in device memory (0-dim
// tensors) and are read through pointers, so a launch needs no host sync; a
// position given as a host integer comes by value with a null pointer.
struct LaunchGeometry {
    long long p0, f0, inc;          // 16.16 phase: t(n) = f0 + n*inc
    int radius, delta, int_radius, step;
};

// Where a kernel reads its LaunchGeometry: the launch state (pointer or
// value) and the ConfigScalars fields, in the order every C entry takes them.
struct GeometryArgs {
    const int* p0_ptr;
    int p0_val;
    const int* f0_ptr;
    int f0_val;
    const int *inc_hi, *inc_lo, *radius, *delta, *int_radius, *step;
};

__device__ __forceinline__ int scalar_at(const int* p, int fallback) {
    return p ? __ldg(p) : fallback;
}

__device__ __forceinline__ LaunchGeometry read_geometry(const GeometryArgs& a) {
    LaunchGeometry g;
    g.p0 = scalar_at(a.p0_ptr, a.p0_val);
    g.f0 = scalar_at(a.f0_ptr, a.f0_val);
    g.inc = (static_cast<long long>(__ldg(a.inc_hi)) << 16) + __ldg(a.inc_lo);
    g.radius = __ldg(a.radius);
    g.delta = __ldg(a.delta);
    g.int_radius = __ldg(a.int_radius);
    g.step = __ldg(a.step);
    return g;
}

// Frame n's window (clownresampler.h:990-1001), positions in closed form in
// int64, exact for any n: row = pos + min_rel is the first input row,
// kernel_start the LUT index of tap 0, taps the count of live taps.
struct FrameWindow {
    int row, kernel_start, taps;
};

__device__ __forceinline__ FrameWindow frame_window(const LaunchGeometry& g, long long n) {
    const long long t = g.f0 + n * g.inc;
    const int frac = static_cast<int>(t & 0xFFFF);
    const int min_rel = (frac + g.delta + 0xFFFF) >> 16;
    const int max_rel = (frac + g.radius) >> 16;
    FrameWindow w;
    w.row = static_cast<int>(g.p0 + (t >> 16) + min_rel);
    w.kernel_start = (g.step * ((min_rel << 16) - frac)) >> 16;
    w.taps = g.int_radius + max_rel - min_rel;
    return w;
}

__device__ __forceinline__ int clamp_row(int row, int row_max) {
    return min(max(row, 0), row_max);
}

// The LUT a launch reads its taps from: the flat table, or (tstr non-null)
// its strided form (tstr_rows, T), one row of T taps per kernel_start.
struct TapTable {
    const int* table;
    int table_size;
    const int* tstr;
    int tstr_rows, T;
};

// The strided table's row for a frame's kernel_start (null for the flat LUT).
__device__ __forceinline__ const int* tap_row(const TapTable& tt, int kernel_start) {
    return tt.tstr ? tt.tstr + static_cast<size_t>(min(max(kernel_start, 0), tt.tstr_rows - 1)) *
                                   tt.T
                   : nullptr;
}

// Masked tap j of a frame (launch precompute, clownresampler.h:1008-1021):
// 0 past the frame's live taps, else the LUT at kernel_start + j*step
// (clamped into the table) or row[j] of the strided table.
__device__ __forceinline__ int lut_tap(const TapTable& tt, const int* row, int kernel_start,
                                       int step, int j, int taps) {
    if (j >= taps) return 0;
    return row ? __ldg(row + j)
               : __ldg(tt.table + min(max(kernel_start + j * step, 0), tt.table_size - 1));
}

// Asynchronous global -> shared copies (cp.async) to a shared-space address:
// 16 or 4 bytes, zero-filled when !valid (src must still be a mapped address).
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src, bool valid) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Lanes of one staged tile: 32 threads x 4 lanes, as 16-byte columns.
constexpr int TILE_LANES = 128;
constexpr int TILE_COLS = TILE_LANES / 4;

// Start the copy of input rows [first, first + rows) x lanes [lane0, lane0 +
// TILE_LANES) of the launch into win (rows x TILE_LANES ints), by THREADS
// threads; lanes past the launch's are zero-filled. A thread keeps one
// column and takes every (THREADS / TILE_COLS)-th row, its source and
// destination advanced by a stride: the loop is the copies and no index
// arithmetic. vec: x, L, lane_offset and lanes are 4-lane aligned, so each
// column is one 16-byte copy.
template <int THREADS>
__device__ __forceinline__ void load_rows_async(const int* x, int L, int lane_offset, int lanes,
                                                int vec, int first, int rows, int lane0,
                                                int* win) {
    static_assert(THREADS % TILE_COLS == 0, "a thread keeps one column");
    constexpr int STEP = THREADS / TILE_COLS;
    constexpr unsigned DST_STEP = STEP * TILE_LANES * sizeof(int);
    const int col = threadIdx.x % TILE_COLS;
    const int lane = lane0 + 4 * col;
    int r = threadIdx.x / TILE_COLS;
    if (r >= rows) return;
    const int* src = x + static_cast<size_t>(first + r) * L + lane_offset + lane;
    const size_t src_step = static_cast<size_t>(STEP) * L;
    unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(win + r * TILE_LANES + 4 * col));
    if (vec) {
        const bool ok = lane < lanes;
        const int* s = ok ? src : x;
        const size_t step = ok ? src_step : 0;
        for (; r < rows; r += STEP, s += step, dst += DST_STEP) cp_async16(dst, s, ok);
        return;
    }
    const int in_launch = min(max(lanes - lane, 0), 4);
    for (; r < rows; r += STEP, src += src_step, dst += DST_STEP) {
        for (int i = 0; i < 4; ++i) {
            cp_async4(dst + 4 * i, i < in_launch ? src + i : x, i < in_launch);
        }
    }
}

// ---------------------------------------------------------------------------
// Scan mode: a step of the whole-stream scan read straight from the chunks
// ---------------------------------------------------------------------------
//
// The scan's chunks are one contiguous (K, n_in, L) int16 or int32 tensor,
// so step k's staged buffer [halo | chunk | zeros] is exactly stream rows
// [k*n_in - 2r, (k+1)*n_in) with zeros before row 0 and past the chunk (for
// n_in < 2r too: the halo is the same stream window). The MAC kernels' scan
// modes (tiled_mac_kernel, strided_mac_kernel, wide_mac_kernel and its fold)
// copy their windows' rows from there into shared memory as they are, int16
// when the chunks are, and widen a quad of lanes when a tap reads it; each
// launch works out the step's bookkeeping itself from the step's state.

// How a window's rows are copied from the stream, picked by the host
// (_build.scan_copy_path): 16-byte cp.async granules (a row's bytes and the
// chunks' address multiples of 16), 4-byte cp.async words (multiples of 4),
// or element loads (cp.async has no 2-byte form: an odd int16 lane count or
// an address off 4 bytes).
constexpr int SCAN_COPY_ELEMENTS = 0;
constexpr int SCAN_COPY_WORDS = 1;
constexpr int SCAN_COPY_VEC = 2;

// Scan mode's source and bookkeeping. Window row i of the step is stream row
// first + i of the chunks read as one (K * n_in, L) stream when 0 <= first + i
// < end, else 0: first = k*n_in - 2r, end = (k+1)*n_in for step k. A launch
// computes frames [offset, offset + N) of the step's n_out (a step of the
// wide engine may be several launches; every other step is one, offset 0).
// The tiled scan mode's launch takes `steps` steps from the given one on,
// step j's window shifted by j*n_in rows and its bookkeeping at index j.
struct ScanSource {
    const void* chunks;               // int16 or int32 (SrcT); never offset before it
    long long first, end;
    int copy;                         // SCAN_COPY_*
    int n_in;                         // chunk frames
    int n_out;                        // the step's output frames, all launches
    int offset;                       // the launch's first frame in the step
    int* produced;                    // (steps,) written by the step's offset-0 launch
    int* over;                        // (steps,)
    int* state_out;                   // (steps, 2) each next step's (p, f)
    int steps;                        // the tiled scan mode's steps a launch (unused by others)
};

// A scan step's bookkeeping from its state (p with the scan's +radius bias,
// f), in int64 as the scan's plain version computes it
// (lowlevel._step_scalars): natural = ceil(((n_in - p) * 2^16 - f) / inc)
// frames are due, produced = min(natural, n_out), and the next step's state
// is the position after them with the carry (clownresampler.h:1063-1068):
// p' = p_after - min(p_after, n_in), f' = t & 0xFFFF.
struct ScanBooks {
    long long natural, produced, p_next, f_next;
};

__device__ __forceinline__ ScanBooks scan_books(const ScanSource& s, long long p, long long f,
                                                long long inc) {
    ScanBooks b;
    const long long num = (static_cast<long long>(s.n_in) - p) * 65536 - f;
    b.natural = num > 0 ? (num + inc - 1) / (inc > 1 ? inc : 1) : 0;
    b.produced = b.natural < s.n_out ? b.natural : s.n_out;
    const long long t = f + b.produced * inc;
    const long long p_after = p + (t >> 16);
    b.p_next = p_after - (p_after < s.n_in ? p_after : s.n_in);
    b.f_next = t & 0xFFFF;
    return b;
}

// Step j's produced, over (natural > n_out) and next state, at index j of
// the launch's bookkeeping arrays.
__device__ __forceinline__ void write_books(const ScanSource& s, int j, const ScanBooks& b) {
    s.produced[j] = static_cast<int>(b.produced);
    s.over[j] = b.natural > s.n_out ? 1 : 0;
    s.state_out[2 * j] = static_cast<int>(b.p_next);
    s.state_out[2 * j + 1] = static_cast<int>(b.f_next);
}

// The bookkeeping of one single-step scan-mode launch. On entry g's
// position is the step's state (read_geometry of the state pointer);
// `writer` (thread 0 of block 0) of the step's offset-0 launch writes its
// books (scan_books); a launch at another offset writes nothing. On return g
// holds the launch's state at frame `offset` of the step: t = f + offset *
// inc, p0 = p + (t >> 16), f0 = t & 0xFFFF. Returns the launch's frames that
// keep their values, produced - offset; its stores mask the rest.
__device__ __forceinline__ int scan_launch(const ScanSource& s, LaunchGeometry& g,
                                           bool writer) {
    const long long p = g.p0, f = g.f0;
    const ScanBooks b = scan_books(s, p, f, g.inc);
    if (writer && s.offset == 0) write_books(s, 0, b);
    const long long t = f + static_cast<long long>(s.offset) * g.inc;
    g.p0 = p + (t >> 16);
    g.f0 = t & 0xFFFF;
    return static_cast<int>(b.produced) - s.offset;
}

// Step j of a multi-step launch (the tiled scan mode): the source with its
// window shifted by j*n_in stream rows.
__device__ __forceinline__ ScanSource scan_step_source(const ScanSource& s, int j) {
    ScanSource t = s;
    const long long shift = static_cast<long long>(j) * s.n_in;
    t.first += shift;
    t.end += shift;
    return t;
}

// Four staged lanes as one shared load (16 bytes of int32, 8 of int16), and
// widened to int32.
template <typename SrcT>
struct Quad;

template <>
struct Quad<int32_t> {
    using type = int4;
    static __device__ __forceinline__ int4 widen(int4 v) { return v; }
};

template <>
struct Quad<int16_t> {
    using type = int2;
    // Little-endian pairs: the low half sign-extended, the high half shifted down.
    static __device__ __forceinline__ int4 widen(int2 v) {
        return make_int4(static_cast<int16_t>(v.x & 0xFFFF), v.x >> 16,
                         static_cast<int16_t>(v.y & 0xFFFF), v.y >> 16);
    }
};

// Ints of a staged window of W rows x TILE_LANES lanes of SrcT.
template <typename SrcT>
__host__ __device__ inline int window_ints(int W) {
    return W * TILE_LANES * static_cast<int>(sizeof(SrcT)) / 4;
}

// Start the copy of window rows [0, rows) -- stream rows first + r -- x lanes
// [lane0, lane0 + TILE_LANES) into win, BYTES (16 or 4) a copy, by THREADS
// threads; rows outside [0, end) and lanes past L are zero-filled (the
// copy's source is then the stream's base, never an address before it). A
// thread keeps one column, as load_rows_async does.
template <int THREADS, int BYTES, typename SrcT>
__device__ __forceinline__ void copy_stream_rows(const SrcT* x, int L, long long first,
                                                 long long end, int rows, int lane0, SrcT* win) {
    constexpr int PER = BYTES / static_cast<int>(sizeof(SrcT));     // lanes a copy
    constexpr int COLS = TILE_LANES / PER;
    constexpr int STEP = THREADS / COLS;
    static_assert(THREADS % COLS == 0, "a thread keeps one column");
    constexpr unsigned DST_STEP = STEP * TILE_LANES * sizeof(SrcT);
    const int col = threadIdx.x % COLS;
    const int lane = lane0 + PER * col;
    int r = threadIdx.x / COLS;
    unsigned dst =
        static_cast<unsigned>(__cvta_generic_to_shared(win + r * TILE_LANES + PER * col));
    for (; r < rows; r += STEP, dst += DST_STEP) {
        const long long s = first + r;
        const bool ok = lane < L && s >= 0 && s < end;
        const SrcT* src = ok ? x + s * L + lane : x;
        if constexpr (BYTES == 16) {
            cp_async16(dst, src, ok);
        } else {
            cp_async4(dst, src, ok);
        }
    }
}

// Start the copy of `rows` window rows from stream row `first` on into win
// by the source's copy path (the element path's plain loads and shared
// stores are visible after the next barrier, as the cp.async copies are
// after the wait and the barrier).
template <int THREADS, typename SrcT>
__device__ __forceinline__ void load_stream_rows(const ScanSource& s, int L, long long first,
                                                 int rows, int lane0, SrcT* win) {
    const SrcT* x = static_cast<const SrcT*>(s.chunks);
    if (s.copy == SCAN_COPY_VEC) {
        copy_stream_rows<THREADS, 16>(x, L, first, s.end, rows, lane0, win);
    } else if (s.copy == SCAN_COPY_WORDS) {
        copy_stream_rows<THREADS, 4>(x, L, first, s.end, rows, lane0, win);
    } else {
        for (int i = threadIdx.x; i < rows * TILE_LANES; i += THREADS) {
            const long long r = first + i / TILE_LANES;
            const int lane = lane0 + i % TILE_LANES;
            win[i] = lane < L && r >= 0 && r < s.end ? __ldg(x + r * L + lane) : SrcT(0);
        }
    }
}

// Four lanes from `lane` on of window row `row` (stream row s.first + row)
// read from the stream directly, a tap's MACs into a0..a3: rows outside the
// step's live range [0, end) read as zero, lanes past the launch's `nl` live
// ones are not read.
template <typename SrcT>
__device__ __forceinline__ void stream_tap(const ScanSource& s, int L, long long row, int lane,
                                           int nl, int k, int& a0, int& a1, int& a2, int& a3) {
    const long long r = s.first + row;
    if (r < 0 || r >= s.end) return;
    const SrcT* xr = static_cast<const SrcT*>(s.chunks) + r * L + lane;
    a0 = macc_trunc(a0, __ldg(xr), k);
    if (nl > 1) a1 = macc_trunc(a1, __ldg(xr + 1), k);
    if (nl > 2) a2 = macc_trunc(a2, __ldg(xr + 2), k);
    if (nl > 3) a3 = macc_trunc(a3, __ldg(xr + 3), k);
}

template <typename OutT>
__device__ __forceinline__ void store4(OutT* o, OutT v0, OutT v1, OutT v2, OutT v3);

template <>
__device__ __forceinline__ void store4<int32_t>(int32_t* o, int32_t v0, int32_t v1, int32_t v2,
                                                int32_t v3) {
    __stcs(reinterpret_cast<int4*>(o), make_int4(v0, v1, v2, v3));
}

template <>
__device__ __forceinline__ void store4<int16_t>(int16_t* o, int16_t v0, int16_t v1, int16_t v2,
                                                int16_t v3) {
    const auto pack = [](int16_t a, int16_t b) {
        return static_cast<int>(static_cast<uint16_t>(a) |
                                (static_cast<unsigned>(static_cast<uint16_t>(b)) << 16));
    };
    __stcs(reinterpret_cast<int2*>(o), make_int2(pack(v0, v1), pack(v2, v3)));
}

// C 0x80000000 / sum (clownresampler.h:1025) with |sum| floored at 2, the
// sign put back: the port's reciprocal_q31. |sum| < 2^31, so one unsigned
// 32-bit division is exact.
__device__ __forceinline__ int reciprocal_q31(int sum) {
    const unsigned m = max(static_cast<unsigned>(sum < 0 ? -sum : sum), 2u);
    const int q = static_cast<int>(0x80000000u / m);
    return sum < 0 ? -q : q;
}

template <typename OutT>
__device__ __forceinline__ OutT finish(int v);

template <>
__device__ __forceinline__ int32_t finish<int32_t>(int v) { return v; }

template <>
__device__ __forceinline__ int16_t finish<int16_t>(int v) {
    return static_cast<int16_t>(min(max(v, -0x7FFF), 0x7FFF));
}

// Frame n's four lanes from `lane` on, of an (N, lanes) output: normalise by
// qn, clamp if OutT is int16, store (one 16- or 8-byte store when vec, else
// per live lane).
template <typename OutT>
__device__ __forceinline__ void store_lanes(void* out, int lanes, int vec, int n, int lane,
                                            int qn, int a0, int a1, int a2, int a3) {
    const OutT v0 = finish<OutT>(mul_shift15(a0, qn)), v1 = finish<OutT>(mul_shift15(a1, qn));
    const OutT v2 = finish<OutT>(mul_shift15(a2, qn)), v3 = finish<OutT>(mul_shift15(a3, qn));
    OutT* o = static_cast<OutT*>(out) + static_cast<size_t>(n) * lanes + lane;
    if (vec) {
        store4<OutT>(o, v0, v1, v2, v3);
        return;
    }
    o[0] = v0;
    if (lane + 1 < lanes) o[1] = v1;
    if (lane + 2 < lanes) o[2] = v2;
    if (lane + 3 < lanes) o[3] = v3;
}

// The frames of a launch that keep their values: frame n is stored as 0 when
// n + frame_offset >= *n_valid (a scan step's frames past `produced`, read
// from device memory: no host sync); every frame when n_valid is null.
__device__ __forceinline__ int valid_frames(const int* n_valid, int frame_offset) {
    return n_valid ? __ldg(n_valid) - frame_offset : 0x7FFFFFFF;
}

// ---------------------------------------------------------------------------
// Host side: the launch's device and a persistent grid
// ---------------------------------------------------------------------------

constexpr int MAX_DEVICES = 64;

// Makes `device` current for the launches of one C entry and puts the
// caller's device back when the entry returns; `err` is the cudaError_t of
// getting and setting it.
struct DeviceGuard {
    int previous = -1;
    bool changed = false;
    int err;
    explicit DeviceGuard(int device) {
        cudaError_t e = cudaGetDevice(&previous);
        if (e == cudaSuccess && previous != device) {
            e = cudaSetDevice(device);
            changed = e == cudaSuccess;
        }
        err = static_cast<int>(e);
    }
    ~DeviceGuard() {
        if (changed) cudaSetDevice(previous);
    }
    DeviceGuard(const DeviceGuard&) = delete;
    DeviceGuard& operator=(const DeviceGuard&) = delete;
};

// Per-device cache of one kernel's persistent grid: its opt-in to the card's
// shared memory and the SM count (set up once per device), the blocks an SM
// holds (once per device and shared memory size).
struct PersistentGrid {
    int sms[MAX_DEVICES], smem[MAX_DEVICES], blocks[MAX_DEVICES];
};

// *grid = as many blocks of `threads` threads and `smem` bytes of dynamic
// shared memory as fit on the card at once; returns a cudaError_t.
template <typename Kernel>
int persistent_grid(PersistentGrid& c, Kernel kernel, int threads, int smem, int device,
                    int* grid) {
    if (device < 0 || device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
    cudaError_t err;
    if (c.sms[device] == 0) {
        // The opt-in covers what the card allows beside the static shared memory.
        cudaFuncAttributes attr;
        err = cudaFuncGetAttributes(&attr, kernel);
        if (err != cudaSuccess) return static_cast<int>(err);
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   227 * 1024 - static_cast<int>(attr.sharedSizeBytes));
        if (err != cudaSuccess) return static_cast<int>(err);
        int n = 0;
        err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
        if (err != cudaSuccess) return static_cast<int>(err);
        c.sms[device] = n;
    }
    if (c.smem[device] != smem || c.blocks[device] == 0) {
        int blocks = 0;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
        c.smem[device] = smem;
        c.blocks[device] = blocks;
    }
    *grid = c.blocks[device] * c.sms[device];
    return 0;
}

}  // namespace
