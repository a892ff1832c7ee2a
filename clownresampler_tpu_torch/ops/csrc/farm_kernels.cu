// Hand-written Hopper (sm_90a) kernels for the two ends of a transcode farm call.
//
// Neither has a Pallas counterpart: they replace device code that XLA compiles
// around the Pallas kernels in the JAX package's farm.
//
// farm_stage_kernel is a call's staging (clownresampler_tpu/farm.py:273-304,
// `_dev_stage`, `_dev_shift` and `_dev_zero_rows`): from the farm's two
// lane-major (capacity, L) int32 staging buffers and a stream-major
// (B, n, C) int16 chunk on the device,
//  - rows [0, keep) of the destination get rows [consumed, consumed + keep)
//    of the source: the slide the call before left parked. With nothing
//    parked the source is the destination (consumed == 0) and the rows stay
//    where they are;
//  - rows [keep, keep + n) get the chunk widened to int32 and transposed to
//    lane-major: row keep + t, lane b*C + c is chunk[b][t][c];
//  - every row from keep + n to the capacity is zero.
// The kept rows and the zero tail are flat (whole rows are contiguous). The
// transpose is a real one: for a fixed stream the chunk is contiguous along
// (t, c), a staged row along (b, c).
//
// Two paths, chosen by the host before the launch from the shapes and
// addresses (ops/_build.py farm_stage_path):
//  - the ring (farm_stage_kernel<2>): C even, n*C a multiple of 8, L a
//    multiple of 4, the chunk and the buffers 16-byte aligned. Two
//    persistent blocks an SM each keep `stages` tiles of TB streams x TT
//    frames in flight: a producer warp fills the ring's stages with one bulk
//    TMA copy (cp.async.bulk) a stream, its run of TT*C samples (256 bytes
//    for stereo: 32 streams x 64 frames), completing on an mbarrier; eight
//    consumer warps widen and transpose the landed tile and store each
//    frame's TB*C lanes (256 bytes) with 16-byte streaming stores, then
//    release the stage. Loads are in flight while a tile is stored: 4 x 8 KB
//    a block, 8.6 MB over the card. The host passes the stage count, the
//    tile and each stream's slot in a stage (ops/_build.py
//    farm_ring_layout, whose values chip_scripts/farm_ring_sweep.py measured
//    against others on the H100, PERF.md);
//  - everything else (farm_stage_kernel<1> and <0>): one tile in flight a
//    block; each stream's run read by a warp, 4-byte loads and 16-byte
//    stores when C is even, L a multiple of 4 and the pointers aligned,
//    element by element (2-byte loads, 4-byte stores) otherwise.
//
// farm_unstage_kernel is the other end (clownresampler_tpu/farm.py:517-529,
// the host's de-interleave of the launched lanes): from the launches'
// lane-major (n_out, L) output, int32 or clamped int16, it writes streams
// [stream_lo, stream_lo + streams) stream-major, (streams, n_out, C)
// contiguous at dst. It moves 4-byte words (one int32 sample, or two int16
// samples when C is even; single int16 samples when C is odd) through a
// shared-memory tile of TT frames x TB streams: rows read coalesced along
// the lanes, each stream's run of TT*C samples written coalesced. A stream's
// block starts wherever n_out*C puts it, so the stores stay one word wide.
//
// What bounds them on the H100: bytes. At 1024 stereo streams, 48 kHz ->
// 44.1 kHz (8916-frame chunks, 8192 frames out) the stage reads 36.5 MB and
// writes 73.0 MB (plus under 1 MB of kept rows and tail), about 0.033 ms at
// 3.35 TB/s; the unstage reads and writes 67.1 MB each, 0.040 ms. At that
// rate the card needs megabytes of loads in flight, which one tile a block
// of 128-byte runs does not give and the ring does.
//
// crt_farm_copy and crt_farm_sync are cudaMemcpyAsync and
// cudaStreamSynchronize on the caller's stream, so that a farm call's
// uploads, download and wait are issued like its launches.
//
// crt_farm_host_stage is host code: the caller's C-contiguous int16 chunk
// into the farm's pinned input by the calling thread and a pool of host
// threads, in pieces; once every thread has written its part of a piece, that
// piece's upload is issued, so the copy of the next piece overlaps it. On the
// H100's host one thread copies 5-6 GB/s and eight 19-33, against an upload of
// 41 GB/s (PERF.md §5), so a chunk goes up at the rate of the threads' copy,
// with no pass of its own before it. The same threads copy a result into a
// fresh array where a caller holds every pooled result buffer. One job runs at
// a time: farms fed from several host threads take turns.
//
// Built by ops/_build.py with nvcc into a shared library with a plain C
// interface, like the MAC kernels' sources; the Python side checks devices,
// dtypes, shapes and alignment before it passes pointers.

#include <sched.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <new>
#include <system_error>
#include <thread>
#include <vector>
#if defined(__x86_64__)
#include <immintrin.h>
#endif

#include "mac_common.cuh"

namespace {

constexpr int FARM_THREADS = 256;
constexpr int FARM_WARPS = FARM_THREADS / 32;
// The ring path: its blocks an SM, its consumer warps and the producer warp
// beside them, and the bytes of shared memory before its stages, which hold
// its 2 x stages mbarriers (ops/_build.py FARM_RING_HEADER): at most
// RING_HEADER / 16 stages.
constexpr int RING_BLOCKS_PER_SM = 2;
constexpr int RING_CONSUMERS = 8;
constexpr int RING_THREADS = (RING_CONSUMERS + 1) * 32;
constexpr int RING_HEADER = 128;

struct StageParams {
    const int* src;                   // the buffer that holds the rows to keep
    int* dst;                         // the buffer to stage into (may be src)
    const int16_t* chunk;             // (B, n, C)
    int streams, n_in, channels;      // B, n, C
    int keep, consumed, capacity;     // rows
    int tile_streams, tile_frames;    // TB, TT
    int row_stride;                   // int16 elements (one tile a block) or words (ring) of
                                      // one stream's part of a tile in shared memory
    int stages;                       // the ring's stages
};

// Flat part: the kept rows and the zero tail, VEC ints at a time, by
// `threads` threads a block (thread `tid`).
template <int VEC>
__device__ __forceinline__ void stage_flat(const StageParams& P, int tid, int threads) {
    const long long L = static_cast<long long>(P.streams) * P.channels;
    const long long stride = static_cast<long long>(gridDim.x) * threads;
    const long long first = static_cast<long long>(blockIdx.x) * threads + tid;
    const long long kept = P.src == P.dst ? 0 : P.keep * L / VEC;
    const long long tail0 = (static_cast<long long>(P.keep) + P.n_in) * L / VEC;
    const long long tail = P.capacity * L / VEC - tail0;
    if (VEC == 4) {
        const int4* s = reinterpret_cast<const int4*>(P.src + P.consumed * L);
        int4* d = reinterpret_cast<int4*>(P.dst);
        for (long long i = first; i < kept; i += stride) d[i] = __ldg(s + i);
        for (long long i = first; i < tail; i += stride) d[tail0 + i] = make_int4(0, 0, 0, 0);
    } else {
        const int* s = P.src + P.consumed * L;
        for (long long i = first; i < kept; i += stride) P.dst[i] = s[i];
        for (long long i = first; i < tail; i += stride) P.dst[tail0 + i] = 0;
    }
}

// One tile in flight a block (FARM_THREADS threads). VEC: C is even, L a
// multiple of 4, TB*C a multiple of 4 and the chunk and dst pointers 4- and
// 16-byte aligned.
template <bool VEC>
__device__ __forceinline__ void stage_tiles(const StageParams& P) {
    extern __shared__ __align__(16) unsigned char farm_tile[];
    int16_t* tile = reinterpret_cast<int16_t*>(farm_tile);
    const int C = P.channels, n = P.n_in;
    const long long L = static_cast<long long>(P.streams) * C;
    stage_flat<VEC ? 4 : 1>(P, threadIdx.x, FARM_THREADS);

    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int TB = P.tile_streams, TT = P.tile_frames;
    const int frame_tiles = (n + TT - 1) / TT;
    const long long tiles = static_cast<long long>((P.streams + TB - 1) / TB) * frame_tiles;
    for (long long tile_id = blockIdx.x; tile_id < tiles; tile_id += gridDim.x) {
        const int b0 = static_cast<int>(tile_id / frame_tiles) * TB;
        const int t0 = static_cast<int>(tile_id % frame_tiles) * TT;
        const int sv = min(TB, P.streams - b0), tv = min(TT, n - t0);
        const int run = tv * C;                       // samples of one stream's run
        // Load: warp w takes streams w, w + 8, ...; a lane walks the run.
        for (int i = warp; i < sv; i += FARM_WARPS) {
            const int16_t* src = P.chunk + (static_cast<long long>(b0 + i) * n + t0) * C;
            int16_t* row = tile + i * P.row_stride;
            if (VEC) {
                const int* src2 = reinterpret_cast<const int*>(src);
                int* row2 = reinterpret_cast<int*>(row);
                for (int j = lane; j < run / 2; j += 32) row2[j] = __ldcs(src2 + j);
            } else {
                for (int j = lane; j < run; j += 32) row[j] = __ldcs(src + j);
            }
        }
        __syncthreads();
        // Store: warp w takes frames w, w + 8, ...; a lane keeps its lanes of
        // the row (their stream and channel worked out once a tile).
        int* out = P.dst + (static_cast<long long>(P.keep) + t0) * L +
                   static_cast<long long>(b0) * C;
        const int width = sv * C;
        if (VEC) {
            for (int q = lane; 4 * q < width; q += 32) {
                int at[4];
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                    const int l = 4 * q + k;
                    at[k] = (l / C) * P.row_stride + l % C;
                }
                for (int t = warp; t < tv; t += FARM_WARPS) {
                    const int16_t* fr = tile + t * C;
                    __stcs(reinterpret_cast<int4*>(out + t * L) + q,
                           make_int4(fr[at[0]], fr[at[1]], fr[at[2]], fr[at[3]]));
                }
            }
        } else {
            for (int l = lane; l < width; l += 32) {
                const int at = (l / C) * P.row_stride + l % C;
                for (int t = warp; t < tv; t += FARM_WARPS) out[t * L + l] = tile[t * C + at];
            }
        }
        __syncthreads();
    }
}

// ---------------------------------------------------------------------------
// The ring: mbarriers and bulk TMA copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned shared_address(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(shared_address(bar)), "r"(count) : "memory");
}

// One arrival that also expects `bytes` of copies to complete on the barrier.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, unsigned bytes) {
    asm volatile("{\n .reg .b64 state;\n"
                 " mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
                 :: "r"(shared_address(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
                 :: "r"(shared_address(bar)) : "memory");
}

// Spin until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    const unsigned addr = shared_address(bar);
    unsigned done = 0;
    while (!done) {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

// Bulk TMA copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// from global to shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                 "[%0], [%1], %2, [%3];\n"
                 :: "r"(shared_address(dst)), "l"(src), "r"(bytes), "r"(shared_address(bar))
                 : "memory");
}

__device__ __forceinline__ int low_sample(int word) {
    return static_cast<int16_t>(word & 0xFFFF);
}

__device__ __forceinline__ int high_sample(int word) { return word >> 16; }

// The ring path (C even; n*C a multiple of 8; the chunk, src and dst 16-byte
// aligned; L a multiple of 4; TB even, TT*C a multiple of 8). Block b takes
// tiles b, b + grid, ...; its k-th tile goes through stage k % stages. Stream
// i of a tile lands at word i*S of its stage (S = row_stride, a multiple of 4
// words), its run of tv*C samples contiguous, so a stream's run is one bulk
// copy. RING_THREADS threads.
__device__ __forceinline__ void stage_ring(const StageParams& P) {
    extern __shared__ __align__(128) unsigned char farm_ring[];
    const int ring = P.stages;
    uint64_t* full = reinterpret_cast<uint64_t*>(farm_ring);
    uint64_t* empty = full + ring;
    int* stages = reinterpret_cast<int*>(farm_ring + RING_HEADER);
    const int C = P.channels, n = P.n_in, S = P.row_stride;
    const int TB = P.tile_streams, TT = P.tile_frames;
    const int stage_words = TB * S;
    const int frame_tiles = (n + TT - 1) / TT;
    const int tiles = (P.streams + TB - 1) / TB * frame_tiles;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
        for (int s = 0; s < ring; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, RING_CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == RING_CONSUMERS) {
        // Producer: wait for the stage to be released (the first round passes),
        // expect the tile's bytes, copy each stream's run.
        int k = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
            const int s = k % ring;
            mbar_wait(empty + s, ((k / ring) & 1) ^ 1);
            const int b0 = tile / frame_tiles * TB, t0 = tile % frame_tiles * TT;
            const int sv = min(TB, P.streams - b0), tv = min(TT, n - t0);
            const unsigned run_bytes = 2u * tv * C;
            if (lane == 0) mbar_arrive_expect(full + s, run_bytes * sv);
            __syncwarp();
            for (int i = lane; i < sv; i += 32) {
                bulk_load(stages + s * stage_words + i * S,
                          P.chunk + (static_cast<long long>(b0 + i) * n + t0) * C, run_bytes,
                          full + s);
            }
        }
        return;
    }

    stage_flat<4>(P, threadIdx.x, RING_CONSUMERS * 32);
    const long long L = static_cast<long long>(P.streams) * C;
    int k = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++k) {
        const int s = k % ring;
        mbar_wait(full + s, (k / ring) & 1);
        const int b0 = tile / frame_tiles * TB, t0 = tile % frame_tiles * TT;
        const int sv = min(TB, P.streams - b0), tv = min(TT, n - t0);
        const int width = sv * C;                     // even
        const int quads = (width + 3) / 4;
        const int* stage = stages + s * stage_words;
        int* out = P.dst + (static_cast<long long>(P.keep) + t0) * L +
                   static_cast<long long>(b0) * C;
        // Item j: lanes [4q, 4q + 4) of the tile's part of frame t's row,
        // two words of the stage (each two channels of one stream).
        for (int j = threadIdx.x; j < quads * tv; j += RING_CONSUMERS * 32) {
            const int q = j % quads, t = j / quads;
            const int l = 4 * q;
            const int w0 = stage[l / C * S + (t * C + l % C) / 2];
            int* o = out + t * L + l;
            if (l + 2 < width) {
                const int w1 = stage[(l + 2) / C * S + (t * C + (l + 2) % C) / 2];
                __stcs(reinterpret_cast<int4*>(o), make_int4(low_sample(w0), high_sample(w0),
                                                             low_sample(w1), high_sample(w1)));
            } else {
                __stcs(reinterpret_cast<int2*>(o), make_int2(low_sample(w0), high_sample(w0)));
            }
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + s);
    }
}

// farm_stage_kernel<PATH>: FARM_STAGE_RING (2) the ring, 1 and 0 one tile in
// flight a block with 16-byte stores or element by element.
constexpr int FARM_STAGE_RING = 2;

template <int PATH>
__global__ void __launch_bounds__(PATH == FARM_STAGE_RING ? RING_THREADS : FARM_THREADS,
                                  PATH == FARM_STAGE_RING ? RING_BLOCKS_PER_SM : 4)
farm_stage_kernel(const StageParams P) {
    if constexpr (PATH == FARM_STAGE_RING) {
        stage_ring(P);
    } else {
        stage_tiles<PATH == 1>(P);
    }
}

struct UnstageParams {
    const void* src;                  // (n_out, L) samples
    void* dst;                        // (streams, n_out, C) samples
    int n_out;
    long long src_row_words;          // words of one src row (L samples)
    int word0;                        // first word of stream_lo in a src row
    int streams, granule;             // streams to write, words of one (stream, frame): G
    int tile_streams, tile_frames;    // TB, TT
    int row_stride;                   // words of one frame's row of the tile (odd)
};

template <typename WordT>
__global__ void __launch_bounds__(FARM_THREADS)
farm_unstage_kernel(const UnstageParams P) {
    extern __shared__ __align__(16) unsigned char farm_tile[];
    WordT* tile = reinterpret_cast<WordT*>(farm_tile);
    const WordT* src = static_cast<const WordT*>(P.src);
    WordT* dst = static_cast<WordT*>(P.dst);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int G = P.granule, TB = P.tile_streams, TT = P.tile_frames;
    const int frame_tiles = (P.n_out + TT - 1) / TT;
    const long long tiles = static_cast<long long>((P.streams + TB - 1) / TB) * frame_tiles;
    // A lane's first word of a stream's run, as (frame, word of the granule),
    // and its step of 32 words in the same form: no division in the loops.
    const int t_first = lane / G, g_first = lane % G, t_step = 32 / G, g_step = 32 % G;
    for (long long tile_id = blockIdx.x; tile_id < tiles; tile_id += gridDim.x) {
        const int b0 = static_cast<int>(tile_id / frame_tiles) * TB;
        const int t0 = static_cast<int>(tile_id % frame_tiles) * TT;
        const int sv = min(TB, P.streams - b0), tv = min(TT, P.n_out - t0);
        const int width = sv * G;
        // Load: warp w takes frames w, w + 8, ...; a lane walks the row.
        for (int t = warp; t < tv; t += FARM_WARPS) {
            const WordT* row = src + (t0 + t) * P.src_row_words + P.word0 +
                               static_cast<long long>(b0) * G;
            WordT* to = tile + t * P.row_stride;
            for (int j = lane; j < width; j += 32) to[j] = __ldcs(row + j);
        }
        __syncthreads();
        // Store: warp w takes streams w, w + 8, ...; a lane walks the run.
        for (int i = warp; i < sv; i += FARM_WARPS) {
            WordT* run = dst + (static_cast<long long>(b0 + i) * P.n_out + t0) * G;
            const WordT* from = tile + i * G;
            int t = t_first, g = g_first;
            for (int j = lane; j < tv * G; j += 32) {
                run[j] = from[t * P.row_stride + g];
                t += t_step;
                g += g_step;
                if (g >= G) {
                    g -= G;
                    ++t;
                }
            }
        }
        __syncthreads();
    }
}

// As many blocks as fit on the card at once (persistent_grid), at most
// `wanted`.
template <typename Kernel>
int farm_grid(PersistentGrid& cache, Kernel kernel, int smem, int device, long long wanted,
              int* grid) {
    int blocks = 0;
    const int err = persistent_grid(cache, kernel, FARM_THREADS, smem, device, &blocks);
    if (err != 0) return err;
    *grid = static_cast<int>(std::max<long long>(1, std::min<long long>(wanted, blocks)));
    return 0;
}

// Blocks for the chunk's tiles, or for its flat part at `threads` threads a
// block and VEC ints a thread, whichever wants more.
template <int VEC>
long long stage_blocks(const StageParams& P, int threads) {
    const long long tiles = static_cast<long long>((P.streams + P.tile_streams - 1) /
                                                   P.tile_streams) *
                            ((P.n_in + P.tile_frames - 1) / P.tile_frames);
    const long long flat = ((P.src == P.dst ? 0 : P.keep) + (P.capacity - P.keep - P.n_in)) *
                           static_cast<long long>(P.streams) * P.channels / VEC;
    return std::max(tiles, (flat + threads - 1) / threads);
}

template <int PATH>
int launch_farm_stage(const StageParams& P, int smem, int device, cudaStream_t stream) {
    static PersistentGrid cache;
    int grid = 0;
    const int err = farm_grid(cache, farm_stage_kernel<PATH>, smem, device,
                              stage_blocks<PATH == 1 ? 4 : 1>(P, FARM_THREADS), &grid);
    if (err != 0) return err;
    farm_stage_kernel<PATH><<<grid, FARM_THREADS, smem, stream>>>(P);
    return static_cast<int>(cudaGetLastError());
}

// RING_BLOCKS_PER_SM blocks an SM at most: each keeps its own ring full. A
// block with no tile writes its share of the flat part only.
int launch_farm_stage_ring(const StageParams& P, int smem, int device, cudaStream_t stream) {
    static PersistentGrid cache;
    int fits = 0;
    const int err = persistent_grid(cache, farm_stage_kernel<FARM_STAGE_RING>, RING_THREADS,
                                    smem, device, &fits);
    if (err != 0) return err;
    const int most = std::min(fits, RING_BLOCKS_PER_SM * cache.sms[device]);
    const int grid = static_cast<int>(std::max<long long>(
        1, std::min<long long>(stage_blocks<4>(P, RING_CONSUMERS * 32), most)));
    farm_stage_kernel<FARM_STAGE_RING><<<grid, RING_THREADS, smem, stream>>>(P);
    return static_cast<int>(cudaGetLastError());
}

template <typename WordT>
int launch_farm_unstage(const UnstageParams& P, int smem, int device, cudaStream_t stream) {
    static PersistentGrid cache;
    const long long tiles = static_cast<long long>((P.streams + P.tile_streams - 1) /
                                                   P.tile_streams) *
                            ((P.n_out + P.tile_frames - 1) / P.tile_frames);
    int grid = 0;
    const int err = farm_grid(cache, farm_unstage_kernel<WordT>, smem, device, tiles, &grid);
    if (err != 0) return err;
    farm_unstage_kernel<WordT><<<grid, FARM_THREADS, smem, stream>>>(P);
    return static_cast<int>(cudaGetLastError());
}

// ---- The host side: the caller's chunk into the pinned input ---------------

// The threads that copy a job (the calling one and the pool's; fewer where
// the process may use fewer CPUs) and the pieces whose uploads are issued as
// each lands (_build.FARM_HOST_PIECES mirrors it): chip_scripts/
// farm_host_probe.py measured 8 x 8 against 4 threads and 4-32 pieces on the
// H100's 8-CPU host (PERF.md §5).
constexpr int HOST_THREADS = 8;
constexpr int HOST_PIECES = 8;

// dst[0, n) = src[0, n) by 16-byte streaming stores (a plain copy off x86-64);
// the stores are fenced before it returns.
void stream_copy(char* dst, const char* src, size_t n) {
#if defined(__x86_64__)
    size_t head = (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15;
    if (head > n) head = n;
    std::memcpy(dst, src, head);
    dst += head;
    src += head;
    n -= head;
    const size_t body = n & ~static_cast<size_t>(63);
    for (size_t i = 0; i < body; i += 64) {
        const __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i));
        const __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 16));
        const __m128i c = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 32));
        const __m128i d = _mm_loadu_si128(reinterpret_cast<const __m128i*>(src + i + 48));
        _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i), a);
        _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 16), b);
        _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 32), c);
        _mm_stream_si128(reinterpret_cast<__m128i*>(dst + i + 48), d);
    }
    std::memcpy(dst + body, src + body, n - body);
    _mm_sfence();
#else
    std::memcpy(dst, src, n);
#endif
}

// Nanoseconds on steady_clock (CLOCK_MONOTONIC, Python's perf_counter_ns).
long long now_ns() {
    return std::chrono::duration_cast<std::chrono::nanoseconds>(
               std::chrono::steady_clock::now().time_since_epoch())
        .count();
}

// The counters of the calling thread's last job (crt_farm_host_stats):
// wait_ns, its time spinning for the pool's parts; late_ns, from the job's
// publication (its generation and notify_all) to the last pool thread's
// first byte.
struct HostStats {
    long long wait_ns = 0;
    long long late_ns = 0;
};
thread_local HostStats host_stats;

// A pool of host threads that copies one job's pieces in order beside the
// thread that issues the job: the job is rows of row_bytes bytes each, row r
// from srcs[r] (zeros where it is null), to dst laid end to end, each piece
// cut into `parts` parts of whole 64-byte units. Pool thread w copies part w
// of each piece, then counts the piece done; the issuing thread copies the
// last part itself. The caller holds `job` from setting a job up until every
// piece is counted done, so that no two jobs share the pool. Each pool thread
// raises `last_start` to the time it begins a job.
struct HostPool {
    std::mutex job;
    std::mutex m;
    std::condition_variable cv;
    std::vector<std::thread> threads;
    bool started = false;
    long generation = 0;
    bool stop = false;
    char* dst = nullptr;
    const char* const* srcs = nullptr;
    long long row_bytes = 0;
    long long bounds[HOST_PIECES + 1];
    int parts = 1;
    std::atomic<int> done[HOST_PIECES];
    std::atomic<long long> last_start{0};

    // Bytes [a, b) of the job.
    void copy(long long a, long long b) const {
        long long r = a / row_bytes, off = a % row_bytes;
        while (a < b) {
            const long long len = std::min(b - a, row_bytes - off);
            if (srcs[r] != nullptr) {
                stream_copy(dst + a, srcs[r] + off, static_cast<size_t>(len));
            } else {
                std::memset(dst + a, 0, static_cast<size_t>(len));
            }
            a += len;
            ++r;
            off = 0;
        }
    }

    // Part w of piece k.
    void copy_part(int k, int w) const {
        const long long lo = bounds[k], hi = bounds[k + 1];
        const long long part = ((hi - lo + parts - 1) / parts + 63) & ~63LL;
        const long long a = std::min(hi, lo + w * part);
        copy(a, std::min(hi, a + part));
    }

    void work(int w, long seen) {
        for (;;) {
            {
                std::unique_lock<std::mutex> lock(m);
                cv.wait(lock, [&] { return stop || generation != seen; });
                if (stop) return;
                seen = generation;
            }
            const long long start = now_ns();
            long long last = last_start.load(std::memory_order_relaxed);
            while (start > last && !last_start.compare_exchange_weak(last, start)) {
            }
            for (int k = 0; k < HOST_PIECES; ++k) {
                copy_part(k, w);
                done[k].fetch_add(1, std::memory_order_release);
            }
        }
    }

    // The pool's threads, once: HOST_THREADS - 1, or one fewer than the CPUs
    // this process may use. Throws std::system_error where a thread does not
    // start, with none left running.
    void start() {
        if (started) return;
        int cpus = HOST_THREADS;
        cpu_set_t set;
        if (sched_getaffinity(0, sizeof(set), &set) == 0) cpus = std::min(cpus, CPU_COUNT(&set));
        try {
            for (int w = 0; w + 1 < std::max(cpus, 1); ++w) {
                threads.emplace_back([this, w, g = generation] { work(w, g); });
            }
        } catch (...) {
            shutdown();
            throw;
        }
        parts = static_cast<int>(threads.size()) + 1;
        started = true;
    }

    void shutdown() {
        {
            std::lock_guard<std::mutex> lock(m);
            stop = true;
        }
        cv.notify_all();
        for (auto& t : threads) t.join();
        threads.clear();
        stop = false;
    }

    ~HostPool() { shutdown(); }
};

HostPool& host_pool() {
    static HostPool pool;
    return pool;
}

}  // namespace

extern "C" {

// One farm call's staging. src and dst are the farm's (capacity, streams *
// channels) int32 buffers (dst written; src read unless it is dst), chunk the
// call's (streams, n_in, channels) int16 input on the device (unread when
// n_in is 0). Tiles hold tile_streams x tile_frames samples. path: 2 the ring
// (its conditions checked by the caller), with `stages` stages whose slot for
// one stream is `slot` words (a multiple of 4, at least tile_frames *
// channels / 2); 1 one tile a block with 16-byte stores; 0 element by
// element. Returns a cudaError_t.
int crt_farm_stage(const int* src, int* dst, const void* chunk, int streams, int n_in,
                   int channels, int keep, int consumed, int capacity, int tile_streams,
                   int tile_frames, int path, int stages, int slot, int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    StageParams P{src, dst, static_cast<const int16_t*>(chunk), streams, n_in, channels, keep,
                  consumed, capacity, tile_streams, tile_frames, 0, stages};
    if (path == FARM_STAGE_RING) {
        if (stages < 1 || 16 * stages > RING_HEADER || slot % 4 != 0 ||
            2 * slot < tile_frames * channels) {
            return static_cast<int>(cudaErrorInvalidValue);
        }
        P.row_stride = slot;
        const int smem = RING_HEADER + stages * tile_streams * slot *
                                           static_cast<int>(sizeof(int));
        return launch_farm_stage_ring(P, smem, device, s);
    }
    // An even row stride whose half is odd: rows 4 bytes aligned, and the
    // store phase's reads of consecutive streams on different banks.
    P.row_stride = 2 * ((tile_frames * channels + 1) / 2 | 1);
    const int smem = tile_streams * P.row_stride * static_cast<int>(sizeof(int16_t));
    return path ? launch_farm_stage<1>(P, smem, device, s)
                : launch_farm_stage<0>(P, smem, device, s);
}

// One farm call's de-interleave: streams [stream_lo, stream_lo + streams) of
// the lane-major (n_out, L) src, int16 when out_s16 else int32, to (streams,
// n_out, channels) at dst. words: move 4-byte words (always for int32; for
// int16 when channels, L and stream_lo * channels are even and the pointers
// 4-byte aligned), else single int16 samples. Returns a cudaError_t.
int crt_farm_unstage(const void* src, void* dst, int L, int n_out, int stream_lo, int streams,
                     int channels, int out_s16, int words, int tile_streams, int tile_frames,
                     int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const bool pairs = out_s16 && words;              // a word is two int16 samples
    const int granule = pairs ? channels / 2 : channels;
    const int row_stride = tile_streams * granule | 1;
    const UnstageParams P{src, dst, n_out, pairs ? L / 2 : L,
                          pairs ? stream_lo * channels / 2 : stream_lo * channels, streams,
                          granule, tile_streams, tile_frames, row_stride};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (out_s16 && !words) {
        return launch_farm_unstage<int16_t>(P, tile_frames * row_stride * 2, device, s);
    }
    return launch_farm_unstage<int32_t>(P, tile_frames * row_stride * 4, device, s);
}

// cudaMemcpyAsync of nbytes from src to dst (either may be pinned host
// memory) on the stream. Returns a cudaError_t.
int crt_farm_copy(void* dst, const void* src, long long nbytes, int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    return static_cast<int>(cudaMemcpyAsync(dst, src, static_cast<size_t>(nbytes),
                                            cudaMemcpyDefault,
                                            static_cast<cudaStream_t>(stream)));
}

// A farm call's chunk into its pinned input and up: `rows` rows of row_bytes
// bytes, row r read from srcs[r] (a host address; null for a row of zeros),
// laid end to end at the host address `pinned` by the calling thread and the
// pool's, in HOST_PIECES pieces of whole 64-byte units (the last one shorter);
// each piece's upload to the same offset of the device address `card` is
// issued on the stream as soon as the piece has landed (with `card` null the
// copy alone). Returns once every piece is written and its upload issued: no
// source is read after that. Calls from several host threads take turns.
// The job's counters are the calling thread's until its next job
// (crt_farm_host_stats).
// Returns a cudaError_t (cudaErrorOperatingSystem where the pool's threads
// do not start, cudaErrorMemoryAllocation where they cannot be held).
int crt_farm_host_stage(void* pinned, const void* srcs, int rows, long long row_bytes,
                        void* card, int device, void* stream) {
    if (rows < 1 || row_bytes < 1) return static_cast<int>(cudaErrorInvalidValue);
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    HostPool& p = host_pool();
    try {
        const std::lock_guard<std::mutex> job(p.job);
        p.start();
        const long long nbytes = rows * row_bytes;
        const long long step = ((nbytes + HOST_PIECES - 1) / HOST_PIECES + 63) & ~63LL;
        for (int k = 0; k <= HOST_PIECES; ++k) p.bounds[k] = std::min(nbytes, k * step);
        for (int k = 0; k < HOST_PIECES; ++k) p.done[k].store(0, std::memory_order_relaxed);
        p.last_start.store(0, std::memory_order_relaxed);
        long long published;
        {
            const std::lock_guard<std::mutex> lock(p.m);
            p.dst = static_cast<char*>(pinned);
            p.srcs = static_cast<const char* const*>(srcs);
            p.row_bytes = row_bytes;
            ++p.generation;
            published = now_ns();
        }
        p.cv.notify_all();
        const int pool = p.parts - 1;
        long long wait_ns = 0;
        cudaError_t err = cudaSuccess;
        for (int k = 0; k < HOST_PIECES; ++k) {
            p.copy_part(k, pool);
            if (p.done[k].load(std::memory_order_acquire) < pool) {
                const long long spin = now_ns();
                while (p.done[k].load(std::memory_order_acquire) < pool) {
#if defined(__x86_64__)
                    _mm_pause();
#endif
                }
                wait_ns += now_ns() - spin;
            }
            const long long size = p.bounds[k + 1] - p.bounds[k];
            if (card != nullptr && size > 0 && err == cudaSuccess) {
                err = cudaMemcpyAsync(static_cast<char*>(card) + p.bounds[k], p.dst + p.bounds[k],
                                      static_cast<size_t>(size), cudaMemcpyHostToDevice,
                                      static_cast<cudaStream_t>(stream));
            }
        }
        const long long last = p.last_start.load(std::memory_order_relaxed);
        host_stats.wait_ns = wait_ns;
        host_stats.late_ns = pool > 0 ? std::max(0LL, last - published) : 0;
        return static_cast<int>(err);
    } catch (const std::system_error&) {
        return static_cast<int>(cudaErrorOperatingSystem);
    } catch (const std::bad_alloc&) {
        return static_cast<int>(cudaErrorMemoryAllocation);
    }
}

// The counters of the calling thread's last crt_farm_host_stage job:
// out[0] pool_wait_ns, out[1] pool_late_ns (HostStats). Returns 0.
int crt_farm_host_stats(long long* out) {
    out[0] = host_stats.wait_ns;
    out[1] = host_stats.late_ns;
    return 0;
}

// Block the host until the stream has done all it holds. Returns a cudaError_t.
int crt_farm_sync(int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    return static_cast<int>(cudaStreamSynchronize(static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
