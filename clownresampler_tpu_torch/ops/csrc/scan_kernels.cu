// Hand-written Hopper (sm_90a) kernel for one step of the whole-stream scan.
//
// scan_stage_kernel has no Pallas counterpart: it replaces the code XLA
// compiles around the Pallas kernel inside the JAX package's jitted scan
// (clownresampler_tpu/lowlevel.py:378-412, resample_scan_fused: `stage`,
// `run_engine`'s bookkeeping and the halo slice) for the strided and wide
// engines; the tiled and general engines' steps read the chunks in place
// (tiled_mac_kernel's scan mode, resample_kernels.cu). One launch does, for
// scan step k:
//  - Stage. The step's engine input [halo | chunk widened to int32] goes into
//    rows [0, 2r + n_in) of one of the scan's two buffers; the halo is rows
//    [n_in, n_in + 2r) of the other buffer, which the step before staged (all
//    zeros before the first step). Whole rows are contiguous, so both pieces
//    are flat copies. The buffers' zero rows past 2r + n_in are written once
//    by the caller and never here.
//  - Bookkeeping, by thread 0 of block 0, in int64: from the step's state
//    (p, f) and the increment, the frames the step produces (`natural` clamped
//    to the output capacity), whether more were due (`over`), the launch state
//    (p0, f0) of each of the step's engine launches (frame offsets i *
//    launch_step: one launch, or several of the wide engine) and the state the
//    next step starts from (the position carry, clownresampler.h:1063-1068).
//    Everything stays in device memory, where the engine launches and the next
//    step's launch read it: the host only queues launches.
//
// What bounds it on the H100: bytes. At 1024 stereo streams, 44.1 kHz -> 8 kHz
// (8192-frame int16 chunks, 2048 lanes, radius 17) it reads 33.6 MB of chunk
// and 0.3 MB of halo and writes 67.4 MB, about 0.030 ms at 3.35 TB/s; the
// bookkeeping is a few dozen integer operations. So the design is a copy that
// keeps the memory system full: a thread moves 4 lanes at a time (an 8-byte
// int16 or 16-byte int32 streaming load, a 16-byte store), four independent
// loads in flight, on a grid that fills the card once. Lane counts that are not
// a multiple of 4, or unaligned pointers, take an element-wise path inside the
// same kernel. The source type (int16 or int32 chunks) is a template
// parameter.
//
// Built by ops/_build.py with nvcc into a shared library with a plain C
// interface, like the MAC kernels' sources; the Python side checks devices,
// dtypes, shapes and alignment before it passes pointers.

#include <algorithm>

#include "mac_common.cuh"

namespace {

constexpr int STAGE_THREADS = 256;
constexpr int STAGE_UNROLL = 4;                   // independent loads a thread keeps in flight

struct StageParams {
    const int* prev;                  // the other buffer (the step before's)
    int* cur;                         // this step's buffer
    const void* chunk;                // (n_in, L) int16 or int32
    long long halo_src;               // n_in * L: where the halo rows start in prev
    long long halo_elems;             // 2r * L
    long long chunk_elems;            // n_in * L
    int vec;                          // L a multiple of 4 and every pointer 16-byte aligned
    // Bookkeeping.
    const int* state_in;              // (2,) the step's (p, f), p with the +radius bias
    const int *inc_hi, *inc_lo;       // ConfigScalars
    int n_in, n_out;                  // chunk frames, output capacity of the step
    int launches, launch_step;        // engine launches of the step, frames between them
    int* produced;                    // (1,)
    int* over;                        // (1,)
    int* launch_states;               // (launches, 2)
    int* state_out;                   // (2,)
};

// The step's scalars (lowlevel.natural_output_count, fixedpoint.
// positions_from_state and the scan's carry), in int64: t(n) = f + n*inc,
// pos(n) = p + (t >> 16), frac(n) = t & 0xFFFF.
__device__ __forceinline__ void scan_bookkeeping(const StageParams& P) {
    const long long p = P.state_in[0], f = P.state_in[1];
    const long long inc = static_cast<long long>(*P.inc_hi) * 65536 + *P.inc_lo;
    const long long num = (static_cast<long long>(P.n_in) - p) * 65536 - f;
    const long long natural = num > 0 ? (num + inc - 1) / (inc > 1 ? inc : 1) : 0;
    const long long produced = natural < P.n_out ? natural : P.n_out;
    *P.produced = static_cast<int>(produced);
    *P.over = natural > P.n_out ? 1 : 0;
    for (int i = 0; i < P.launches; ++i) {
        const long long t = f + static_cast<long long>(i) * P.launch_step * inc;
        P.launch_states[2 * i] = static_cast<int>(p + (t >> 16));
        P.launch_states[2 * i + 1] = static_cast<int>(t & 0xFFFF);
    }
    const long long t = f + produced * inc;
    const long long p_after = p + (t >> 16);
    P.state_out[0] = static_cast<int>(p_after - (p_after < P.n_in ? p_after : P.n_in));
    P.state_out[1] = static_cast<int>(t & 0xFFFF);
}

// Elements 4j .. 4j + 3 of the chunk, widened to int32 (read once: streaming).
template <typename SrcT>
__device__ __forceinline__ int4 load_chunk4(const void* chunk, long long j);

template <>
__device__ __forceinline__ int4 load_chunk4<int32_t>(const void* chunk, long long j) {
    return __ldcs(static_cast<const int4*>(chunk) + j);
}

template <>
__device__ __forceinline__ int4 load_chunk4<int16_t>(const void* chunk, long long j) {
    const int2 v = __ldcs(static_cast<const int2*>(chunk) + j);
    // Little-endian pairs: the low half sign-extended, the high half shifted down.
    return make_int4(static_cast<int16_t>(v.x & 0xFFFF), v.x >> 16,
                     static_cast<int16_t>(v.y & 0xFFFF), v.y >> 16);
}

template <typename SrcT>
__global__ void __launch_bounds__(STAGE_THREADS)
scan_stage_kernel(const StageParams P) {
    if (blockIdx.x == 0 && threadIdx.x == 0) scan_bookkeeping(P);
    const long long stride = static_cast<long long>(gridDim.x) * STAGE_THREADS;
    long long i = static_cast<long long>(blockIdx.x) * STAGE_THREADS + threadIdx.x;
    if (P.vec) {
        const long long halo4 = P.halo_elems / 4;
        const long long total4 = halo4 + P.chunk_elems / 4;
        const int4* const halo = reinterpret_cast<const int4*>(P.prev + P.halo_src);
        int4* const out = reinterpret_cast<int4*>(P.cur);
        const auto load = [&](long long j) {
            return j < halo4 ? __ldg(halo + j) : load_chunk4<SrcT>(P.chunk, j - halo4);
        };
        for (; i + (STAGE_UNROLL - 1) * stride < total4; i += STAGE_UNROLL * stride) {
            int4 v[STAGE_UNROLL];
#pragma unroll
            for (int u = 0; u < STAGE_UNROLL; ++u) v[u] = load(i + u * stride);
#pragma unroll
            for (int u = 0; u < STAGE_UNROLL; ++u) out[i + u * stride] = v[u];
        }
        for (; i < total4; i += stride) out[i] = load(i);
        return;
    }
    const long long total = P.halo_elems + P.chunk_elems;
    const SrcT* const chunk = static_cast<const SrcT*>(P.chunk);
    for (; i < total; i += stride) {
        P.cur[i] = i < P.halo_elems ? P.prev[P.halo_src + i]
                                    : static_cast<int>(chunk[i - P.halo_elems]);
    }
}

// A grid that fills the card once (persistent_grid, mac_common.cuh), at most
// one thread per STAGE_UNROLL copies.
template <typename SrcT>
int launch_stage(const StageParams& P, int device, cudaStream_t stream) {
    static PersistentGrid cache;
    int blocks = 0;
    const int err = persistent_grid(cache, scan_stage_kernel<SrcT>, STAGE_THREADS, 0, device,
                                    &blocks);
    if (err != 0) return err;
    const long long items = (P.halo_elems + P.chunk_elems) / (P.vec ? 4 : 1);
    const long long wanted = (items + STAGE_THREADS * STAGE_UNROLL - 1) /
                             (STAGE_THREADS * STAGE_UNROLL);
    const int grid = static_cast<int>(std::max<long long>(1, std::min<long long>(wanted, blocks)));
    scan_stage_kernel<SrcT><<<grid, STAGE_THREADS, 0, stream>>>(P);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One scan step's stage and bookkeeping. prev and cur are the scan's two
// (2r + n_in + tail, L) int32 buffers (cur written, prev read), chunk the
// step's (n_in, L) input, int16 when chunk_s16 else int32. Returns a
// cudaError_t.
int crt_scan_stage(const int* prev, int* cur, const void* chunk, int chunk_s16, int n_in,
                   int halo_rows, int L, int vec, const int* state_in, const int* inc_hi,
                   const int* inc_lo, int n_out, int launches, int launch_step, int* produced,
                   int* over, int* launch_states, int* state_out, int device, void* stream) {
    const DeviceGuard guard(device);
    if (guard.err != 0) return guard.err;
    const long long row = L;
    const StageParams P{prev, cur, chunk, n_in * row, halo_rows * row, n_in * row, vec,
                        state_in, inc_hi, inc_lo, n_in, n_out, launches, launch_step,
                        produced, over, launch_states, state_out};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return chunk_s16 ? launch_stage<int16_t>(P, device, s) : launch_stage<int32_t>(P, device, s);
}

}  // extern "C"
