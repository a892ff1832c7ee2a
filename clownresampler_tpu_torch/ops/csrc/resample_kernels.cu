// Hand-written Hopper (sm_90a) kernels for the resampler's multiply-accumulate.
//
// Both kernels compute, for every output frame n and lane l of a launch,
//
//     acc      = sum_t trunc(x[rows[n] + t][l] * kv[n][t] / 2^16)
//     out[n,l] = trunc(acc * q[n] / 2^15)            (optionally clamped to s16)
//
// bit-exactly as the C reference's inner loop does (clownresampler.h:1008-1033).
// The per-frame scalars (window row, masked LUT taps, 17.15 reciprocal) come
// from the launch precompute in ops/resample.py; x is lane-major (S, L) int32
// with streams x channels on the fast axis, which is the coalesced one here.
//
// tiled_mac_kernel replaces the Pallas kernel _kernel_tiled
// (clownresampler_tpu/ops/pallas_resample.py:201). For increments below 2^17
// the windows of neighbouring frames overlap almost entirely, so one block of
// FRAMES_PER_BLOCK frames x LANE_TILE lanes stages the union of its windows
// in shared memory once (coalesced row loads) and every frame reads its taps
// from there: the input is read from device memory about once instead of
// T times. The TPU kernel's Bresenham eps/cand split and sublane roll exist
// only for Mosaic's aligned loads; here each frame indexes the staged window
// at rows[n] - rows[first] directly.
//
// general_mac_kernel replaces _kernel_general (pallas_resample.py:475). For
// increments of 2^17 and more the windows barely overlap, so each thread
// reads its own window straight from device memory; a warp covers 32
// neighbouring lanes of one frame, so every tap is one coalesced 128-byte row
// segment and the frame's tap value is a broadcast.
//
// What bounds them: the MACs are int32 multiply-adds on the CUDA cores (the
// per-term truncation rules out tensor cores), about 5 integer operations a
// tap, and each kernel moves its input and output through device memory once.
// At the farm's headline launch (taps 8) both bounds are tens of microseconds.
//
// Built by ops/_build.py with nvcc into a shared library with a plain C
// interface; the Python wrappers check devices, dtypes, shapes and strides
// before they pass pointers, and every entry returns cudaGetLastError().
// The tap arithmetic (macc_trunc, mul_shift15, finish) is in mac_common.cuh.

#include "mac_common.cuh"

namespace {

// grid (ceil(lanes / LANE_TILE), ceil(N / frames_per_block)),
// block (LANE_TILE, FRAME_ROWS), dynamic shared memory win_rows * LANE_TILE ints.
// rows must be non-decreasing with rows[n] + T <= S, and within any block
// rows[last] - rows[first] + T <= win_rows (the wrapper derives win_rows from
// the launch's increment class).
template <typename OutT>
__global__ void __launch_bounds__(LANE_TILE * FRAME_ROWS)
tiled_mac_kernel(const int* __restrict__ x, int S, int L, int lane_offset, int lanes,
                 const int* __restrict__ rows, const int* __restrict__ kv,
                 const int* __restrict__ q, int N, int T, int frames_per_block,
                 int win_rows, OutT* __restrict__ out) {
    extern __shared__ int s_win[];                  // [win_rows][LANE_TILE]
    const int n0 = blockIdx.y * frames_per_block;
    const int nb = min(frames_per_block, N - n0);
    const int lx = threadIdx.x;
    const int l = blockIdx.x * LANE_TILE + lx;
    const bool lane_ok = l < lanes;

    const int r0 = rows[n0];
    const int wr = min(win_rows, S - r0);
    const int* xcol = x + lane_offset + l;
    for (int r = threadIdx.y; r < wr; r += FRAME_ROWS) {
        s_win[r * LANE_TILE + lx] = lane_ok ? xcol[static_cast<size_t>(r0 + r) * L] : 0;
    }
    __syncthreads();
    if (!lane_ok) return;

    for (int f = threadIdx.y; f < nb; f += FRAME_ROWS) {
        const int n = n0 + f;
        const int base = rows[n] - r0;
        const int* k = kv + static_cast<size_t>(n) * T;
        int acc = 0;
        for (int t = 0; t < T; ++t) {
            // The min only guards memory; the row bound above keeps it inert.
            const int idx = min(base + t, wr - 1);
            acc = macc_trunc(acc, s_win[idx * LANE_TILE + lx], __ldg(k + t));
        }
        out[static_cast<size_t>(n) * lanes + l] = finish<OutT>(mul_shift15(acc, q[n]));
    }
}

// grid (ceil(lanes / LANE_TILE), ceil(N / FRAME_ROWS)), block (LANE_TILE, FRAME_ROWS).
// rows[n] + T <= S for every frame.
template <typename OutT>
__global__ void __launch_bounds__(LANE_TILE * FRAME_ROWS)
general_mac_kernel(const int* __restrict__ x, int S, int L, int lane_offset, int lanes,
                   const int* __restrict__ rows, const int* __restrict__ kv,
                   const int* __restrict__ q, int N, int T, OutT* __restrict__ out) {
    const int l = blockIdx.x * LANE_TILE + threadIdx.x;
    const int n = blockIdx.y * FRAME_ROWS + threadIdx.y;
    if (l >= lanes || n >= N) return;
    const int* xp = x + static_cast<size_t>(rows[n]) * L + lane_offset + l;
    const int* k = kv + static_cast<size_t>(n) * T;
    int acc = 0;
    for (int t = 0; t < T; ++t) {
        acc = macc_trunc(acc, __ldg(xp + static_cast<size_t>(t) * L), __ldg(k + t));
    }
    out[static_cast<size_t>(n) * lanes + l] = finish<OutT>(mul_shift15(acc, q[n]));
}

template <typename OutT>
int launch_tiled(const int* x, int S, int L, int lane_offset, int lanes, const int* rows,
                 const int* kv, const int* q, int N, int T, int frames_per_block,
                 int win_rows, void* out, cudaStream_t stream) {
    const size_t smem = static_cast<size_t>(win_rows) * LANE_TILE * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(tiled_mac_kernel<OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(LANE_TILE, FRAME_ROWS);
    const dim3 grid((lanes + LANE_TILE - 1) / LANE_TILE,
                    (N + frames_per_block - 1) / frames_per_block);
    tiled_mac_kernel<OutT><<<grid, block, smem, stream>>>(
        x, S, L, lane_offset, lanes, rows, kv, q, N, T, frames_per_block, win_rows,
        static_cast<OutT*>(out));
    return static_cast<int>(cudaGetLastError());
}

template <typename OutT>
int launch_general(const int* x, int S, int L, int lane_offset, int lanes, const int* rows,
                   const int* kv, const int* q, int N, int T, void* out,
                   cudaStream_t stream) {
    const dim3 block(LANE_TILE, FRAME_ROWS);
    const dim3 grid((lanes + LANE_TILE - 1) / LANE_TILE, (N + FRAME_ROWS - 1) / FRAME_ROWS);
    general_mac_kernel<OutT><<<grid, block, 0, stream>>>(
        x, S, L, lane_offset, lanes, rows, kv, q, N, T, static_cast<OutT*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crt_tiled_mac(const int* x, int S, int L, int lane_offset, int lanes, const int* rows,
                  const int* kv, const int* q, int N, int T, int frames_per_block,
                  int win_rows, void* out, int clamp_s16, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return clamp_s16
        ? launch_tiled<int16_t>(x, S, L, lane_offset, lanes, rows, kv, q, N, T,
                                frames_per_block, win_rows, out, s)
        : launch_tiled<int32_t>(x, S, L, lane_offset, lanes, rows, kv, q, N, T,
                                frames_per_block, win_rows, out, s);
}

int crt_general_mac(const int* x, int S, int L, int lane_offset, int lanes, const int* rows,
                    const int* kv, const int* q, int N, int T, void* out, int clamp_s16,
                    int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return clamp_s16
        ? launch_general<int16_t>(x, S, L, lane_offset, lanes, rows, kv, q, N, T, out, s)
        : launch_general<int32_t>(x, S, L, lane_offset, lanes, rows, kv, q, N, T, out, s);
}

const char* crt_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
