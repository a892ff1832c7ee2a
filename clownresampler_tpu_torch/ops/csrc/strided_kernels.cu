// Hand-written Hopper (sm_90a) kernel for exact integer strides.
//
// strided_mac_kernel replaces the Pallas kernels _kernel_strided and
// _kernel_strided_partial (clownresampler_tpu/ops/pallas_resample.py:664,
// :720). With a zero fractional increment the phase fraction is constant, so
// one tap vector k0 (T,) and one 17.15 reciprocal q0 serve every frame of a
// launch, and frame n's window starts at row r0 + n*d (clownresampler.h:
// 1076-1078). The TPU kernels re-view x as (S/d, d*L) so that Mosaic sees
// stride-1 aligned loads, fold the d phases in VMEM, and (the partial form)
// split the phases across grid steps to fit the v5e's VMEM; none of that is
// needed here. A block of F frames x LANE_TILE lanes stages the union of its
// windows, rows [row(n0), row(n0 + F - 1) + T), in shared memory once with
// coalesced row loads, keeps k0 there beside it, and each frame reads its
// window at offset row(n) - row(n0): no per-frame rows array, no jitter, no
// tap matrix.
//
// Padding frames (past the caller's natural count, results discarded) have
// their window start clamped into the buffer, row(n) = clamp(r0 + n*d, 0,
// S - T), exactly as ops/resample.launch_rows clamps the other classes'
// rows; the clamp is monotone, so a block's rows still span at most
// (F - 1)*d + T.
//
// What bounds it: each staged row feeds about T/d frames, so a block reads
// (F - 1)*d + T rows for F*T MACs; at the 96k -> 48k farm launch (d 2, T 16,
// F 64) the input is read about 1.1 times and the MACs are ~5 integer
// operations a tap on the CUDA cores (the per-term truncation rules out
// tensor cores). The wrapper picks F from (d, T) so that the staged window
// fits its shared-memory budget.

#include "mac_common.cuh"

namespace {

// Window start of frame n, clamped so that [row, row + T) lies inside the
// S-row input (hi = max(S - T, 0)).
__device__ __forceinline__ int strided_row(long long r0, int n, int d, int hi) {
    const long long r = r0 + static_cast<long long>(n) * d;
    return static_cast<int>(r < 0 ? 0 : (r > hi ? hi : r));
}

// grid (ceil(lanes / LANE_TILE), ceil(N / frames_per_block)),
// block (LANE_TILE, FRAME_ROWS), dynamic shared memory
// (T + ((frames_per_block - 1) * d + T) * LANE_TILE) ints. r0 and q0 are read
// from device memory (one int each), so the launch needs no host sync.
template <typename OutT>
__global__ void __launch_bounds__(LANE_TILE * FRAME_ROWS)
strided_mac_kernel(const int* __restrict__ x, int S, int L, int lane_offset, int lanes,
                   const int* __restrict__ r0p, int d, const int* __restrict__ k0,
                   const int* __restrict__ q0p, int N, int T, int frames_per_block,
                   OutT* __restrict__ out) {
    extern __shared__ int smem[];
    int* s_k = smem;                                // [T]
    int* s_win = smem + T;                          // [win rows][LANE_TILE]
    const int hi = max(S - T, 0);
    const long long r0 = __ldg(r0p);
    const int n0 = blockIdx.y * frames_per_block;
    const int nb = min(frames_per_block, N - n0);
    const int first = strided_row(r0, n0, d, hi);
    const int wr = strided_row(r0, n0 + nb - 1, d, hi) - first + T;   // <= S - first
    const int lx = threadIdx.x;
    const int l = blockIdx.x * LANE_TILE + lx;
    const bool lane_ok = l < lanes;

    for (int t = threadIdx.y * LANE_TILE + lx; t < T; t += LANE_TILE * FRAME_ROWS) {
        s_k[t] = __ldg(k0 + t);
    }
    const int* xcol = x + lane_offset + l;
    for (int r = threadIdx.y; r < wr; r += FRAME_ROWS) {
        s_win[r * LANE_TILE + lx] = lane_ok ? xcol[static_cast<size_t>(first + r) * L] : 0;
    }
    __syncthreads();
    if (!lane_ok) return;

    const int q = __ldg(q0p);
    for (int f = threadIdx.y; f < nb; f += FRAME_ROWS) {
        const int* w = s_win + (strided_row(r0, n0 + f, d, hi) - first) * LANE_TILE + lx;
        int acc = 0;
        for (int t = 0; t < T; ++t) {
            acc = macc_trunc(acc, w[t * LANE_TILE], s_k[t]);
        }
        out[static_cast<size_t>(n0 + f) * lanes + l] = finish<OutT>(mul_shift15(acc, q));
    }
}

template <typename OutT>
int launch_strided(const int* x, int S, int L, int lane_offset, int lanes, const int* r0,
                   int d, const int* k0, const int* q0, int N, int T, int frames_per_block,
                   void* out, cudaStream_t stream) {
    const size_t win_rows = static_cast<size_t>(frames_per_block - 1) * d + T;
    const size_t smem = (T + win_rows * LANE_TILE) * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(strided_mac_kernel<OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 block(LANE_TILE, FRAME_ROWS);
    const dim3 grid((lanes + LANE_TILE - 1) / LANE_TILE,
                    (N + frames_per_block - 1) / frames_per_block);
    strided_mac_kernel<OutT><<<grid, block, smem, stream>>>(
        x, S, L, lane_offset, lanes, r0, d, k0, q0, N, T, frames_per_block,
        static_cast<OutT*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crt_strided_mac(const int* x, int S, int L, int lane_offset, int lanes, const int* r0,
                    int d, const int* k0, const int* q0, int N, int T, int frames_per_block,
                    void* out, int clamp_s16, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return clamp_s16
        ? launch_strided<int16_t>(x, S, L, lane_offset, lanes, r0, d, k0, q0, N, T,
                                  frames_per_block, out, s)
        : launch_strided<int32_t>(x, S, L, lane_offset, lanes, r0, d, k0, q0, N, T,
                                  frames_per_block, out, s);
}

}  // extern "C"
