// Hand-written Hopper (sm_90a) kernels for tap widths past 1024.
//
// wide_mac_kernel and its fold epilogue wide_fold_kernel replace the Pallas
// kernels _kernel_wide_taps and _kernel_wide_taps_pipelined
// (clownresampler_tpu/ops/pallas_resample.py:1074, :1158). Those keep x in
// HBM, DMA each 8-frame group's union window into VMEM (double-buffered in
// the pipelined form) and put the tap axis on the sequential grid so that
// Mosaic's live vector temporaries stay bounded. What carries over is the
// split of the tap axis: the reference's tap sum is a plain sum of
// independently truncated terms, so it may be cut into n_k blocks of
// tap_block taps, summed separately and folded in a fixed order, exactly.
//
// Why not the general kernel: at 64 frames x 1024 lanes x 2008 taps (the
// 44.1k -> 132 launch) the general kernel has 2,048 warps, each with a
// 2,008-step serial loop. Here the grid is (n_k, lane tiles, frame groups),
// so the same launch has n_k times the warps, each with tap_block steps.
// On the H100 that measured 3.4x faster there, and 2.5x at 1024 frames x
// 512 lanes, where the general kernel already fills the card. With one tap
// block the two kernels tie. An unroll pragma on the tap loop measured 2x
// slower and is left out (PERF.md).
//
// Why no shared-memory window: at these ratios frames are d >= ~170 rows
// apart (d = increment >> 16, ~T/6), so the union of a group's 8 windows
// for one tap block spans 7*(d+1) + tap_block rows (2,473 rows, 317 KB at
// 32 lanes for 44.1k -> 132), past the 227 KB a block can have, and the 8
// frames' slices of one tap block do not overlap (d > tap_block), so a
// staged window would share no row. Each warp reads its frame's rows
// straight from device memory as coalesced 128-byte segments (the tap value
// is a warp-wide broadcast); the row reuse between neighbouring frames
// (each row feeds ~T/d frames) is left to L2, with the tap-block index the
// fastest grid axis so that the blocks of one frame group run together.
//
// What bounds it: ~5 integer operations a tap on the CUDA cores and N*T*4
// bytes of per-frame taps (the (N, T) matrix from the launch precompute),
// read once; the partial sums cost n_k*N*lanes*4 bytes written and read.

#include "mac_common.cuh"

namespace {

// grid (n_k, ceil(lanes / LANE_TILE), ceil(N / FRAME_ROWS)),
// block (LANE_TILE, FRAME_ROWS): warp y sums frame blockIdx.z*8 + y's taps
// [k*tap_block, min(T, (k+1)*tap_block)) into partial[k][n][l].
// rows[n] + T <= S for every frame.
__global__ void __launch_bounds__(LANE_TILE * FRAME_ROWS)
wide_mac_kernel(const int* __restrict__ x, int L, int lane_offset, int lanes,
                const int* __restrict__ rows, const int* __restrict__ kv, int N, int T,
                int tap_block, int* __restrict__ partial) {
    const int k = blockIdx.x;
    const int l = blockIdx.y * LANE_TILE + threadIdx.x;
    const int n = blockIdx.z * FRAME_ROWS + threadIdx.y;
    if (l >= lanes || n >= N) return;
    const int t0 = k * tap_block;
    const int t1 = min(T, t0 + tap_block);
    const int* xp = x + static_cast<size_t>(rows[n] + t0) * L + lane_offset + l;
    const int* kp = kv + static_cast<size_t>(n) * T;
    int acc = 0;
    for (int t = t0; t < t1; ++t) {
        acc = macc_trunc(acc, __ldg(xp), __ldg(kp + t));
        xp += L;
    }
    partial[(static_cast<size_t>(k) * N + n) * lanes + l] = acc;
}

// grid (ceil(lanes / 256), N), block 256: out[n][l] = finish(mul_shift15(
// sum_k partial[k][n][l], q[n])), the blocks summed in order k = 0..n_k-1.
template <typename OutT>
__global__ void wide_fold_kernel(const int* __restrict__ partial, int n_k, int N, int lanes,
                                 const int* __restrict__ q, OutT* __restrict__ out) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    const int n = blockIdx.y;
    if (l >= lanes) return;
    const size_t i = static_cast<size_t>(n) * lanes + l;
    const size_t plane = static_cast<size_t>(N) * lanes;
    int acc = 0;
    for (int k = 0; k < n_k; ++k) acc += partial[k * plane + i];
    out[i] = finish<OutT>(mul_shift15(acc, __ldg(q + n)));
}

template <typename OutT>
int launch_wide(const int* x, int L, int lane_offset, int lanes, const int* rows,
                const int* kv, const int* q, int N, int T, int tap_block, int n_k,
                int* partial, void* out, cudaStream_t stream) {
    const dim3 block(LANE_TILE, FRAME_ROWS);
    const dim3 grid(n_k, (lanes + LANE_TILE - 1) / LANE_TILE,
                    (N + FRAME_ROWS - 1) / FRAME_ROWS);
    wide_mac_kernel<<<grid, block, 0, stream>>>(x, L, lane_offset, lanes, rows, kv, N, T,
                                                tap_block, partial);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int fold_threads = 256;
    const dim3 fold_grid((lanes + fold_threads - 1) / fold_threads, N);
    wide_fold_kernel<OutT><<<fold_grid, fold_threads, 0, stream>>>(
        partial, n_k, N, lanes, q, static_cast<OutT*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int crt_wide_mac(const int* x, int L, int lane_offset, int lanes, const int* rows,
                 const int* kv, const int* q, int N, int T, int tap_block, int n_k,
                 int* partial, void* out, int clamp_s16, int device, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return clamp_s16
        ? launch_wide<int16_t>(x, L, lane_offset, lanes, rows, kv, q, N, T, tap_block, n_k,
                               partial, out, s)
        : launch_wide<int32_t>(x, L, lane_offset, lanes, rows, kv, q, N, T, tap_block, n_k,
                               partial, out, s);
}

}  // extern "C"
