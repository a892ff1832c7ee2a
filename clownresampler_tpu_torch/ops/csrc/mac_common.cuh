// Arithmetic shared by the resampler's hand-written kernels (sm_90a).
//
// Every kernel computes, for output frame n and lane l,
//
//     acc      = sum_t trunc(x[row + t][l] * k[t] / 2^16)
//     out[n,l] = trunc(acc * q / 2^15)            (optionally clamped to s16)
//
// bit-exactly as the C reference's inner loop does (clownresampler.h:1008-1033).
// The helpers below are that arithmetic; each source that includes this header
// is its own translation unit and shared library (ops/_build.py).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANE_TILE = 32;   // lanes per block: one warp spans one row segment
constexpr int FRAME_ROWS = 8;   // warps per block (blockDim.y)

// One tap: acc + trunc((x * k) / 2^16). |x| <= 32768 and k in [-9651, 65536],
// so the product spans exactly [-2^31, 2^31); it is formed with wrapping
// unsigned arithmetic (no signed-overflow UB), and (p >> 31) & 0xFFFF is the
// bias that turns the arithmetic shift (floor) into truncation toward zero.
__device__ __forceinline__ int macc_trunc(int acc, int x, int k) {
    const int p = static_cast<int>(static_cast<unsigned>(x) * static_cast<unsigned>(k));
    return acc + ((p + ((p >> 31) & 0xFFFF)) >> 16);
}

// C (acc * q) / 2^15 with a 64-bit product; C division truncates toward zero.
__device__ __forceinline__ int mul_shift15(int acc, int q) {
    const long long p = static_cast<long long>(acc) * static_cast<long long>(q);
    return static_cast<int>(p / 32768);
}

template <typename OutT>
__device__ __forceinline__ OutT finish(int v);

template <>
__device__ __forceinline__ int32_t finish<int32_t>(int v) { return v; }

template <>
__device__ __forceinline__ int16_t finish<int16_t>(int v) {
    return static_cast<int16_t>(min(max(v, -0x7FFF), 0x7FFF));
}

}  // namespace
