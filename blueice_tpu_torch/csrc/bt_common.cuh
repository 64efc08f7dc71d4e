// Shared pieces of the port's CUDA kernels (fused_binned.cu, fused_bb.cu,
// fused_bb_lite.cu, fused_unbinned.cu): the block size, the fixed-order
// block reduction, the packed upper-triangle index, and the (S, K)
// instantiation list.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace bt {

constexpr int kThreads = 256;
constexpr float kPenalty = 1e6f;

// Sum each of NV per-thread values (float or double) over the block of NT
// threads in a fixed order (warp shuffles, then the warps' partials in
// shared memory, red holding NT / 32 * NV values); the totals land in
// tot[0..NV) (shared memory), visible after the call. No float atomics, so
// a rerun on the same inputs is bit-identical.
template <int NV, int NT = kThreads, typename T>
__device__ __forceinline__ void block_sum(T (&v)[NV], T* red, T* tot) {
  constexpr int kNW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    T x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * NV + i] = x;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NV; i += NT) {
    T s = 0;
#pragma unroll
    for (int w = 0; w < kNW; ++w) s += red[w * NV + i];
    tot[i] = s;
  }
  __syncthreads();
}

// Row-major index of (i, j), i <= j, in the packed upper triangle of a
// P x P matrix.
__host__ __device__ constexpr int tri(int P, int i, int j) {
  return i * P - i * (i - 1) / 2 + (j - i);
}

// Writes the block's reduced (ll, g, packed upper H) totals of one toy
// (a block of NT threads).
template <int P, int NT = kThreads>
__device__ __forceinline__ void store_vgh(const float* tot, int b,
                                          float* ll_out, float* g_out,
                                          float* h_out) {
  if (threadIdx.x == 0) ll_out[b] = tot[0];
  for (int i = threadIdx.x; i < P; i += NT)
    g_out[(size_t)b * P + i] = tot[1 + i];
  for (int ij = threadIdx.x; ij < P * P; ij += NT) {
    const int i = ij / P, j = ij % P;
    const int lo = i < j ? i : j, hi = i < j ? j : i;
    h_out[(size_t)b * P * P + ij] = tot[1 + P + tri(P, lo, hi)];
  }
}

}  // namespace bt

// One switch case per instantiated (S, K): S in 1..8, K in 0..4.
#define BT_FOR_K(X, S_) X(S_, 0) X(S_, 1) X(S_, 2) X(S_, 3) X(S_, 4)
#define BT_FOR_SK(X)                                                   \
  BT_FOR_K(X, 1) BT_FOR_K(X, 2) BT_FOR_K(X, 3) BT_FOR_K(X, 4)          \
  BT_FOR_K(X, 5) BT_FOR_K(X, 6) BT_FOR_K(X, 7) BT_FOR_K(X, 8)
