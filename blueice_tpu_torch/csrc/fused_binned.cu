// Fused binned Poisson likelihood kernels for NVIDIA Hopper (sm_90a).
//
// Two contracts, each one kernel, each with a plain PyTorch twin in
// blueice_tpu_torch/ops/fused.py (the batched closed form of
// ops/binned_vgh.py), which the wrapper uses for CPU tensors:
//
//   vgh_kernel   deviance-form ll, gradient g (P) and Hessian H (P x P) in
//                (m, t), P = S + K, one toy per block. Replaces the Pallas
//                kernels _vgh_kernel (blueice_tpu/ops/fused.py:144, gather
//                flavor) and _vgh_kernel_dense (fused.py:597, dense flavor).
//   ll_kernel    deviance-form ll at one line-search candidate, one
//                (toy, candidate) pair per block. Replaces _ll_kernel
//                (fused.py:251) and _ll_kernel_dense (fused.py:690).
//
// What bounds them on an H100: the corner gathers. Every bin of every toy
// reads its C = 2^K corner values for each of the S sources from the anchor
// tensor (G, S, N): C*S*N*4 bytes per toy per vgh, about 1.2 MB at the
// XENON shape (G = 81, S = 6, N = 3100, K = 4), 0.6 GB for 512 toys, and
// A times that per value call. The TPU kernels kept the 6 MB anchor tensor
// resident in VMEM; a block here has at most 227 KB of shared memory, so the
// anchor tensor stays in global memory and is served from the 50 MB L2
// (it fits many times over). Neighbouring threads take neighbouring bins, so
// every gather is a coalesced row read. The arithmetic per loaded value is a
// handful of FMAs (value, K derivative and the m-weighted cross-pair
// combinations), so the kernels are L2-bandwidth bound by design.
//
// Reductions: each thread accumulates its bins' contributions to ll, g and
// the upper triangle of H in registers; a block then sums them in a fixed
// order (bt::block_sum in bt_common.cuh), so a rerun on the same inputs is
// bit-identical.
//
// Semantics kept exactly from the reference: lambda floored at FLT_MIN
// inside the log, the 1e6 linear penalty on negative expectations (in value
// and in r), and r = -1 in empty-model bins.
//
// Built by blueice_tpu_torch/ops/fused.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes; the C entry points return cudaGetLastError().

#include "bt_common.cuh"

namespace {

using namespace bt;

template <int S, int K>
__global__ void __launch_bounds__(kThreads)
vgh_kernel(const float* __restrict__ anchor, int N,
           const int* __restrict__ ids, const float* __restrict__ w,
           const float* __restrict__ wd, const float* __restrict__ wx,
           const float* __restrict__ m, const float* __restrict__ obs,
           float* __restrict__ ll_out, float* __restrict__ g_out,
           float* __restrict__ h_out) {
  constexpr int C = 1 << K;
  constexpr int NP = K * (K - 1) / 2;
  constexpr int P = S + K;
  constexpr int NH = P * (P + 1) / 2;
  constexpr int NV = 1 + P + NH;      // ll, g, packed upper H
  constexpr int KD = K > 0 ? K : 1;   // no zero-length arrays
  constexpr int NPD = NP > 0 ? NP : 1;

  __shared__ int s_ids[C];
  __shared__ float s_w[C];
  __shared__ float s_wd[KD * C];
  __shared__ float s_wx[NPD * C];
  __shared__ float s_m[S];
  __shared__ float s_red[kWarps * NV];
  __shared__ float s_tot[NV];

  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < C; i += kThreads) {
    s_ids[i] = ids[(size_t)b * C + i];
    s_w[i] = w[(size_t)b * C + i];
  }
  for (int i = threadIdx.x; i < K * C; i += kThreads)
    s_wd[i] = wd[(size_t)b * K * C + i];
  for (int i = threadIdx.x; i < NP * C; i += kThreads)
    s_wx[i] = wx[(size_t)b * NP * C + i];
  for (int i = threadIdx.x; i < S; i += kThreads) s_m[i] = m[(size_t)b * S + i];
  __syncthreads();

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  const float* obs_b = obs + (size_t)b * N;
  const size_t row = (size_t)S * N;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    // Multilinear combination of the corner templates: P (S), D (K x S),
    // and the m-weighted cross-pair second derivatives Xbar (NP)
    float Pv[S];
    float Dv[KD][S];
    float Xb[NPD];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      Pv[s] = 0.f;
#pragma unroll
      for (int d = 0; d < KD; ++d) Dv[d][s] = 0.f;
    }
#pragma unroll
    for (int p = 0; p < NPD; ++p) Xb[p] = 0.f;

#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* a = anchor + (size_t)s_ids[c] * row + n;
      const float wc = s_w[c];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float x = __ldg(a + (size_t)s * N);
        Pv[s] = fmaf(wc, x, Pv[s]);
#pragma unroll
        for (int d = 0; d < K; ++d) Dv[d][s] = fmaf(s_wd[d * C + c], x, Dv[d][s]);
        if (NP > 0) {
          const float mx = s_m[s] * x;
#pragma unroll
          for (int p = 0; p < NP; ++p) Xb[p] = fmaf(s_wx[p * C + c], mx, Xb[p]);
        }
      }
    }

    // v = dlambda/d(m, t): [P_1..P_S, Dbar_1..Dbar_K]
    float v[P];
    float lam = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      v[s] = Pv[s];
      lam = fmaf(s_m[s], Pv[s], lam);
    }
#pragma unroll
    for (int d = 0; d < K; ++d) {
      float db = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) db = fmaf(s_m[s], Dv[d][s], db);
      v[S + d] = db;
    }

    const float k = obs_b[n];
    const float lam_safe = fmaxf(lam, FLT_MIN);
    const float k_safe = k > 0.f ? k : 1.f;
    acc[0] += k * logf(lam_safe / k_safe) - (lam - k)
              + kPenalty * fminf(lam, 0.f);
    const float inv = 1.f / lam_safe;
    const float r = k * inv - 1.f + (lam < 0.f ? kPenalty : 0.f);
    const float q = k * inv * inv;

#pragma unroll
    for (int i = 0; i < P; ++i) {
      acc[1 + i] = fmaf(v[i], r, acc[1 + i]);
      const float qi = -q * v[i];
#pragma unroll
      for (int j = i; j < P; ++j)
        acc[1 + P + tri(P, i, j)] = fmaf(qi, v[j], acc[1 + P + tri(P, i, j)]);
    }
    // Second-derivative terms: d2lam/dm_s dt_d = D_ds, d2lam/dt_d dt_e = Xbar
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int d = 0; d < K; ++d)
        acc[1 + P + tri(P, s, S + d)] =
            fmaf(Dv[d][s], r, acc[1 + P + tri(P, s, S + d)]);
    {
      int p = 0;
#pragma unroll
      for (int d = 0; d < K; ++d)
#pragma unroll
        for (int e = d + 1; e < K; ++e, ++p)
          acc[1 + P + tri(P, S + d, S + e)] =
              fmaf(Xb[p], r, acc[1 + P + tri(P, S + d, S + e)]);
    }
  }

  block_sum<NV>(acc, s_red, s_tot);
  store_vgh<P>(s_tot, b, ll_out, g_out, h_out);
}

template <int S, int K>
__global__ void __launch_bounds__(kThreads)
ll_kernel(const float* __restrict__ anchor, int N, int A,
          const int* __restrict__ ids, const float* __restrict__ w,
          const float* __restrict__ m, const float* __restrict__ obs,
          float* __restrict__ ll_out) {
  constexpr int C = 1 << K;

  __shared__ int s_ids[C];
  __shared__ float s_w[C];
  __shared__ float s_m[S];
  __shared__ float s_red[kWarps];
  __shared__ float s_tot[1];

  const int ba = blockIdx.x;   // (toy, candidate), candidate fastest
  const int b = ba / A;
  for (int i = threadIdx.x; i < C; i += kThreads) {
    s_ids[i] = ids[(size_t)ba * C + i];
    s_w[i] = w[(size_t)ba * C + i];
  }
  for (int i = threadIdx.x; i < S; i += kThreads) s_m[i] = m[(size_t)ba * S + i];
  __syncthreads();

  float acc[1] = {0.f};
  const float* obs_b = obs + (size_t)b * N;
  const size_t row = (size_t)S * N;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float Pv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) Pv[s] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* a = anchor + (size_t)s_ids[c] * row + n;
      const float wc = s_w[c];
#pragma unroll
      for (int s = 0; s < S; ++s) Pv[s] = fmaf(wc, __ldg(a + (size_t)s * N), Pv[s]);
    }
    float lam = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) lam = fmaf(s_m[s], Pv[s], lam);
    const float k = obs_b[n];
    const float lam_safe = fmaxf(lam, FLT_MIN);
    const float k_safe = k > 0.f ? k : 1.f;
    acc[0] += k * logf(lam_safe / k_safe) - (lam - k)
              + kPenalty * fminf(lam, 0.f);
  }

  block_sum<1>(acc, s_red, s_tot);
  if (threadIdx.x == 0) ll_out[ba] = s_tot[0];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or -1 when
// (S, K) is outside the instantiated range.
int bt_binned_vgh(int S, int K, int N, int B, const float* anchor,
                  const int* ids, const float* w, const float* wd,
                  const float* wx, const float* m, const float* obs,
                  float* ll, float* g, float* h, cudaStream_t stream) {
  if (B <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
#define BT_VGH_CASE(S_, K_)                                                 \
  case (S_) * 8 + (K_):                                                     \
    vgh_kernel<S_, K_><<<B, kThreads, 0, stream>>>(anchor, N, ids, w, wd,   \
                                                   wx, m, obs, ll, g, h);   \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_VGH_CASE)
    default:
      return -1;
  }
#undef BT_VGH_CASE
  return (int)cudaGetLastError();
}

int bt_binned_ll_multi(int S, int K, int N, int B, int A, const float* anchor,
                       const int* ids, const float* w, const float* m,
                       const float* obs, float* ll, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  cudaGetLastError();
#define BT_LL_CASE(S_, K_)                                                  \
  case (S_) * 8 + (K_):                                                     \
    ll_kernel<S_, K_><<<B * A, kThreads, 0, stream>>>(anchor, N, A, ids, w, \
                                                      m, obs, ll);          \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_LL_CASE)
    default:
      return -1;
  }
#undef BT_LL_CASE
  return (int)cudaGetLastError();
}

}  // extern "C"
