// Fused Barlow-Beeston-lite binned likelihood kernels for NVIDIA Hopper
// (sm_90a).
//
// Two contracts, each one kernel, each with a plain PyTorch twin in
// blueice_tpu_torch/ops/fused_bb_lite.py, which the wrapper uses for CPU
// tensors:
//
//   bblite_vgh_kernel  deviance-form ll, gradient g (P) and Hessian
//                      H (P x P) in (m, t), P = S + K, of the likelihood
//                      with one profiled scale per bin on the total
//                      expectation, gamma = (k + M) / (lam + M); one toy per
//                      block. Replaces the Pallas kernels _bblite_vgh_kernel
//                      (blueice_tpu/ops/fused_bb_lite.py:154, gather flavor)
//                      and _bblite_vgh_kernel_dense (fused_bb_lite.py:417,
//                      dense flavor).
//   bblite_ll_kernel   the same ll at one line-search candidate, one (toy,
//                      candidate) pair per block. Replaces _bblite_ll_kernel
//                      (fused_bb_lite.py:189) and _bblite_ll_kernel_dense
//                      (fused_bb_lite.py:511).
//
// Per bin: the 2^K corner rows of the pmf anchors (G, S, N) and of the
// total MC counts (G, N) (summed over sources on the host) combine into
// lam = sum_s m_s P_s and M, and the closed forms of
// blueice_tpu/ops/bb_lite.py:_per_bin_parts give the value and its first
// and second derivatives in (lam, M), chained to (m, t) through the
// corner-difference tables. The negative-expectation penalty (1e6 * lam in
// value, 1e6 in d/dlam where lam < 0) is kept, as in the reference.
//
// What bounds them on an H100: the corner gathers, (S + 1) * 2^K rows per
// bin, served from the 50 MB L2; neighbouring threads take neighbouring
// bins, so every gather is a coalesced row read. No global sums are needed.
//
// Reductions: per-thread register accumulators, then bt::block_sum in a
// fixed order: reruns are bit-identical.
//
// Built by blueice_tpu_torch/ops/fused.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared) and loaded with ctypes; the C
// entry points return cudaGetLastError().

#include "bt_common.cuh"

namespace {

using namespace bt;

__device__ __forceinline__ float xlogy_f(float x, float y) {
  return x == 0.f ? 0.f : x * logf(y);
}

struct LiteParts {
  float value, f_lam, f_M, H_ll, H_lM, H_MM;
};

// _per_bin_parts of blueice_tpu/ops/bb_lite.py.
__device__ __forceinline__ LiteParts lite_parts(float lam, float M, float k) {
  const float tiny = FLT_MIN;
  LiteParts o;
  const float lam_pos = fmaxf(lam, tiny);
  const bool has_mc = M > 0.f;
  const float den = fmaxf(lam_pos + M, tiny);
  const float g = has_mc ? (k + M) / den : 1.f;
  const float k_safe = k > 0.f ? k : 1.f;
  o.value = xlogy_f(k, fmaxf(g * lam_pos, tiny) / k_safe) - (g * lam - k)
            + xlogy_f(M, g) - M * (g - 1.f) + kPenalty * fminf(lam, 0.f);
  const float inv_lam = 1.f / lam_pos;
  o.f_lam = k * inv_lam - g + (lam < 0.f ? kPenalty : 0.f);
  const float g_safe = has_mc ? g : 1.f;
  o.f_M = has_mc ? logf(g_safe) - (g - 1.f) : 0.f;
  const float inv_den = has_mc ? 1.f / den : 0.f;
  const float g_lam = has_mc ? -g * inv_den : 0.f;
  const float g_M = has_mc ? (lam_pos - k) * inv_den * inv_den : 0.f;
  o.H_ll = -k * inv_lam * inv_lam - g_lam;
  o.H_lM = -g_M;
  o.H_MM = has_mc ? (1.f / g_safe - 1.f) * g_M : 0.f;
  return o;
}

template <int S, int K>
__global__ void __launch_bounds__(kThreads)
bblite_vgh_kernel(const float* __restrict__ anchor,
                  const float* __restrict__ nme, int N,
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
    // Corner combination: P (S), D (K x S), the m-weighted cross-pair
    // second differences Xb (NP), and the total-count row's Mn, DM, XM
    float Pv[S];
    float Dv[KD][S];
    float Xb[NPD], DM[KD], XM[NPD];
    float Mn = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      Pv[s] = 0.f;
#pragma unroll
      for (int d = 0; d < KD; ++d) Dv[d][s] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < KD; ++d) DM[d] = 0.f;
#pragma unroll
    for (int p = 0; p < NPD; ++p) Xb[p] = XM[p] = 0.f;

#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t gid = (size_t)s_ids[c];
      const float* a = anchor + gid * row + n;
      const float wc = s_w[c];
      const float nx = __ldg(nme + gid * N + n);
      Mn = fmaf(wc, nx, Mn);
#pragma unroll
      for (int d = 0; d < K; ++d) DM[d] = fmaf(s_wd[d * C + c], nx, DM[d]);
#pragma unroll
      for (int p = 0; p < NP; ++p) XM[p] = fmaf(s_wx[p * C + c], nx, XM[p]);
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

    float lam = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) lam = fmaf(s_m[s], Pv[s], lam);
    float Dbar[KD];
#pragma unroll
    for (int d = 0; d < K; ++d) {
      Dbar[d] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) Dbar[d] = fmaf(s_m[s], Dv[d][s], Dbar[d]);
    }

    const LiteParts lp = lite_parts(lam, Mn, obs_b[n]);
    acc[0] += lp.value;
    // Parameter rows: dlam/dm_s = P_s, dlam/dt_d = Dbar_d; dM/dm = 0,
    // dM/dt_d = DM_d
#pragma unroll
    for (int s = 0; s < S; ++s) acc[1 + s] = fmaf(Pv[s], lp.f_lam, acc[1 + s]);
#pragma unroll
    for (int d = 0; d < K; ++d)
      acc[1 + S + d] += Dbar[d] * lp.f_lam + DM[d] * lp.f_M;

    // (t columns) H_ll Dbar + H_lM DM and H_lM Dbar + H_MM DM
    float Vl[KD], VM[KD];
#pragma unroll
    for (int d = 0; d < K; ++d) {
      Vl[d] = lp.H_ll * Dbar[d] + lp.H_lM * DM[d];
      VM[d] = lp.H_lM * Dbar[d] + lp.H_MM * DM[d];
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float pi = Pv[i] * lp.H_ll;
#pragma unroll
      for (int j = i; j < S; ++j)
        acc[1 + P + tri(P, i, j)] = fmaf(pi, Pv[j], acc[1 + P + tri(P, i, j)]);
#pragma unroll
      for (int d = 0; d < K; ++d)
        acc[1 + P + tri(P, i, S + d)] +=
            fmaf(Pv[i], Vl[d], Dv[d][i] * lp.f_lam);
    }
    {
      int p = 0;
#pragma unroll
      for (int d = 0; d < K; ++d) {
#pragma unroll
        for (int e = d; e < K; ++e) {
          float h = Dbar[d] * Vl[e] + DM[d] * VM[e];
          if (e > d) {
            h += Xb[p] * lp.f_lam + XM[p] * lp.f_M;
            ++p;
          }
          acc[1 + P + tri(P, S + d, S + e)] += h;
        }
      }
    }
  }

  block_sum<NV>(acc, s_red, s_tot);
  store_vgh<P>(s_tot, b, ll_out, g_out, h_out);
}

template <int S, int K>
__global__ void __launch_bounds__(kThreads)
bblite_ll_kernel(const float* __restrict__ anchor,
                 const float* __restrict__ nme, int N, int A,
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
    float Mn = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t gid = (size_t)s_ids[c];
      const float* a = anchor + gid * row + n;
      const float wc = s_w[c];
      Mn = fmaf(wc, __ldg(nme + gid * N + n), Mn);
#pragma unroll
      for (int s = 0; s < S; ++s) Pv[s] = fmaf(wc, __ldg(a + (size_t)s * N), Pv[s]);
    }
    float lam = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) lam = fmaf(s_m[s], Pv[s], lam);
    acc[0] += lite_parts(lam, Mn, obs_b[n]).value;
  }

  block_sum<1>(acc, s_red, s_tot);
  if (threadIdx.x == 0) ll_out[ba] = s_tot[0];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or -1 when
// (S, K) is outside the instantiated range.
int bt_bblite_vgh(int S, int K, int N, int B, const float* anchor,
                  const float* nme, const int* ids, const float* w,
                  const float* wd, const float* wx, const float* m,
                  const float* obs, float* ll, float* g, float* h,
                  cudaStream_t stream) {
  if (B <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
#define BT_VGH_CASE(S_, K_)                                                \
  case (S_) * 8 + (K_):                                                    \
    bblite_vgh_kernel<S_, K_><<<B, kThreads, 0, stream>>>(                 \
        anchor, nme, N, ids, w, wd, wx, m, obs, ll, g, h);                 \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_VGH_CASE)
    default:
      return -1;
  }
#undef BT_VGH_CASE
  return (int)cudaGetLastError();
}

int bt_bblite_ll_multi(int S, int K, int N, int B, int A,
                       const float* anchor, const float* nme, const int* ids,
                       const float* w, const float* m, const float* obs,
                       float* ll, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  cudaGetLastError();
#define BT_LL_CASE(S_, K_)                                                 \
  case (S_) * 8 + (K_):                                                    \
    bblite_ll_kernel<S_, K_><<<B * A, kThreads, 0, stream>>>(              \
        anchor, nme, N, A, ids, w, m, obs, ll);                            \
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
