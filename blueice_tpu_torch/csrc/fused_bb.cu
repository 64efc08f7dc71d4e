// Fused Beeston-Barlow (bb_single) binned likelihood kernels for NVIDIA
// Hopper (sm_90a).
//
// Two contracts, each one kernel, each with a plain PyTorch twin in
// blueice_tpu_torch/ops/fused_bb.py, which the wrapper uses for CPU tensors:
//
//   bb_vgh_kernel  deviance-form ll, gradient g (P) and Hessian H (P x P) in
//                  (m, t), P = S + K, of the likelihood with source bb's
//                  per-bin expectation profiled by the closed-form
//                  Beeston-Barlow root; one toy per block. Replaces the
//                  Pallas kernels _bb_vgh_kernel (blueice_tpu/ops/
//                  fused_bb.py:191, gather flavor) and _bb_vgh_kernel_dense
//                  (fused_bb.py:458, dense flavor).
//   bb_ll_kernel   the same ll at one line-search candidate, one (toy,
//                  candidate) pair per block. Replaces _bb_ll_kernel
//                  (fused_bb.py:227) and _bb_ll_kernel_dense (fused_bb.py:605).
//
// Per bin the kernels combine the 2^K corner rows of the pmf anchors
// (G, S, N) and of the finite source's MC counts (G, N), form the five
// inputs of the root (bb pmf Pb, bb counts Nb, other-source expectation U,
// bb rate M, total MC count T) and evaluate the closed forms of
// blueice_tpu/ops/bb_vgh.py: bb_lambda for the value, bb_lam_parts (root,
// gradient and Hessian in the five inputs by implicit differentiation) for
// the vgh, with every branch and guard of the reference kept: has_mc = N > 0,
// active = pw > 0, Citardauq on b >= 0, the U == 0 special root, the tiny
// floors and the finite dlam/dM limit at M == 0. There is no
// negative-expectation penalty, as in the reference; the fitter routes
// allow_negative bb models to its plain engine.
//
// Global sums: T = sum_n Nb and its t-derivatives enter every bin, so they
// are needed before the per-bin pass. They are linear in the corner rows,
// so the wrapper passes per-anchor totals tot[g] = sum_n nme[g, n] (summed
// in float64) and each block combines them with its corner weights:
// T = sum_c w_c tot[id_c], SN_k = sum_c wd_kc tot[id_c], SXN_de =
// sum_c wx_dec tot[id_c]. No pre-pass over the bins, no extra traffic.
//
// What bounds them on an H100: the corner gathers, (S + 1) * 2^K rows per
// bin, served from the 50 MB L2 (the 6 MB pmf anchors and 1 MB count rows
// fit it many times over); neighbouring threads take neighbouring bins, so
// every gather is a coalesced row read. The vgh's per-bin work is the root
// and its 5 + 14 partials plus the (S+K)(S+K+1)/2 Hessian updates; the
// Jacobian of the five inputs is sparse (the M row is one-hot at bb, the T
// row carries only SN on the t columns, the Pb and Nb rows only the t
// columns), and the kernel multiplies only its nonzero blocks.
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

// bb_lambda of blueice_tpu/ops/bb_vgh.py: the adjusted expected count.
__device__ __forceinline__ float bb_lambda(float P, float N, float U, float M,
                                           float T, float d) {
  const float tiny = FLT_MIN;
  const bool has_mc = N > 0.f;
  const float N_safe = has_mc ? N : 1.f;
  const float pw = has_mc ? M * P / N_safe : 0.f;
  const float pw_safe = pw > 0.f ? pw : 1.f;
  const float b_lin = U * (pw_safe + 1.f) - pw_safe * (N + d);
  const float disc =
      b_lin * b_lin + 4.f * pw_safe * (pw_safe + 1.f) * (U * N);
  const float root = sqrtf(fmaxf(disc, tiny));
  const bool sel_hi = b_lin >= 0.f;
  const float den_hi = fmaxf(sel_hi ? b_lin + root : 1.f, tiny);
  const float den_lo = sel_hi ? 1.f : 2.f * pw_safe * (pw_safe + 1.f);
  const float A_general =
      sel_hi ? 2.f * U * N / den_hi : (root - b_lin) / den_lo;
  const float A_special = (d + N) / (1.f + M / T);
  const float A = U == 0.f ? A_special : A_general;
  return U + (pw > 0.f ? pw * A : 0.f);
}

// bb_lam_parts of blueice_tpu/ops/bb_vgh.py: lam, its gradient g[5] in
// (P, N, U, M, T) and the upper-triangle second derivatives (o24 is
// identically zero and left out).
struct BBParts {
  float lam;
  float g[5];
  float o00, o01, o02, o03, o04, o11, o12, o13, o14, o22, o23, o33, o34, o44;
};

__device__ __forceinline__ BBParts bb_lam_parts(float P, float N, float U,
                                                float M, float T, float d) {
  const float tiny = FLT_MIN;
  BBParts o;
  o.g[0] = o.g[1] = o.g[3] = o.g[4] = 0.f;
  o.g[2] = 1.f;
  o.o00 = o.o01 = o.o02 = o.o03 = o.o04 = o.o11 = o.o12 = o.o13 = o.o14 =
      o.o22 = o.o23 = o.o33 = o.o34 = o.o44 = 0.f;
  const bool has_mc = N > 0.f;
  const float N_s = has_mc ? N : 1.f;
  const float p = has_mc ? M * P / N_s : 0.f;
  if (!(p > 0.f)) {
    // Inert bin: lam = U; d lam / dM keeps its finite limit at M == 0
    o.lam = U;
    if (has_mc && P > 0.f && M == 0.f)
      o.g[3] = U == 0.f ? (P * (1.f / N_s)) * (d + N) : P;
    return o;
  }
  const float p_s = p;   // active: pw > 0
  const float inv_N = 1.f / N_s;
  const float p_P = M * inv_N;
  const float p_M = P * inv_N;
  const float p_N = -p_s * inv_N;
  const float p2_PN = -p_P * inv_N;
  const float p2_PM = inv_N;
  const float p2_NN = 2.f * p_s * inv_N * inv_N;
  const float p2_NM = -p_M * inv_N;

  if (U == 0.f) {
    // Special root A = (d + N) / (1 + M / T)
    const float T_s = T > 0.f ? T : 1.f;
    const float beta = 1.f + M / T_s;
    const float ib = 1.f / beta;
    const float iT = 1.f / T_s;
    const float dN = d + N;
    const float As = dN * ib;
    const float As_N = ib;
    const float As_M = -As * ib * iT;
    const float As_T = As * M * ib * iT * iT;
    const float As_NM = -ib * ib * iT;
    const float As_NT = M * ib * ib * iT * iT;
    const float ib2 = ib * ib, ib3 = ib2 * ib;
    const float iT2 = iT * iT, iT3 = iT2 * iT, iT4 = iT3 * iT;
    const float As_MM = 2.f * dN * ib3 * iT * iT;
    const float As_MT = dN * (ib2 * iT2 - 2.f * M * ib3 * iT3);
    const float As_TT = dN * M * (2.f * M * ib3 * iT4 - 2.f * ib2 * iT3);
    o.lam = U + p_s * As;
    o.g[0] = p_P * As;
    o.g[1] = p_N * As + p_s * As_N;
    o.g[2] = 1.f;
    o.g[3] = p_M * As + p_s * As_M;
    o.g[4] = p_s * As_T;
    o.o01 = p2_PN * As + p_P * As_N;
    o.o03 = p2_PM * As + p_P * As_M;
    o.o04 = p_P * As_T;
    o.o11 = p2_NN * As + 2.f * p_N * As_N;
    o.o13 = p2_NM * As + p_N * As_M + p_M * As_N + p_s * As_NM;
    o.o14 = p_N * As_T + p_s * As_NT;
    o.o33 = 2.f * p_M * As_M + p_s * As_MM;
    o.o34 = p_M * As_T + p_s * As_MT;
    o.o44 = p_s * As_TT;
    return o;
  }

  // General root of a A^2 + b A - U N = 0 and its implicit derivatives
  const float a = p_s * (p_s + 1.f);
  const float b = U * (p_s + 1.f) - p_s * (N + d);
  const float disc = b * b + 4.f * U * N * a;
  const float R = sqrtf(fmaxf(disc, tiny));
  const bool sel_hi = b >= 0.f;
  const float den_hi = fmaxf(sel_hi ? b + R : 1.f, tiny);
  const float den_lo = sel_hi ? 1.f : 2.f * a;
  const float A = sel_hi ? 2.f * U * N / den_hi : (R - b) / den_lo;

  const float F_p = (2.f * p_s + 1.f) * A * A + (U - N - d) * A;
  const float F_U = (p_s + 1.f) * A - N;
  const float F_N = -p_s * A - U;
  const float inv_R = 1.f / R;
  const float A_p = -F_p * inv_R;
  const float A_U = -F_U * inv_R;
  const float A_N = -F_N * inv_R;
  const float F_pA = 2.f * (2.f * p_s + 1.f) * A + (U - N - d);
  const float F_UA = p_s + 1.f;
  const float F_NA = -p_s;
  const float two_a = 2.f * a;
  const float A_pp =
      -(2.f * A * A + 2.f * F_pA * A_p + two_a * A_p * A_p) * inv_R;
  const float A_pU =
      -(A + F_pA * A_U + F_UA * A_p + two_a * A_p * A_U) * inv_R;
  const float A_pN =
      -(-A + F_pA * A_N + F_NA * A_p + two_a * A_p * A_N) * inv_R;
  const float A_UU = -(2.f * F_UA * A_U + two_a * A_U * A_U) * inv_R;
  const float A_UN =
      -(-1.f + F_UA * A_N + F_NA * A_U + two_a * A_U * A_N) * inv_R;
  const float A_NN = -(2.f * F_NA * A_N + two_a * A_N * A_N) * inv_R;

  const float L_p = A + p_s * A_p;
  const float L_U = 1.f + p_s * A_U;
  const float L_N = p_s * A_N;
  const float L_pp = 2.f * A_p + p_s * A_pp;
  const float L_pU = A_U + p_s * A_pU;
  const float L_pN = A_N + p_s * A_pN;

  o.lam = U + p_s * A;
  o.g[0] = L_p * p_P;
  o.g[1] = L_N + L_p * p_N;
  o.g[2] = L_U;
  o.g[3] = L_p * p_M;
  o.o00 = L_pp * p_P * p_P;
  o.o01 = L_pp * p_P * p_N + L_pN * p_P + L_p * p2_PN;
  o.o02 = L_pU * p_P;
  o.o03 = L_pp * p_P * p_M + L_p * p2_PM;
  o.o11 = L_pp * p_N * p_N + 2.f * L_pN * p_N + p_s * A_NN + L_p * p2_NN;
  o.o12 = L_pU * p_N + p_s * A_UN;
  o.o13 = L_pp * p_N * p_M + L_pN * p_M + L_p * p2_NM;
  o.o22 = p_s * A_UU;
  o.o23 = L_pU * p_M;
  o.o33 = L_pp * p_M * p_M;
  return o;
}

// The block's global sums from per-anchor MC totals (see the header):
// glob = [T, SN_0..SN_{K-1}, SXN_0..SXN_{NP-1}], computed by thread 0 in a
// fixed order.
template <int K>
__device__ __forceinline__ void global_sums(const float* __restrict__ tot,
                                            const int* s_ids,
                                            const float* s_w,
                                            const float* s_wd,
                                            const float* s_wx, float* glob) {
  constexpr int C = 1 << K;
  constexpr int NP = K * (K - 1) / 2;
  if (threadIdx.x == 0) {
    float acc[1 + K + NP];
#pragma unroll
    for (int i = 0; i < 1 + K + NP; ++i) acc[i] = 0.f;
    for (int c = 0; c < C; ++c) {
      const float tc = tot[s_ids[c]];
      acc[0] = fmaf(s_w[c], tc, acc[0]);
#pragma unroll
      for (int d = 0; d < K; ++d) acc[1 + d] = fmaf(s_wd[d * C + c], tc, acc[1 + d]);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        acc[1 + K + p] = fmaf(s_wx[p * C + c], tc, acc[1 + K + p]);
    }
#pragma unroll
    for (int i = 0; i < 1 + K + NP; ++i) glob[i] = acc[i];
  }
}

template <int S, int K>
__global__ void __launch_bounds__(kThreads)
bb_vgh_kernel(const float* __restrict__ anchor, const float* __restrict__ nme,
              const float* __restrict__ tot, int N, int bb,
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
  __shared__ float s_glob[1 + KD + NPD];
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
  global_sums<K>(tot, s_ids, s_w, s_wd, s_wx, s_glob);
  __syncthreads();
  const float T = s_glob[0];
  const float M = s_m[bb];

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  const float* obs_b = obs + (size_t)b * N;
  const size_t row = (size_t)S * N;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    // Corner combination: per-source P and D, the other sources'
    // m-weighted and the bb source's cross-pair second differences, and
    // the bb MC-count row's value and differences
    float Pv[S];
    float Dv[KD][S];
    float Xu[NPD], Xp[NPD], DN[KD], XN[NPD];
    float Nb = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      Pv[s] = 0.f;
#pragma unroll
      for (int d = 0; d < KD; ++d) Dv[d][s] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < KD; ++d) DN[d] = 0.f;
#pragma unroll
    for (int p = 0; p < NPD; ++p) Xu[p] = Xp[p] = XN[p] = 0.f;

#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t gid = (size_t)s_ids[c];
      const float* a = anchor + gid * row + n;
      const float wc = s_w[c];
      const float nx = __ldg(nme + gid * N + n);
      Nb = fmaf(wc, nx, Nb);
#pragma unroll
      for (int d = 0; d < K; ++d) DN[d] = fmaf(s_wd[d * C + c], nx, DN[d]);
#pragma unroll
      for (int p = 0; p < NP; ++p) XN[p] = fmaf(s_wx[p * C + c], nx, XN[p]);
      float xb = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float x = __ldg(a + (size_t)s * N);
        Pv[s] = fmaf(wc, x, Pv[s]);
#pragma unroll
        for (int d = 0; d < K; ++d) Dv[d][s] = fmaf(s_wd[d * C + c], x, Dv[d][s]);
        if (NP > 0) {
          const float xo = s == bb ? 0.f : s_m[s] * x;
#pragma unroll
          for (int p = 0; p < NP; ++p) Xu[p] = fmaf(s_wx[p * C + c], xo, Xu[p]);
        }
        xb = s == bb ? x : xb;
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) Xp[p] = fmaf(s_wx[p * C + c], xb, Xp[p]);
    }

    // The root's inputs and their t-derivatives
    float Pb = 0.f, U = 0.f;
    float Dpb[KD], DU[KD];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      Pb = s == bb ? Pv[s] : Pb;
      U = s == bb ? U : fmaf(s_m[s], Pv[s], U);
    }
#pragma unroll
    for (int d = 0; d < K; ++d) {
      Dpb[d] = 0.f;
      DU[d] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        Dpb[d] = s == bb ? Dv[d][s] : Dpb[d];
        DU[d] = s == bb ? DU[d] : fmaf(s_m[s], Dv[d][s], DU[d]);
      }
    }

    const float k = obs_b[n];
    const BBParts bp = bb_lam_parts(Pb, Nb, U, M, T, k);
    const float lam_safe = fmaxf(bp.lam, FLT_MIN);
    const float k_safe = k > 0.f ? k : 1.f;
    acc[0] += k * logf(lam_safe / k_safe) - (bp.lam - k);
    const float inv = 1.f / lam_safe;
    const float r = k * inv - 1.f;
    const float q = (k * inv) * inv;

    // dlam/d(m, t): m_s -> g2 * P_s (s != bb) or g3 (s == bb);
    // t_d -> g0 Dpb + g1 DN + g2 DU + g4 SN
    float dl[P];
#pragma unroll
    for (int s = 0; s < S; ++s) dl[s] = s == bb ? bp.g[3] : bp.g[2] * Pv[s];
#pragma unroll
    for (int d = 0; d < K; ++d)
      dl[S + d] = bp.g[0] * Dpb[d] + bp.g[1] * DN[d] + bp.g[2] * DU[d]
                  + bp.g[4] * s_glob[1 + d];

    // r * om: the input-space curvature weighted by this bin's residual
    const float r00 = r * bp.o00, r01 = r * bp.o01, r02 = r * bp.o02,
                r03 = r * bp.o03, r04 = r * bp.o04, r11 = r * bp.o11,
                r12 = r * bp.o12, r13 = r * bp.o13, r14 = r * bp.o14,
                r22 = r * bp.o22, r23 = r * bp.o23, r33 = r * bp.o33,
                r34 = r * bp.o34, r44 = r * bp.o44;
    // (r om) J for the t columns, J(t_d) = (Dpb, DN, DU, 0, SN)
    float W0[KD], W1[KD], W2[KD], W3[KD], W4[KD];
#pragma unroll
    for (int d = 0; d < K; ++d) {
      const float sn = s_glob[1 + d];
      W0[d] = r00 * Dpb[d] + r01 * DN[d] + r02 * DU[d] + r04 * sn;
      W1[d] = r01 * Dpb[d] + r11 * DN[d] + r12 * DU[d] + r14 * sn;
      W2[d] = r02 * Dpb[d] + r12 * DN[d] + r22 * DU[d];
      W3[d] = r03 * Dpb[d] + r13 * DN[d] + r23 * DU[d] + r34 * sn;
      W4[d] = r04 * Dpb[d] + r14 * DN[d] + r44 * sn;
    }
    const float rg2 = r * bp.g[2];

#pragma unroll
    for (int i = 0; i < P; ++i) acc[1 + i] = fmaf(r, dl[i], acc[1 + i]);
    // (m_i, m_j): J(m_s) = (0, 0, P_s, 0, 0) for s != bb, (0, 0, 0, 1, 0)
    // for s == bb
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float qi = -q * dl[i];
#pragma unroll
      for (int j = i; j < S; ++j) {
        const float joj = i == bb ? (j == bb ? r33 : r23 * Pv[j])
                                  : (j == bb ? r23 * Pv[i]
                                             : r22 * Pv[i] * Pv[j]);
        acc[1 + P + tri(P, i, j)] += fmaf(qi, dl[j], joj);
      }
      // (m_i, t_d), with d2U/dm_s dt_d = D[d][s] for s != bb
#pragma unroll
      for (int d = 0; d < K; ++d) {
        const float joj = i == bb ? W3[d]
                                  : fmaf(Pv[i], W2[d], rg2 * Dv[d][i]);
        acc[1 + P + tri(P, i, S + d)] += fmaf(qi, dl[S + d], joj);
      }
    }
    // (t_d, t_e), with the inputs' cross-pair second differences
    {
      int p = 0;
#pragma unroll
      for (int d = 0; d < K; ++d) {
        const float qd = -q * dl[S + d];
#pragma unroll
        for (int e = d; e < K; ++e) {
          float joj = Dpb[d] * W0[e] + DN[d] * W1[e] + DU[d] * W2[e]
                      + s_glob[1 + d] * W4[e];
          if (e > d) {
            joj += r * (bp.g[0] * Xp[p] + bp.g[1] * XN[p] + bp.g[2] * Xu[p]
                        + bp.g[4] * s_glob[1 + K + p]);
            ++p;
          }
          acc[1 + P + tri(P, S + d, S + e)] += fmaf(qd, dl[S + e], joj);
        }
      }
    }
  }

  block_sum<NV>(acc, s_red, s_tot);
  store_vgh<P>(s_tot, b, ll_out, g_out, h_out);
}

template <int S, int K>
__global__ void __launch_bounds__(kThreads)
bb_ll_kernel(const float* __restrict__ anchor, const float* __restrict__ nme,
             const float* __restrict__ tot, int N, int A, int bb,
             const int* __restrict__ ids, const float* __restrict__ w,
             const float* __restrict__ m, const float* __restrict__ obs,
             float* __restrict__ ll_out) {
  constexpr int C = 1 << K;

  __shared__ int s_ids[C];
  __shared__ float s_w[C];
  __shared__ float s_m[S];
  __shared__ float s_glob[1];
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
  if (threadIdx.x == 0) {   // T = sum_c w_c tot[id_c], in a fixed order
    float T = 0.f;
    for (int c = 0; c < C; ++c) T = fmaf(s_w[c], tot[s_ids[c]], T);
    s_glob[0] = T;
  }
  __syncthreads();
  const float T = s_glob[0];
  const float M = s_m[bb];

  float acc[1] = {0.f};
  const float* obs_b = obs + (size_t)b * N;
  const size_t row = (size_t)S * N;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    float Pv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) Pv[s] = 0.f;
    float Nb = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const size_t gid = (size_t)s_ids[c];
      const float* a = anchor + gid * row + n;
      const float wc = s_w[c];
      Nb = fmaf(wc, __ldg(nme + gid * N + n), Nb);
#pragma unroll
      for (int s = 0; s < S; ++s) Pv[s] = fmaf(wc, __ldg(a + (size_t)s * N), Pv[s]);
    }
    float Pb = 0.f, U = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      Pb = s == bb ? Pv[s] : Pb;
      U = s == bb ? U : fmaf(s_m[s], Pv[s], U);
    }
    const float k = obs_b[n];
    const float lam = bb_lambda(Pb, Nb, U, M, T, k);
    const float lam_safe = fmaxf(lam, FLT_MIN);
    const float k_safe = k > 0.f ? k : 1.f;
    acc[0] += k * logf(lam_safe / k_safe) - (lam - k);
  }

  block_sum<1>(acc, s_red, s_tot);
  if (threadIdx.x == 0) ll_out[ba] = s_tot[0];
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or -1 when
// (S, K) is outside the instantiated range or bb is not a source index.
int bt_bb_vgh(int S, int K, int N, int B, int bb, const float* anchor,
              const float* nme, const float* tot, const int* ids,
              const float* w, const float* wd, const float* wx,
              const float* m, const float* obs, float* ll, float* g,
              float* h, cudaStream_t stream) {
  if (B <= 0) return 0;
  if (bb < 0 || bb >= S) return -1;
  cudaGetLastError();   // clear a stale error so the return value is ours
#define BT_VGH_CASE(S_, K_)                                                \
  case (S_) * 8 + (K_):                                                    \
    bb_vgh_kernel<S_, K_><<<B, kThreads, 0, stream>>>(                     \
        anchor, nme, tot, N, bb, ids, w, wd, wx, m, obs, ll, g, h);        \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_VGH_CASE)
    default:
      return -1;
  }
#undef BT_VGH_CASE
  return (int)cudaGetLastError();
}

int bt_bb_ll_multi(int S, int K, int N, int B, int A, int bb,
                   const float* anchor, const float* nme, const float* tot,
                   const int* ids, const float* w, const float* m,
                   const float* obs, float* ll, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  if (bb < 0 || bb >= S) return -1;
  cudaGetLastError();
#define BT_LL_CASE(S_, K_)                                                 \
  case (S_) * 8 + (K_):                                                    \
    bb_ll_kernel<S_, K_><<<B * A, kThreads, 0, stream>>>(                  \
        anchor, nme, tot, N, A, bb, ids, w, m, obs, ll);                   \
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
