// Fused Beeston-Barlow (bb_single) binned likelihood kernels for NVIDIA
// Hopper (sm_90a).
//
// Two contracts, each one kernel, each with a plain PyTorch twin in
// blueice_tpu_torch/ops/fused_bb.py, which the wrapper uses for CPU tensors:
//
//   bb_vgh_kernel  deviance-form ll, gradient g (P) and Hessian H (P x P) in
//                  (m, t), P = S + K, of the likelihood with source bb's
//                  per-bin expectation profiled by the closed-form
//                  Beeston-Barlow root, in the bin ranges of
//                  bt_ranges.cuh (one block per toy and bin range, a toy's
//                  ranges one cluster). Replaces the
//                  Pallas kernels _bb_vgh_kernel (blueice_tpu/ops/
//                  fused_bb.py:191, gather flavor) and _bb_vgh_kernel_dense
//                  (fused_bb.py:458, dense flavor).
//   bb_ll_kernel   the same ll at A line-search candidates per toy, in the
//                  cell layout of bt_cells.cuh (one block per toy and bin
//                  range, the candidates of one grid cell sharing each load
//                  of its corner rows). Replaces _bb_ll_kernel
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
// allow_negative bb models to its plain engine. bb_lambda and bb_lam_parts
// live in bt_perbin.cuh, shared with the op-mix probe (op_mix.cu).
//
// Global sums: T = sum_n Nb and its t-derivatives enter every bin, so they
// are needed before the per-bin pass. They are linear in the corner rows,
// so the wrapper passes per-anchor totals tot[g] = sum_n nme[g, n] (summed
// in float64) and each block (every range) combines them with its corner
// weights:
// T = sum_c w_c tot[id_c], SN_k = sum_c wd_kc tot[id_c], SXN_de =
// sum_c wx_dec tot[id_c]. No pre-pass over the bins, no extra traffic.
//
// What bounds them on an H100: float32 issue and the latency of the corner
// gathers, (S + 1) * 2^K rows per bin, served from the 50 MB L2 (the 6 MB
// pmf anchors and 1 MB count rows fit it many times over); neighbouring
// threads take neighbouring bins, so every gather is a coalesced row read.
// The vgh's per-bin work is the combine (bt::corner_tree: value, K
// differences and K(K-1)/2 cross differences of each row by K lerp steps),
// the root and its 5 + 14 partials, and the (S+K)(S+K+1)/2 Hessian updates;
// the Jacobian of the five inputs is sparse (the M row is one-hot at bb,
// the T row carries only SN on the t columns, the Pb and Nb rows only the t
// columns), and the kernel multiplies only its nonzero blocks. The Newton
// loop calls it on its live lanes only, often under 132 toys: a toy's bins
// split over up to 8 blocks (launch_ranges, as many as the batch needs to
// fill the card), 128-thread blocks whose ~66 accumulators, combine and
// root fit the registers of two blocks an SM.
// The value kernel reads a cell's rows once per bin for all of the toy's
// candidates in that cell, so where they share cells the per-candidate
// combine and root set its pace.
//
// Reductions: fixed order everywhere (per-thread register accumulators,
// bt::block_sum and the cluster's ranges in rank order,
// bt::cluster_vgh_sum, for the vgh; bt::cell_sums for the value kernel),
// no float atomics: reruns are bit-identical.
//
// Built by blueice_tpu_torch/ops/fused.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared) and loaded with ctypes; the C
// entry points return cudaGetLastError().

#include "bt_cells.cuh"
#include "bt_common.cuh"
#include "bt_perbin.cuh"

namespace {

using namespace bt;

// The block's global sums from the per-anchor MC totals of its corners
// (s_tc, see the header): glob = [T, SN_0..SN_{K-1}, SXN_0..SXN_{NP-1}],
// computed by thread 0 in a fixed order.
template <int K>
__device__ __forceinline__ void global_sums(const float* s_tc,
                                            const float* s_w,
                                            const float* s_wd,
                                            const float* s_wx, float* glob) {
  constexpr int C = 1 << K;
  constexpr int NP = K * (K - 1) / 2;
  if (threadIdx.x == 0) {
    float acc[1 + K + NP];
#pragma unroll
    for (int i = 0; i < 1 + K + NP; ++i) acc[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float tc = s_tc[c];
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
__global__ void __launch_bounds__(kVghThreads, kVghBlocks)
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
  constexpr int NT = kVghThreads;

  __shared__ int s_ids[C];
  __shared__ float s_w[C], s_tc[C];
  __shared__ float s_wd[KD * C];
  __shared__ float s_wx[NPD * C];
  __shared__ float s_m[S];
  __shared__ int s_rid[C], s_flip;
  __shared__ float s_lw[KD];
  __shared__ float s_glob[1 + KD + NPD];
  __shared__ float s_red[NT / 32 * NV];
  __shared__ float s_part[NV];
  __shared__ float s_tot[NV];

  const BinRange rg = bin_range(N);
  const int b = blockIdx.x / rg.T;
  for (int i = threadIdx.x; i < C; i += NT) {
    s_ids[i] = ids[(size_t)b * C + i];
    s_w[i] = w[(size_t)b * C + i];
    s_tc[i] = tot[s_ids[i]];
  }
  for (int i = threadIdx.x; i < K * C; i += NT)
    s_wd[i] = wd[(size_t)b * K * C + i];
  for (int i = threadIdx.x; i < NP * C; i += NT)
    s_wx[i] = wx[(size_t)b * NP * C + i];
  for (int i = threadIdx.x; i < S; i += NT) s_m[i] = m[(size_t)b * S + i];
  __syncthreads();
  tree_cell<K>(s_ids, s_w, s_rid, s_lw, &s_flip);
  if (threadIdx.x == 0) {
    global_sums<K>(s_tc, s_w, s_wd, s_wx, s_glob);
    flip_sums<K>(s_glob, s_flip);
  }
  __syncthreads();
  const float T = s_glob[0];
  const float M = s_m[bb];
  float lw[KD];
#pragma unroll
  for (int d = 0; d < KD; ++d) lw[d] = d < K ? s_lw[d] : 0.f;

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;
  float gb = 0.f, hbb = 0.f, hbm[S], hbt[KD];   // source bb's row, apart
#pragma unroll
  for (int i = 0; i < S; ++i) hbm[i] = 0.f;
#pragma unroll
  for (int d = 0; d < KD; ++d) hbt[d] = 0.f;

  const float* obs_b = obs + (size_t)b * N;
  for (int n = rg.lo + threadIdx.x; n < rg.hi; n += NT) {
    // Corner combination (bt::tree_rows): per-source P and D; source bb's
    // value Pb, differences Dpb and cross differences Xp by a one-hot FMA
    // chain (exact: the other terms add zeros; a select on the runtime
    // index went through local memory); the other sources' m-weighted U,
    // DU, Xu; and the bb MC-count row's Nb, DN, XN
    float Pv[S];
    float Dv[KD][S];
    float Pb = 0.f, U = 0.f, Nb = 0.f;
    float Dpb[KD], DU[KD], DN[KD], Xp[NPD], Xu[NPD], XN[NPD];
#pragma unroll
    for (int d = 0; d < KD; ++d) Dpb[d] = DU[d] = DN[d] = 0.f;
#pragma unroll
    for (int p = 0; p < NPD; ++p) Xp[p] = Xu[p] = XN[p] = 0.f;
    tree_rows<S, K>(
        anchor, nme, N, n, s_rid, lw,
        [&](const auto& a) {
          Nb = a[0][0];
#pragma unroll
          for (int d = 0; d < K; ++d) DN[d] = a[1 + d][0];
#pragma unroll
          for (int p = 0; p < NP; ++p) XN[p] = a[1 + K + p][0];
        },
        [&](int s, const auto& a) {
          const float oh = s == bb ? 1.f : 0.f;
          const float mo = s == bb ? 0.f : s_m[s];
          Pv[s] = a[0][0];
          Pb = __fmaf_rn(oh, a[0][0], Pb);
          U = fmaf(mo, a[0][0], U);
#pragma unroll
          for (int d = 0; d < K; ++d) {
            Dv[d][s] = a[1 + d][0];
            Dpb[d] = __fmaf_rn(oh, a[1 + d][0], Dpb[d]);
            DU[d] = fmaf(mo, a[1 + d][0], DU[d]);
          }
#pragma unroll
          for (int p = 0; p < NP; ++p) {
            Xp[p] = __fmaf_rn(oh, a[1 + K + p][0], Xp[p]);
            Xu[p] = fmaf(mo, a[1 + K + p][0], Xu[p]);
          }
        });

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
    float dlt[KD];
#pragma unroll
    for (int d = 0; d < K; ++d)
      dlt[d] = bp.g[0] * Dpb[d] + bp.g[1] * DN[d] + bp.g[2] * DU[d]
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
    const float qg2 = q * bp.g[2], qg3 = q * bp.g[3];

    // g and the m rows of H, every source s taken as s != bb (J(m_s) =
    // (0, 0, P_s, 0, 0), dlam/dm_s = g2 P_s); source bb's row and column
    // (J(m_bb) = (0, 0, 0, 1, 0), dlam/dm_bb = g3) accumulate apart and
    // replace them after the loop:
    //   H(m_i, m_j) = (r22 - q g2^2) P_i P_j,
    //   H(m_bb, m_j) = (r23 - q g3 g2) P_j, H(m_bb, m_bb) = r33 - q g3^2,
    //   H(m_i, t_d) = P_i (W2_d - q g2 dl_d) + r g2 D[d][i]
    //     (d2U/dm_i dt_d = D[d][i]),
    //   H(m_bb, t_d) = W3_d - q g3 dl_d
#pragma unroll
    for (int i = 0; i < S; ++i) acc[1 + i] = fmaf(rg2, Pv[i], acc[1 + i]);
#pragma unroll
    for (int d = 0; d < K; ++d)
      acc[1 + S + d] = fmaf(r, dlt[d], acc[1 + S + d]);
    gb = fmaf(r, bp.g[3], gb);
    const float c22 = fmaf(-qg2, bp.g[2], r22);
    const float c23 = fmaf(-qg3, bp.g[2], r23);
    hbb += fmaf(-qg3, bp.g[3], r33);
    float V[KD];
#pragma unroll
    for (int d = 0; d < K; ++d) {
      V[d] = fmaf(-qg2, dlt[d], W2[d]);
      hbt[d] += fmaf(-qg3, dlt[d], W3[d]);
    }
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const float ci = c22 * Pv[i];
      hbm[i] = fmaf(c23, Pv[i], hbm[i]);
#pragma unroll
      for (int j = i; j < S; ++j)
        acc[1 + P + tri(P, i, j)] = fmaf(ci, Pv[j], acc[1 + P + tri(P, i, j)]);
#pragma unroll
      for (int d = 0; d < K; ++d) {
        float& h = acc[1 + P + tri(P, i, S + d)];
        h = fmaf(rg2, Dv[d][i], fmaf(Pv[i], V[d], h));
      }
    }
    // (t_d, t_e), with the inputs' cross-pair second differences
    {
      int p = 0;
#pragma unroll
      for (int d = 0; d < K; ++d) {
        const float qd = -q * dlt[d];
#pragma unroll
        for (int e = d; e < K; ++e) {
          float joj = Dpb[d] * W0[e] + DN[d] * W1[e] + DU[d] * W2[e]
                      + s_glob[1 + d] * W4[e];
          if (e > d) {
            joj += r * (bp.g[0] * Xp[p] + bp.g[1] * XN[p] + bp.g[2] * Xu[p]
                        + bp.g[4] * s_glob[1 + K + p]);
            ++p;
          }
          acc[1 + P + tri(P, S + d, S + e)] += fmaf(qd, dlt[e], joj);
        }
      }
    }
  }
  // Source bb's row and column of g and H
#pragma unroll
  for (int i = 0; i < S; ++i) {
    acc[1 + i] = i == bb ? gb : acc[1 + i];
#pragma unroll
    for (int j = i; j < S; ++j)
      acc[1 + P + tri(P, i, j)] =
          i == bb ? (j == bb ? hbb : hbm[j])
                  : (j == bb ? hbm[i] : acc[1 + P + tri(P, i, j)]);
#pragma unroll
    for (int d = 0; d < K; ++d)
      acc[1 + P + tri(P, i, S + d)] =
          i == bb ? hbt[d] : acc[1 + P + tri(P, i, S + d)];
  }

  cluster_vgh_sum<NV, NT>(acc, s_red, s_part, s_tot);
  if (rg.range == 0) {   // back from the reflected cell's coordinates
    if (threadIdx.x == 0) flip_vgh<S, K>(s_tot, s_flip);
    __syncthreads();
    store_vgh<P, NT>(s_tot, b, ll_out, g_out, h_out);
  }
}

// The value kernel, in the cell layout of bt_cells.cuh: one CTA per (toy,
// bin range[, candidate group]), a toy's ranges one cluster, candidates
// grouped by cell; per bin and cell the cell's C x (S+1) corner values
// (pmf rows and the MC-count row) are read once for all of its
// candidates (bt::mc_cell_pass). T is per candidate, summed in the
// prologue (c ascending, as the CTA-per-candidate kernel summed it).
template <int S, int K>
__global__ void __launch_bounds__(kMcThreads, 3)
bb_ll_kernel(int N, int A, int Acta, const float* __restrict__ anchor,
             const float* __restrict__ nme, const float* __restrict__ tot,
             int bb, const int* __restrict__ ids,
             const float* __restrict__ w, const float* __restrict__ m,
             const float* __restrict__ obs, float* __restrict__ ll_out) {
  constexpr int C = 1 << K;
  const CellBlock cb = cell_block(N, A, Acta);
  const int t = threadIdx.x;

  extern __shared__ float4 dyn4[];
  float* s_dev = reinterpret_cast<float*>(dyn4);  // [Acta][kMcThreads]
  __shared__ __align__(16) float s_w[kMaxActa * C];
  __shared__ float s_m[kMaxActa * S];
  __shared__ int s_ids[kMaxActa * C];
  __shared__ int s_lead[kMaxActa];
  __shared__ int s_order[kMaxActa];
  __shared__ float s_T[kMaxActa];
  __shared__ float s_tot[kMaxActa];
  stage_cells<S, C, kMcThreads>(cb, ids, w, m, s_ids, s_w, s_m, s_dev,
                                s_lead, s_order);
  if (t < cb.Aq) {   // T = sum_c w_c tot[id_c], in a fixed order
    float T = 0.f;
    for (int c = 0; c < C; ++c)
      T = fmaf(s_w[t * C + c], tot[s_ids[t * C + c]], T);
    s_T[t] = T;
  }
  __syncthreads();

  mc_cell_pass<S, K>(
      cb, anchor, nme, N, obs + (size_t)cb.b * N, s_ids, s_w, s_lead, s_order,
      s_dev, [&](int a, const float (&P)[S], float Nb, float k) {
        // Pb = P[bb] by a one-hot FMA chain (exact: the other terms add
        // zeros), which keeps P in registers where a select chain on the
        // runtime index went through local memory
        float Pb = 0.f, U = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          Pb = __fmaf_rn(s == bb ? 1.f : 0.f, P[s], Pb);
          U = s == bb ? U : fmaf(s_m[a * S + s], P[s], U);
        }
        const float lam = bb_lambda(Pb, Nb, U, s_m[a * S + bb], s_T[a], k);
        const float lam_safe = fmaxf(lam, FLT_MIN);
        const float k_safe = k > 0.f ? k : 1.f;
        return k * logf(lam_safe / k_safe) - (lam - k);
      });
  cell_sums<kMcThreads>(cb, s_dev, s_tot, ll_out);
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
  cudaError_t err = cudaSuccess;
#define BT_VGH_CASE(S_, K_)                                                \
  case (S_) * 8 + (K_):                                                    \
    err = launch_ranges<bb_vgh_kernel<S_, K_>, kVghThreads>(                \
        N, B, stream, anchor, nme, tot, N, bb, ids, w, wd, wx, m, obs, ll,  \
        g, h);                                                             \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_VGH_CASE)
    default:
      return -1;
  }
#undef BT_VGH_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int bt_bb_ll_multi(int S, int K, int N, int B, int A, int bb,
                   const float* anchor, const float* nme, const float* tot,
                   const int* ids, const float* w, const float* m,
                   const float* obs, float* ll, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  if (bb < 0 || bb >= S) return -1;
  cudaGetLastError();
  if (S < 1 || S > 8 || K < 0 || K > 4) return -1;
  if (N <= 0)
    return (int)cudaMemsetAsync(ll, 0, sizeof(float) * B * A, stream);
  cudaError_t err = cudaSuccess;
#define BT_LL_CASE(S_, K_)                                                 \
  case (S_) * 8 + (K_):                                                    \
    err = launch_cells<bb_ll_kernel<S_, K_>, kMcThreads>(                   \
        N, B, A, stream, anchor, nme, tot, bb, ids, w, m, obs, ll);        \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_LL_CASE)
  }
#undef BT_LL_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
