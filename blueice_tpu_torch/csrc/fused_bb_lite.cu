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
//                      expectation, gamma = (k + M) / (lam + M), in the bin
//                      ranges of bt_ranges.cuh (one block per toy and bin
//                      range, a toy's ranges one cluster). Replaces the
//                      Pallas kernels _bblite_vgh_kernel
//                      (blueice_tpu/ops/fused_bb_lite.py:154, gather flavor)
//                      and _bblite_vgh_kernel_dense (fused_bb_lite.py:417,
//                      dense flavor).
//   bblite_ll_kernel   the same ll at A line-search candidates per toy, in
//                      the cell layout of bt_cells.cuh (one block per toy
//                      and bin range, the candidates of one grid cell
//                      sharing each load of its corner rows). Replaces
//                      _bblite_ll_kernel (fused_bb_lite.py:189) and
//                      _bblite_ll_kernel_dense (fused_bb_lite.py:511).
//
// Per bin: the 2^K corner rows of the pmf anchors (G, S, N) and of the
// total MC counts (G, N) (summed over sources on the host) combine into
// lam = sum_s m_s P_s and M (the vgh by bt::corner_tree's lerp steps, at
// the lerp weights it recovers from the corner weights; the value kernel by
// the corner weights), and the closed forms of
// blueice_tpu/ops/bb_lite.py:_per_bin_parts give the value and its first
// and second derivatives in (lam, M), chained to (m, t) through the
// corner differences. The negative-expectation penalty (1e6 * lam in
// value, 1e6 in d/dlam where lam < 0) is kept, as in the reference.
// lite_parts lives in bt_perbin.cuh, shared with the op-mix probe
// (op_mix.cu).
//
// What bounds them on an H100: float32 issue and the latency of the corner
// gathers, (S + 1) * 2^K rows per bin, served from the 50 MB L2;
// neighbouring threads take neighbouring bins, so every gather is a
// coalesced row read. The vgh kernel runs on the Newton loop's live lanes,
// often under 132 toys: a toy's bins split over up to 8 blocks of 128
// threads (bt_ranges.cuh, as many as the batch needs to fill the card).
// The value kernel reads a cell's rows once per bin for all of the toy's
// candidates in that cell, so where they share cells the per-candidate
// combine and lite_parts set its pace. No global sums are needed.
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

template <int S, int K>
__global__ void __launch_bounds__(kVghThreads, kVghBlocks)
bblite_vgh_kernel(const float* __restrict__ anchor,
                  const float* __restrict__ nme, int N,
                  const int* __restrict__ ids, const float* __restrict__ w,
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
  __shared__ float s_w[C];
  __shared__ float s_m[S];
  __shared__ int s_rid[C], s_flip;
  __shared__ float s_lw[KD];
  __shared__ float s_red[NT / 32 * NV];
  __shared__ float s_part[NV];
  __shared__ float s_tot[NV];

  const BinRange rg = bin_range(N);
  const int b = blockIdx.x / rg.T;
  for (int i = threadIdx.x; i < C; i += NT) {
    s_ids[i] = ids[(size_t)b * C + i];
    s_w[i] = w[(size_t)b * C + i];
  }
  for (int i = threadIdx.x; i < S; i += NT) s_m[i] = m[(size_t)b * S + i];
  __syncthreads();
  tree_cell<K>(s_ids, s_w, s_rid, s_lw, &s_flip);
  __syncthreads();
  float lw[KD];
#pragma unroll
  for (int d = 0; d < KD; ++d) lw[d] = d < K ? s_lw[d] : 0.f;

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  const float* obs_b = obs + (size_t)b * N;
  for (int n = rg.lo + threadIdx.x; n < rg.hi; n += NT) {
    // Corner combination (bt::tree_rows): P (S), D (K x S), the m-weighted
    // lam, Dbar and cross-pair second differences Xb, and the total-count
    // row's Mn, DM, XM
    float Pv[S];
    float Dv[KD][S];
    float lam = 0.f, Mn = 0.f;
    float Dbar[KD], DM[KD], Xb[NPD], XM[NPD];
#pragma unroll
    for (int d = 0; d < KD; ++d) Dbar[d] = DM[d] = 0.f;
#pragma unroll
    for (int p = 0; p < NPD; ++p) Xb[p] = XM[p] = 0.f;
    tree_rows<S, K>(
        anchor, nme, N, n, s_rid, lw,
        [&](const auto& a) {
          Mn = a[0][0];
#pragma unroll
          for (int d = 0; d < K; ++d) DM[d] = a[1 + d][0];
#pragma unroll
          for (int p = 0; p < NP; ++p) XM[p] = a[1 + K + p][0];
        },
        [&](int s, const auto& a) {
          const float ms = s_m[s];
          Pv[s] = a[0][0];
          lam = fmaf(ms, a[0][0], lam);
#pragma unroll
          for (int d = 0; d < K; ++d) {
            Dv[d][s] = a[1 + d][0];
            Dbar[d] = fmaf(ms, a[1 + d][0], Dbar[d]);
          }
#pragma unroll
          for (int p = 0; p < NP; ++p)
            Xb[p] = fmaf(ms, a[1 + K + p][0], Xb[p]);
        });

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
      for (int d = 0; d < K; ++d) {
        float& h = acc[1 + P + tri(P, i, S + d)];
        h = fmaf(Dv[d][i], lp.f_lam, fmaf(Pv[i], Vl[d], h));
      }
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
// (pmf rows and the MC-total row) are read once for all of its
// candidates (bt::mc_cell_pass).
template <int S, int K>
__global__ void __launch_bounds__(kMcThreads, 3)
bblite_ll_kernel(int N, int A, int Acta, const float* __restrict__ anchor,
                 const float* __restrict__ nme, const int* __restrict__ ids,
                 const float* __restrict__ w, const float* __restrict__ m,
                 const float* __restrict__ obs, float* __restrict__ ll_out) {
  constexpr int C = 1 << K;
  const CellBlock cb = cell_block(N, A, Acta);

  extern __shared__ float4 dyn4[];
  float* s_dev = reinterpret_cast<float*>(dyn4);  // [Acta][kMcThreads]
  __shared__ __align__(16) float s_w[kMaxActa * C];
  __shared__ float s_m[kMaxActa * S];
  __shared__ int s_ids[kMaxActa * C];
  __shared__ int s_lead[kMaxActa];
  __shared__ int s_order[kMaxActa];
  __shared__ float s_tot[kMaxActa];
  stage_cells<S, C, kMcThreads>(cb, ids, w, m, s_ids, s_w, s_m, s_dev,
                                s_lead, s_order);

  mc_cell_pass<S, K>(
      cb, anchor, nme, N, obs + (size_t)cb.b * N, s_ids, s_w, s_lead, s_order,
      s_dev, [&](int a, const float (&P)[S], float Mn, float k) {
        float lam = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) lam = fmaf(s_m[a * S + s], P[s], lam);
        return lite_parts(lam, Mn, k).value;
      });
  cell_sums<kMcThreads>(cb, s_dev, s_tot, ll_out);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or -1 when
// (S, K) is outside the instantiated range. wd and wx (the corner weights'
// derivatives) are not read: the kernel takes the differences by its
// corner tree.
int bt_bblite_vgh(int S, int K, int N, int B, const float* anchor,
                  const float* nme, const int* ids, const float* w,
                  const float* wd, const float* wx, const float* m,
                  const float* obs, float* ll, float* g, float* h,
                  cudaStream_t stream) {
  if (B <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
  cudaError_t err = cudaSuccess;
#define BT_VGH_CASE(S_, K_)                                                \
  case (S_) * 8 + (K_):                                                    \
    err = launch_ranges<bblite_vgh_kernel<S_, K_>, kVghThreads>(            \
        N, B, stream, anchor, nme, N, ids, w, m, obs, ll, g, h);           \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_VGH_CASE)
    default:
      return -1;
  }
#undef BT_VGH_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int bt_bblite_ll_multi(int S, int K, int N, int B, int A,
                       const float* anchor, const float* nme, const int* ids,
                       const float* w, const float* m, const float* obs,
                       float* ll, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  cudaGetLastError();
  if (S < 1 || S > 8 || K < 0 || K > 4) return -1;
  if (N <= 0)
    return (int)cudaMemsetAsync(ll, 0, sizeof(float) * B * A, stream);
  cudaError_t err = cudaSuccess;
#define BT_LL_CASE(S_, K_)                                                 \
  case (S_) * 8 + (K_):                                                    \
    err = launch_cells<bblite_ll_kernel<S_, K_>, kMcThreads>(               \
        N, B, A, stream, anchor, nme, ids, w, m, obs, ll);                 \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_LL_CASE)
  }
#undef BT_LL_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
