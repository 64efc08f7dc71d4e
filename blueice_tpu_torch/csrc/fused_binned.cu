// Fused binned Poisson likelihood kernels for NVIDIA Hopper (sm_90a).
//
// Two contracts, each one kernel, each with a plain PyTorch twin in
// blueice_tpu_torch/ops/fused.py (the batched closed form of
// ops/binned_vgh.py), which the wrapper uses for CPU tensors:
//
//   vgh_kernel   deviance-form ll, gradient g (P) and Hessian H (P x P) in
//                (m, t), P = S + K, one block per (toy, bin range), a
//                toy's ranges one cluster (the bin ranges of
//                bt_ranges.cuh), the corner rows combined by lerp steps
//                (bt::corner_tree). Replaces the Pallas
//                kernels _vgh_kernel (blueice_tpu/ops/fused.py:144, gather
//                flavor) and _vgh_kernel_dense (fused.py:597, dense flavor).
//   ll_kernel    deviance-form ll at A line-search candidates per toy, one
//                block per (toy, bin range), the candidates of one grid
//                cell sharing each load of its corner rows (the cell
//                layout of bt_cells.cuh). Replaces _ll_kernel
//                (fused.py:251) and _ll_kernel_dense (fused.py:690).
//
// What bounds them on an H100: the corner gathers. Every bin of every toy
// reads its C = 2^K corner values for each of the S sources from the anchor
// tensor (G, S, N): C*S*N*4 bytes per toy per vgh, about 1.2 MB at the
// XENON shape (G = 81, S = 6, N = 3100, K = 4), 0.6 GB for 512 toys. The
// TPU kernels kept the 6 MB anchor tensor resident in VMEM; a block here
// has at most 227 KB of shared memory, so the anchor tensor stays in global
// memory and is served from the 50 MB L2 (it fits many times over).
// Neighbouring threads take neighbouring bins, so every gather is a
// coalesced row read. vgh_kernel's per-bin work is the corner tree (value,
// K differences and K(K-1)/2 cross differences of each row, 62 operations
// a row at K = 4 where the weight tables took 176 FMAs) and the
// (S+K)(S+K+1)/2 Hessian updates: float32 issue and the latency of the
// gathers bound it. ll_kernel reads a cell's corner values once
// per bin for all of the toy's candidates in that cell, so where they share
// cells the float32 FMA rate bounds it.
//
// Reductions: fixed order everywhere (bt::block_sum and the cluster's
// ranges in rank order, bt::cluster_vgh_sum, for vgh_kernel; warp
// shuffles, the warps in order and the cluster's blocks in rank order for
// ll_kernel), no float atomics, so a rerun on the same inputs is
// bit-identical.
//
// Semantics kept exactly from the reference: lambda floored at FLT_MIN
// inside the log, the 1e6 linear penalty on negative expectations (in value
// and in r), and r = -1 in empty-model bins.
//
// Built by blueice_tpu_torch/ops/fused.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes; the C entry points return cudaGetLastError().

#include "bt_cells.cuh"
#include "bt_common.cuh"

namespace {

using namespace bt;

// ---------------------------------------------------------------------------
// The vgh kernel, in the bin ranges of bt_ranges.cuh: one CTA of
// kVghThreads per (toy, bin range), two an SM, a toy's ranges one cluster
// summed in rank order (bt::cluster_vgh_sum2), the range count per call
// from the batch and the clusters of each size that the card holds at once
// (bt::launch_range_clusters: the Newton loop's few live lanes still fill
// the card, and a range count whose clusters do not pack the GPCs is not
// taken). Per bin the toy's C corner rows of each source, loaded at 32-bit
// offsets from the anchor tensor (bt::tree_pmf_rows), combine by
// bt::corner_tree's lerp steps over the reflected cell (bt::tree_cell; the
// lerp weights recovered from the corner weights, so a fit next to an
// anchor keeps the weight tables' precision): the value P_s, the
// differences D_ds and the cross differences of each pair, m-weighted into
// lambda, Dbar and Xbar. Then the deviance closed form:
//   r = k / lambda - 1 (+ kPenalty where lambda < 0), q = k / lambda^2,
//   g = v r,  H = -q v v^T + [D r on the (m, t) block, Xbar r on (t, t)],
// v = (P_1..P_S, Dbar_1..Dbar_K), accumulated in the reflected cell's
// coordinates and flipped back as they are stored. g accumulates in
// double (the float products v r added exactly): at a converged fit a
// t-gradient is a sum of large terms of both signs that nearly cancel,
// and float32 sums lose what is left to their order. wd and
// wx, the weight tables' derivatives, are not read. Measured slower on the
// H100 (PERF.md §6, PR 9): 128-thread CTAs held to three an SM (168
// registers), 96-thread CTAs (four an SM: faster at 512 toys, slower on
// the few-lane calls), clusters of up to 16 ranges.

template <int S, int K>
__global__ void __launch_bounds__(kVghThreads, kVghBlocks)
vgh_kernel(const float* __restrict__ anchor, int N,
           const int* __restrict__ ids, const float* __restrict__ w,
           const float* __restrict__ m, const float* __restrict__ obs,
           float* __restrict__ ll_out, float* __restrict__ g_out,
           float* __restrict__ h_out) {
  constexpr int C = 1 << K;
  constexpr int NP = K * (K - 1) / 2;
  constexpr int P = S + K;
  constexpr int NH = P * (P + 1) / 2;
  constexpr int NF = 1 + NH;          // the float sums: ll, packed upper H
  constexpr int KD = K > 0 ? K : 1;   // no zero-length arrays
  constexpr int NPD = NP > 0 ? NP : 1;
  constexpr int NT = kVghThreads;

  __shared__ int s_ids[C];
  __shared__ float s_w[C];
  __shared__ float s_m[S];
  __shared__ int s_rid[C], s_flip;
  __shared__ float s_lw[KD];
  __shared__ float s_red[NT / 32 * NF];
  __shared__ float s_part[NF];
  __shared__ float s_ftot[NF];
  __shared__ double s_gred[NT / 32 * P];
  __shared__ double s_gpart[P];
  __shared__ double s_gtot[P];

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
  unsigned rofs[C];   // corner c's first row, in floats into anchor
#pragma unroll
  for (int c = 0; c < C; ++c) rofs[c] = (unsigned)s_rid[c] * S * N;

  float acc[NF];     // ll, packed upper H
  double gacc[P];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) gacc[i] = 0.0;

  const float* obs_b = obs + (size_t)b * N;
  for (int n = rg.lo + threadIdx.x; n < rg.hi; n += NT) {
    // Corner combination (bt::tree_pmf_rows): P (S), D (K x S), and the
    // m-weighted lambda, Dbar (K) and cross-pair second differences Xb (NP)
    float Pv[S];
    float Dv[KD][S];
    float lam = 0.f, Dbar[KD], Xb[NPD];
#pragma unroll
    for (int d = 0; d < KD; ++d) Dbar[d] = 0.f;
#pragma unroll
    for (int p = 0; p < NPD; ++p) Xb[p] = 0.f;
    tree_pmf_rows<S, K>(anchor, N, n, rofs, lw, [&](int s, const auto& a) {
      const float ms = s_m[s];
      Pv[s] = a[0][0];
      lam = fmaf(ms, a[0][0], lam);
#pragma unroll
      for (int d = 0; d < K; ++d) {
        Dv[d][s] = a[1 + d][0];
        Dbar[d] = fmaf(ms, a[1 + d][0], Dbar[d]);
      }
#pragma unroll
      for (int p = 0; p < NP; ++p) Xb[p] = fmaf(ms, a[1 + K + p][0], Xb[p]);
    });

    // v = dlambda/d(m, t): [P_1..P_S, Dbar_1..Dbar_K]
    float v[P];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = Pv[s];
#pragma unroll
    for (int d = 0; d < K; ++d) v[S + d] = Dbar[d];

    const float k = obs_b[n];
    const float lam_safe = fmaxf(lam, FLT_MIN);
    const float k_safe = k > 0.f ? k : 1.f;
    acc[0] += k * logf(lam_safe / k_safe) - (lam - k)
              + kPenalty * fminf(lam, 0.f);
    const float inv = 1.f / lam_safe;
    const float r = k * inv - 1.f + (lam < 0.f ? kPenalty : 0.f);
    const float q = k * inv * inv;

    const double rd = r;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      gacc[i] = fma((double)v[i], rd, gacc[i]);
      const float qi = -q * v[i];
#pragma unroll
      for (int j = i; j < P; ++j)
        acc[1 + tri(P, i, j)] = fmaf(qi, v[j], acc[1 + tri(P, i, j)]);
    }
    // Second-derivative terms: d2lam/dm_s dt_d = D_ds, d2lam/dt_d dt_e = Xbar
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int d = 0; d < K; ++d)
        acc[1 + tri(P, s, S + d)] =
            fmaf(Dv[d][s], r, acc[1 + tri(P, s, S + d)]);
#pragma unroll
    for (int d = 0; d < K; ++d)
#pragma unroll
      for (int e = d + 1; e < K; ++e)
        acc[1 + tri(P, S + d, S + e)] =
            fmaf(Xb[pair_id<K>(d, e)], r, acc[1 + tri(P, S + d, S + e)]);
  }

  cluster_vgh_sum2<NF, P, NT>(acc, s_red, s_part, s_ftot, gacc, s_gred,
                              s_gpart, s_gtot);
  if (rg.range == 0) {   // ll, g and H, back from the reflected cell's
    // coordinates as they are stored: an entry of a reflected axis's t
    // changes sign (flip_vgh's products, exactly)
    const int flip = s_flip;
    auto sign = [&](int i) {
      return i < S ? 1.f : flip_sign<K>(flip, i - S);
    };
    if (threadIdx.x == 0) ll_out[b] = s_ftot[0];
    for (int i = threadIdx.x; i < P; i += NT)
      g_out[(size_t)b * P + i] = sign(i) * (float)s_gtot[i];
    for (int ij = threadIdx.x; ij < P * P; ij += NT) {
      const int i = ij / P, j = ij % P;
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      h_out[(size_t)b * P * P + ij] =
          sign(i) * sign(j) * s_ftot[1 + tri(P, lo, hi)];
    }
  }
}

// ---------------------------------------------------------------------------
// The value kernel, in the cell layout of bt_cells.cuh (one CTA per (toy,
// bin range[, candidate group]), a toy's ranges one cluster, candidates
// grouped by cell). Its per-bin pass: per bin and cell the cell's C x S
// corner values go into registers once (C*S independent loads in flight,
// coalesced over the threads' neighbouring bins), then every candidate of
// the cell is evaluated from them: lambda = sum_s m_s sum_c w_c X[c][s]
// (the weights from shared memory as broadcasts), and its deviance term.
// So the FMAs, not the loads, set the pace once candidates share cells.
//
// Measured slower on the H100 and not kept (PERF.md §6): staging a
// toy's distinct rows in shared memory (cp.async) for a dense product of
// every candidate with every row of the union (up to 5x the FMAs at random
// corners, a barrier per staged row), the same product with the rows
// loaded into registers, and per-source loads with the lambdas in shared
// memory (fewer registers, more shared-memory traffic).

constexpr int kLLThreads = 256;   // threads of a value CTA

template <int S, int K>
__global__ void __launch_bounds__(kLLThreads)
ll_kernel(int N, int A, int Acta, const float* __restrict__ anchor,
          const int* __restrict__ ids, const float* __restrict__ w,
          const float* __restrict__ m, const float* __restrict__ obs,
          float* __restrict__ ll_out) {
  constexpr int C = 1 << K;
  const CellBlock cb = cell_block(N, A, Acta);
  const int t = threadIdx.x;

  // s_dev holds the threads' deviance sums, one column a thread
  extern __shared__ float4 dyn4[];
  float* s_dev = reinterpret_cast<float*>(dyn4);  // [Acta][kLLThreads]
  __shared__ __align__(16) float s_w[kMaxActa * C];
  __shared__ float s_m[kMaxActa * S];
  __shared__ int s_ids[kMaxActa * C];
  __shared__ int s_lead[kMaxActa];
  __shared__ int s_order[kMaxActa];
  __shared__ float s_tot[kMaxActa];
  stage_cells<S, C, kLLThreads>(cb, ids, w, m, s_ids, s_w, s_m, s_dev,
                                s_lead, s_order);

  const float* obs_b = obs + (size_t)cb.b * N;
  const size_t row = (size_t)S * N;
  const int Aq = cb.Aq;

  for (int n = cb.lo + t; n < cb.hi; n += kLLThreads) {
    const float k = obs_b[n];
    const float k_safe = k > 0.f ? k : 1.f;
    for (int i = 0; i < Aq;) {
      const int cell = s_lead[s_order[i]];
      float X[C][S];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* x = anchor + (size_t)s_ids[cell * C + c] * row + n;
#pragma unroll
        for (int s = 0; s < S; ++s) X[c][s] = __ldg(x + (size_t)s * N);
      }
      do {   // every candidate of the cell
        const int a = s_order[i];
        float P[S];
#pragma unroll
        for (int s = 0; s < S; ++s) P[s] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float wc = s_w[a * C + c];
#pragma unroll
          for (int s = 0; s < S; ++s) P[s] = fmaf(wc, X[c][s], P[s]);
        }
        float lam = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) lam = fmaf(s_m[a * S + s], P[s], lam);
        const float lam_safe = fmaxf(lam, FLT_MIN);
        s_dev[a * kLLThreads + t] += k * logf(lam_safe / k_safe) - (lam - k)
                                     + kPenalty * fminf(lam, 0.f);
        ++i;
      } while (i < Aq && s_lead[s_order[i]] == cell);
    }
  }
  cell_sums<kLLThreads>(cb, s_dev, s_tot, ll_out);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or -1 when
// (S, K) is outside the instantiated range. wd and wx (the corner weights'
// derivatives) are not read: the kernel takes the differences by its
// corner tree. Precondition, not checked here (the entry is not given the
// anchor tensor's length): the anchor tensor (G, S, N) holds fewer than
// 2^32 floats, as the kernel addresses its rows at 32-bit offsets; the
// Python launcher (ops/fused.py binned_vgh_launcher) raises otherwise. A
// larger tensor here would read wrapped addresses without an error.
int bt_binned_vgh(int S, int K, int N, int B, const float* anchor,
                  const int* ids, const float* w, const float* wd,
                  const float* wx, const float* m, const float* obs,
                  float* ll, float* g, float* h, cudaStream_t stream) {
  if (B <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
  cudaError_t err = cudaSuccess;
#define BT_VGH_CASE(S_, K_)                                                 \
  case (S_) * 8 + (K_):                                                     \
    err = launch_range_clusters<vgh_kernel<S_, K_>, kVghThreads>(            \
        N, B, stream, anchor, N, ids, w, m, obs, ll, g, h);                 \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_VGH_CASE)
    default:
      return -1;
  }
#undef BT_VGH_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

int bt_binned_ll_multi(int S, int K, int N, int B, int A, const float* anchor,
                       const int* ids, const float* w, const float* m,
                       const float* obs, float* ll, cudaStream_t stream) {
  if (B <= 0 || A <= 0) return 0;
  cudaGetLastError();
  if (S < 1 || S > 8 || K < 0 || K > 4) return -1;
  if (N <= 0)
    return (int)cudaMemsetAsync(ll, 0, sizeof(float) * B * A, stream);
  cudaError_t err = cudaSuccess;
#define BT_LL_CASE(S_, K_)                                                  \
  case (S_) * 8 + (K_):                                                     \
    err = launch_cells<ll_kernel<S_, K_>, kLLThreads>(                      \
        N, B, A, stream, anchor, ids, w, m, obs, ll);                       \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_LL_CASE)
  }
#undef BT_LL_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
