// Fused extended unbinned likelihood kernels for NVIDIA Hopper (sm_90a).
//
// Two contracts, each one kernel, each with a plain PyTorch twin in
// blueice_tpu_torch/ops/fused_unbinned.py (the batched closed form of
// ops/unbinned_vgh.py), which the wrapper uses for CPU tensors:
//
//   uvgh_kernel  extended unbinned ll, gradient g (P) and Hessian H (P x P)
//                in (m, t), P = S + K, one toy per block. Replaces the
//                Pallas kernels _uvgh_block_kernel
//                (blueice_tpu/ops/fused_unbinned.py:81, the G <= 16 block
//                flavor) and _uvgh_kernel (fused_unbinned.py:245, the
//                per-toy gather flavor).
//   ull_kernel   the same ll at A line-search candidates per lane, in the
//                cell layout of bt_cells.cuh: one block per (lane, event
//                range[, candidate group]), a lane's ranges one cluster,
//                the candidates of one grid cell sharing each load of its
//                corner rows. Replaces _ull_block_kernel
//                (fused_unbinned.py:156) and _ull_kernel
//                (fused_unbinned.py:332).
//
// Per toy b (the lane's entry of `lanes`) and event e:
//   lam_e  = sum_s m_s P_se(t),  P = sum_c w_c ps[b, id_c, s, e]
//   ll     = sum_e mask_e log(lam_eff_e * inv_ref_e) - moff
//            (lam_eff = lam where lam > 0, else outlier when outlier != 0;
//            moff = sum m - ref_msum, the centered rate term)
//   inv    = (mask & lam > 0) / lam,  q = inv / lam
//   g_m    = P inv - 1,  g_t = Dbar inv
//   H      = -v q v^T + [D inv on the (m, t) block, Xbar inv on (t, t)]
// with v = (P_1..P_S, Dbar_1..Dbar_K) and Xbar formed through each corner's
// lam_c = sum_s m_s ps[b, id_c, s, e], so no (pairs x S) table is held.
//
// What bounds them on an H100: streaming each toy's corner rows from HBM.
// Unlike the binned kernels, the density tensor is per toy (each toy
// scored its own events): (B, G, S, E) float32, 4.1 MB a toy at the XENON
// shape (G = 81, S = 6, E = n_max = 2,094), 1.04 GB at 256 toys, so it
// does not stay in the 50 MB L2. Both kernels skip masked events, so a vgh
// call reads C*S*4 B of corner rows per valid event (~1,830 a toy: 0.70 MB
// at K = 4, ~180 MB for 256 toys, ~54 us at 3.35 TB/s) and does ~2,400
// FLOPs per event (~10 us at 67 TFLOP/s float32): memory-bound. The
// value kernel reads a cell's rows once per event for all of the lane's
// candidates in that cell (a lane's candidates fall in a few cells): the
// rows, not the candidates, set its bytes; with few candidates a cell the
// per-candidate logarithm and the per-event loads set its pace (the
// Gaussian model's S = 2, K = 1: four floats a cell). The toy's entry of
// `lanes` is read in the kernel, so the fitter never copies a lane subset
// of the 1 GB tensor. Neighbouring threads take neighbouring events: every
// corner-row read is coalesced.
//
// Reductions: per-thread register accumulators, then a fixed-order block
// reduction (bt::block_sum) for the vgh; bt::cell_sums (per-candidate
// columns, a warp each, then the cluster's ranges in rank order) for the
// value. No float atomics, so a rerun on the same inputs is bit-identical.
// E is any length (no padding).
//
// Built by blueice_tpu_torch/ops/fused.py's build_library with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes; the C entry points return cudaGetLastError().

#include "bt_cells.cuh"
#include "bt_common.cuh"

namespace {

using namespace bt;

// lam_eff of the value: the outlier floor where lam is not positive (a nan
// lam takes the floor too), unless the floor is 0.
__device__ __forceinline__ float lam_eff(float lam, float outlier) {
  return (lam > 0.f || outlier == 0.f) ? lam : outlier;
}

template <int S, int K>
__global__ void __launch_bounds__(kThreads)
uvgh_kernel(const float* __restrict__ ps, int G, int E, float outlier,
            const long long* __restrict__ lanes, const int* __restrict__ ids,
            const float* __restrict__ w, const float* __restrict__ wd,
            const float* __restrict__ wx, const float* __restrict__ m,
            const unsigned char* __restrict__ mask,
            const float* __restrict__ inv_ref, const float* __restrict__ moff,
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

  const int l = blockIdx.x;
  const size_t b = (size_t)lanes[l];
  for (int i = threadIdx.x; i < C; i += kThreads) {
    s_ids[i] = ids[(size_t)l * C + i];
    s_w[i] = w[(size_t)l * C + i];
  }
  for (int i = threadIdx.x; i < K * C; i += kThreads)
    s_wd[i] = wd[(size_t)l * K * C + i];
  for (int i = threadIdx.x; i < NP * C; i += kThreads)
    s_wx[i] = wx[(size_t)l * NP * C + i];
  for (int i = threadIdx.x; i < S; i += kThreads) s_m[i] = m[(size_t)l * S + i];
  __syncthreads();

  float acc[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) acc[i] = 0.f;

  const size_t row = (size_t)S * E;
  const float* ps_b = ps + b * G * row;
  const unsigned char* mask_b = mask + b * E;
  const float* ir_b = inv_ref + b * E;
  for (int e = threadIdx.x; e < E; e += kThreads) {
    // A masked event adds nothing to ll, g or H: its rows are not read
    if (!mask_b[e]) continue;
    // Multilinear combination of the corner rows: P (S), D (K x S), and the
    // m-weighted cross-pair second derivatives Xbar (NP)
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
      const float* a = ps_b + (size_t)s_ids[c] * row + e;
      const float wc = s_w[c];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float x = __ldg(a + (size_t)s * E);
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

    const bool pos = lam > 0.f;
    acc[0] += logf(lam_eff(lam, outlier) * __ldg(ir_b + e));
    // Outlier-floored events are constant in the parameters
    const float lam_safe = pos ? lam : 1.f;
    const float inv = pos ? 1.f / lam_safe : 0.f;
    const float q = inv / lam_safe;

#pragma unroll
    for (int i = 0; i < P; ++i) {
      acc[1 + i] = fmaf(v[i], inv, acc[1 + i]);
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
            fmaf(Dv[d][s], inv, acc[1 + P + tri(P, s, S + d)]);
    {
      int p = 0;
#pragma unroll
      for (int d = 0; d < K; ++d)
#pragma unroll
        for (int f = d + 1; f < K; ++f, ++p)
          acc[1 + P + tri(P, S + d, S + f)] =
              fmaf(Xb[p], inv, acc[1 + P + tri(P, S + d, S + f)]);
    }
  }

  block_sum<NV>(acc, s_red, s_tot);
  // The rate term: -moff in the value, -1 in each rate's gradient
  if (threadIdx.x == 0) s_tot[0] -= moff[l];
  if (threadIdx.x < S) s_tot[1 + threadIdx.x] -= 1.f;
  __syncthreads();
  store_vgh<P>(s_tot, l, ll_out, g_out, h_out);
}

// ---------------------------------------------------------------------------
// The value kernel, in the cell layout of bt_cells.cuh: one CTA per (lane,
// event range[, candidate group]), a lane's event ranges one cluster,
// candidates grouped by grid cell (equal corner-id tuples). Per valid event
// the event's inv_ref is loaded once; per cell the cell's C x S corner
// values go into registers once (C*S independent loads in flight, coalesced
// over the threads' neighbouring events); then each candidate of the cell
// combines them (P_s = sum_c w_c X[c][s], c ascending, and lam = sum_s m_s
// P_s: the arithmetic of the CTA-per-candidate kernel it replaces, so every
// event's term is the same float) and adds log(lam_eff * inv_ref) to its
// column of s_dev. bt::cell_sums sums the columns in a fixed order (a warp
// a candidate, then the cluster's ranges in rank order) and subtracts the
// candidate's rate term moff. A lane's toy (lanes[l]) picks its event data
// (ps, mask, inv_ref); the tables, moff and the output are the lane's.
// Ranges split E evenly, so with a prefix mask the last ranges of a lane
// hold fewer valid events than the first. The range count comes from the
// rounds of the card times a CTA's trips (launch_cells<..., ByTrips>): it
// beat the value kernels' two-wave sizing on both paths' recorded calls.
// Measured slower or no faster on the H100 (PERF.md §6, PR 9): 128-thread
// CTAs, eight ranges a lane, the tables copied into cell order, the
// sources in two groups (80 registers at S = 6, K = 4, three CTAs an SM),
// ranges sized by the clusters the card holds; one logarithm per thread
// and candidate over a product of terms was faster on the Gaussian path
// at A = 12 and failed the agreement check.

constexpr int kUllThreads = 256;   // threads of a value CTA

template <int S, int K>
__global__ void __launch_bounds__(kUllThreads)
ull_kernel(int E, int A, int Acta, const float* __restrict__ ps, int G,
           float outlier, const long long* __restrict__ lanes,
           const int* __restrict__ ids, const float* __restrict__ w,
           const float* __restrict__ m,
           const unsigned char* __restrict__ mask,
           const float* __restrict__ inv_ref, const float* __restrict__ moff,
           float* __restrict__ ll_out) {
  constexpr int C = 1 << K;
  const CellBlock cb = cell_block(E, A, Acta);
  const int t = threadIdx.x;

  extern __shared__ float4 dyn4[];
  float* s_dev = reinterpret_cast<float*>(dyn4);  // [Acta][kUllThreads]
  __shared__ __align__(16) float s_w[kMaxActa * C];
  __shared__ float s_m[kMaxActa * S];
  __shared__ int s_ids[kMaxActa * C];
  __shared__ int s_lead[kMaxActa];
  __shared__ int s_order[kMaxActa];
  __shared__ float s_tot[kMaxActa];
  stage_cells<S, C, kUllThreads>(cb, ids, w, m, s_ids, s_w, s_m, s_dev,
                                 s_lead, s_order);

  const size_t b = (size_t)lanes[cb.b];   // the lane's toy
  const size_t row = (size_t)S * E;
  const float* ps_b = ps + b * G * row;
  const unsigned char* mask_b = mask + b * E;
  const float* ir_b = inv_ref + b * E;
  const int Aq = cb.Aq;

  for (int e = cb.lo + t; e < cb.hi; e += kUllThreads) {
    // A masked event adds nothing: its rows are not read
    if (!mask_b[e]) continue;
    const float ir = __ldg(ir_b + e);
    for (int i = 0; i < Aq;) {
      const int cell = s_lead[s_order[i]];
      float X[C][S];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float* x = ps_b + (size_t)s_ids[cell * C + c] * row + e;
#pragma unroll
        for (int s = 0; s < S; ++s) X[c][s] = __ldg(x + (size_t)s * E);
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
        s_dev[a * kUllThreads + t] += logf(lam_eff(lam, outlier) * ir);
        ++i;
      } while (i < Aq && s_lead[s_order[i]] == cell);
    }
  }
  cell_sums<kUllThreads, true>(cb, s_dev, s_tot, ll_out, moff);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success), or -1 when
// (S, K) is outside the instantiated range.
int bt_unbinned_vgh(int S, int K, int G, int E, int L, float outlier,
                    const float* ps, const long long* lanes, const int* ids,
                    const float* w, const float* wd, const float* wx,
                    const float* m, const unsigned char* mask,
                    const float* inv_ref, const float* moff, float* ll,
                    float* g, float* h, cudaStream_t stream) {
  if (L <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
#define BT_UVGH_CASE(S_, K_)                                                \
  case (S_) * 8 + (K_):                                                     \
    uvgh_kernel<S_, K_><<<L, kThreads, 0, stream>>>(                        \
        ps, G, E, outlier, lanes, ids, w, wd, wx, m, mask, inv_ref, moff,   \
        ll, g, h);                                                          \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_UVGH_CASE)
    default:
      return -1;
  }
#undef BT_UVGH_CASE
  return (int)cudaGetLastError();
}

int bt_unbinned_ll_multi(int S, int K, int G, int E, int L, int A,
                         float outlier, const float* ps,
                         const long long* lanes, const int* ids,
                         const float* w, const float* m,
                         const unsigned char* mask, const float* inv_ref,
                         const float* moff, float* ll, cudaStream_t stream) {
  if (L <= 0 || A <= 0) return 0;
  cudaGetLastError();
  if (S < 1 || S > 8 || K < 0 || K > 4) return -1;
  cudaError_t err = cudaSuccess;
#define BT_ULL_CASE(S_, K_)                                                 \
  case (S_) * 8 + (K_):                                                     \
    err = launch_cells<ull_kernel<S_, K_>, kUllThreads, true>(               \
        E, L, A, stream, ps, G, outlier, lanes, ids, w, m, mask, inv_ref,   \
        moff, ll);                                                          \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_ULL_CASE)
  }
#undef BT_ULL_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
