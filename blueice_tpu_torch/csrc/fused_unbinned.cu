// Fused extended unbinned likelihood kernels for NVIDIA Hopper (sm_90a).
//
// Two contracts, each one kernel, each with a plain PyTorch twin in
// blueice_tpu_torch/ops/fused_unbinned.py (the batched closed form of
// ops/unbinned_vgh.py), which the wrapper uses for CPU tensors:
//
//   uvgh_kernel  extended unbinned ll, gradient g (P) and Hessian H (P x P)
//                in (m, t), P = S + K, one block per (lane, event range),
//                a lane's ranges one cluster (the ranges of bt_ranges.cuh
//                over events), the corner rows combined by lerp steps
//                (bt::corner_tree). Replaces the Pallas kernels
//                _uvgh_block_kernel (blueice_tpu/ops/fused_unbinned.py:81,
//                the G <= 16 block flavor) and _uvgh_kernel
//                (fused_unbinned.py:245, the per-toy gather flavor).
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
// with v = (P_1..P_S, Dbar_1..Dbar_K), D and Xbar the first and cross
// second differences of the corner rows, m-weighted into Dbar and Xbar.
//
// What bounds them on an H100: streaming each toy's corner rows from HBM.
// Unlike the binned kernels, the density tensor is per toy (each toy
// scored its own events): (B, G, S, E) float32, 4.1 MB a toy at the XENON
// shape (G = 81, S = 6, E = n_max = 2,094), 1.04 GB at 256 toys, so it
// does not stay in the 50 MB L2. Both kernels skip masked events, so a vgh
// call reads C*S*4 B of corner rows per valid event (~1,830 a toy: 0.70 MB
// at K = 4, ~180 MB for 256 toys, ~54 us at 3.35 TB/s) and does ~890
// float32 operations per event by the corner tree (0.42 GFLOP, ~6 us at
// 67 TFLOP/s): memory-bound. The Newton loop's calls have few lanes (56
// on average on the XENON path), so the vgh kernel splits each lane's
// events over a cluster of blocks to keep the card's SMs reading. The
// value kernel reads a cell's rows once per event for all of the lane's
// candidates in that cell (a lane's candidates fall in a few cells): the
// rows, not the candidates, set its bytes; with few candidates a cell the
// per-candidate logarithm and the per-event loads set its pace (the
// Gaussian model's S = 2, K = 1: four floats a cell). The toy's entry of
// `lanes` is read in the kernel, so the fitter never copies a lane subset
// of the 1 GB tensor. Neighbouring threads take neighbouring events: every
// corner-row read is coalesced.
//
// Reductions: per-thread register accumulators, then fixed-order sums:
// over the block's warps and the cluster's ranges in rank order
// (bt::cluster_vgh_sum2; g in double) for the vgh; bt::cell_sums
// (per-candidate columns, a warp each, then the cluster's ranges in rank
// order) for the value. No float atomics, so a rerun on the same inputs is
// bit-identical. E is any length (no padding).
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

// ---------------------------------------------------------------------------
// The vgh kernel, in the ranges of bt_ranges.cuh over events: one CTA of
// kVghThreads per (lane, event range), a lane's ranges one cluster summed
// in rank order (bt::cluster_vgh_sum2), the range count per call from the
// lanes and the clusters of each size that the card holds at once
// (bt::launch_range_clusters), as for the binned vgh_kernel: the Newton
// loop's few lanes still fill the card. The lane's toy (lanes[l]) picks
// its event data (ps, mask, inv_ref); the tables, m, moff and the outputs
// are the lane's. Ranges split E evenly, so with the sampler's prefix mask
// the last ranges of a lane hold fewer valid events. Per valid event the
// toy's C corner rows of each source, loaded at 32-bit offsets from the
// toy's (G, S, E) block (the offsets in shared memory: in registers they
// take the kernel past 255 registers at S = 6, K = 4), combine by
// bt::corner_tree's lerp steps over the reflected cell (bt::tree_cell): the
// value P_s, the differences D_ds and the cross differences of each pair,
// m-weighted into lambda, Dbar and Xbar. g, H accumulate in the reflected
// cell's coordinates and are flipped back as they are stored; g
// accumulates in double (the float products v inv added exactly): at a
// converged fit g_m = sum_e P_se / lam_e - 1 nearly cancels. Rank 0
// subtracts the rate terms (moff from ll, 1 from each rate's g, in double)
// as it stores. A trip's masks are loaded a trip ahead, and the toy's
// index before the tables are staged, so a trip waits on one round of
// loads. Measured slower or no faster on the H100 (PERF.md §6):
// 96- and 256-thread CTAs, ranges sized by rounds x trips
// (bt::launch_ranges), the logarithm after the Hessian's sums; for few
// rows an event, one or four events a trip, 256-thread CTAs, or two
// CTAs an SM.

// The launch shape by the corner rows an event reads: an event of few
// (C * S <= 8, the Gaussian model's four) leaves a thread waiting on its
// loads, so a thread takes two events a trip, their loads in flight
// together, and its CTA is held to 64 registers, eight an SM
template <int S, int K>
struct UvghShape {
  static constexpr bool kFewRows = (1 << K) * S <= 8;
  static constexpr int kEvents = kFewRows ? 2 : 1;   // events a trip
  static constexpr int kBlocks = kFewRows ? 8 : kVghBlocks;
};

template <int S, int K>
__global__ void __launch_bounds__(kVghThreads, UvghShape<S, K>::kBlocks)
uvgh_kernel(const float* __restrict__ ps, int G, int E, float outlier,
            const long long* __restrict__ lanes, const int* __restrict__ ids,
            const float* __restrict__ w, const float* __restrict__ m,
            const unsigned char* __restrict__ mask,
            const float* __restrict__ inv_ref, const float* __restrict__ moff,
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
  constexpr int U = UvghShape<S, K>::kEvents;

  __shared__ int s_ids[C];
  __shared__ float s_w[C];
  __shared__ float s_m[S];
  __shared__ int s_rid[C], s_flip;
  __shared__ unsigned s_rofs[C];
  __shared__ float s_lw[KD];
  __shared__ float s_red[NT / 32 * NF];
  __shared__ float s_part[NF];
  __shared__ float s_ftot[NF];
  __shared__ double s_gred[NT / 32 * P];
  __shared__ double s_gpart[P];
  __shared__ double s_gtot[P];

  const BinRange rg = bin_range(E);
  const int l = blockIdx.x / rg.T;
  // The lane's toy and the first trip's masks first: their loads are in
  // flight while the tables are staged
  const size_t b = (size_t)lanes[l];
  const float* ps_b = ps + b * G * S * E;
  const unsigned be = (unsigned)(b * E);   // the toy's first event
  int e = rg.lo + threadIdx.x;
  bool valid[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    valid[u] = e + u * NT < rg.hi && mask[be + e + u * NT];
  for (int i = threadIdx.x; i < C; i += NT) {
    s_ids[i] = ids[(size_t)l * C + i];
    s_w[i] = w[(size_t)l * C + i];
  }
  for (int i = threadIdx.x; i < S; i += NT) s_m[i] = m[(size_t)l * S + i];
  __syncthreads();
  tree_cell<K>(s_ids, s_w, s_rid, s_lw, &s_flip);
  // corner c's first row, in floats into the toy's (G, S, E) block (thread
  // c wrote s_rid[c])
  if (threadIdx.x < C)
    s_rofs[threadIdx.x] = (unsigned)s_rid[threadIdx.x] * S * E;
  __syncthreads();
  float lw[KD];
#pragma unroll
  for (int d = 0; d < KD; ++d) lw[d] = d < K ? s_lw[d] : 0.f;

  float acc[NF];     // ll, packed upper H
  double gacc[P];
#pragma unroll
  for (int i = 0; i < NF; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < P; ++i) gacc[i] = 0.0;

  // Event e's terms where ok; where not, its loads are not issued and it
  // adds zeros (lam = 0: inv = 0 and v = 0), exactly
  auto event = [&](int e, bool ok) {
    const float ir = ok ? __ldg(inv_ref + (be + e)) : 1.f;
    // Corner combination (bt::corner_tree over each source's C corner
    // rows, as bt::tree_pmf_rows with its loads predicated): P (S), D
    // (K x S), and the m-weighted lambda, Dbar (K) and cross-pair second
    // differences Xb (NP)
    float Pv[S];
    float Dv[KD][S];
    float lam = 0.f, Dbar[KD], Xb[NPD];
#pragma unroll
    for (int d = 0; d < KD; ++d) Dbar[d] = 0.f;
#pragma unroll
    for (int p = 0; p < NPD; ++p) Xb[p] = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const unsigned base = (unsigned)s * E + e;
      float a[Tree<K>::NM][C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        a[0][c] = ok ? __ldg(ps_b + (s_rofs[c] + base)) : 0.f;
      corner_tree<K>(a, lw);
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
    }

    // v = dlambda/d(m, t): [P_1..P_S, Dbar_1..Dbar_K]
    float v[P];
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = Pv[s];
#pragma unroll
    for (int d = 0; d < K; ++d) v[S + d] = Dbar[d];

    const bool pos = lam > 0.f;
    acc[0] += ok ? logf(lam_eff(lam, outlier) * ir) : 0.f;
    // Outlier-floored events are constant in the parameters
    const float lam_safe = pos ? lam : 1.f;
    const float inv = pos ? 1.f / lam_safe : 0.f;
    const float q = inv / lam_safe;

    const double invd = inv;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      gacc[i] = fma((double)v[i], invd, gacc[i]);
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
            fmaf(Dv[d][s], inv, acc[1 + tri(P, s, S + d)]);
#pragma unroll
    for (int d = 0; d < K; ++d)
#pragma unroll
      for (int f = d + 1; f < K; ++f)
        acc[1 + tri(P, S + d, S + f)] =
            fmaf(Xb[pair_id<K>(d, f)], inv, acc[1 + tri(P, S + d, S + f)]);
  };

  for (; e < rg.hi; e += U * NT) {
    // The next trip's masks are loaded a trip ahead. A trip of masked
    // events is skipped: their rows are not read
    bool cur[U], any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      cur[u] = valid[u];
      any |= cur[u];
      const int next = e + (U + u) * NT;
      valid[u] = next < rg.hi && mask[be + next];
    }
    if (!any) continue;
#pragma unroll
    for (int u = 0; u < U; ++u) event(e + u * NT, cur[u]);
  }

  cluster_vgh_sum2<NF, P, NT>(acc, s_red, s_part, s_ftot, gacc, s_gred,
                              s_gpart, s_gtot);
  if (rg.range == 0) {   // ll, g and H with the rate terms, back from the
    // reflected cell's coordinates as they are stored: an entry of a
    // reflected axis's t changes sign (flip_vgh's products, exactly)
    const int flip = s_flip;
    auto sign = [&](int i) {
      return i < S ? 1.f : flip_sign<K>(flip, i - S);
    };
    if (threadIdx.x == 0) ll_out[l] = s_ftot[0] - moff[l];
    for (int i = threadIdx.x; i < P; i += NT)
      g_out[(size_t)l * P + i] =
          sign(i) * (float)(i < S ? s_gtot[i] - 1.0 : s_gtot[i]);
    for (int ij = threadIdx.x; ij < P * P; ij += NT) {
      const int i = ij / P, j = ij % P;
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      h_out[(size_t)l * P * P + ij] =
          sign(i) * sign(j) * s_ftot[1 + tri(P, lo, hi)];
    }
  }
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
// (S, K) is outside the instantiated range. wd and wx (the corner weights'
// derivatives) are not read: the kernel takes the differences by its
// corner tree. They stay in the signature so that checkouts' kernels can
// be measured on the same recorded calls; the launchers' host tables go
// together (ROADMAP R4). Precondition, not checked here: a toy's (G, S, E)
// block and the (B, E) mask and inv_ref each hold fewer than 2^32
// entries, as the kernel addresses them at 32-bit offsets from the block's
// and the tensors' start; the Python launcher (ops/fused_unbinned.py
// unbinned_vgh_launcher) raises otherwise.
int bt_unbinned_vgh(int S, int K, int G, int E, int L, float outlier,
                    const float* ps, const long long* lanes, const int* ids,
                    const float* w, const float* wd, const float* wx,
                    const float* m, const unsigned char* mask,
                    const float* inv_ref, const float* moff, float* ll,
                    float* g, float* h, cudaStream_t stream) {
  (void)wd;
  (void)wx;
  if (L <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
  cudaError_t err = cudaSuccess;
#define BT_UVGH_CASE(S_, K_)                                                \
  case (S_) * 8 + (K_):                                                     \
    err = launch_range_clusters<uvgh_kernel<S_, K_>, kVghThreads>(           \
        E, L, stream, ps, G, E, outlier, lanes, ids, w, m, mask, inv_ref,   \
        moff, ll, g, h);                                                    \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_UVGH_CASE)
    default:
      return -1;
  }
#undef BT_UVGH_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
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
