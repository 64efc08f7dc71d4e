// The cell layout of the value kernels: ll_kernel (fused_binned.cu),
// bb_ll_kernel (fused_bb.cu), bblite_ll_kernel (fused_bb_lite.cu) and the
// unbinned ull_kernel (fused_unbinned.cu, over a lane's events where the
// others walk a toy's bins). The parts that do not depend on the
// likelihood live here, one copy for the four: the CTA's place in the grid
// and its bin range, the staging of its candidates' tables, the grouping
// of candidates by cell, the fixed-order sum over the cluster, and the
// launch (occupancy, grid sizing).
//
// One CTA per (toy, bin range[, candidate group]); the CTAs of one toy's
// bin ranges form a thread-block cluster.
//
// A toy's candidates are step scalings of one Newton direction, snaps and
// one-coordinate polish moves, so most of them lie in a few anchor-grid
// cells, and candidates in one cell name the same C corner rows (only their
// lerp weights and rates differ).
//
//   1. group_cells orders the CTA's candidates by cell (equal corner-id
//      tuples, which also merges candidates whose corners corner_ids
//      clamped alike at the grid's edge), in order of first occurrence.
//   2. The kernel's own per-bin pass: each thread walks its bins; per bin
//      and cell it reads the cell's corner values once for all of the
//      cell's candidates and evaluates each candidate from them, adding its
//      deviance term to the candidate's column of s_dev (shared memory, one
//      column a thread). A corner row is read once per bin for all of the
//      cell's candidates, where a CTA per candidate read it once per
//      candidate.
//   3. cell_sums: fixed-order sums, a warp over each candidate's column,
//      then the cluster's CTAs in rank order through distributed shared
//      memory. No float atomics: a rerun is bit-identical.
//
// launch_cells sizes the grid to about two waves of the card: up to 8 bin
// ranges a toy (one cluster), and with few lanes left the candidates split
// over more CTAs. The bin ranges, the cluster's rank-ordered sum and the
// launch queries (once a device and kernel, at the first launch: the first
// launch of a shape must come before any CUDA-graph capture) are
// bt_ranges.cuh's, shared with the binned vgh kernels. The CTA size
// is the kernel's: ll_kernel and ull_kernel 256 threads (128 registers at
// S = 6, K = 4, two CTAs an SM), the Beeston-Barlow kernels 128 (about 160
// registers, three an SM).

#pragma once

#include "bt_ranges.cuh"

namespace bt {

constexpr int kMaxActa = 64;                    // candidates a CTA, max

// A value CTA's place: its toy b, its candidates [cand0, cand0 + Aq) of the
// (B, A) output, and its bins [lo, hi), range `range` of the toy's T
struct CellBlock {
  int T, range, b, Aq, lo, hi;
  size_t cand0;
};

__device__ __forceinline__ CellBlock cell_block(int N, int A, int Acta) {
  const BinRange r = bin_range(N);
  CellBlock cb;
  cb.T = r.T;
  cb.range = r.range;
  cb.b = blockIdx.x / cb.T;
  const int c0 = blockIdx.y * Acta;
  cb.Aq = min(Acta, A - c0);
  cb.cand0 = (size_t)cb.b * A + c0;
  cb.lo = r.lo;
  cb.hi = r.hi;
  return cb;
}

// Orders candidates [0, A) by cell: order[0..A) lists them cell by cell
// (cells in order of first occurrence, candidates ascending within one),
// lead[a] the first candidate of a's cell. ids holds A tuples of C ints.
// Every thread of the CTA calls it (A <= blockDim.x); the results are
// visible on return.
__device__ inline void group_cells(const int* ids, int A, int C, int* lead,
                                   int* order) {
  const int a = threadIdx.x;
  if (a < A) {
    int first = a;
    for (int b = 0; b < a && first == a; ++b) {
      bool same = ids[b * C] == ids[a * C];
      for (int c = 1; c < C && same; ++c)
        same = ids[b * C + c] == ids[a * C + c];
      if (same) first = b;
    }
    lead[a] = first;
  }
  __syncthreads();
  if (a < A) {
    int rank = 0;
    for (int b = 0; b < A; ++b)
      rank += lead[b] < lead[a] || (lead[b] == lead[a] && b < a);
    order[rank] = a;
  }
  __syncthreads();
}

// Stages the CTA's candidate tables (corner ids and weights, C a
// candidate; rates, S a candidate), zeroes its deviance columns (NT, the
// CTA's threads, a candidate) and groups the candidates by cell; the
// results are visible on return.
template <int S, int C, int NT>
__device__ __forceinline__ void stage_cells(
    const CellBlock& cb, const int* __restrict__ ids,
    const float* __restrict__ w, const float* __restrict__ m, int* s_ids,
    float* s_w, float* s_m, float* s_dev, int* s_lead, int* s_order) {
  const int t = threadIdx.x;
  for (int i = t; i < cb.Aq * C; i += NT) {
    s_ids[i] = ids[cb.cand0 * C + i];
    s_w[i] = w[cb.cand0 * C + i];
  }
  for (int i = t; i < cb.Aq * S; i += NT) s_m[i] = m[cb.cand0 * S + i];
  for (int i = t; i < cb.Aq * NT; i += NT) s_dev[i] = 0.f;
  __syncthreads();
  group_cells(s_ids, cb.Aq, C, s_lead, s_order);
}

// Fixed-order sums of the deviance columns s_dev[Aq][NT]: a warp over each
// candidate's column, then the cluster's ranges in rank order (rank 0
// writes out[0..Aq), less the candidate's offset off[0..Aq) where Off, the
// unbinned value's rate term). Every thread of every CTA of the cluster
// calls it.
template <int NT, bool Off = false>
__device__ inline void cell_sums(const CellBlock& cb, const float* s_dev,
                                 float* s_tot, float* __restrict__ out,
                                 const float* __restrict__ off = nullptr) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int a = warp; a < cb.Aq; a += NT / 32) {
    float x = 0.f;
    for (int j = lane; j < NT; j += 32) x += s_dev[a * NT + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) s_tot[a] = x;
  }
  cluster.sync();
  if (cb.range == 0 && t < cb.Aq) {
    if constexpr (Off)
      out[cb.cand0 + t] = rank_sum(s_tot, t) - off[cb.cand0 + t];
    else
      out[cb.cand0 + t] = rank_sum(s_tot, t);
  }
  cluster.sync();   // the ranges' s_tot stay alive until rank 0 has read
}

// Launches Kernel(N, A, Acta, args...) in CTAs of NT threads for B toys of
// A candidates over N bins: candidates a CTA (Acta) and bin ranges a toy
// (T, the cluster size) sized for about two waves of the card, or, where
// ByTrips, T by the rounds of the card times the trips of a CTA
// (ranges_for_bins: a CTA's last trip over its range is not left mostly
// idle)
template <auto Kernel, int NT, bool ByTrips = false, typename... Args>
cudaError_t launch_cells(int N, int B, int A, cudaStream_t stream,
                         Args... args) {
  int device = 0, sms = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  // A CTA takes all of a toy's candidates (up to kMaxActa); while even
  // kMaxCluster bin ranges a toy would leave the card under two waves, the
  // candidates split over twice as many CTAs, down to one a CTA. Then as
  // many bin ranges as two waves need.
  int groups = (A + kMaxActa - 1) / kMaxActa, Acta, per_sm = 0;
  long long wave2, ctas;
  for (;;) {
    Acta = (A + groups - 1) / groups;
    groups = (A + Acta - 1) / Acta;
    err = occupancy<Kernel, NT, kMaxActa + 1>(
        device, Acta, sizeof(float) * Acta * NT,
        sizeof(float) * kMaxActa * NT, &per_sm);
    if (err != cudaSuccess) return err;
    wave2 = 2LL * sms * (per_sm > 0 ? per_sm : 1);
    ctas = (long long)B * groups;
    if (ctas * kMaxCluster >= wave2 || Acta == 1) break;
    groups *= 2;
  }
  const int T = ByTrips ? ranges_for_bins(ctas, wave2 / 2, N, NT)
                        : ranges_for(ctas, wave2, N);
  return launch_cluster<Kernel>(B, groups, T, NT, sizeof(float) * Acta * NT,
                                stream, N, A, Acta, args...);
}


// -- the per-bin pass of the Beeston-Barlow value kernels --------------------
//
// bb_ll_kernel and bblite_ll_kernel read, per corner, the S pmf rows of the
// anchor tensor (G, S, N) and one MC-count row (G, N). Per bin and cell the
// cell's C x (S+1) corner values go into registers once (112 floats at
// S = 6, K = 4: C*(S+1) independent loads in flight, coalesced over the
// threads' neighbouring bins), then each candidate of the cell is combined
// from them, P[s] = sum_c w_c X[c][s] and Nr = sum_c w_c Y[c] (c ascending,
// the FMA order of the CTA-per-candidate kernels they replace), and its
// deviance term, term(a, P, Nr, k), is added to its column.
//
// The cell, the combine and the root need about 160 registers, so a CTA has
// 128 threads and three fit an SM (twelve warps); with 256 threads one fit.
// Measured slower on the H100 (PERF.md §6): two candidates evaluated side
// by side (190 registers), corners streamed through subgroups of 1-8
// candidates (fewer registers, each corner a round of load latency), half
// a cell at a time with the partial sums in shared memory, and the tables
// staged in cell order.

constexpr int kMcThreads = 128;    // threads of a Beeston-Barlow value CTA

template <int S, int K, class Term>
__device__ __forceinline__ void mc_cell_pass(
    const CellBlock& cb, const float* __restrict__ anchor,
    const float* __restrict__ nme, int N, const float* __restrict__ obs_b,
    const int* s_ids, const float* s_w, const int* s_lead,
    const int* s_order, float* s_dev, Term term) {
  constexpr int C = 1 << K;
  const int t = threadIdx.x;
  const int Aq = cb.Aq;
  const size_t row = (size_t)S * N;
  for (int n = cb.lo + t; n < cb.hi; n += kMcThreads) {
    const float k = obs_b[n];
    for (int i = 0; i < Aq;) {
      const int cell = s_lead[s_order[i]];
      float X[C][S], Y[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const size_t gid = (size_t)s_ids[cell * C + c];
        const float* x = anchor + gid * row + n;
        Y[c] = __ldg(nme + gid * N + n);
#pragma unroll
        for (int s = 0; s < S; ++s) X[c][s] = __ldg(x + (size_t)s * N);
      }
      do {   // every candidate of the cell
        const int a = s_order[i];
        float P[S], Nr = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) P[s] = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float wc = s_w[a * C + c];
          Nr = fmaf(wc, Y[c], Nr);
#pragma unroll
          for (int s = 0; s < S; ++s) P[s] = fmaf(wc, X[c][s], P[s]);
        }
        s_dev[a * kMcThreads + t] += term(a, P, Nr, k);
        ++i;
      } while (i < Aq && s_lead[s_order[i]] == cell);
    }
  }
}

}  // namespace bt
