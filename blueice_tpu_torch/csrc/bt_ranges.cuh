// Bin ranges over a thread-block cluster: the layout of the port's kernels
// that sum over a toy's bins (or events) on few toys. The value kernels
// (bt_cells.cuh: ll_kernel, bb_ll_kernel, bblite_ll_kernel, and the
// unbinned ull_kernel over event ranges) and the vgh kernels (vgh_kernel,
// bb_vgh_kernel, bblite_vgh_kernel, and the unbinned uvgh_kernel over
// event ranges) run one CTA per (toy, bin range[, candidate group]); the
// CTAs of one toy's bin ranges form a thread-block cluster (up to 8, the
// portable size). The parts that do not depend on the likelihood live
// here, one copy for all of them:
//
//   * bin_range: the CTA's range, its rank in the cluster, its bins split
//     evenly over the ranges in whole warps' worth;
//   * rank_sum / cluster_vgh_sum(2): fixed-order sums, over the CTA's warps
//     (bt::block_sum) and then over the cluster's CTAs in rank order
//     through distributed shared memory. No float atomics: a rerun on the
//     same inputs is bit-identical (a different range count, another batch
//     size, rounds differently);
//   * the launch: the SM count and the kernel's CTAs an SM (occupancy) or
//     clusters of each size (cluster_slots), queried once a device and
//     kernel at the first launch (so the first launch of a shape must come
//     before any CUDA-graph capture), and the cluster launch
//     (cudaLaunchKernelEx); launch_ranges and launch_range_clusters size
//     the ranges a toy for the batch (ranges_for_bins,
//     ranges_for_clusters), so that few toys fill the card.
//
// And, for the four vgh kernels, the per-bin combine of the corner rows
// (corner_tree; tree_rows with the Beeston-Barlow kernels' MC-count row,
// tree_pmf_rows without, for vgh_kernel; uvgh_kernel loads its rows
// itself, predicated on the event mask): a cell's value, first differences
// and cross second differences by K lerp steps over its 2^K corners in
// registers, where the corner-weight tables took 2^K (1 + K + K(K-1)/2)
// FMAs a row (a third of the operations at K = 4).

#pragma once

#include <algorithm>

#include <cooperative_groups.h>

#include "bt_common.cuh"

namespace bt {

constexpr int kMaxCluster = 8;                  // portable cluster size
constexpr int kMaxDevices = 64;

// A CTA's bin range: range `range` of the toy's T (its cluster rank), bins
// [lo, hi) of N, split evenly over T in whole warps' worth
struct BinRange {
  int T, range, lo, hi;
};

__device__ __forceinline__ BinRange bin_range(int N) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  BinRange r;
  r.T = (int)cluster.num_blocks();
  r.range = (int)cluster.block_rank();
  const int chunks32 = (N + 31) / 32;
  r.lo = (int)((long long)r.range * chunks32 / r.T) * 32;
  r.hi = min(N, (int)((long long)(r.range + 1) * chunks32 / r.T) * 32);
  return r;
}

// Element i of `part` (a shared-memory array of every CTA of the cluster)
// summed over the cluster's CTAs in rank order. Call it between two
// cluster.sync()s: after the CTAs have written part, before they exit.
template <typename T>
__device__ __forceinline__ T rank_sum(const T* part, int i) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  T x = 0;
  for (int r = 0; r < (int)cluster.num_blocks(); ++r)
    x += cluster.map_shared_rank(part, r)[i];
  return x;
}

// The vgh kernels' sum of NV per-thread values over the toy's bins: over
// the CTA of NT threads (bt::block_sum into part), then over the cluster's
// ranges in rank order into tot (rank 0's; red, part and tot are shared
// arrays of NT / 32 * NV, NV and NV floats). Every thread of every CTA of
// the cluster calls it; on return rank 0 holds the toy's totals in tot.
template <int NV, int NT>
__device__ __forceinline__ void cluster_vgh_sum(float (&v)[NV], float* red,
                                                float* part, float* tot) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  block_sum<NV, NT>(v, red, part);
  cluster.sync();
  if (cluster.block_rank() == 0)
    for (int i = threadIdx.x; i < NV; i += NT) tot[i] = rank_sum(part, i);
  cluster.sync();   // the ranges' parts stay alive until rank 0 has read
}

// rank_sum with the cluster's loads issued before the adds (the same sum in
// the same rank order): one round of distributed-shared-memory latency
// where rank_sum's loop waits for each load in turn
template <typename T>
__device__ __forceinline__ T rank_sum_loads_first(const T* part, int i) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  const int ranks = (int)cluster.num_blocks();
  T x[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < ranks) x[r] = cluster.map_shared_rank(part, r)[i];
  T sum = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < ranks) sum += x[r];
  return sum;
}

// cluster_vgh_sum of two sets of per-thread values (of two types: float and
// double) at once: both over the CTA, then both over the cluster in one
// round of cluster syncs
template <int NA, int NB, int NT, typename TA, typename TB>
__device__ __forceinline__ void cluster_vgh_sum2(TA (&va)[NA], TA* reda,
                                                 TA* parta, TA* tota,
                                                 TB (&vb)[NB], TB* redb,
                                                 TB* partb, TB* totb) {
  namespace cg = cooperative_groups;
  const cg::cluster_group cluster = cg::this_cluster();
  block_sum<NA, NT>(va, reda, parta);
  block_sum<NB, NT>(vb, redb, partb);
  cluster.sync();
  if (cluster.block_rank() == 0) {
    for (int i = threadIdx.x; i < NA; i += NT)
      tota[i] = rank_sum_loads_first(parta, i);
    for (int i = threadIdx.x; i < NB; i += NT)
      totb[i] = rank_sum_loads_first(partb, i);
  }
  cluster.sync();   // the ranges' parts stay alive until rank 0 has read
}

// -- the launch ---------------------------------------------------------------

// The device's SM count, queried once a device
inline cudaError_t sm_count(int device, int* n) {
  static int sms_of[kMaxDevices];
  if (sms_of[device] == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &sms_of[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *n = sms_of[device];
  return cudaSuccess;
}

// The CTAs of NT threads with `smem` bytes of dynamic shared memory that one
// SM holds, queried once a (device, kernel, slot: one of Slots launch
// shapes) and cached; the dynamic shared memory limit is raised to
// max_smem, once a (device, kernel). Both at the first launch, outside any
// CUDA-graph capture.
template <auto Kernel, int NT, int Slots>
cudaError_t occupancy(int device, int slot, size_t smem, size_t max_smem,
                      int* per_sm) {
  static int cache[kMaxDevices][Slots];
  static bool ready[kMaxDevices];
  if (!ready[device]) {
    if (max_smem > 0) {
      const cudaError_t err = cudaFuncSetAttribute(
          Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)max_smem);
      if (err != cudaSuccess) return err;
    }
    ready[device] = true;
  }
  int& cached = cache[device][slot];
  if (cached == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &cached, Kernel, NT, smem);
    if (err != cudaSuccess) return err;
  }
  *per_sm = cached;
  return cudaSuccess;
}

// The current device, checked against the caches' size
inline cudaError_t current_device(int* device) {
  const cudaError_t err = cudaGetDevice(device);
  if (err != cudaSuccess) return err;
  return *device < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// Bin ranges a toy (the cluster size) that bring `ctas` CTAs a range up to
// about `wave2` CTAs: at most kMaxCluster and one warp's worth of N's bins
// a range
inline int ranges_for(long long ctas, long long wave2, int N) {
  return (int)std::min<long long>(
      std::min(kMaxCluster, std::max(1, (N + 31) / 32)),
      std::max(1LL, (wave2 + ctas - 1) / ctas));
}

// Launches Kernel(args...) on grid (gx * T, gy) in CTAs of NT threads with
// `smem` bytes of dynamic shared memory, T consecutive CTAs along x one
// cluster
template <auto Kernel, typename... Args>
cudaError_t launch_cluster(int gx, int gy, int T, int NT, size_t smem,
                           cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(gx * T), (unsigned)gy, 1);
  cfg.blockDim = dim3((unsigned)NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)T;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, Kernel, args...);
}

// The T in 1..kMaxCluster (bin ranges a toy, at most one warp's worth of N
// bins a range) with the least rounds(T) x (trips of a CTA over its range
// + cta_trips), trips = ceil(ceil(chunks / T) / (NT / 32)) with chunks the
// toy's warps' worth of bins and cta_trips a CTA's own work (staging, the
// sums over its warps and its cluster) counted in trips; on a tie the
// smaller T. Few toys take many ranges, so that they still fill the card;
// many take few.
template <class Rounds>
inline int least_cost_ranges(int N, int NT, long long cta_trips,
                             Rounds rounds) {
  const long long chunks = (N + 31) / 32, warps = NT / 32;
  int best = 1;
  long long best_cost = -1;
  for (int T = 1; T <= std::min<long long>(kMaxCluster, std::max(1LL, chunks));
       ++T) {
    const long long trips = ((chunks + T - 1) / T + warps - 1) / warps;
    const long long cost = rounds(T) * (trips + cta_trips);
    if (best_cost < 0 || cost < best_cost) {
      best = T;
      best_cost = cost;
    }
  }
  return best;
}

// Bin ranges a toy for B toys of N bins in CTAs of NT threads, `slots` of
// which the card holds at once: least_cost_ranges with ceil(B T / slots)
// rounds and kCtaTrips
constexpr long long kCtaTrips = 2;

inline int ranges_for_bins(long long B, long long slots, int N, int NT) {
  return least_cost_ranges(N, NT, kCtaTrips, [&](int T) {
    return (B * T + slots - 1) / slots;
  });
}

// Launches Kernel(args...) for B toys over N bins, one CTA of NT threads
// (static shared memory only) per (toy, bin range), a toy's ranges one
// cluster, their count from ranges_for_bins at the kernel's CTAs an SM
template <auto Kernel, int NT, typename... Args>
cudaError_t launch_ranges(int N, int B, cudaStream_t stream, Args... args) {
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err == cudaSuccess)
    err = occupancy<Kernel, NT, 1>(device, 0, 0, 0, &per_sm);
  if (err != cudaSuccess) return err;
  const long long slots = (long long)sms * std::max(per_sm, 1);
  return launch_cluster<Kernel>(B, 1, ranges_for_bins(B, slots, N, NT), NT,
                                0, stream, args...);
}

// The clusters of T CTAs of NT threads (T = 1..kMaxCluster) that the device
// holds at once, for each T (cudaOccupancyMaxActiveClusters: a cluster's
// CTAs run at once on one GPC, so T CTAs an SM times the SMs overstates
// what the card holds where T does not pack the GPCs' SMs), queried once a
// (device, kernel) at its first launch and cached; *slots points at the
// counts, indexed by T.
template <auto Kernel, int NT>
cudaError_t cluster_slots(int device, const int** slots) {
  static int cache[kMaxDevices][kMaxCluster + 1];
  int* counts = cache[device];
  if (counts[1] == 0) {
    for (int T = 1; T <= kMaxCluster; ++T) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3((unsigned)T, 1, 1);
      cfg.blockDim = dim3((unsigned)NT, 1, 1);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = (unsigned)T;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      int n = 0;
      const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, Kernel, &cfg);
      if (err != cudaSuccess) return err;
      counts[T] = std::max(n, 1);
    }
  }
  *slots = counts;
  return cudaSuccess;
}

// As ranges_for_bins, with each T's rounds counted in the clusters of T
// CTAs that the card holds at once (cluster_slots): ceil(B / clusters[T]),
// and a CTA's own work counted as kClusterCtaTrips trips (3 beat 1 and 2
// on xenon's recorded vgh calls, 4 and 6 tied; PERF.md §6, PR 9)
constexpr long long kClusterCtaTrips = 3;

inline int ranges_for_clusters(long long B, const int* clusters, int N,
                               int NT) {
  return least_cost_ranges(N, NT, kClusterCtaTrips, [&](int T) {
    return (B + clusters[T] - 1) / clusters[T];
  });
}

// launch_ranges with the range count from ranges_for_clusters
template <auto Kernel, int NT, typename... Args>
cudaError_t launch_range_clusters(int N, int B, cudaStream_t stream,
                                  Args... args) {
  int device = 0;
  const int* clusters = nullptr;
  cudaError_t err = current_device(&device);
  if (err == cudaSuccess) err = cluster_slots<Kernel, NT>(device, &clusters);
  if (err != cudaSuccess) return err;
  return launch_cluster<Kernel>(B, 1, ranges_for_clusters(B, clusters, N, NT),
                                NT, 0, stream, args...);
}

// -- the per-bin combine of the vgh kernels -----------------------------------
//
// A toy's cell has C = 2^K corner rows; corner c's bit K-1-d is its side of
// axis d (axis K-1 the lowest bit, the corner order of corner_weight_tables).
// The kernels need, per row and bin, the multilinear combine at the toy's
// lerp weights, its first differences along each axis and its cross second
// differences for each pair of axes (d, e), d < e, in the row-major pair
// order of the wrapper's tables. corner_tree takes them by K lerp steps,
// axis K-1 first: each step halves every partial array by the lerp
// lo + w (hi - lo) in place and, for arrays of at most one difference so
// far, keeps the difference hi - lo as a new array. At K = 4: 62
// operations a row where the weight tables took 176 FMAs. Equal to the
// tables' sums in exact arithmetic; in float32 the two round differently
// (the plain versions use the tables).
//
// A lerp lo + t (hi - lo) loses (1 - t)'s relative precision at t near 1:
// a value that the tables make tiny (an MC count at a fit next to an anchor
// whose row is empty) would come out wrong by orders of magnitude. So the
// cell is reflected along every axis with t_d > 1/2 (tree_cell): the lerp
// leans on the heavier corner, with w_d = min(t_d, 1 - t_d), and is as
// precise as the tables' sum; at t = 0 or 1 it is a corner exactly. The
// differences along a reflected axis, and the kernels' derivatives in its
// t, change sign: the kernels accumulate g and H in the reflected
// coordinates and flip them back once (flip_vgh; bb's global sums in
// (flip_sums)).

// Index of the pair (d, e), d < e, among K axes' pairs in row-major order
template <int K>
__host__ __device__ constexpr int pair_id(int d, int e) {
  return d * K - d * (d + 1) / 2 + (e - d - 1);
}

// The vgh kernels' CTA: 128 threads, two an SM at up to 255 registers
// (uvgh_kernel's of few corner rows an event, eight an SM)
constexpr int kVghThreads = 128;
constexpr int kVghBlocks = 2;

template <int K>
struct Tree {
  static constexpr int C = 1 << K;
  static constexpr int NP = K * (K - 1) / 2;
  static constexpr int NM = 1 + K + NP;   // value, differences, cross pairs
};

// One lerp step over the lowest remaining axis on R pairs of x: x[r] =
// lo + w (hi - lo) of (lo, hi) = (x[2r], x[2r + 1]), and (Diff) dx[r] =
// hi - lo
template <int C, int R, bool Diff>
__device__ __forceinline__ void tree_step(float (&x)[C], float (&dx)[C],
                                          float w) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float lo = x[2 * r], diff = x[2 * r + 1] - lo;
    if (Diff) dx[r] = diff;
    x[r] = fmaf(w, diff, lo);
  }
}

// The step on axis D, then the steps on the axes below it
template <int K, int D>
struct TreeSteps {
  static __device__ __forceinline__ void run(
      float (&a)[Tree<K>::NM][Tree<K>::C], const float* w) {
    constexpr int C = Tree<K>::C, R = 1 << D;
    const float wd = w[D];
    tree_step<C, R, true>(a[0], a[1 + D], wd);
#pragma unroll
    for (int e = D + 1; e < K; ++e)
      tree_step<C, R, true>(a[1 + e], a[1 + K + pair_id<K>(D, e)], wd);
#pragma unroll
    for (int e = D + 1; e < K; ++e)
#pragma unroll
      for (int f = e + 1; f < K; ++f)
        tree_step<C, R, false>(a[1 + K + pair_id<K>(e, f)], a[0], wd);
    TreeSteps<K, D - 1>::run(a, w);
  }
};

template <int K>
struct TreeSteps<K, -1> {
  static __device__ __forceinline__ void run(
      float (&)[Tree<K>::NM][Tree<K>::C], const float*) {}
};

// a[0][c] holds corner c's value on entry (in the reflected cell's order);
// on return a[0][0] is the combine at lerp weights w, a[1 + d][0] its
// difference along axis d and a[1 + K + p][0] its cross second difference
// of pair p
template <int K>
__device__ __forceinline__ void corner_tree(
    float (&a)[Tree<K>::NM][Tree<K>::C], const float* w) {
  TreeSteps<K, K - 1>::run(a, w);
}

// The toy's reflected cell from its corner ids and weights (C each, shared
// memory): per axis d, the weights W0 and W1 of the corners on its low and
// high side (summed, c ascending) give 1 - t_d = W0 / (W0 + W1) and t_d =
// W1 / (W0 + W1), each to a few ulps of its own size (the other axes'
// weights, a common factor, cancel), 0 or 1 exactly where one side's
// weights are zeros. Axis d is reflected where t_d > 1 - t_d (bit K-1-d of
// *s_flip), its lerp weight s_lw[d] is the smaller of the two, and
// s_rid[c] = s_ids[c ^ *s_flip] lists the corner ids in the reflected
// order. Threads c < C take part; the results are visible after the next
// barrier.
template <int K>
__device__ __forceinline__ void tree_cell(const int* s_ids, const float* s_w,
                                          int* s_rid, float* s_lw,
                                          int* s_flip) {
  constexpr int C = Tree<K>::C;
  const int c = threadIdx.x;
  if (c >= C) return;
  int flip = 0;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    float w0 = 0.f, w1 = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if ((j >> (K - 1 - d)) & 1)
        w1 += s_w[j];
      else
        w0 += s_w[j];
    }
    const bool reflect = w1 > w0;
    flip |= (int)reflect << (K - 1 - d);
    if (c == 0) s_lw[d] = (reflect ? w0 : w1) / (w0 + w1);
  }
  s_rid[c] = s_ids[c ^ flip];
  if (c == 0) *s_flip = flip;
}

// The sign of axis d's derivatives in the reflected cell
template <int K>
__device__ __forceinline__ float flip_sign(int flip, int d) {
  return (flip >> (K - 1 - d)) & 1 ? -1.f : 1.f;
}

// bb's global sums glob = [T, SN (K), SXN (K(K-1)/2)] (global_sums in
// fused_bb.cu) taken into the reflected cell's coordinates
template <int K>
__device__ __forceinline__ void flip_sums(float* glob, int flip) {
#pragma unroll
  for (int d = 0; d < K; ++d) {
    glob[1 + d] *= flip_sign<K>(flip, d);
#pragma unroll
    for (int e = d + 1; e < K; ++e)
      glob[1 + K + pair_id<K>(d, e)] *= flip_sign<K>(flip, d) *
                                        flip_sign<K>(flip, e);
  }
}

// A toy's totals tot = [ll, g (P), packed upper H] (P = S + K) taken from
// the reflected cell's coordinates back to the toy's: the entries of a
// reflected axis's t change sign (exactly)
template <int S, int K>
__device__ __forceinline__ void flip_vgh(float* tot, int flip) {
  constexpr int P = S + K;
#pragma unroll
  for (int d = 0; d < K; ++d) {
    const float sd = flip_sign<K>(flip, d);
    tot[1 + S + d] *= sd;
#pragma unroll
    for (int i = 0; i < S; ++i) tot[1 + P + tri(P, i, S + d)] *= sd;
#pragma unroll
    for (int e = d + 1; e < K; ++e)
      tot[1 + P + tri(P, S + d, S + e)] *= sd * flip_sign<K>(flip, e);
  }
}

// row + id * stride bytes, as one 32 x 32 + 64-bit multiply-add
__device__ __forceinline__ const float* row_at(const float* row, int id,
                                               unsigned stride) {
  const float* p;
  asm("mad.wide.u32 %0, %1, %2, %3;"
      : "=l"(p)
      : "r"((unsigned)id), "r"(stride), "l"(row));
  return p;
}

// Bin n's combine of the toy's corner rows (corner ids s_rid in the
// reflected order, lerp weights w; tree_cell), row by row: the MC-count
// row (nme (G, N)) first, handed to mc_row(a), then the S pmf rows of the
// anchor tensor (G, S, N), handed to pmf_row(s, a), each as corner_tree
// leaves it. The C loads of a row are independent and coalesced over the
// threads' neighbouring bins.
template <int S, int K, class McRow, class PmfRow>
__device__ __forceinline__ void tree_rows(const float* __restrict__ anchor,
                                          const float* __restrict__ nme,
                                          int N, int n, const int* s_rid,
                                          const float* w, McRow mc_row,
                                          PmfRow pmf_row) {
  constexpr int C = Tree<K>::C, NM = Tree<K>::NM;
  {
    const float* row = nme + n;
    float a[NM][C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      a[0][c] = __ldg(row_at(row, s_rid[c], 4u * N));
    corner_tree<K>(a, w);
    mc_row(a);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float* row = anchor + (size_t)s * N + n;
    float a[NM][C];
#pragma unroll
    for (int c = 0; c < C; ++c)
      a[0][c] = __ldg(row_at(row, s_rid[c], 4u * S * N));
    corner_tree<K>(a, w);
    pmf_row(s, a);
  }
}

// The same without the MC-count row (vgh_kernel): the S pmf rows only, at
// 32-bit offsets from the anchor tensor's base (rofs[c], corner c's first
// row in floats, in the reflected order; the tensor holds fewer than 2^32
// floats): a load's address is a 32-bit add and a wide multiply-add,
// where tree_rows' 64-bit corner offsets take a 64-bit add (two adds) and
// twice the registers
template <int S, int K, class PmfRow>
__device__ __forceinline__ void tree_pmf_rows(
    const float* __restrict__ anchor, int N, int n,
    const unsigned (&rofs)[Tree<K>::C], const float* w, PmfRow pmf_row) {
  constexpr int C = Tree<K>::C, NM = Tree<K>::NM;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const unsigned base = (unsigned)s * N + n;
    float a[NM][C];
#pragma unroll
    for (int c = 0; c < C; ++c) a[0][c] = __ldg(anchor + (rofs[c] + base));
    corner_tree<K>(a, w);
    pmf_row(s, a);
  }
}

}  // namespace bt
