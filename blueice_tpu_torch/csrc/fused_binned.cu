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
//   ll_kernel    deviance-form ll at A line-search candidates per toy, one
//                block per (toy, bin range), the candidates of one grid
//                cell sharing each load of its corner rows. Replaces
//                _ll_kernel (fused.py:251) and _ll_kernel_dense
//                (fused.py:690). Its design is described above it.
//
// What bounds them on an H100: the corner gathers. Every bin of every toy
// reads its C = 2^K corner values for each of the S sources from the anchor
// tensor (G, S, N): C*S*N*4 bytes per toy per vgh, about 1.2 MB at the
// XENON shape (G = 81, S = 6, N = 3100, K = 4), 0.6 GB for 512 toys. The
// TPU kernels kept the 6 MB anchor tensor resident in VMEM; a block here
// has at most 227 KB of shared memory, so the anchor tensor stays in global
// memory and is served from the 50 MB L2 (it fits many times over).
// Neighbouring threads take neighbouring bins, so every gather is a
// coalesced row read. vgh_kernel does a handful of FMAs per loaded value
// (value, K derivatives and the m-weighted cross-pair combinations) and is
// L2-bandwidth bound by design. ll_kernel reads a cell's corner values once
// per bin for all of the toy's candidates in that cell, so where they share
// cells the float32 FMA rate bounds it.
//
// Reductions: fixed order everywhere (bt::block_sum in bt_common.cuh for
// vgh_kernel; warp shuffles, the warps in order and the cluster's blocks
// in rank order for ll_kernel), no float atomics, so a rerun on the same
// inputs is bit-identical.
//
// Semantics kept exactly from the reference: lambda floored at FLT_MIN
// inside the log, the 1e6 linear penalty on negative expectations (in value
// and in r), and r = -1 in empty-model bins.
//
// Built by blueice_tpu_torch/ops/fused.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes; the C entry points return cudaGetLastError().

#include <algorithm>

#include <cooperative_groups.h>

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

// ---------------------------------------------------------------------------
// The value kernel: one CTA per (toy, bin range[, candidate group]); the
// CTAs of one toy's bin ranges form a thread-block cluster.
//
// A toy's candidates are step scalings of one Newton direction, snaps and
// one-coordinate polish moves, so most of them lie in a few anchor-grid
// cells, and candidates in one cell name the same C corner rows (only their
// lerp weights and rates differ).
//
//   1. group_cells orders the CTA's candidates by cell (equal corner-id
//      tuples, which also merges candidates whose corners corner_ids
//      clamped alike at the grid's edge), in order of first occurrence.
//   2. Each thread walks its bins; per bin and cell it loads the cell's
//      C x S corner values into registers once (C*S independent loads in
//      flight, coalesced over the threads' neighbouring bins), then
//      evaluates every candidate of the cell from them: lambda =
//      sum_s m_s sum_c w_c X[c][s] (the weights from shared memory as
//      broadcasts), and its deviance term. So a corner row is read once
//      per bin for all of the cell's candidates, where the per-candidate
//      kernel read it once per candidate, and the FMAs, not the loads, set
//      the pace once candidates share cells.
//   3. Each thread's deviance sums live in shared memory (one column a
//      thread); then fixed-order sums: a warp over each candidate's column,
//      then the cluster's CTAs in rank order through distributed shared
//      memory. No float atomics: a rerun is bit-identical.
//
// Measured slower on the H100 and not kept (PERF.md §6): staging a
// toy's distinct rows in shared memory (cp.async) for a dense product of
// every candidate with every row of the union (up to 5x the FMAs at random
// corners, a barrier per staged row), the same product with the rows
// loaded into registers, and per-source loads with the lambdas in shared
// memory (fewer registers, more shared-memory traffic).
//
// The launch sizes the grid to about two waves of the card: up to 8 bin
// ranges a toy (one cluster), and with few lanes left the candidates split
// over more CTAs. group_cells is written to be lifted into a header for the
// Beeston-Barlow value kernels.

constexpr int kLLThreads = 256;                 // threads of a value CTA
constexpr int kLLWarps = kLLThreads / 32;
constexpr int kMaxActa = 64;                    // candidates a CTA, max
constexpr int kMaxCluster = 8;                  // portable cluster size
constexpr int kMaxDevices = 64;

// Orders candidates [0, A) by cell: order[0..A) lists them cell by cell
// (cells in order of first occurrence, candidates ascending within one),
// lead[a] the first candidate of a's cell. ids holds A tuples of C ints.
// Every thread of the CTA calls it (A <= blockDim.x); the results are
// visible on return.
__device__ void group_cells(const int* ids, int A, int C, int* lead,
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

template <int S, int K>
__global__ void __launch_bounds__(kLLThreads)
ll_kernel(const float* __restrict__ anchor, int N, int A, int Acta,
          const int* __restrict__ ids, const float* __restrict__ w,
          const float* __restrict__ m, const float* __restrict__ obs,
          float* __restrict__ ll_out) {
  constexpr int C = 1 << K;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int T = (int)cluster.num_blocks();       // bin ranges of the toy
  const int range = (int)cluster.block_rank();
  const int b = blockIdx.x / T;
  const int c0 = blockIdx.y * Acta;
  const int Aq = min(Acta, A - c0);               // the CTA's candidates
  const size_t cand0 = (size_t)b * A + c0;
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

  for (int i = t; i < Aq * C; i += kLLThreads) {
    s_ids[i] = ids[cand0 * C + i];
    s_w[i] = w[cand0 * C + i];
  }
  for (int i = t; i < Aq * S; i += kLLThreads) s_m[i] = m[cand0 * S + i];
  for (int i = t; i < Aq * kLLThreads; i += kLLThreads) s_dev[i] = 0.f;
  __syncthreads();
  group_cells(s_ids, Aq, C, s_lead, s_order);

  // The range's bins, split evenly over T in whole warps' worth
  const int chunks32 = (N + 31) / 32;
  const int lo = (int)((long long)range * chunks32 / T) * 32;
  const int hi = min(N, (int)((long long)(range + 1) * chunks32 / T) * 32);
  const float* obs_b = obs + (size_t)b * N;
  const size_t row = (size_t)S * N;

  for (int n = lo + t; n < hi; n += kLLThreads) {
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
  __syncthreads();

  // Fixed-order sums: a warp over each candidate's column, then the
  // cluster's ranges
  const int lane = t & 31, warp = t >> 5;
  for (int a = warp; a < Aq; a += kLLWarps) {
    float x = 0.f;
    for (int j = lane; j < kLLThreads; j += 32) x += s_dev[a * kLLThreads + j];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) s_tot[a] = x;
  }
  cluster.sync();
  if (range == 0 && t < Aq) {
    float x = 0.f;
    for (int r = 0; r < T; ++r) x += cluster.map_shared_rank(s_tot, r)[t];
    ll_out[cand0 + t] = x;
  }
  cluster.sync();   // the ranges' s_tot stay alive until rank 0 has read
}

// The CTAs one SM holds, once per (device, S, K, Acta), and the dynamic
// shared memory limit, once per device, both set up at the first launch
// (outside any CUDA-graph capture)
template <int S, int K>
cudaError_t ll_occupancy(int device, int Acta, int* per_sm) {
  static int cache[kMaxDevices][kMaxActa + 1];
  static bool ready[kMaxDevices];
  if (!ready[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ll_kernel<S, K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)(sizeof(float) * kMaxActa * kLLThreads));
    if (err != cudaSuccess) return err;
    ready[device] = true;
  }
  int& slot = cache[device][Acta];
  if (slot == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &slot, ll_kernel<S, K>, kLLThreads,
        sizeof(float) * Acta * kLLThreads);
    if (err != cudaSuccess) return err;
  }
  *per_sm = slot;
  return cudaSuccess;
}

// The launch of ll_kernel<S, K>: candidates a CTA (Acta) and bin ranges a
// toy (T) sized for about two waves of the card
template <int S, int K>
cudaError_t launch_ll(int N, int B, int A, const float* anchor,
                      const int* ids, const float* w, const float* m,
                      const float* obs, float* ll, cudaStream_t stream) {
  static int sms_of[kMaxDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sms_of[device] == 0) {
    err = cudaDeviceGetAttribute(&sms_of[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  // A CTA takes all of a toy's candidates (up to kMaxActa); while even
  // kMaxCluster bin ranges a toy would leave the card under two waves, the
  // candidates split over twice as many CTAs, down to one a CTA. Then as
  // many bin ranges as two waves need.
  int groups = (A + kMaxActa - 1) / kMaxActa, Acta, per_sm = 0;
  long long wave2, ctas;
  for (;;) {
    Acta = (A + groups - 1) / groups;
    groups = (A + Acta - 1) / Acta;
    err = ll_occupancy<S, K>(device, Acta, &per_sm);
    if (err != cudaSuccess) return err;
    wave2 = 2LL * sms_of[device] * (per_sm > 0 ? per_sm : 1);
    ctas = (long long)B * groups;
    if (ctas * kMaxCluster >= wave2 || Acta == 1) break;
    groups *= 2;
  }
  const int T = (int)std::min<long long>(
      std::min(kMaxCluster, (N + 31) / 32),
      std::max(1LL, (wave2 + ctas - 1) / ctas));

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(B * T), (unsigned)groups, 1);
  cfg.blockDim = dim3(kLLThreads, 1, 1);
  cfg.dynamicSmemBytes = sizeof(float) * Acta * kLLThreads;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)T;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, ll_kernel<S, K>, anchor, N, A, Acta, ids,
                            w, m, obs, ll);
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
  if (S < 1 || S > 8 || K < 0 || K > 4) return -1;
  if (N <= 0)
    return (int)cudaMemsetAsync(ll, 0, sizeof(float) * B * A, stream);
  cudaError_t err = cudaSuccess;
#define BT_LL_CASE(S_, K_)                                                  \
  case (S_) * 8 + (K_):                                                     \
    err = launch_ll<S_, K_>(N, B, A, anchor, ids, w, m, obs, ll, stream);   \
    break;
  switch (S * 8 + K) {
    BT_FOR_SK(BT_LL_CASE)
  }
#undef BT_LL_CASE
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

}  // extern "C"
