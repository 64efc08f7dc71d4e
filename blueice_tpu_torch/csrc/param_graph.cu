// The parameter graph of the closed-form fits as two kernels for NVIDIA
// Hopper (sm_90a): the map from the optimizer's unconstrained point u to
// the likelihood kernels' inputs, and its chain rule.
//
//   graph_fwd_kernel<K>    one thread per row of u (a lane, or one of a
//                          lane's line-search candidates): x = Transform(u),
//                          each shape parameter's cell index and lerp
//                          weight t, the rates m = mus(t) R E (the mus
//                          anchor corners lerped axis by axis, times the
//                          rate multiplier and the efficiency) and the
//                          summed Normal log prior; x itself where the
//                          caller asks for it.
//   graph_chain_kernel<K>  a group of 16 threads per lane: the gradient and
//                          Hessian in u of -(ll + prior) from the
//                          likelihood's (g, H) in (m, t), with the forward
//                          quantities recomputed from u, the corner weights
//                          and their t-derivatives formed inline (a thread
//                          a corner, then a thread a coordinate).
//
// Both take the source count S at run time and the shape-parameter count K
// as a template argument: eight instantiations, where one per (S, K) made
// 64 and took 160 s of nvcc (the unrolled per-lane chain spilled at 255
// registers).
//
// They replace no TPU kernel: the JAX package leaves this graph to XLA,
// which fuses it into each fit's program. In eager PyTorch the same graph
// is some 270 small operations a value call and 630 a vgh call
// (parallel/fitter.py _ParamGraph: cells, values, chain), each a launch the
// host dispatches while the card waits; that PyTorch graph stays as the
// twin these kernels are tested against, and runs wherever they do not
// (the CPU, float64, other priors, K = 0).
//
// What bounds them on an H100: neither the card's bytes nor its
// operations. A row reads its u and fv (a few dozen bytes) and its 2^K
// corner rows of the mus tensor (G x S floats, L1- and L2-resident) and
// writes idx, t, m and the prior (76 bytes at the XENON shape, S = 6,
// K = 4); a chain lane reads its (g, H) in (m, t) (440 bytes) and writes
// (g, H) in u. What costs is the launch: one each where the PyTorch graph
// made hundreds.
//
// Numbers: graph_fwd_kernel computes each value with the operations, in
// the order and with the roundings of the PyTorch graph's float32 ops on
// the card (explicitly rounded intrinsics, so that no multiply-add is
// contracted; a Python scalar divisor as the multiply by its float32
// reciprocal that PyTorch's CUDA division takes), so idx, t, m and the
// prior agree with it to the last bit or within a few ulps. The chain
// kernel sums in another order than the PyTorch graph's einsums and
// matrix products: float32 rounding, no more.
//
// Tables: a GraphDesc, built once per fitter on the host
// (ops/param_graph.py GraphTables, from the fitter's parameter routing) and
// copied once to the card; the kernels read it through a pointer. Every
// parameter the graph reads is a slot: the K shape parameters, the S rate
// multipliers, the S efficiencies, the live time and the prior terms, each
// read from a floating coordinate of u (through its transform), a column
// of the runtime-fixed values fv, or a constant. The chain works on the
// graph's own floating coordinates ("compact" coordinates, at most S + K),
// and writes zeros in every other coordinate of u (those of a compiled
// Sum's other children).
//
// Built by blueice_tpu_torch/ops/fused.py build_library with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 4;
constexpr int kMaxS = 8;
constexpr int kMaxN = 32;
constexpr int kMaxAnchors = 256;
constexpr int kMaxPriors = 32;
constexpr int kSlotShape = 0;
constexpr int kSlotRate = kSlotShape + kMaxK;
constexpr int kSlotEff = kSlotRate + kMaxS;
constexpr int kSlotLive = kSlotEff + kMaxS;
constexpr int kSlotPrior = kSlotLive + 1;
constexpr int kSlots = kSlotPrior + kMaxPriors;

// Where a slot's value comes from
constexpr int kFloating = 0;   // x = Transform(u) at column src_pos
constexpr int kRuntime = 1;    // fv at column src_pos
constexpr int kConstant = 2;   // src_val

constexpr int kFwdThreads = 256;
constexpr int kChainThreads = 128;
constexpr int kGroup = 16;      // chain threads a lane

// Mirrored field for field by ops/param_graph.py _Desc (ctypes): 4-byte
// fields only, so neither side pads.
struct GraphDesc {
  int S, K, n, R, G, n_prior, has_live;
  int stride[kMaxK];
  int n_anchor[kMaxK];
  int anchor_off[kMaxK];
  int tkind[kMaxN];              // transform of each column of u
  float tlo[kMaxN], thi[kMaxN];
  int src_kind[kSlots], src_pos[kSlots];
  float src_val[kSlots];
  int cpos[kMaxK + kMaxS];       // compact coordinate -> column of u, or -1
  int t_c[kMaxK], rate_c[kMaxS], eff_c[kMaxS], prior_c[kMaxPriors];
  float inv_base;                // 1 / base live time (float32)
  float prior_mu[kMaxPriors], prior_inv[kMaxPriors], prior_log[kMaxPriors];
  float prior_inv2[kMaxPriors], prior_hess[kMaxPriors];
  float log_sqrt_2pi;
  float anchors[kMaxAnchors];
};

// x of one coordinate: kinds 0 identity, 1 lo + exp(u), 2 lo + (hi - lo)
// sigmoid(u), 3 hi - exp(-u); sigmoid as PyTorch's CUDA kernel takes it,
// 1 / (1 + exp(-u)).
__device__ __forceinline__ float to_x(int kind, float lo, float hi,
                                      float u) {
  if (kind == 0) return u;
  if (kind == 1) return __fadd_rn(lo, expf(u));
  if (kind == 2) {
    const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-u)));
    return __fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), sig));
  }
  return __fsub_rn(hi, expf(-u));
}

// (dx/du, d2x/du2) of one coordinate.
__device__ __forceinline__ void to_x_derivs(int kind, float lo, float hi,
                                            float u, float& d1, float& d2) {
  if (kind == 0) {
    d1 = 1.0f;
    d2 = 0.0f;
  } else if (kind == 1) {
    d1 = d2 = expf(u);
  } else if (kind == 2) {
    const float sig = 1.0f / (1.0f + expf(-u));
    d1 = (hi - lo) * sig * (1.0f - sig);
    d2 = d1 * (1.0f - 2.0f * sig);
  } else {
    d1 = expf(-u);
    d2 = -d1;
  }
}

__device__ __forceinline__ float slot_value(const GraphDesc& d, int slot,
                                            const float* ur,
                                            const float* fr) {
  const int kind = d.src_kind[slot], pos = d.src_pos[slot];
  if (kind == kFloating)
    return to_x(d.tkind[pos], d.tlo[pos], d.thi[pos], ur[pos]);
  if (kind == kRuntime) return fr[pos];
  return d.src_val[slot];
}

// minimum(maximum(v, lo), hi) with PyTorch's NaN propagation.
__device__ __forceinline__ float clip(float v, float lo, float hi) {
  if (v != v) return v;
  v = v > lo ? v : lo;
  return v < hi ? v : hi;
}

// d/dv of clip(v, lo, hi) as JAX differentiates jnp.clip: 1 inside, 0
// outside, 0.5 exactly on a bound (fitter.py _tie_slope).
__device__ __forceinline__ float tie_slope(float v, float lo, float hi) {
  const float f1 = v > lo ? 1.0f : (v == lo ? 0.5f : 0.0f);
  const float vl = (v != v) ? v : (v > lo ? v : lo);
  const float f2 = vl < hi ? 1.0f : (vl == hi ? 0.5f : 0.0f);
  return f1 * f2;
}

struct Cell {
  int i;          // lower anchor index
  float t;        // lerp weight in [0, 1]
  float slope;    // dt/dz, JAX's clip derivatives
};

// Axis k at shape value z: clip onto the anchors, searchsorted-right minus
// one clamped to [0, n - 2], t = clip((zc - lo) / (hi - lo), 0, 1).
__device__ __forceinline__ Cell cell_of(const GraphDesc& d, int k, float z) {
  const float* a = d.anchors + d.anchor_off[k];
  const int na = d.n_anchor[k];
  const float a0 = a[0], a1 = a[na - 1];
  const float zc = clip(z, a0, a1);
  int c = 0;
  for (int j = 0; j < na; ++j) c += !(a[j] > zc);
  c = min(max(c - 1, 0), na - 2);
  const float lo = a[c];
  const float width = __fsub_rn(a[c + 1], lo);
  const float y = __fdiv_rn(__fsub_rn(zc, lo), width);
  Cell out;
  out.i = c;
  out.t = clip(y, 0.0f, 1.0f);
  out.slope = tie_slope(z, a0, a1) * tie_slope(y, 0.0f, 1.0f) / width;
  return out;
}

// Flattened-grid id of corner c (bit K-1-k of c: the upper anchor on axis
// k) of the cell at flat offset base, clamped to [0, G - 1] as
// ops/fused.py corner_ids clamps it.
template <int K>
__device__ __forceinline__ int corner_id(const GraphDesc& d, int base,
                                         int c) {
  int id = base;
#pragma unroll
  for (int k = 0; k < K; ++k)
    if ((c >> (K - 1 - k)) & 1) id += d.stride[k];
  return min(max(id, 0), d.G - 1);
}

template <int K>
__global__ void __launch_bounds__(kFwdThreads) graph_fwd_kernel(
    const GraphDesc* __restrict__ gd, int rows, int reps,
    const float* __restrict__ u, const float* __restrict__ fv,
    const float* __restrict__ mus, long long* __restrict__ idx_out,
    float* __restrict__ t_out, float* __restrict__ m_out,
    float* __restrict__ prior_out, float* __restrict__ x_out) {
  constexpr int C = 1 << K;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const GraphDesc& d = *gd;
  const int S = d.S;
  const float* ur = u + (size_t)r * d.n;
  const float* fr = fv + (size_t)(r / reps) * d.R;

  float t[K];
  int base = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const Cell c = cell_of(d, k, slot_value(d, kSlotShape + k, ur, fr));
    t[k] = c.t;
    base += c.i * d.stride[k];
    idx_out[(size_t)r * K + k] = c.i;
    t_out[(size_t)r * K + k] = c.t;
  }
  int id[C];
#pragma unroll
  for (int c = 0; c < C; ++c) id[c] = corner_id<K>(d, base, c);
  const bool live = d.has_live != 0;
  const float scale =
      live ? __fmul_rn(slot_value(d, kSlotLive, ur, fr), d.inv_base) : 1.0f;

  for (int s = 0; s < S; ++s) {
    float v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = __ldg(mus + (size_t)id[c] * S + s);
      if (live) v[c] = __fmul_rn(v[c], scale);
    }
    // axis by axis, axis 0 first: (1 - t) * lower + t * upper
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int half = C >> (k + 1);
      const float w0 = __fsub_rn(1.0f, t[k]);
#pragma unroll
      for (int j = 0; j < half; ++j)
        v[j] = __fadd_rn(__fmul_rn(w0, v[j]), __fmul_rn(t[k], v[j + half]));
    }
    const float R = slot_value(d, kSlotRate + s, ur, fr);
    const float E = slot_value(d, kSlotEff + s, ur, fr);
    m_out[(size_t)r * S + s] = __fmul_rn(__fmul_rn(v[0], R), E);
  }

  // -0.5 z^2 - log(sigma) - log(sqrt(2 pi)), z = (x - mu) / sigma
  float prior = 0.0f;
  for (int p = 0; p < d.n_prior; ++p) {
    const float z = __fmul_rn(
        __fsub_rn(slot_value(d, kSlotPrior + p, ur, fr), d.prior_mu[p]),
        d.prior_inv[p]);
    const float term = __fsub_rn(
        __fsub_rn(__fmul_rn(__fmul_rn(z, -0.5f), z), d.prior_log[p]),
        d.log_sqrt_2pi);
    prior = __fadd_rn(prior, term);
  }
  prior_out[r] = prior;

  if (x_out != nullptr)
    for (int j = 0; j < d.n; ++j)
      x_out[(size_t)r * d.n + j] = to_x(d.tkind[j], d.tlo[j], d.thi[j],
                                        ur[j]);
}

// The chain rule of one lane, by a group of kGroup threads, in the graph's
// M = S + K compact coordinates. With the Jacobian J (M x M) of (m, t) in
// x (rows: the S sources, then the K axes),
//   G = J^T g_mt + prior gradient,
//   Q = J^T H_mt J + sum_s g_mt[s] d2m_s/dx2 + prior Hessian (diagonal),
// and in u: g = -(d1 G), H = -(d1 d1^T Q + diag(d2 G)), d1 and d2 the
// transform's first and second derivatives. Thread j of the group takes
// corner j of the cell (the corner sums mus(t), dmus/dt and the cross
// second derivatives, then summed over the group by a butterfly, which
// leaves every thread the same bits), then compact coordinate a = j: its
// column of J, G_a, and the row a of Q from the upper triangle (b >= a),
// with the columns b shuffled in from their threads. S is read at run
// time (arrays of kMaxS, the sources past S zero); K is the template's.
template <int K>
__global__ void __launch_bounds__(kChainThreads) graph_chain_kernel(
    const GraphDesc* __restrict__ gd, int lanes,
    const float* __restrict__ u, const float* __restrict__ fv,
    const float* __restrict__ mus, const float* __restrict__ g_mt,
    const float* __restrict__ h_mt, float* __restrict__ g_out,
    float* __restrict__ h_out) {
  constexpr int C = 1 << K;
  constexpr int NP = K * (K - 1) / 2;
  constexpr int NPA = NP > 0 ? NP : 1;
  constexpr int SX = kMaxS;
  static_assert(C <= kGroup && kMaxS + kMaxK <= kGroup, "one group a lane");
  const int l = (blockIdx.x * blockDim.x + threadIdx.x) / kGroup;
  if (l >= lanes) return;   // the whole group
  const int j = threadIdx.x % kGroup;
  const unsigned mask = 0xFFFFu << (threadIdx.x & 16);
  const GraphDesc& d = *gd;
  const int S = d.S, M = S + K, n = d.n;
  const float* ur = u + (size_t)l * n;
  const float* fr = fv + (size_t)l * d.R;
  const float* gm = g_mt + (size_t)l * M;
  const float* hm = h_mt + (size_t)l * M * M;

  int tc[K];
  float t[K], slope[K];
  int base = 0;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const Cell c = cell_of(d, k, slot_value(d, kSlotShape + k, ur, fr));
    t[k] = c.t;
    slope[k] = c.slope;
    base += c.i * d.stride[k];
    tc[k] = d.t_c[k];
  }
  const float scale =
      d.has_live ? __fmul_rn(slot_value(d, kSlotLive, ur, fr), d.inv_base)
                 : 1.0f;

  // corner j's share of mus(t), its t-derivatives and its cross second
  // derivatives (pairs k < e in row-major order; the diagonal is zero: mus
  // is multilinear in t), from the corner weight prod_k (bit ? t_k :
  // 1 - t_k) and its derivatives
  float mu[SX], dm[SX][K], dx[SX][NPA];
#pragma unroll
  for (int s = 0; s < SX; ++s) {
    mu[s] = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) dm[s][k] = 0.0f;
#pragma unroll
    for (int p = 0; p < NPA; ++p) dx[s][p] = 0.0f;
  }
  if (j < C) {
    const int id = corner_id<K>(d, base, j);
    float f[K], sg[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const bool up = (j >> (K - 1 - k)) & 1;
      f[k] = up ? t[k] : 1.0f - t[k];
      sg[k] = up ? 1.0f : -1.0f;
    }
    float w = 1.0f, wd[K], wx[NPA];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      w *= f[k];
      float q = sg[k];
#pragma unroll
      for (int i = 0; i < K; ++i)
        if (i != k) q *= f[i];
      wd[k] = q;
    }
    int p = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = k + 1; e < K; ++e) {
        float q = sg[k] * sg[e];
#pragma unroll
        for (int i = 0; i < K; ++i)
          if (i != k && i != e) q *= f[i];
        wx[p++] = q;
      }
#pragma unroll
    for (int s = 0; s < SX; ++s) {
      if (s >= S) break;
      const float v = __ldg(mus + (size_t)id * S + s) * scale;
      mu[s] = w * v;
#pragma unroll
      for (int k = 0; k < K; ++k) dm[s][k] = wd[k] * v;
#pragma unroll
      for (int q = 0; q < NP; ++q) dx[s][q] = wx[q] * v;
    }
  }
#pragma unroll
  for (int off = kGroup / 2; off > 0; off >>= 1) {
#pragma unroll
    for (int s = 0; s < SX; ++s) {
      if (s >= S) break;
      mu[s] += __shfl_xor_sync(mask, mu[s], off, kGroup);
#pragma unroll
      for (int k = 0; k < K; ++k)
        dm[s][k] += __shfl_xor_sync(mask, dm[s][k], off, kGroup);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        dx[s][q] += __shfl_xor_sync(mask, dx[s][q], off, kGroup);
    }
  }

  float Rv[SX], Ev[SX], F[SX], gs[SX];
  int rc[SX], ec[SX];
  float Y[NPA];   // sum_s g_s F_s d2mus_s/dt_k dt_e, pair by pair
#pragma unroll
  for (int q = 0; q < NPA; ++q) Y[q] = 0.0f;
#pragma unroll
  for (int s = 0; s < SX; ++s) {
    Rv[s] = Ev[s] = F[s] = gs[s] = 0.0f;
    rc[s] = ec[s] = -1;
    if (s >= S) continue;
    Rv[s] = slot_value(d, kSlotRate + s, ur, fr);
    Ev[s] = slot_value(d, kSlotEff + s, ur, fr);
    F[s] = Rv[s] * Ev[s];
    rc[s] = d.rate_c[s];
    ec[s] = d.eff_c[s];
    gs[s] = __ldg(gm + s);
#pragma unroll
    for (int q = 0; q < NP; ++q) Y[q] += gs[s] * F[s] * dx[s][q];
  }
  float gt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) gt[k] = __ldg(gm + S + k);

  // dmus_s/dt . dt/dx_a, and dF_s/dx_a (F = R E)
  auto dmus = [&](int s, int a) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (tc[k] == a) v = dm[s][k] * slope[k];
    return v;
  };
  auto dF = [&](int s, int a) {
    return (rc[s] == a ? Ev[s] : 0.0f) + (ec[s] == a ? Rv[s] : 0.0f);
  };

  // this thread's column a = j of J, G_a and the transform at a
  const int a = j;
  float Js[SX], Jt[K];
  float G = 0.0f;
#pragma unroll
  for (int s = 0; s < SX; ++s) {
    Js[s] = s < S ? dmus(s, a) * F[s] + mu[s] * dF(s, a) : 0.0f;
    G += Js[s] * gs[s];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    Jt[k] = tc[k] == a ? slope[k] : 0.0f;
    G += Jt[k] * gt[k];
  }
  float ph = 0.0f;
  for (int p = 0; p < d.n_prior; ++p) {
    if (d.prior_c[p] != a) continue;
    const float x = slot_value(d, kSlotPrior + p, ur, fr);
    G += -(x - d.prior_mu[p]) * d.prior_inv2[p];
    ph += d.prior_hess[p];
  }
  const int ca = a < M ? d.cpos[a] : -1;
  float d1 = 1.0f, d2 = 0.0f;
  if (ca >= 0)
    to_x_derivs(d.tkind[ca], d.tlo[ca], d.thi[ca], ur[ca], d1, d2);

  // V = J[:, a]^T H_mt
  float Vs[SX], Vt[K];
#pragma unroll
  for (int s = 0; s < SX; ++s) Vs[s] = 0.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) Vt[k] = 0.0f;
  auto add_row = [&](float jr, const float* hr) {
#pragma unroll
    for (int s = 0; s < SX; ++s)
      if (s < S) Vs[s] += jr * __ldg(hr + s);
#pragma unroll
    for (int k = 0; k < K; ++k) Vt[k] += jr * __ldg(hr + S + k);
  };
#pragma unroll
  for (int s = 0; s < SX; ++s) {
    if (s >= S) break;
    add_row(Js[s], hm + (size_t)s * M);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) add_row(Jt[k], hm + (size_t)(S + k) * M);

  float* go = g_out + (size_t)l * n;
  float* ho = h_out + (size_t)l * n * n;
  for (int i = j; i < n * n; i += kGroup) ho[i] = 0.0f;
  for (int i = j; i < n; i += kGroup) go[i] = 0.0f;
  __syncwarp(mask);
  if (ca >= 0) go[ca] = -(d1 * G);
  // row a of Q over b >= a, each entry written to both triangles
#pragma unroll
  for (int b = 0; b < kMaxS + kMaxK; ++b) {
    float Jbs[SX], Jbt[K];
#pragma unroll
    for (int s = 0; s < SX; ++s)
      Jbs[s] = __shfl_sync(mask, Js[s], b, kGroup);
#pragma unroll
    for (int k = 0; k < K; ++k)
      Jbt[k] = __shfl_sync(mask, Jt[k], b, kGroup);
    const float d1b = __shfl_sync(mask, d1, b, kGroup);
    if (b < a || b >= M || ca < 0) continue;
    const int cb = d.cpos[b];
    if (cb < 0) continue;
    float q = a == b ? ph : 0.0f;
#pragma unroll
    for (int s = 0; s < SX; ++s) q += Vs[s] * Jbs[s];
#pragma unroll
    for (int k = 0; k < K; ++k) q += Vt[k] * Jbt[k];
    // sum_s g_s d2m_s/dx_a dx_b, m_s = mus_s(t) F_s
    int p = 0;
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int e = k + 1; e < K; ++e, ++p)
        if ((tc[k] == a && tc[e] == b) || (tc[e] == a && tc[k] == b))
          q += Y[p] * slope[k] * slope[e];
#pragma unroll
    for (int s = 0; s < SX; ++s) {
      if (s >= S) break;
      const float d2F = (rc[s] == a && ec[s] == b ? 1.0f : 0.0f) +
                        (ec[s] == a && rc[s] == b ? 1.0f : 0.0f);
      q += gs[s] * (dmus(s, a) * dF(s, b) + dF(s, a) * dmus(s, b) +
                    mu[s] * d2F);
    }
    const float h = -(d1 * d1b * q + (a == b ? d2 * G : 0.0f));
    ho[(size_t)ca * n + cb] = h;
    ho[(size_t)cb * n + ca] = h;
  }
}

}  // namespace

extern "C" {

// sizeof(GraphDesc): the Python side checks its ctypes mirror against it.
int bt_graph_desc_bytes() { return (int)sizeof(GraphDesc); }

// Returns cudaGetLastError() after the launch (0 = success), or -1 when
// (S, K) is outside the kernels' range (1 <= S <= 8, 1 <= K <= 4). desc is
// a device copy of the GraphDesc; x may be null (not written). rows = L *
// reps rows of u, row r reading fv row r / reps.
int bt_graph_fwd(int S, int K, int rows, int reps, const void* desc,
                 const float* u, const float* fv, const float* mus,
                 long long* idx, float* t, float* m, float* prior, float* x,
                 cudaStream_t stream) {
  if (S < 1 || S > kMaxS || K < 1 || K > kMaxK) return -1;
  if (rows <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
  const GraphDesc* gd = static_cast<const GraphDesc*>(desc);
  const int blocks = (rows + kFwdThreads - 1) / kFwdThreads;
#define PG_FWD_CASE(K_)                                                   \
  case K_:                                                                \
    graph_fwd_kernel<K_><<<blocks, kFwdThreads, 0, stream>>>(             \
        gd, rows, reps, u, fv, mus, idx, t, m, prior, x);                 \
    break;
  switch (K) {
    PG_FWD_CASE(1) PG_FWD_CASE(2) PG_FWD_CASE(3) PG_FWD_CASE(4)
  }
#undef PG_FWD_CASE
  return (int)cudaGetLastError();
}

// As bt_graph_fwd: g_mt (lanes, S + K), h_mt (lanes, S + K, S + K) in;
// g (lanes, n), h (lanes, n, n) out.
int bt_graph_chain(int S, int K, int lanes, const void* desc, const float* u,
                   const float* fv, const float* mus, const float* g_mt,
                   const float* h_mt, float* g, float* h,
                   cudaStream_t stream) {
  if (S < 1 || S > kMaxS || K < 1 || K > kMaxK) return -1;
  if (lanes <= 0) return 0;
  cudaGetLastError();
  const GraphDesc* gd = static_cast<const GraphDesc*>(desc);
  const long long threads = (long long)lanes * kGroup;
  const int blocks = (int)((threads + kChainThreads - 1) / kChainThreads);
#define PG_CHAIN_CASE(K_)                                                 \
  case K_:                                                                \
    graph_chain_kernel<K_><<<blocks, kChainThreads, 0, stream>>>(         \
        gd, lanes, u, fv, mus, g_mt, h_mt, g, h);                         \
    break;
  switch (K) {
    PG_CHAIN_CASE(1) PG_CHAIN_CASE(2) PG_CHAIN_CASE(3) PG_CHAIN_CASE(4)
  }
#undef PG_CHAIN_CASE
  return (int)cudaGetLastError();
}

}  // extern "C"
