// The Newton step of the batched fits (parallel/fitter.py minimize_newton)
// as two kernels for NVIDIA Hopper (sm_90a), one on either side of the
// step's value call:
//
//   newton_cands_kernel<T,N>   one thread per lane: the lane's gradient and
//                              Hessian made finite (non-finite -> 0), then
//                              every damped solve of the step (the Newton
//                              step, each snap candidate's reduced system,
//                              the active-set system) and the step's
//                              line-search candidates (L, A, n) in the
//                              PyTorch step's order: 3 alpha steps, the
//                              drop-direction steps, the jumps, the snaps,
//                              the active set.
//   newton_accept_kernel<T,N>  one thread per lane, after the value call:
//                              the first least candidate value (non-finite
//                              as +inf), the gain ratio and the Nielsen
//                              damping update, the stop rule and the polish
//                              entry, written straight into the fit's batch
//                              state at the lane (u, f, lam, nu, it, done,
//                              stall, pc, improved).
//
// T is float or double (the fit's dtype). N is the number of floating
// coordinates for 1 <= N <= 16, where a lane's vectors and its factor live
// in registers; N = 0 takes any n at run time, a lane's vectors and its
// matrix in a workspace the caller passes (column-interleaved over the
// lanes, entry k of lane l at ws[k * L + l]). 34 instantiations a kernel.
//
// They replace no TPU kernel: the JAX package runs this step inside one
// jitted lax.while_loop body (blueice_tpu/parallel/fitter.py), where XLA
// fuses it. In eager PyTorch the same step is some hundred small
// operations an iteration and six batched Cholesky factors and solves, each
// of which waits for the card; that PyTorch step stays as the twin these
// kernels are tested against, and runs on the CPU.
//
// What bounds them on an H100: neither bytes nor operations. A lane reads
// its g and H (288 bytes at N = 8 in float32) and writes A x N candidates
// (384 bytes at A = 12); the accept kernel reads the lane's A values, the
// winning candidate, g and H and its state. The solves are N^3 / 3 fused
// multiply-adds each. What costs is the launch: two where the PyTorch step
// made hundreds and drained the queue six times.
//
// Numbers: everything outside the solves takes the PyTorch step's
// elementwise operations with their roundings (explicitly rounded
// intrinsics, so that no multiply-add is contracted); the sums (the ascent
// test's g . du, the gain ratio's g . du and du . H du) add in sequence,
// where the PyTorch step's reductions and its batched matrix product may
// add in another order. So the candidates, the damping and the stop rule
// agree to the last bit except where a sum's sign decides: near zero the
// ascent test (g . du > 0, which picks the steepest-descent rescue) and the
// gain ratio's predicted decrease (> 0, which picks the damping's shrink)
// may come out the other way, within float rounding of the sum. The solves
// follow _solve_spd_small: the closed forms for N <= 3, a Cholesky factor
// (row by row) and two triangular solves for 4 <= N <= 16, where a pivot
// that is not > 0 (NaN included) gives NaN in every entry, as
// torch.linalg.cholesky_ex's info != 0 does there; for n > 16 (N = 0) an LU
// factor with partial pivoting, NaN where a pivot is 0, as
// torch.linalg.solve_ex's info != 0. Their sums run in another order than
// the batched library factor's: float rounding, no more.
//
// Tables: the step's numbers, built once per fit on the host
// (ops/newton_step.py build_table) and copied to the card once, as one
// float64 array: the 3 alphas, the kink coordinates (the drop directions),
// the jumps, the snapped coordinates, the offsets of each one's anchors,
// and the anchors (u-space). Its counts are kernel parameters (Step).
//
// Built by blueice_tpu_torch/ops/fused.py build_library with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16;
constexpr int kAlphas = 3;
constexpr int kThreads = 128;

// The step's counts and its table on the card (see the header).
struct Step {
  int n;
  int n_drop;
  int n_jump;
  int n_snap;
  int A;
  const double* tab;

  __device__ __forceinline__ double alpha(int k) const { return __ldg(tab + k); }
  __device__ __forceinline__ int drop(int k) const {
    return (int)__ldg(tab + kAlphas + k);
  }
  __device__ __forceinline__ double jump(int j) const {
    return __ldg(tab + kAlphas + n_drop + j);
  }
  __device__ __forceinline__ int snap_coord(int s) const {
    return (int)__ldg(tab + kAlphas + n_drop + n_jump + s);
  }
  __device__ __forceinline__ int snap_off(int s) const {
    return (int)__ldg(tab + kAlphas + n_drop + n_jump + n_snap + s);
  }
  __device__ __forceinline__ double anchor(int k) const {
    return __ldg(tab + kAlphas + n_drop + n_jump + 2 * n_snap + 1 + k);
  }
};

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

__device__ __forceinline__ float abs_rn(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_rn(double a) { return fabs(a); }
__device__ __forceinline__ float sqrt_rn(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double sqrt_rn(double a) { return __dsqrt_rn(a); }
__device__ __forceinline__ bool is_fin(float a) { return isfinite(a); }
__device__ __forceinline__ bool is_fin(double a) { return isfinite(a); }

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fc00000);
}
template <> __device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}
template <typename T> __device__ __forceinline__ T infinity();
template <> __device__ __forceinline__ float infinity<float>() {
  return __int_as_float(0x7f800000);
}
template <> __device__ __forceinline__ double infinity<double>() {
  return __longlong_as_double(0x7ff0000000000000LL);
}

template <typename T>
__device__ __forceinline__ T finite_or_zero(T x) {
  return is_fin(x) ? x : T(0);
}

// torch.clamp(x, min=lo): NaN stays NaN.
template <typename T>
__device__ __forceinline__ T clamp_min(T x, T lo) {
  return x < lo ? lo : x;
}

// A lane's vector of n values: registers for N > 0 (the loops over it
// unroll, so every index is a constant), a column of the workspace for
// N = 0 (entry i at p[i * s]).
template <typename T, int N>
struct Vec {
  T v[N];
  __device__ __forceinline__ T& operator[](int i) { return v[i]; }
  __device__ __forceinline__ const T& operator[](int i) const { return v[i]; }
};
template <typename T>
struct Vec<T, 0> {
  T* p;
  size_t s;
  __device__ __forceinline__ T& operator[](int i) const {
    return p[(size_t)i * s];
  }
};

// Hands out a lane's vectors (and, for N = 0, its n x (n + 1) matrix) in
// turn: for N > 0 registers, for N = 0 consecutive columns of the
// workspace.
template <typename T, int N>
struct Work {
  __device__ __forceinline__ Work(T*, int, int, int) {}
  __device__ __forceinline__ Vec<T, N> vec() { return Vec<T, N>(); }
};
template <typename T>
struct Work<T, 0> {
  T* base;
  size_t L;
  int n;
  size_t used;
  __device__ __forceinline__ Work(T* ws, int n_, int L_, int l)
      : base(ws + l), L((size_t)L_), n(n_), used(0) {}
  __device__ __forceinline__ Vec<T, 0> vec() {
    Vec<T, 0> v{base + used * L, L};
    used += n;
    return v;
  }
  __device__ __forceinline__ Vec<T, 0> mat() {
    Vec<T, 0> v{base + used * L, L};
    used += (size_t)n * (n + 1);
    return v;
  }
};

// H[i][j] of a lane's row-major n x n Hessian, made finite.
template <typename T>
__device__ __forceinline__ T h_at(const T* __restrict__ Hl, int n, int i,
                                  int j) {
  return finite_or_zero(__ldg(Hl + i * n + j));
}

// Entry (i, j) of the damped system Hm + diag(lam d): Hm = H (.) (m m^T) +
// diag(1 - m), m a 0/1 mask (all ones for the Newton step), d = max(|diag
// Hm|, 1e-10); as the PyTorch step forms it, op by op.
template <typename T, typename V>
__device__ __forceinline__ T damped_entry(const T* __restrict__ Hl, int n,
                                          const V& m, T lam, int i, int j) {
  T h = mul_rn(h_at(Hl, n, i, j), mul_rn(m[i], m[j]));
  if (i == j) {
    h = add_rn(h, sub_rn(T(1), m[i]));
    const T d = clamp_min(abs_rn(h), T(1e-10));
    h = add_rn(h, mul_rn(lam, d));
  }
  return h;
}

// x = -(Hm + diag(lam d))^-1 gm (see damped_entry): _solve_spd_small's
// closed forms for N <= 3; for 4 <= N <= 16 a Cholesky factor of the lower
// triangle, NaN in every entry where a pivot is not > 0; for N = 0 (n > 16)
// an LU factor with partial pivoting of [A | gm] in the workspace, NaN
// where a pivot is 0.
template <typename T, int N>
__device__ __forceinline__ void damped_solve(const T* __restrict__ Hl, int n,
                                             const Vec<T, N>& m,
                                             const Vec<T, N>& gm, T lam,
                                             Vec<T, N>& x, Work<T, N>& w) {
  if constexpr (N >= 1 && N <= 3) {
    T a[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) a[i][j] = damped_entry(Hl, N, m, lam, i, j);
    if constexpr (N == 1) {
      x[0] = -div_rn(gm[0], a[0][0]);
    } else if constexpr (N == 2) {
      const T det = sub_rn(mul_rn(a[0][0], a[1][1]), mul_rn(a[0][1], a[1][0]));
      x[0] = -div_rn(sub_rn(mul_rn(a[1][1], gm[0]), mul_rn(a[0][1], gm[1])),
                     det);
      x[1] = -div_rn(sub_rn(mul_rn(a[0][0], gm[1]), mul_rn(a[1][0], gm[0])),
                     det);
    } else {
      const T c00 = sub_rn(mul_rn(a[1][1], a[2][2]), mul_rn(a[1][2], a[2][1]));
      const T c01 = sub_rn(mul_rn(a[1][2], a[2][0]), mul_rn(a[1][0], a[2][2]));
      const T c02 = sub_rn(mul_rn(a[1][0], a[2][1]), mul_rn(a[1][1], a[2][0]));
      const T det = add_rn(add_rn(mul_rn(a[0][0], c00), mul_rn(a[0][1], c01)),
                           mul_rn(a[0][2], c02));
      const T c10 = sub_rn(mul_rn(a[0][2], a[2][1]), mul_rn(a[0][1], a[2][2]));
      const T c11 = sub_rn(mul_rn(a[0][0], a[2][2]), mul_rn(a[0][2], a[2][0]));
      const T c12 = sub_rn(mul_rn(a[0][1], a[2][0]), mul_rn(a[0][0], a[2][1]));
      const T c20 = sub_rn(mul_rn(a[0][1], a[1][2]), mul_rn(a[0][2], a[1][1]));
      const T c21 = sub_rn(mul_rn(a[0][2], a[1][0]), mul_rn(a[0][0], a[1][2]));
      const T c22 = sub_rn(mul_rn(a[0][0], a[1][1]), mul_rn(a[0][1], a[1][0]));
      const T c[3][3] = {{c00, c01, c02}, {c10, c11, c12}, {c20, c21, c22}};
#pragma unroll
      for (int j = 0; j < 3; ++j)
        x[j] = -div_rn(add_rn(add_rn(mul_rn(c[0][j], gm[0]),
                                     mul_rn(c[1][j], gm[1])),
                              mul_rn(c[2][j], gm[2])),
                       det);
    }
  } else if constexpr (N > 3) {
    // packed lower triangle, row i at i (i + 1) / 2
    T a[N * (N + 1) / 2];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j <= i; ++j)
        a[i * (i + 1) / 2 + j] = damped_entry(Hl, N, m, lam, i, j);
    bool ok = true;
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        T s = a[i * (i + 1) / 2 + j];
#pragma unroll
        for (int k = 0; k < j; ++k)
          s -= a[i * (i + 1) / 2 + k] * a[j * (j + 1) / 2 + k];
        if (i == j) {
          ok = ok && s > T(0);
          a[i * (i + 1) / 2 + i] = sqrt_rn(s);
        } else {
          a[i * (i + 1) / 2 + j] = s / a[j * (j + 1) / 2 + j];
        }
      }
    }
    T y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      T s = gm[i];
#pragma unroll
      for (int k = 0; k < i; ++k) s -= a[i * (i + 1) / 2 + k] * y[k];
      y[i] = s / a[i * (i + 1) / 2 + i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
      T s = y[i];
#pragma unroll
      for (int k = i + 1; k < N; ++k) s -= a[k * (k + 1) / 2 + i] * x[k];
      x[i] = s / a[i * (i + 1) / 2 + i];
    }
    const T nan = quiet_nan<T>();
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = ok ? -x[i] : nan;
  } else {
    // [A | gm] row-major in the workspace, (i, j) at a[i * (n + 1) + j]
    const Vec<T, 0> a = w.mat();
    const int c = n + 1;
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) a[i * c + j] = damped_entry(Hl, n, m, lam, i, j);
      a[i * c + n] = gm[i];
    }
    bool ok = true;
    for (int k = 0; k < n; ++k) {
      int p = k;
      T big = abs_rn(a[k * c + k]);
      for (int i = k + 1; i < n; ++i) {
        const T v = abs_rn(a[i * c + k]);
        if (v > big) {
          big = v;
          p = i;
        }
      }
      if (!(big > T(0))) {
        ok = false;
        continue;
      }
      if (p != k)
        for (int j = k; j <= n; ++j) {
          const T t = a[k * c + j];
          a[k * c + j] = a[p * c + j];
          a[p * c + j] = t;
        }
      const T piv = a[k * c + k];
      for (int i = k + 1; i < n; ++i) {
        const T f = a[i * c + k] / piv;
        for (int j = k + 1; j <= n; ++j) a[i * c + j] -= f * a[k * c + j];
      }
    }
    for (int i = n - 1; i >= 0; --i) {
      T s = a[i * c + n];
      for (int k = i + 1; k < n; ++k) s -= a[i * c + k] * x[k];
      x[i] = s / a[i * c + i];
    }
    const T nan = quiet_nan<T>();
    for (int i = 0; i < n; ++i) x[i] = ok ? -x[i] : nan;
  }
}

template <typename T, typename V>
__device__ __forceinline__ bool all_finite(const V& x, int n) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < n; ++i) ok = ok && is_fin(x[i]);
  return ok;
}

// The step's systems in one loop, so the solve is inlined once: system 0
// the Newton step, 1..n_snap the snaps, n_snap + 1 the active set (with
// snaps only).
template <typename T, int N>
__global__ void __launch_bounds__(kThreads) newton_cands_kernel(
    const Step d, int L, const long long* __restrict__ lanes,
    const T* __restrict__ u, const T* __restrict__ lam,
    const T* __restrict__ g, const T* __restrict__ H,
    T* __restrict__ cands, T* __restrict__ ws) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int n = N > 0 ? N : d.n;
  const long long b = lanes[l];
  const T* Hl = H + (size_t)l * n * n;
  Work<T, N> w(ws, n, L, l);
  Vec<T, N> uv = w.vec(), gv = w.vec(), act = w.vec(), m = w.vec(),
            gm = w.vec(), x = w.vec();
#pragma unroll
  for (int i = 0; i < n; ++i) {
    uv[i] = u[b * n + i];
    gv[i] = finite_or_zero(g[(size_t)l * n + i]);
    act[i] = T(1);
  }
  const T lm = lam[b];
  T* out = cands + (size_t)l * d.A * n;
  const int snap_base = kAlphas + d.n_drop * (1 + d.n_jump);
  const int n_sys = d.n_snap ? d.n_snap + 2 : 1;
  for (int sys = 0; sys < n_sys; ++sys) {
    const int s = sys - 1;
    const bool snap = sys >= 1 && s < d.n_snap;
    const int ci = snap ? d.snap_coord(s) : -1;
    T nearest = T(0), dist_min = T(0);
    if (snap) {
      T uc = T(0);
#pragma unroll
      for (int i = 0; i < n; ++i)
        if (i == ci) uc = uv[i];
      // the nearest anchor, the first of equals (torch.argmin)
      for (int k = d.snap_off(s); k < d.snap_off(s + 1); ++k) {
        const T au = T(d.anchor(k));
        const T dist = abs_rn(sub_rn(au, uc));
        if (k == d.snap_off(s) || dist < dist_min) {
          dist_min = dist;
          nearest = au;
        }
      }
      const T delta = sub_rn(nearest, uc);
#pragma unroll
      for (int i = 0; i < n; ++i) {
        m[i] = i == ci ? T(0) : T(1);
        gm[i] = mul_rn(add_rn(gv[i], mul_rn(h_at(Hl, n, i, ci), delta)),
                       m[i]);
      }
    } else if (sys == 0) {
#pragma unroll
      for (int i = 0; i < n; ++i) {
        m[i] = T(1);
        gm[i] = gv[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < n; ++i) {
        m[i] = act[i];
        gm[i] = mul_rn(gv[i], act[i]);
      }
    }
    Work<T, N> sw = w;   // the solve's matrix: the workspace after the vectors
    damped_solve<T, N>(Hl, n, m, gm, lm, x, sw);
    if (sys == 0) {
      // an indefinite damped Hessian: the scaled steepest-descent rescue;
      // an ascent proposal: the curvature-scaled steepest-descent step
      if (!all_finite<T>(x, n)) {
        const T lc = clamp_min(lm, T(1));
#pragma unroll
        for (int i = 0; i < n; ++i)
          x[i] = div_rn(-gv[i],
                        mul_rn(lc, clamp_min(abs_rn(h_at(Hl, n, i, i)),
                                             T(1e-10))));
      }
      T gdu = T(0);
#pragma unroll
      for (int i = 0; i < n; ++i) gdu = add_rn(gdu, mul_rn(gv[i], x[i]));
      if (gdu > T(0)) {
#pragma unroll
        for (int i = 0; i < n; ++i)
          x[i] = div_rn(-gv[i],
                        mul_rn(clamp_min(abs_rn(h_at(Hl, n, i, i)), T(1e-10)),
                               add_rn(T(1), lm)));
      }
      int a = 0;
      for (int k = 0; k < kAlphas; ++k, ++a) {
        const T al = T(d.alpha(k));
#pragma unroll
        for (int i = 0; i < n; ++i)
          out[a * n + i] = add_rn(uv[i], mul_rn(al, x[i]));
      }
      for (int k = 0; k < d.n_drop; ++k, ++a) {
        const int c = d.drop(k);
#pragma unroll
        for (int i = 0; i < n; ++i)
          out[a * n + i] = add_rn(uv[i], mul_rn(x[i], i == c ? T(0) : T(1)));
      }
      for (int j = 0; j < d.n_jump; ++j) {
        const T jump = T(d.jump(j));
        for (int k = 0; k < d.n_drop; ++k, ++a) {
          const int c = d.drop(k);
#pragma unroll
          for (int i = 0; i < n; ++i)
            out[a * n + i] = add_rn(uv[i], mul_rn(jump, i == c ? T(1) : T(0)));
        }
      }
    } else if (snap) {
      const bool fin = all_finite<T>(x, n);
      T* o = out + (size_t)(snap_base + s) * n;
#pragma unroll
      for (int i = 0; i < n; ++i)
        o[i] = i == ci ? nearest : add_rn(uv[i], fin ? x[i] : T(0));
      if (dist_min < T(1e-6)) {
#pragma unroll
        for (int i = 0; i < n; ++i) act[i] = mul_rn(act[i], m[i]);
      }
    } else {
      const bool fin = all_finite<T>(x, n);
      T* o = out + (size_t)(snap_base + d.n_snap) * n;
#pragma unroll
      for (int i = 0; i < n; ++i)
        o[i] = add_rn(uv[i], mul_rn(fin ? x[i] : T(0), act[i]));
    }
  }
}

template <typename T>
__device__ __forceinline__ T max_nan(T s, T x) {
  return (x != x || x > s) ? x : s;
}

template <typename T, int N>
__global__ void __launch_bounds__(kThreads) newton_accept_kernel(
    int n_rt, int L, int A, int n_drop, const long long* __restrict__ lanes,
    const T* __restrict__ fs, const T* __restrict__ cands,
    const T* __restrict__ g, const T* __restrict__ H, T tol, T ftol,
    long long polish, T* __restrict__ u, T* __restrict__ f,
    T* __restrict__ lam, T* __restrict__ nu, long long* __restrict__ it,
    bool* __restrict__ done, long long* __restrict__ stall,
    long long* __restrict__ pc, const long long* __restrict__ rounds,
    bool* __restrict__ improved, T* __restrict__ ws) {
  const int l = blockIdx.x * blockDim.x + threadIdx.x;
  if (l >= L) return;
  const int n = N > 0 ? N : n_rt;
  const long long b = lanes[l];
  const T inf = infinity<T>();
  const T* fl = fs + (size_t)l * A;
  int best = 0;
  T f_try = is_fin(fl[0]) ? fl[0] : inf;
  for (int a = 1; a < A; ++a) {
    const T v = is_fin(fl[a]) ? fl[a] : inf;
    if (v < f_try) {
      f_try = v;
      best = a;
    }
  }
  const T* ut = cands + ((size_t)l * A + best) * n;
  const T* Hl = H + (size_t)l * n * n;
  const T fval = f[b], lm = lam[b], nv = nu[b];
  const bool accept = is_fin(f_try) && f_try < fval;
  Work<T, N> w(ws, n, L, l);
  Vec<T, N> u_old = w.vec(), u_try = w.vec(), du = w.vec(), gv = w.vec();
#pragma unroll
  for (int i = 0; i < n; ++i) {
    u_old[i] = u[b * n + i];
    u_try[i] = ut[i];
    du[i] = sub_rn(u_try[i], u_old[i]);
    gv[i] = finite_or_zero(g[(size_t)l * n + i]);
  }
  // Nielsen gain-ratio damping schedule
  T gdu = T(0), quad = T(0);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    gdu = add_rn(gdu, mul_rn(gv[i], du[i]));
    T hd = T(0);
#pragma unroll
    for (int j = 0; j < n; ++j) hd = add_rn(hd, mul_rn(h_at(Hl, n, i, j), du[j]));
    quad = add_rn(quad, mul_rn(du[i], hd));
  }
  const T predicted = -add_rn(gdu, mul_rn(T(0.5), quad));
  const T rho = div_rn(sub_rn(fval, f_try),
                       predicted > T(0) ? predicted : T(1));
  const bool good = accept && predicted > T(0);
  const T c = sub_rn(mul_rn(T(2), rho), T(1));
  T shrink = sub_rn(T(1), mul_rn(mul_rn(c, c), c));
  shrink = clamp_min(shrink, T(1.0 / 3.0));
  T lam_new = good ? mul_rn(lm, shrink) : (accept ? lm : mul_rn(lm, nv));
  lam_new = lam_new < T(1e-12) ? T(1e-12)
                               : (lam_new > T(1e10) ? T(1e10) : lam_new);
  T nu_new = mul_rn(nv, T(2));
  nu_new = accept ? T(2) : (nu_new > T(64) ? T(64) : nu_new);
  T gnorm = abs_rn(gv[0]), step = T(0);
#pragma unroll
  for (int i = 0; i < n; ++i) {
    gnorm = max_nan(gnorm, abs_rn(gv[i]));
    const T un = accept ? u_try[i] : u_old[i];
    const T di = abs_rn(sub_rn(un, u_old[i]));
    step = i == 0 ? di : max_nan(step, di);
    u[b * n + i] = un;
  }
  const T f_new = accept ? f_try : fval;
  const T fdelta = sub_rn(fval, f_new);
  const long long st = fdelta > ftol ? 0 : stall[b] + 1;
  const bool undamped =
      best == 0 || (best >= kAlphas && best < kAlphas + n_drop);
  const long long iv = it[b];
  const bool converged =
      gnorm < tol || (accept && step < T(1e-14)) ||
      (accept && fdelta <= ftol && lm < T(1e-2) && undamped && iv > 3) ||
      lam_new > T(1e8) || st >= 4;
  const bool enter_polish = converged && rounds[b] < polish;
  f[b] = f_new;
  lam[b] = lam_new;
  nu[b] = nu_new;
  it[b] = iv + 1;
  done[b] = converged && !enter_polish;
  stall[b] = converged ? 0 : st;
  if (enter_polish) pc[b] = 0;
  improved[b] = false;
}

template <typename T, int N>
void launch_cands_t(int L, const Step& d, const long long* lanes,
                    const void* u, const void* lam, const void* g,
                    const void* H, void* cands, void* ws,
                    cudaStream_t stream) {
  const int blocks = (L + kThreads - 1) / kThreads;
  newton_cands_kernel<T, N><<<blocks, kThreads, 0, stream>>>(
      d, L, lanes, static_cast<const T*>(u), static_cast<const T*>(lam),
      static_cast<const T*>(g), static_cast<const T*>(H),
      static_cast<T*>(cands), static_cast<T*>(ws));
}

template <int N>
int launch_cands(int dtype, int L, const Step& d, const long long* lanes,
                 const void* u, const void* lam, const void* g, const void* H,
                 void* cands, void* ws, cudaStream_t stream) {
  if (dtype == 0)
    launch_cands_t<float, N>(L, d, lanes, u, lam, g, H, cands, ws, stream);
  else
    launch_cands_t<double, N>(L, d, lanes, u, lam, g, H, cands, ws, stream);
  return (int)cudaGetLastError();
}

template <typename T, int N>
void launch_accept_t(int n, int L, int A, int n_drop, const long long* lanes,
                     const void* fs, const void* cands, const void* g,
                     const void* H, double tol, double ftol, long long polish,
                     void* u, void* f, void* lam, void* nu, long long* it,
                     bool* done, long long* stall, long long* pc,
                     const long long* rounds, bool* improved, void* ws,
                     cudaStream_t stream) {
  const int blocks = (L + kThreads - 1) / kThreads;
  newton_accept_kernel<T, N><<<blocks, kThreads, 0, stream>>>(
      n, L, A, n_drop, lanes, static_cast<const T*>(fs),
      static_cast<const T*>(cands), static_cast<const T*>(g),
      static_cast<const T*>(H), T(tol), T(ftol), polish, static_cast<T*>(u),
      static_cast<T*>(f), static_cast<T*>(lam), static_cast<T*>(nu), it,
      done, stall, pc, rounds, improved, static_cast<T*>(ws));
}

template <int N>
int launch_accept(int dtype, int n, int L, int A, int n_drop,
                  const long long* lanes, const void* fs, const void* cands,
                  const void* g, const void* H, double tol, double ftol,
                  long long polish, void* u, void* f, void* lam, void* nu,
                  long long* it, bool* done, long long* stall, long long* pc,
                  const long long* rounds, bool* improved, void* ws,
                  cudaStream_t stream) {
  if (dtype == 0)
    launch_accept_t<float, N>(n, L, A, n_drop, lanes, fs, cands, g, H, tol,
                              ftol, polish, u, f, lam, nu, it, done, stall,
                              pc, rounds, improved, ws, stream);
  else
    launch_accept_t<double, N>(n, L, A, n_drop, lanes, fs, cands, g, H, tol,
                               ftol, polish, u, f, lam, nu, it, done, stall,
                               pc, rounds, improved, ws, stream);
  return (int)cudaGetLastError();
}

}  // namespace

#define NS_CASES(X)                                                       \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13)    \
  X(14) X(15) X(16)

extern "C" {

// The largest n whose lanes live in registers; past it the kernels take a
// workspace (bt_newton_cands_ws, bt_newton_accept_ws elements a lane).
int bt_newton_max_register_n() { return kMaxN; }

// Workspace entries a lane of each kernel takes at n (0 for n <= 16).
long long bt_newton_cands_ws(int n) {
  return n > kMaxN ? 6LL * n + (long long)n * (n + 1) : 0;
}
long long bt_newton_accept_ws(int n) { return n > kMaxN ? 4LL * n : 0; }

// Returns cudaGetLastError() after the launch (0 = success), or -1 when n
// < 1, the dtype (0 float32, 1 float64) is neither, or n > 16 comes
// without a workspace. tab is the step's table on the card (see the
// header) with its counts n_drop, n_jump, n_snap and A; lanes (L,) int64
// index the batch state u (B, n) and lam (B,); g (L, n) and H (L, n, n)
// the lanes' gradient and Hessian; cands (L, A, n) out; ws the workspace,
// bt_newton_cands_ws(n) x L entries of the dtype (unused for n <= 16).
int bt_newton_cands(int dtype, int n, int L, int n_drop, int n_jump,
                    int n_snap, int A, const double* tab,
                    const long long* lanes, const void* u, const void* lam,
                    const void* g, const void* H, void* cands, void* ws,
                    cudaStream_t stream) {
  if (n < 1 || dtype < 0 || dtype > 1 || (n > kMaxN && ws == nullptr))
    return -1;
  if (L <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
  const Step d{n, n_drop, n_jump, n_snap, A, tab};
#define NS_CANDS_CASE(N_)                                                 \
  case N_:                                                                \
    return launch_cands<N_>(dtype, L, d, lanes, u, lam, g, H, cands, ws,  \
                            stream);
  switch (n) { NS_CASES(NS_CANDS_CASE) }
#undef NS_CANDS_CASE
  return launch_cands<0>(dtype, L, d, lanes, u, lam, g, H, cands, ws, stream);
}

// As bt_newton_cands: fs (L, A) the candidates' values, cands (L, A, n);
// the state (B,) of the fit written at each lane: u (B, n), f, lam, nu in
// the dtype, it, stall, pc (read by rounds < polish) int64, done, improved
// bool; ws bt_newton_accept_ws(n) x L entries (unused for n <= 16).
int bt_newton_accept(int dtype, int n, int L, int A, int n_drop,
                     const long long* lanes, const void* fs,
                     const void* cands, const void* g, const void* H,
                     double tol, double ftol, long long polish, void* u,
                     void* f, void* lam, void* nu, long long* it, bool* done,
                     long long* stall, long long* pc, const long long* rounds,
                     bool* improved, void* ws, cudaStream_t stream) {
  if (n < 1 || dtype < 0 || dtype > 1 || (n > kMaxN && ws == nullptr))
    return -1;
  if (L <= 0) return 0;
  cudaGetLastError();
#define NS_ACCEPT_CASE(N_)                                                \
  case N_:                                                                \
    return launch_accept<N_>(dtype, n, L, A, n_drop, lanes, fs, cands, g, \
                             H, tol, ftol, polish, u, f, lam, nu, it,     \
                             done, stall, pc, rounds, improved, ws,       \
                             stream);
  switch (n) { NS_CASES(NS_ACCEPT_CASE) }
#undef NS_ACCEPT_CASE
  return launch_accept<0>(dtype, n, L, A, n_drop, lanes, fs, cands, g, H,
                          tol, ftol, polish, u, f, lam, nu, it, done, stall,
                          pc, rounds, improved, ws, stream);
}

}  // extern "C"
