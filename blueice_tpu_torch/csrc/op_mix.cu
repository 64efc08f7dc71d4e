// The op-mix probe for NVIDIA Hopper (sm_90a): the rate a per-element op
// mix of the fit kernels reaches on this card when memory plays no part.
//
// Replaces the Pallas kernel of measure_op_mix (blueice_tpu/utils/
// roofline.py:338, body roofline.py:322-335), which loads one (64, 512)
// float32 block and its 0-5 auxiliary blocks into VMEM, applies the mix
// reps x unroll times in a serially dependent loop and writes the block
// once. Its plain PyTorch twin is op_mix_plain in
// blueice_tpu_torch/utils/roofline.py, whose wrapper op_mix launches this
// kernel for CUDA tensors.
//
// The mixes (the step each element takes; the flops the reference's cost
// models charge for it; the unroll):
//   fma      x <- 1.0001 x + 0.0001                                (2, 16)
//   bb       P <- P + eps (lam + sum dlam + sum om) of
//            bb_lam_parts(P, N, U, M, T, d)                        (200, 1)
//   bblite   lam <- lam + eps (value + sum of the partials) of
//            lite_parts(lam, Ntot, d)                              (40, 4)
//   poisson  lam <- lam + eps (r + inv + q), the residual chain of
//            roofline.py:302-309 (a log and two divisions)         (16, 4)
//
// What bounds it: operations, by construction. Each element and its aux
// values are read once and the element is written once; in between it
// takes reps * unroll steps in registers.
//
// Design. The counterpart of the TPU's VMEM-resident block is a register-
// resident one. Each thread owns kV = 4 independent elements and steps them
// side by side: one element's chain is serially dependent, so a thread with
// one element waits out each instruction's latency (4 cycles for an FMA)
// and reaches about a quarter of the FMA rate; four independent chains a
// thread, with up to 64 warps an SM, hide it. Blocks of 256 threads; the
// caller sizes the element count to fill every SM at this kernel's
// occupancy (bt_op_mix_blocks_per_sm). reps and eps are runtime arguments
// and unroll a template constant, and every term reaches the output, so the
// compiler can neither fold the loop nor drop a term.
//
// The bb and bblite steps call the fit kernels' own per-bin code
// (bt_perbin.cuh), built with the same flags (no --use_fast_math), so
// sqrtf, logf and the IEEE divisions compile to the sequences those kernels
// run.
//
// Built by blueice_tpu_torch/ops/fused.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -shared) and loaded with ctypes; the C
// entry points return cudaGetLastError().

#include "bt_common.cuh"
#include "bt_perbin.cuh"

namespace {

using namespace bt;

constexpr int kV = 4;        // independent elements per thread
constexpr int kMaxAux = 5;

enum Kind { kFma = 0, kBB = 1, kLite = 2, kPoisson = 3 };

struct AuxPtrs {
  const float* p[kMaxAux];
};

template <int KIND>
struct Mix;

template <>
struct Mix<kFma> {
  static constexpr int kAux = 0, kUnroll = 16;
  __device__ __forceinline__ static float step(float x, const float*, float) {
    return fmaf(1.0001f, x, 0.0001f);
  }
};

template <>
struct Mix<kBB> {
  static constexpr int kAux = 5, kUnroll = 1;
  __device__ __forceinline__ static float step(float P, const float* a,
                                               float eps) {
    const BBParts o = bb_lam_parts(P, a[0], a[1], a[2], a[3], a[4]);
    const float dlam = (((o.g[0] + o.g[1]) + o.g[2]) + o.g[3]) + o.g[4];
    // om in the sorted key order of the plain version (o24 is zero)
    const float om = ((((((((((((o.o00 + o.o01) + o.o02) + o.o03) + o.o04)
                             + o.o11) + o.o12) + o.o13) + o.o14) + o.o22)
                        + o.o23) + o.o33) + o.o34) + o.o44;
    return P + eps * ((o.lam + dlam) + om);
  }
};

template <>
struct Mix<kLite> {
  static constexpr int kAux = 2, kUnroll = 4;
  __device__ __forceinline__ static float step(float lam, const float* a,
                                               float eps) {
    const LiteParts o = lite_parts(lam, a[0], a[1]);
    return lam + eps * (o.value
                        + ((((o.f_lam + o.f_M) + o.H_ll) + o.H_lM) + o.H_MM));
  }
};

template <>
struct Mix<kPoisson> {
  static constexpr int kAux = 1, kUnroll = 4;
  __device__ __forceinline__ static float step(float lam, const float* a,
                                               float eps) {
    const float d = a[0];
    const bool pos = lam > 0.f;
    const float lam_safe = pos ? lam : 1.f;
    const float r = pos ? d * logf(lam_safe) - lam : 0.f;
    const float inv = pos ? d / lam_safe : 0.f;
    const float q = inv / lam_safe;
    return lam + eps * ((r + inv) + q);
  }
};

template <int KIND>
__global__ void __launch_bounds__(kThreads)
op_mix_kernel(const float* __restrict__ x, AuxPtrs aux, int n, int reps,
              float eps, float* __restrict__ out) {
  using M = Mix<KIND>;
  constexpr int kAuxD = M::kAux > 0 ? M::kAux : 1;   // no zero-length arrays
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;

  // Element j of this thread is first + j * stride: each load and store of
  // a warp is one coalesced row. Past the end, inert ones that are not
  // stored.
  float v[kV];
  float a[kV][kAuxD];
#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int i = first + j * stride;
    const bool in = i < n;
    v[j] = in ? x[i] : 1.f;
#pragma unroll
    for (int q = 0; q < kAuxD; ++q)
      a[j][q] = (in && q < M::kAux) ? aux.p[q][i] : 1.f;
  }

#pragma unroll 1
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int u = 0; u < M::kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < kV; ++j) v[j] = M::step(v[j], a[j], eps);
    }
  }

#pragma unroll
  for (int j = 0; j < kV; ++j) {
    const int i = first + j * stride;
    if (i < n) out[i] = v[j];
  }
}

template <int KIND>
void launch(int n, int reps, float eps, const float* x, const AuxPtrs& aux,
            float* out, cudaStream_t stream) {
  const int per_block = kThreads * kV;
  const int blocks = (n + per_block - 1) / per_block;
  op_mix_kernel<KIND><<<blocks, kThreads, 0, stream>>>(x, aux, n, reps, eps,
                                                       out);
}

template <int KIND>
int blocks_per_sm() {
  int blocks = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, op_mix_kernel<KIND>, kThreads, 0);
  return e == cudaSuccess ? blocks : -(int)e;
}

}  // namespace

extern "C" {

// Applies mix `kind` (0 fma, 1 bb, 2 bblite, 3 poisson) reps * unroll times
// to each of the n elements of x, with the kind's aux arrays (unused ones
// may be null). Returns cudaGetLastError() after the launch (0 = success),
// or -1 for an unknown kind or a negative reps.
int bt_op_mix(int kind, int n, int reps, float eps, const float* x,
              const float* a0, const float* a1, const float* a2,
              const float* a3, const float* a4, float* out,
              cudaStream_t stream) {
  if (reps < 0) return -1;
  if (n <= 0) return 0;
  cudaGetLastError();   // clear a stale error so the return value is ours
  const AuxPtrs aux = {{a0, a1, a2, a3, a4}};
  switch (kind) {
    case kFma: launch<kFma>(n, reps, eps, x, aux, out, stream); break;
    case kBB: launch<kBB>(n, reps, eps, x, aux, out, stream); break;
    case kLite: launch<kLite>(n, reps, eps, x, aux, out, stream); break;
    case kPoisson: launch<kPoisson>(n, reps, eps, x, aux, out, stream); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}

// Blocks of kind's kernel resident on one SM at once (> 0), or <= 0 on an
// unknown kind or a CUDA error.
int bt_op_mix_blocks_per_sm(int kind) {
  switch (kind) {
    case kFma: return blocks_per_sm<kFma>();
    case kBB: return blocks_per_sm<kBB>();
    case kLite: return blocks_per_sm<kLite>();
    case kPoisson: return blocks_per_sm<kPoisson>();
    default: return -1;
  }
}

// Elements each thread owns (kV).
int bt_op_mix_elements_per_thread() { return kV; }

}  // extern "C"
