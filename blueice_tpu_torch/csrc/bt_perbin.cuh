// Per-bin closed forms shared by the fit kernels and the op-mix probe:
// the Beeston-Barlow root and its partials (fused_bb.cu, op_mix.cu) and the
// Barlow-Beeston-lite per-bin parts (fused_bb_lite.cu, op_mix.cu). One copy,
// so the probe measures the arithmetic the fit kernels run.
#pragma once

#include "bt_common.cuh"

namespace bt {

// bb_lambda of blueice_tpu/ops/bb_vgh.py: the adjusted expected count.
// The reference's selects are branches here, so a bin evaluates only the
// root it takes (inert: none; U == 0: the special root; else the general
// root on the side of b's sign), each with the reference's operations: two
// divisions fewer a bin. The last step keeps its multiply and add apart,
// as the select between them kept them apart.
__device__ __forceinline__ float bb_lambda(float P, float N, float U, float M,
                                           float T, float d) {
  const float tiny = FLT_MIN;
  const bool has_mc = N > 0.f;
  const float N_safe = has_mc ? N : 1.f;
  const float pw = has_mc ? M * P / N_safe : 0.f;
  if (!(pw > 0.f)) return __fadd_rn(U, 0.f);
  float A;
  if (U == 0.f) {
    A = (d + N) / (1.f + M / T);
  } else {
    const float b_lin = U * (pw + 1.f) - pw * (N + d);
    const float disc = b_lin * b_lin + 4.f * pw * (pw + 1.f) * (U * N);
    const float root = sqrtf(fmaxf(disc, tiny));
    if (b_lin >= 0.f)
      A = 2.f * U * N / fmaxf(b_lin + root, tiny);
    else
      A = (root - b_lin) / (2.f * pw * (pw + 1.f));
  }
  return __fadd_rn(U, __fmul_rn(pw, A));
}

// bb_lam_parts of blueice_tpu/ops/bb_vgh.py: lam, its gradient g[5] in
// (P, N, U, M, T) and the upper-triangle second derivatives (o24 is
// identically zero and left out).
struct BBParts {
  float lam;
  float g[5];
  float o00, o01, o02, o03, o04, o11, o12, o13, o14, o22, o23, o33, o34, o44;
};

__device__ __forceinline__ BBParts bb_lam_parts(float P, float N, float U,
                                                float M, float T, float d) {
  const float tiny = FLT_MIN;
  BBParts o;
  o.g[0] = o.g[1] = o.g[3] = o.g[4] = 0.f;
  o.g[2] = 1.f;
  o.o00 = o.o01 = o.o02 = o.o03 = o.o04 = o.o11 = o.o12 = o.o13 = o.o14 =
      o.o22 = o.o23 = o.o33 = o.o34 = o.o44 = 0.f;
  const bool has_mc = N > 0.f;
  const float N_s = has_mc ? N : 1.f;
  const float p = has_mc ? M * P / N_s : 0.f;
  if (!(p > 0.f)) {
    // Inert bin: lam = U; d lam / dM keeps its finite limit at M == 0
    o.lam = U;
    if (has_mc && P > 0.f && M == 0.f)
      o.g[3] = U == 0.f ? (P * (1.f / N_s)) * (d + N) : P;
    return o;
  }
  const float p_s = p;   // active: pw > 0
  const float inv_N = 1.f / N_s;
  const float p_P = M * inv_N;
  const float p_M = P * inv_N;
  const float p_N = -p_s * inv_N;
  const float p2_PN = -p_P * inv_N;
  const float p2_PM = inv_N;
  const float p2_NN = 2.f * p_s * inv_N * inv_N;
  const float p2_NM = -p_M * inv_N;

  if (U == 0.f) {
    // Special root A = (d + N) / (1 + M / T)
    const float T_s = T > 0.f ? T : 1.f;
    const float beta = 1.f + M / T_s;
    const float ib = 1.f / beta;
    const float iT = 1.f / T_s;
    const float dN = d + N;
    const float As = dN * ib;
    const float As_N = ib;
    const float As_M = -As * ib * iT;
    const float As_T = As * M * ib * iT * iT;
    const float As_NM = -ib * ib * iT;
    const float As_NT = M * ib * ib * iT * iT;
    const float ib2 = ib * ib, ib3 = ib2 * ib;
    const float iT2 = iT * iT, iT3 = iT2 * iT, iT4 = iT3 * iT;
    const float As_MM = 2.f * dN * ib3 * iT * iT;
    const float As_MT = dN * (ib2 * iT2 - 2.f * M * ib3 * iT3);
    const float As_TT = dN * M * (2.f * M * ib3 * iT4 - 2.f * ib2 * iT3);
    o.lam = U + p_s * As;
    o.g[0] = p_P * As;
    o.g[1] = p_N * As + p_s * As_N;
    o.g[2] = 1.f;
    o.g[3] = p_M * As + p_s * As_M;
    o.g[4] = p_s * As_T;
    o.o01 = p2_PN * As + p_P * As_N;
    o.o03 = p2_PM * As + p_P * As_M;
    o.o04 = p_P * As_T;
    o.o11 = p2_NN * As + 2.f * p_N * As_N;
    o.o13 = p2_NM * As + p_N * As_M + p_M * As_N + p_s * As_NM;
    o.o14 = p_N * As_T + p_s * As_NT;
    o.o33 = 2.f * p_M * As_M + p_s * As_MM;
    o.o34 = p_M * As_T + p_s * As_MT;
    o.o44 = p_s * As_TT;
    return o;
  }

  // General root of a A^2 + b A - U N = 0 and its implicit derivatives
  const float a = p_s * (p_s + 1.f);
  const float b = U * (p_s + 1.f) - p_s * (N + d);
  const float disc = b * b + 4.f * U * N * a;
  const float R = sqrtf(fmaxf(disc, tiny));
  const bool sel_hi = b >= 0.f;
  const float den_hi = fmaxf(sel_hi ? b + R : 1.f, tiny);
  const float den_lo = sel_hi ? 1.f : 2.f * a;
  const float A = sel_hi ? 2.f * U * N / den_hi : (R - b) / den_lo;

  const float F_p = (2.f * p_s + 1.f) * A * A + (U - N - d) * A;
  const float F_U = (p_s + 1.f) * A - N;
  const float F_N = -p_s * A - U;
  const float inv_R = 1.f / R;
  const float A_p = -F_p * inv_R;
  const float A_U = -F_U * inv_R;
  const float A_N = -F_N * inv_R;
  const float F_pA = 2.f * (2.f * p_s + 1.f) * A + (U - N - d);
  const float F_UA = p_s + 1.f;
  const float F_NA = -p_s;
  const float two_a = 2.f * a;
  const float A_pp =
      -(2.f * A * A + 2.f * F_pA * A_p + two_a * A_p * A_p) * inv_R;
  const float A_pU =
      -(A + F_pA * A_U + F_UA * A_p + two_a * A_p * A_U) * inv_R;
  const float A_pN =
      -(-A + F_pA * A_N + F_NA * A_p + two_a * A_p * A_N) * inv_R;
  const float A_UU = -(2.f * F_UA * A_U + two_a * A_U * A_U) * inv_R;
  const float A_UN =
      -(-1.f + F_UA * A_N + F_NA * A_U + two_a * A_U * A_N) * inv_R;
  const float A_NN = -(2.f * F_NA * A_N + two_a * A_N * A_N) * inv_R;

  const float L_p = A + p_s * A_p;
  const float L_U = 1.f + p_s * A_U;
  const float L_N = p_s * A_N;
  const float L_pp = 2.f * A_p + p_s * A_pp;
  const float L_pU = A_U + p_s * A_pU;
  const float L_pN = A_N + p_s * A_pN;

  o.lam = U + p_s * A;
  o.g[0] = L_p * p_P;
  o.g[1] = L_N + L_p * p_N;
  o.g[2] = L_U;
  o.g[3] = L_p * p_M;
  o.o00 = L_pp * p_P * p_P;
  o.o01 = L_pp * p_P * p_N + L_pN * p_P + L_p * p2_PN;
  o.o02 = L_pU * p_P;
  o.o03 = L_pp * p_P * p_M + L_p * p2_PM;
  o.o11 = L_pp * p_N * p_N + 2.f * L_pN * p_N + p_s * A_NN + L_p * p2_NN;
  o.o12 = L_pU * p_N + p_s * A_UN;
  o.o13 = L_pp * p_N * p_M + L_pN * p_M + L_p * p2_NM;
  o.o22 = p_s * A_UU;
  o.o23 = L_pU * p_M;
  o.o33 = L_pp * p_M * p_M;
  return o;
}

__device__ __forceinline__ float xlogy_f(float x, float y) {
  return x == 0.f ? 0.f : x * logf(y);
}

struct LiteParts {
  float value, f_lam, f_M, H_ll, H_lM, H_MM;
};

// _per_bin_parts of blueice_tpu/ops/bb_lite.py.
__device__ __forceinline__ LiteParts lite_parts(float lam, float M, float k) {
  const float tiny = FLT_MIN;
  LiteParts o;
  const float lam_pos = fmaxf(lam, tiny);
  const bool has_mc = M > 0.f;
  const float den = fmaxf(lam_pos + M, tiny);
  const float g = has_mc ? (k + M) / den : 1.f;
  const float k_safe = k > 0.f ? k : 1.f;
  o.value = xlogy_f(k, fmaxf(g * lam_pos, tiny) / k_safe) - (g * lam - k)
            + xlogy_f(M, g) - M * (g - 1.f) + kPenalty * fminf(lam, 0.f);
  const float inv_lam = 1.f / lam_pos;
  o.f_lam = k * inv_lam - g + (lam < 0.f ? kPenalty : 0.f);
  const float g_safe = has_mc ? g : 1.f;
  o.f_M = has_mc ? logf(g_safe) - (g - 1.f) : 0.f;
  const float inv_den = has_mc ? 1.f / den : 0.f;
  const float g_lam = has_mc ? -g * inv_den : 0.f;
  const float g_M = has_mc ? (lam_pos - k) * inv_den * inv_den : 0.f;
  o.H_ll = -k * inv_lam * inv_lam - g_lam;
  o.H_lM = -g_M;
  o.H_MM = has_mc ? (1.f / g_safe - 1.f) * g_M : 0.f;
  return o;
}

}  // namespace bt
