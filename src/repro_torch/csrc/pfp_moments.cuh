// Moment functions of the activations, shared by the activation kernel,
// the norm kernel's activation epilogue and the fused unit's epilogue:
// (mu, var) of a Gaussian in, (mean, srm) of its image out, as
// repro_torch/core/pfp_math.py computes them. fp32 with the accurate erff,
// expf, sqrtf and tanhf (no fast math). What they cost is counted from the
// SASS (tools/sass_counts.py): an IEEE division or square root is a MUFU op
// and about ten issued instructions, so the formulas below take one
// reciprocal square root for ReLU's 1/sd and sd, multiply by reciprocal
// constants, and form silu's and sigmoid's 1/(1 + e) with the
// special-function unit's reciprocal (1 ulp) and a multiply. chip_smoke.py
// holds each kind's error against fp64 to 4x its plain version's.
#pragma once

#include "pfp_common.cuh"

namespace pfp {

enum ActKind { kRelu = 0, kGelu = 1, kSilu = 2, kTanh = 3, kSigmoid = 4 };

// 1/x on the special-function unit: one MUFU.RCP, at most 1 ulp from the
// rounded quotient (PTX ISA, rcp.approx.ftz.f32); 1/inf is 0. A result
// under 2^-126 flushes to 0: 1/(1 + e) for x < -87.3, where silu and
// sigmoid are under 1e-36 anyway. The form without ftz scales its operand
// around the MUFU op, 6 more instructions a call (tools/sass_counts.py).
__device__ __forceinline__ float approx_rcp(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// ReLU by the closed form of Eq. 8/9, with the point-mass branch. One
// rsqrtf gives 1/sd, and sd = safe_var / sd; safe_var >= kVarEps is a
// normal number, so rsqrtf is in its accurate range (2 ulp).
__device__ __forceinline__ void relu_moments(float mu, float var,
                                             float* mean_out, float* srm_out) {
  const float safe_var = fmaxf(var, kVarEps);
  const float inv_sd = rsqrtf(safe_var);
  const float sd = safe_var * inv_sd;
  const float t = mu * inv_sd;                                // mu / sd
  const float cdf = 0.5f * (1.0f + erff(t * kInvSqrt2));
  const float pdf = sd * expf(-0.5f * (t * t)) * kInvSqrt2Pi;
  float mean = mu * cdf + pdf;                                // Eq. (8)
  float srm = (safe_var + mu * mu) * cdf + mu * pdf;          // Eq. (9)
  if (var <= kVarEps) {  // point mass: relu of a constant
    mean = fmaxf(mu, 0.0f);
    srm = mean * mean;
  } else {
    srm = fmaxf(srm, 0.0f);
  }
  *mean_out = mean;
  *srm_out = srm;
}

template <int KIND>
__device__ __forceinline__ float act(float x) {
  if constexpr (KIND == kGelu) {
    // jax.nn.gelu's default (approximate=True): the tanh form.
    const float c = 0.79788456080286535588f;  // sqrt(2 / pi)
    return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
  } else if constexpr (KIND == kSilu) {
    return x * approx_rcp(1.0f + expf(-x));
  } else if constexpr (KIND == kTanh) {
    return tanhf(x);
  } else {
    return approx_rcp(1.0f + expf(-x));
  }
}

// E[f(X)], E[f(X)^2] for X ~ N(mu, var): 8 Gauss-Hermite nodes, weights
// already divided by sqrt(pi) (numpy.polynomial.hermite.hermgauss(8)).
template <int KIND>
__device__ __forceinline__ void gh_moments(float mu, float var,
                                           float* mean_out, float* srm_out) {
  constexpr float kNodes[8] = {
      -2.930637420257244f, -1.981656756695843f, -1.1571937124467802f,
      -0.3811869902073221f, 0.3811869902073221f, 1.1571937124467802f,
      1.981656756695843f, 2.930637420257244f};
  constexpr float kWeights[8] = {
      0.0001126145383753679f, 0.009635220120788263f, 0.117239907661759f,
      0.3730122576790775f, 0.3730122576790775f, 0.117239907661759f,
      0.009635220120788263f, 0.0001126145383753679f};
  const float scale = sqrtf(fmaxf(var, 0.0f)) * kSqrt2;
  float acc_m = 0.0f, acc_s = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float fx = act<KIND>(mu + scale * kNodes[i]);
    acc_m += kWeights[i] * fx;
    acc_s += kWeights[i] * (fx * fx);
  }
  *mean_out = acc_m;
  *srm_out = acc_s;
}

// Any kind, chosen at compile time.
template <int KIND>
__device__ __forceinline__ void activation_moments(float mu, float var,
                                                   float* mean_out,
                                                   float* srm_out) {
  if constexpr (KIND == kRelu) {
    relu_moments(mu, var, mean_out, srm_out);
  } else {
    gh_moments<KIND>(mu, var, mean_out, srm_out);
  }
}

}  // namespace pfp
