// Moment-matched activation kernel for Hopper: (mu, var) -> (mean, srm).
//
// Replaces repro/kernels/pfp_activations.py: pfp_activation_pallas
// (_make_kernel over MOMENT_FNS): ReLU by the closed form of Eq. 8/9 with
// its point-mass branch, gelu/silu/tanh/sigmoid by 8-node Gauss-Hermite.
//
// What bounds it on the H100: bytes. Each element reads two floats and
// writes two (16 bytes) for a few dozen flops and two transcendentals, far
// below the card's flop-per-byte balance. The design is the TPU's
// joint-operator idea in its elementwise form: one pass reads mu and var
// once and writes both outputs, one thread per element, neighbouring
// threads on neighbouring addresses so every load and store is coalesced.
// erff/expf/sqrtf/tanhf are the accurate library versions (no fast math).
#include "pfp_common.cuh"

namespace {

enum Kind { kRelu = 0, kGelu = 1, kSilu = 2, kTanh = 3, kSigmoid = 4 };

__device__ __forceinline__ void relu_moments(float mu, float var,
                                             float* mean_out, float* srm_out) {
  const float safe_var = fmaxf(var, pfp::kVarEps);
  const float sd = sqrtf(safe_var);
  const float cdf = 0.5f * (1.0f + erff(mu / (sd * pfp::kSqrt2)));
  const float pdf = sd * expf(-0.5f * (mu * mu) / safe_var) / pfp::kSqrt2Pi;
  float mean = mu * cdf + pdf;                                // Eq. (8)
  float srm = (safe_var + mu * mu) * cdf + mu * pdf;          // Eq. (9)
  if (var <= pfp::kVarEps) {  // point mass: relu of a constant
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
    return x / (1.0f + expf(-x));
  } else if constexpr (KIND == kTanh) {
    return tanhf(x);
  } else {
    return 1.0f / (1.0f + expf(-x));
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
  const float scale = sqrtf(fmaxf(var, 0.0f)) * pfp::kSqrt2;
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

template <int KIND>
__global__ void __launch_bounds__(256)
pfp_activation_kernel(const float* __restrict__ mu,
                      const float* __restrict__ var,
                      float* __restrict__ mean_out,
                      float* __restrict__ srm_out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  if constexpr (KIND == kRelu) {
    relu_moments(mu[i], var[i], &mean_out[i], &srm_out[i]);
  } else {
    gh_moments<KIND>(mu[i], var[i], &mean_out[i], &srm_out[i]);
  }
}

template <int KIND>
void launch(const float* mu, const float* var, float* mean_out,
            float* srm_out, long long n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  pfp_activation_kernel<KIND><<<blocks, 256, 0, stream>>>(mu, var, mean_out,
                                                          srm_out, n);
}

}  // namespace

// kind: 0 relu, 1 gelu (tanh form), 2 silu, 3 tanh, 4 sigmoid. n >= 1
// contiguous fp32 elements in each array.
PFP_EXPORT int pfp_activation_launch(int kind, const void* mu,
                                     const void* var, void* mean_out,
                                     void* srm_out, long long n,
                                     void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pm = static_cast<const float*>(mu);
  const auto* pv = static_cast<const float*>(var);
  auto* om = static_cast<float*>(mean_out);
  auto* os = static_cast<float*>(srm_out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kRelu: launch<kRelu>(pm, pv, om, os, n, s); break;
    case kGelu: launch<kGelu>(pm, pv, om, os, n, s); break;
    case kSilu: launch<kSilu>(pm, pv, om, os, n, s); break;
    case kTanh: launch<kTanh>(pm, pv, om, os, n, s); break;
    case kSigmoid: launch<kSigmoid>(pm, pv, om, os, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return pfp::launch_status();
}
