// Elementwise PFP kernels for Hopper: the moment-matched activation and the
// GLU gated product.
//
// Replaces repro/kernels/pfp_activations.py:
//  * pfp_activation_pallas (_make_kernel over MOMENT_FNS): (mu, var) ->
//    (mean, srm), ReLU by the closed form of Eq. 8/9 with its point-mass
//    branch, gelu/silu/tanh/sigmoid by 8-node Gauss-Hermite (the moment
//    functions live in pfp_moments.cuh, shared with the norm kernel's
//    activation epilogue);
//  * pfp_glu_pallas (_glu_product_kernel): the exact SRM product of two
//    independent Gaussians, mean = mu_a mu_b, srm = srm_a srm_b.
//
// What bounds them on the H100: bytes. The activation reads two floats and
// writes two (16 bytes) per element for a few dozen flops; the GLU reads
// four and writes two (24 bytes) for two multiplies. The design is the
// TPU's joint-operator idea in its elementwise form: one pass reads every
// operand once and writes both outputs, neighbouring threads on
// neighbouring addresses so every load and store is coalesced. The GLU
// moves 16 bytes per load and store (float4) when all six arrays are
// 16-byte aligned, the rest one float at a time.
#include "pfp_moments.cuh"

namespace {

template <int KIND>
__global__ void __launch_bounds__(256)
pfp_activation_kernel(const float* __restrict__ mu,
                      const float* __restrict__ var,
                      float* __restrict__ mean_out,
                      float* __restrict__ srm_out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  pfp::activation_moments<KIND>(mu[i], var[i], &mean_out[i], &srm_out[i]);
}

template <int KIND>
void launch(const float* mu, const float* var, float* mean_out,
            float* srm_out, long long n, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  pfp_activation_kernel<KIND><<<blocks, 256, 0, stream>>>(mu, var, mean_out,
                                                          srm_out, n);
}

// One thread per four consecutive elements. VEC: float4 loads and stores
// for every full group of four (all pointers 16-byte aligned).
template <bool VEC>
__global__ void __launch_bounds__(256)
pfp_glu_kernel(const float* __restrict__ mu_a, const float* __restrict__ srm_a,
               const float* __restrict__ mu_b, const float* __restrict__ srm_b,
               float* __restrict__ mu_out, float* __restrict__ srm_out,
               long long n) {
  const long long i = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x +
                           threadIdx.x);
  if (i >= n) return;
  if (VEC && i + 4 <= n) {
    const float4 ma = *reinterpret_cast<const float4*>(mu_a + i);
    const float4 sa = *reinterpret_cast<const float4*>(srm_a + i);
    const float4 mb = *reinterpret_cast<const float4*>(mu_b + i);
    const float4 sb = *reinterpret_cast<const float4*>(srm_b + i);
    *reinterpret_cast<float4*>(mu_out + i) =
        make_float4(ma.x * mb.x, ma.y * mb.y, ma.z * mb.z, ma.w * mb.w);
    *reinterpret_cast<float4*>(srm_out + i) =
        make_float4(sa.x * sb.x, sa.y * sb.y, sa.z * sb.z, sa.w * sb.w);
    return;
  }
  const long long end = i + 4 < n ? i + 4 : n;
  for (long long j = i; j < end; ++j) {
    mu_out[j] = mu_a[j] * mu_b[j];
    srm_out[j] = srm_a[j] * srm_b[j];
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
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
    case pfp::kRelu: launch<pfp::kRelu>(pm, pv, om, os, n, s); break;
    case pfp::kGelu: launch<pfp::kGelu>(pm, pv, om, os, n, s); break;
    case pfp::kSilu: launch<pfp::kSilu>(pm, pv, om, os, n, s); break;
    case pfp::kTanh: launch<pfp::kTanh>(pm, pv, om, os, n, s); break;
    case pfp::kSigmoid: launch<pfp::kSigmoid>(pm, pv, om, os, n, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return pfp::launch_status();
}

// (mu_a, srm_a) x (mu_b, srm_b) -> (mu_out, srm_out); n >= 1 contiguous
// fp32 elements in each array.
PFP_EXPORT int pfp_glu_launch(const void* mu_a, const void* srm_a,
                              const void* mu_b, const void* srm_b,
                              void* mu_out, void* srm_out, long long n,
                              void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = (n + 3) / 4;
  const unsigned blocks = static_cast<unsigned>((threads + 255) / 256);
  auto s = static_cast<cudaStream_t>(stream);
  const auto* ma = static_cast<const float*>(mu_a);
  const auto* sa = static_cast<const float*>(srm_a);
  const auto* mb = static_cast<const float*>(mu_b);
  const auto* sb = static_cast<const float*>(srm_b);
  auto* mo = static_cast<float*>(mu_out);
  auto* so = static_cast<float*>(srm_out);
  if (aligned16(ma) && aligned16(sa) && aligned16(mb) && aligned16(sb) &&
      aligned16(mo) && aligned16(so))
    pfp_glu_kernel<true><<<blocks, 256, 0, s>>>(ma, sa, mb, sb, mo, so, n);
  else
    pfp_glu_kernel<false><<<blocks, 256, 0, s>>>(ma, sa, mb, sb, mo, so, n);
  return pfp::launch_status();
}
