// Elementwise PFP kernels for Hopper: the moment-matched activation and the
// GLU gated product.
//
// Replaces repro/kernels/pfp_activations.py:
//  * pfp_activation_pallas (_make_kernel over MOMENT_FNS): (mu, var) ->
//    (mean, srm), ReLU by the closed form of Eq. 8/9 with its point-mass
//    branch, gelu/silu/tanh/sigmoid by 8-node Gauss-Hermite (the moment
//    functions live in pfp_moments.cuh, shared with the norm kernel's and
//    the fused unit's activation epilogues);
//  * pfp_glu_pallas (_glu_product_kernel): the exact SRM product of two
//    independent Gaussians, mean = mu_a mu_b, srm = srm_a srm_b.
//
// What bounds them on the H100. The GLU reads four floats and writes two
// (24 bytes) for two multiplies: bytes. The activation moves 16 bytes an
// element; its issued instructions (tools/sass_counts.py) put ReLU under
// the byte bound and the Gauss-Hermite kinds near it (silu's 8 nodes are
// 8 expf and 8 reciprocals), and its small calls (the CNNs' dense layers
// at batch 100 hold 10^4 elements) under one wave, where a launch and one
// thread's chain of dependent operations are the time.
//
// So the activation runs a plan the wrapper picks from n and alignment
// (kernels/pfp_activations.py activation_plan): a call that fits one wave
// takes one element a thread, in blocks of 64 to 256 sized to spread over
// every SM it can; a larger one takes groups of 4 elements with float4
// loads and stores (all four pointers 16-byte aligned; one element at a
// time otherwise), and at a wave or more a grid of exactly one wave
// strides over them, loading the next group before computing the moments
// of the current one. Every element runs the same moment function whichever
// thread takes it, so the outputs do not depend on the plan.
#include "pfp_moments.cuh"

namespace {

// Threads a block at most, and blocks an SM the register budget must
// allow (64 registers a thread): the plan's wave counts on them.
constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;

template <int KIND>
__device__ __forceinline__ void moments4(const float4& m, const float4& v,
                                         float4* mean, float4* srm) {
  pfp::activation_moments<KIND>(m.x, v.x, &mean->x, &srm->x);
  pfp::activation_moments<KIND>(m.y, v.y, &mean->y, &srm->y);
  pfp::activation_moments<KIND>(m.z, v.z, &mean->z, &srm->z);
  pfp::activation_moments<KIND>(m.w, v.w, &mean->w, &srm->w);
}

// VEC 4: groups of four elements (float4) strided over the grid, then the
// n % 4 elements past the last group, one each for the first threads.
// VEC 1: one element at a time, strided over the grid.
template <int KIND, int VEC>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
pfp_activation_kernel(const float* __restrict__ mu,
                      const float* __restrict__ var,
                      float* __restrict__ mean_out,
                      float* __restrict__ srm_out, long long n) {
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if constexpr (VEC == 4) {
    const long long groups = n / 4;
    const auto* mu4 = reinterpret_cast<const float4*>(mu);
    const auto* var4 = reinterpret_cast<const float4*>(var);
    auto* mean4 = reinterpret_cast<float4*>(mean_out);
    auto* srm4 = reinterpret_cast<float4*>(srm_out);
    long long g = first;
    if (g < groups) {
      float4 m = __ldg(mu4 + g), v = __ldg(var4 + g);
      for (;;) {
        const long long next = g + stride;
        const bool more = next < groups;
        float4 m_next = m, v_next = v;
        if (more) {   // in flight while this group's moments are computed
          m_next = __ldg(mu4 + next);
          v_next = __ldg(var4 + next);
        }
        float4 mean, srm;
        moments4<KIND>(m, v, &mean, &srm);
        mean4[g] = mean;
        srm4[g] = srm;
        if (!more) break;
        g = next;
        m = m_next;
        v = v_next;
      }
    }
    const long long i = 4 * groups + first;
    if (i < n)
      pfp::activation_moments<KIND>(mu[i], var[i], &mean_out[i], &srm_out[i]);
  } else {
    for (long long i = first; i < n; i += stride)
      pfp::activation_moments<KIND>(mu[i], var[i], &mean_out[i], &srm_out[i]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <int KIND>
int launch(const float* mu, const float* var, float* mean_out,
           float* srm_out, long long n, int vec, int block, int grid,
           cudaStream_t stream) {
  if (vec == 4) {
    if (!aligned16(mu) || !aligned16(var) || !aligned16(mean_out) ||
        !aligned16(srm_out))
      return static_cast<int>(cudaErrorMisalignedAddress);
    pfp_activation_kernel<KIND, 4><<<grid, block, 0, stream>>>(
        mu, var, mean_out, srm_out, n);
  } else {
    pfp_activation_kernel<KIND, 1><<<grid, block, 0, stream>>>(
        mu, var, mean_out, srm_out, n);
  }
  return pfp::launch_status();
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

}  // namespace

// kind: 0 relu, 1 gelu (tanh form), 2 silu, 3 tanh, 4 sigmoid. n >= 1
// contiguous fp32 elements in each array. The plan: vec 4 (float4 groups;
// every pointer 16-byte aligned) or 1, block a multiple of 32 up to 256,
// grid >= 1 blocks; any plan covers every element once.
PFP_EXPORT int pfp_activation_launch(int kind, const void* mu,
                                     const void* var, void* mean_out,
                                     void* srm_out, long long n, int vec,
                                     int block, int grid, void* stream) {
  if (n < 1 || (vec != 1 && vec != 4) || block < 32 ||
      block > kMaxThreads || block % 32 || grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pm = static_cast<const float*>(mu);
  const auto* pv = static_cast<const float*>(var);
  auto* om = static_cast<float*>(mean_out);
  auto* os = static_cast<float*>(srm_out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case pfp::kRelu:
      return launch<pfp::kRelu>(pm, pv, om, os, n, vec, block, grid, s);
    case pfp::kGelu:
      return launch<pfp::kGelu>(pm, pv, om, os, n, vec, block, grid, s);
    case pfp::kSilu:
      return launch<pfp::kSilu>(pm, pv, om, os, n, vec, block, grid, s);
    case pfp::kTanh:
      return launch<pfp::kTanh>(pm, pv, om, os, n, vec, block, grid, s);
    case pfp::kSigmoid:
      return launch<pfp::kSigmoid>(pm, pv, om, os, n, vec, block, grid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
