// PFP 2x2/stride-2 max-pool kernel for Hopper (NHWC; VAR or SRM in, VAR
// out).
//
// Replaces repro/kernels/pfp_maxpool.py: pfp_maxpool2d_pallas (_pool_kernel,
// _clark), the tournament of three Clark pairwise maxes (the two W pairs,
// then H).
//
// What bounds it on the H100. Each output reads 8 floats and writes 2 for
// three Clark maxes (an erff, an expf and a reciprocal square root each);
// counted from the SASS (tools/sass_counts.py), bytes bind. The paper's
// LeNet-5 pools hold 10^5 outputs at batch 100, under one wave, so a
// launch and one thread's chain of dependent operations are the time. The
// TPU wrapper cuts the input into its four 2x2 phases with XLA slices
// before the kernel; here each thread reads its window straight from the
// NHWC input, so the phases never touch device memory. A thread takes V
// neighbouring channels of one output position (V 4 at C 16, 2 at C 6,
// with float4 / float2 loads and stores where every pointer is aligned to
// them), so a warp's loads and stores stay coalesced with the channel
// fastest. The launch plan (kernels/pfp_maxpool.py pool_plan) spreads the
// threads over the SMs as the activation kernel's plan does.
//
// The input comes as a variance or, with SRM, as a second raw moment: then
// var = srm - mu * mu with torch's two roundings (no contraction), so the
// result is bit for bit that of GaussianTensor.to_var() followed by the
// VAR kernel, and the two elementwise launches of to_var() are saved.
#include "pfp_common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinBlocks = 4;

// Clark max of two independent Gaussians, moment-matched back to
// (mean, var). As the TPU kernel: cdf_b = 1 - cdf_a, var clamped at 0, and
// a point-mass branch when both inputs are deterministic. One rsqrtf gives
// 1/theta and theta; the divisions by constants are multiplications.
__device__ __forceinline__ void clark(float ma, float va, float mb, float vb,
                                      float* mean_out, float* var_out) {
  const float theta_sq = fmaxf(va + vb, pfp::kVarEps);
  const float inv_theta = rsqrtf(theta_sq);
  const float theta = theta_sq * inv_theta;
  const float alpha = (ma - mb) * inv_theta;
  const float cdf_a = 0.5f * (1.0f + erff(alpha * pfp::kInvSqrt2));
  const float cdf_b = 1.0f - cdf_a;
  const float pdf = expf(-0.5f * (alpha * alpha)) * pfp::kInvSqrt2Pi;
  const float mean = ma * cdf_a + mb * cdf_b + theta * pdf;
  const float srm = (ma * ma + va) * cdf_a + (mb * mb + vb) * cdf_b +
                    (ma + mb) * theta * pdf;
  if (va + vb <= pfp::kVarEps) {
    *mean_out = fmaxf(ma, mb);
    *var_out = 0.0f;
  } else {
    *mean_out = mean;
    *var_out = fmaxf(srm - mean * mean, 0.0f);
  }
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&out)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = t.x, out[1] = t.y, out[2] = t.z, out[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    out[0] = t.x, out[1] = t.y;
  } else {
    out[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&in)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2], in[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
  } else {
    *p = in[0];
  }
}

// One unit: V channels at one output position; units strided over the
// grid. The outputs of unit u are elements u * V .. u * V + V - 1.
template <int V, bool SRM>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
pfp_maxpool2d_kernel(const float* __restrict__ mu,
                     const float* __restrict__ second,
                     float* __restrict__ mu_out, float* __restrict__ var_out,
                     unsigned h, unsigned w, unsigned c, unsigned units) {
  const unsigned ho_n = h / 2, wo_n = w / 2, groups = c / V;
  const unsigned row = w * c;
  for (unsigned u = blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += gridDim.x * blockDim.x) {
    const unsigned cg = u % groups;
    unsigned t = u / groups;
    const unsigned wo = t % wo_n;
    t /= wo_n;
    const unsigned ho = t % ho_n;
    const unsigned b = t / ho_n;
    const unsigned i00 = ((b * h + 2 * ho) * w + 2 * wo) * c + cg * V;
    const unsigned at[4] = {i00, i00 + c, i00 + row, i00 + row + c};
    float m[4][V], v[4][V];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      load<V>(mu + at[q], m[q]);
      load<V>(second + at[q], v[q]);
    }
    if constexpr (SRM) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int j = 0; j < V; ++j)
          v[q][j] = __fsub_rn(v[q][j], __fmul_rn(m[q][j], m[q][j]));
    }
    float om[V], ov[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float m0, v0, m1, v1;
      clark(m[0][j], v[0][j], m[1][j], v[1][j], &m0, &v0);  // W pair, top
      clark(m[2][j], v[2][j], m[3][j], v[3][j], &m1, &v1);  // W pair, bottom
      clark(m0, v0, m1, v1, &om[j], &ov[j]);                // H pair
    }
    store<V>(mu_out + static_cast<size_t>(u) * V, om);
    store<V>(var_out + static_cast<size_t>(u) * V, ov);
  }
}

template <int V, bool SRM>
void launch(const float* mu, const float* second, float* mu_out,
            float* var_out, unsigned h, unsigned w, unsigned c,
            unsigned units, int block, int grid, cudaStream_t stream) {
  pfp_maxpool2d_kernel<V, SRM><<<grid, block, 0, stream>>>(
      mu, second, mu_out, var_out, h, w, c, units);
}

template <bool SRM>
void launch_vec(int vec, const float* mu, const float* second, float* mu_out,
                float* var_out, unsigned h, unsigned w, unsigned c,
                unsigned units, int block, int grid, cudaStream_t stream) {
  if (vec == 4)
    launch<4, SRM>(mu, second, mu_out, var_out, h, w, c, units, block, grid,
                   stream);
  else if (vec == 2)
    launch<2, SRM>(mu, second, mu_out, var_out, h, w, c, units, block, grid,
                   stream);
  else
    launch<1, SRM>(mu, second, mu_out, var_out, h, w, c, units, block, grid,
                   stream);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<unsigned long long>(p) % bytes == 0;
}

}  // namespace

// NHWC fp32 input (n, h, w, c), h and w even, fewer than 2^31 elements;
// output (n, h/2, w/2, c). srm: `second` holds E[x^2] (else the variance).
// The plan: vec channels a thread (1, 2 or 4, dividing c; every pointer
// aligned to vec floats), block a multiple of 32 up to 256, grid >= 1.
PFP_EXPORT int pfp_maxpool2d_launch(const void* mu, const void* second,
                                    void* mu_out, void* var_out, int n,
                                    int h, int w, int c, int srm, int vec,
                                    int block, int grid, void* stream) {
  const long long total = static_cast<long long>(n) * h * w * c;
  if (n < 1 || h < 2 || w < 2 || c < 1 || h % 2 || w % 2 ||
      total >= (1LL << 31) || (vec != 1 && vec != 2 && vec != 4) ||
      c % vec || block < 32 || block > kMaxThreads || block % 32 ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned(mu, 4 * vec) || !aligned(second, 4 * vec) ||
      !aligned(mu_out, 4 * vec) || !aligned(var_out, 4 * vec))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto units = static_cast<unsigned>(total / 4 / vec);
  const auto* pm = static_cast<const float*>(mu);
  const auto* ps = static_cast<const float*>(second);
  auto* om = static_cast<float*>(mu_out);
  auto* ov = static_cast<float*>(var_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (srm)
    launch_vec<true>(vec, pm, ps, om, ov, h, w, c, units, block, grid, s);
  else
    launch_vec<false>(vec, pm, ps, om, ov, h, w, c, units, block, grid, s);
  return pfp::launch_status();
}
