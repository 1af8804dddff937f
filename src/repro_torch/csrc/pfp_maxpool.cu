// PFP 2x2/stride-2 max-pool kernel for Hopper (NHWC, VAR in, VAR out).
//
// Replaces repro/kernels/pfp_maxpool.py: pfp_maxpool2d_pallas (_pool_kernel,
// _clark), the tournament of three Clark pairwise maxes (the two W pairs,
// then H).
//
// What bounds it on the H100: bytes. Each output reads 8 floats and writes
// 2 for three Clark maxes (an erf and an exp each). The TPU wrapper cuts
// the input into its four 2x2 phases with XLA slices before the kernel;
// here each thread reads its four (mu, var) pairs straight from the NHWC
// input, so the phases never touch device memory. One thread per output
// element with the channel fastest keeps loads and stores coalesced.
#include "pfp_common.cuh"

namespace {

// Clark max of two independent Gaussians, moment-matched back to
// (mean, var). As the TPU kernel: cdf_b = 1 - cdf_a, var clamped at 0, and
// a point-mass branch when both inputs are deterministic.
__device__ __forceinline__ void clark(float ma, float va, float mb, float vb,
                                      float* mean_out, float* var_out) {
  const float theta = sqrtf(fmaxf(va + vb, pfp::kVarEps));
  const float alpha = (ma - mb) / theta;
  const float cdf_a = 0.5f * (1.0f + erff(alpha / pfp::kSqrt2));
  const float cdf_b = 1.0f - cdf_a;
  const float pdf = expf(-0.5f * (alpha * alpha)) / pfp::kSqrt2Pi;
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

__global__ void __launch_bounds__(256)
pfp_maxpool2d_kernel(const float* __restrict__ mu,
                     const float* __restrict__ var,
                     float* __restrict__ mu_out, float* __restrict__ var_out,
                     int h, int w, int c, long long total) {
  const long long o = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (o >= total) return;
  const int ho_n = h / 2, wo_n = w / 2;
  const int ch = static_cast<int>(o % c);
  long long t = o / c;
  const int wo = static_cast<int>(t % wo_n);
  t /= wo_n;
  const int ho = static_cast<int>(t % ho_n);
  const long long b = t / ho_n;
  const long long row = static_cast<long long>(w) * c;
  const long long i00 = ((b * h + 2 * ho) * w + 2 * wo) * c + ch;
  const long long i01 = i00 + c, i10 = i00 + row, i11 = i10 + c;
  float m0, v0, m1, v1, m, v;
  clark(mu[i00], var[i00], mu[i01], var[i01], &m0, &v0);  // W pair, top row
  clark(mu[i10], var[i10], mu[i11], var[i11], &m1, &v1);  // W pair, bottom row
  clark(m0, v0, m1, v1, &m, &v);                          // H pair
  mu_out[o] = m;
  var_out[o] = v;
}

}  // namespace

// NHWC fp32 input (n, h, w, c), h and w even; output (n, h/2, w/2, c).
PFP_EXPORT int pfp_maxpool2d_launch(const void* mu, const void* var,
                                    void* mu_out, void* var_out, int n,
                                    int h, int w, int c, void* stream) {
  if (n < 1 || h < 2 || w < 2 || c < 1 || h % 2 || w % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n) * (h / 2) * (w / 2) * c;
  const unsigned blocks = static_cast<unsigned>((total + 255) / 256);
  pfp_maxpool2d_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(mu), static_cast<const float*>(var),
      static_cast<float*>(mu_out), static_cast<float*>(var_out), h, w, c,
      total);
  return pfp::launch_status();
}
