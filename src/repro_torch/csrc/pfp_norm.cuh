// The delta-method norms' row statistics and per-element normalisation,
// shared by the norm kernel (pfp_norms.cu) and the fused norm -> dense ->
// activation unit (pfp_fused.cu), so that both form every value with the
// same operations in the same order, and the fused unit equals the
// unfused chain bit for bit.
//
// A row's statistics are sums over its d entries, each formed by one block
// of kNormThreads threads: thread t sums the terms j = t, t + 256, ... in
// order (the partial_* functions), then block_sum adds the 256 partial
// sums by a shuffle tree in each warp and the 8 warp totals in order.
// block_row_stats is that whole reduction, for the norm kernel and the
// fused unit's norm pass alike.
#pragma once

#include "pfp_moments.cuh"

namespace pfp {

constexpr int kNormThreads = 256;
constexpr int kNormWarps = kNormThreads / 32;

enum Norm { kRms = 0, kLayer = 1 };
enum Rep { kRepVar = 0, kRepSrm = 1 };

template <int REP>
__device__ __forceinline__ void var_srm(float mu, float sec, float* var,
                                        float* srm) {
  if constexpr (REP == kRepVar) {
    *var = sec;
    *srm = sec + mu * mu;
  } else {
    *var = sec - mu * mu;
    *srm = sec;
  }
}

// The shuffle tree of one warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over a block of kNormThreads threads; every thread gets the total.
__device__ __forceinline__ float block_sum(float v, float* s_part) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // s_part may still be read by a previous reduction
  if (lane == 0) s_part[warp] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int w = 0; w < kNormWarps; ++w) total += s_part[w];
  return total;
}

// Thread t's partial sums over a row m, s of d entries.
template <int REP>
__device__ __forceinline__ float partial_srm(const float* m, const float* s,
                                             int d, int t) {
  float acc = 0.0f;
  for (int j = t; j < d; j += kNormThreads) {
    float var, srm;
    var_srm<REP>(m[j], s[j], &var, &srm);
    acc += srm;
  }
  return acc;
}

__device__ __forceinline__ float partial_mean(const float* m, int d, int t) {
  float acc = 0.0f;
  for (int j = t; j < d; j += kNormThreads) acc += m[j];
  return acc;
}

template <int REP>
__device__ __forceinline__ float partial_spread(const float* m,
                                                const float* s, int d, int t,
                                                float mu_tok) {
  float acc = 0.0f;
  for (int j = t; j < d; j += kNormThreads) {
    float var, srm;
    var_srm<REP>(m[j], s[j], &var, &srm);
    const float c = m[j] - mu_tok;
    acc += var + c * c;
  }
  return acc;
}

__device__ __forceinline__ float normaliser(float total, float inv_d,
                                            float eps) {
  return 1.0f / sqrtf(total * inv_d + eps);
}

// The row statistics (LayerNorm's token mean, 0 for RMSNorm, and the
// normaliser) of row m, s of d entries, formed by a block of kNormThreads
// threads; every thread gets them. s_part holds kNormWarps floats.
template <int NORM, int REP>
__device__ __forceinline__ void block_row_stats(const float* m, const float* s,
                                                int d, float eps,
                                                float* s_part, float* mu_tok,
                                                float* norm) {
  const float inv_d = 1.0f / static_cast<float>(d);
  if constexpr (NORM == kRms) {
    *mu_tok = 0.0f;
    *norm = normaliser(
        block_sum(partial_srm<REP>(m, s, d, threadIdx.x), s_part), inv_d,
        eps);
  } else {
    const float tok =
        block_sum(partial_mean(m, d, threadIdx.x), s_part) * inv_d;
    *mu_tok = tok;
    *norm = normaliser(
        block_sum(partial_spread<REP>(m, s, d, threadIdx.x, tok), s_part),
        inv_d, eps);
  }
}

// One normalised entry: (mean, var) of the norm's output.
template <int NORM, int REP>
__device__ __forceinline__ void normalise(float mu, float sec, float gain,
                                          float bias, float mu_tok,
                                          float norm, float* mean,
                                          float* var) {
  float v, srm;
  var_srm<REP>(mu, sec, &v, &srm);
  const float scale = norm * gain;
  if constexpr (NORM == kRms)
    *mean = mu * scale;
  else
    *mean = (mu - mu_tok) * scale + bias;
  *var = v * (scale * scale);
}

}  // namespace pfp
