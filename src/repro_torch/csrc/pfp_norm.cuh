// The delta-method norms' row statistics and per-element normalisation,
// shared by the norm kernel (pfp_norms.cu) and the fused norm -> dense ->
// activation unit's norm pass (pfp_fused.cu), so that both form every
// value with the same operations in the same order, and the fused unit
// equals the unfused chain bit for bit.
//
// One block of T threads takes one row of d entries, in registers. Thread
// t holds G float4 groups of the row: group g is entries 4 (g T + t) .. +3
// (zeros past d). The plan (T, G) comes from the row width alone
// (kernels/pfp_norms.py norm_plan); PFP_NORM_GROUPS lists the G this file
// is instantiated on and the most threads each takes. Each thread loads its
// slice of mu and the second moment (and of gain and bias) once, as float4
// where every pointer is 16-byte aligned and d % 4 == 0, else one float at
// a time into the same registers. The row statistics come from those
// registers: each thread folds its slice, a shuffle tree folds each warp,
// and one exchange through shared memory folds the warps. RMSNorm needs one
// such reduction (one barrier); LayerNorm two, the token mean and then the
// centred spread from the same registers, each into its own buffer, so the
// second needs no barrier before it (two barriers a row). Then each thread
// normalises and stores its slice.
//
// Bit rules (tests/test_torch_norm_plan.py and chip_smoke.py hold them):
//  * The tree depends on d only. Which thread sums which entry and the
//    order of every fold follow from (T, G), a function of d. So a row's
//    outputs do not depend on how many rows the call has (M-independence,
//    which chunked and whole prefills rely on), nor on whether the
//    operands are 16-byte aligned: the scalar loads fill the same
//    registers as the float4 ones, and entries past d are masked alike.
//  * A thread folds its slice as ((x + y) + (z + w)) a group, the groups
//    in order g = 0, 1, ...; a warp by __shfl_xor_sync at offsets 16, 8,
//    4, 2, 1; the block by the same shuffle tree over the T / 32 warp
//    totals (lanes past T / 32 add 0).
//  * The fused unit follows the norm kernel: its norm pass forms
//    (h_mu, h_var) by norm_row, the function the norm kernel runs, and
//    rounds h_srm = h_var + h_mu^2 as torch's to_srm does.
//  * Only these rules hold bit for bit. Against the plain version
//    (kernels/ref.py) the outputs agree within NORM_TOL.
#pragma once

#include "pfp_moments.cuh"

namespace pfp {

enum Norm { kRms = 0, kLayer = 1 };
enum Rep { kRepVar = 0, kRepSrm = 1 };

// The plans' float4 groups a thread (G) and the most threads a block of
// each (T <= that, a multiple of 32): a thread holds 4 G floats of each of
// mu, the second moment, gain and bias in registers (G 2: 40-54 registers,
// no spills; four groups measured no faster and spilled, PERF.md).
// kernels/pfp_norms.py GROUPS is this list.
#define PFP_NORM_GROUPS(X) \
  X(1, 1024)               \
  X(2, 1024)

constexpr int kNormMaxWarps = 32;

constexpr int norm_max_threads(int groups) {
#define PFP_NORM_MAX(G, T) groups == G ? T:
  return PFP_NORM_GROUPS(PFP_NORM_MAX) 0;
#undef PFP_NORM_MAX
}

// Whether a block of `threads` threads of `groups` groups each can take a
// row of d entries.
inline bool norm_plan_ok(int threads, int groups, int d) {
  const int most = norm_max_threads(groups);
  return most > 0 && threads >= 32 && threads <= most &&
         threads % 32 == 0 &&
         4LL * groups * static_cast<long long>(threads) >= d;
}

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

__device__ __forceinline__ float& lane(float4& v, int l) {
  return reinterpret_cast<float*>(&v)[l];
}

__device__ __forceinline__ float lane(const float4& v, int l) {
  return reinterpret_cast<const float*>(&v)[l];
}

__device__ __forceinline__ float sum4(const float4& v) {
  return (v.x + v.y) + (v.z + v.w);
}

// The shuffle tree of one warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block; every thread gets the total. `part` holds
// kNormMaxWarps floats that no thread reads before this call's barrier.
__device__ __forceinline__ float block_sum(float v, float* part) {
  v = warp_sum(v);
  const int lane_id = threadIdx.x % 32;
  if (lane_id == 0) part[threadIdx.x / 32] = v;
  __syncthreads();
  return warp_sum(lane_id < static_cast<int>(blockDim.x / 32)
                      ? part[lane_id]
                      : 0.0f);
}

// First entry of this thread's group g.
__device__ __forceinline__ int group_start(int g) {
  return 4 * (g * static_cast<int>(blockDim.x) +
              static_cast<int>(threadIdx.x));
}

// This thread's G groups of row p (d entries), 0 past d: float4 loads
// where `vec`, else one float at a time into the same registers.
template <int G>
__device__ __forceinline__ void load_slice(const float* __restrict__ p,
                                           int d, bool vec, float4 (&r)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = group_start(g);
    if (vec) {
      r[g] = j < d ? __ldg(reinterpret_cast<const float4*>(p + j))
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
#pragma unroll
      for (int l = 0; l < 4; ++l) lane(r[g], l) = j + l < d ? __ldg(p + j + l)
                                                            : 0.0f;
    }
  }
}

__device__ __forceinline__ float normaliser(float total, float inv_d,
                                            float eps) {
  return 1.0f / sqrtf(total * inv_d + eps);
}

// The row statistics (LayerNorm's token mean, 0 for RMSNorm, and the
// normaliser) of a row held as the block's slices m, s; every thread gets
// them. `part` holds 2 * kNormMaxWarps floats.
template <int NORM, int REP, int G>
__device__ __forceinline__ void slice_row_stats(const float4 (&m)[G],
                                                const float4 (&s)[G], int d,
                                                float eps, float* part,
                                                float* mu_tok, float* norm) {
  const float inv_d = 1.0f / static_cast<float>(d);
  float acc = 0.0f;
  if constexpr (NORM == kRms) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4 srm;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float var;
        var_srm<REP>(lane(m[g], l), lane(s[g], l), &var, &lane(srm, l));
      }
      acc += sum4(srm);
    }
    *mu_tok = 0.0f;
    *norm = normaliser(block_sum(acc, part), inv_d, eps);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) acc += sum4(m[g]);
    const float tok = block_sum(acc, part) * inv_d;
    acc = 0.0f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int j = group_start(g);
      float4 term;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float var, srm;
        var_srm<REP>(lane(m[g], l), lane(s[g], l), &var, &srm);
        const float c = lane(m[g], l) - tok;
        lane(term, l) = j + l < d ? var + c * c : 0.0f;
      }
      acc += sum4(term);
    }
    *mu_tok = tok;
    *norm = normaliser(block_sum(acc, part + kNormMaxWarps), inv_d, eps);
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

// One row (m, s of d entries; gain and bias (d,), bias read only by
// LayerNorm) by the block, on a plan of G groups a thread: load, row
// statistics, normalise. store(j, mean, var) takes each group that starts
// inside the row (j its first entry; lanes past d hold no entry).
template <int NORM, int REP, int G, class Store>
__device__ __forceinline__ void norm_row(const float* __restrict__ m_row,
                                         const float* __restrict__ s_row,
                                         const float* __restrict__ gain,
                                         const float* __restrict__ bias,
                                         int d, float eps, bool vec,
                                         float* part, const Store& store) {
  float4 m[G], s[G], w[G], b[G];
  load_slice<G>(m_row, d, vec, m);
  load_slice<G>(s_row, d, vec, s);
  load_slice<G>(gain, d, vec, w);   // in flight across the reductions
  if constexpr (NORM == kLayer) {
    load_slice<G>(bias, d, vec, b);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) b[g] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  float mu_tok, norm;
  slice_row_stats<NORM, REP, G>(m, s, d, eps, part, &mu_tok, &norm);
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int j = group_start(g);
    if (j >= d) continue;
    float4 mean, var;
#pragma unroll
    for (int l = 0; l < 4; ++l)
      normalise<NORM, REP>(lane(m[g], l), lane(s[g], l), lane(w[g], l),
                           lane(b[g], l), mu_tok, norm, &lane(mean, l),
                           &lane(var, l));
    store(j, mean, var);
  }
}

// Store a group of two outputs at entry j of rows a and b (d entries):
// float4 where `vec`, else the lanes inside the row one at a time.
__device__ __forceinline__ void store_group(float* __restrict__ a,
                                            float* __restrict__ b, int j,
                                            int d, bool vec,
                                            const float4& va,
                                            const float4& vb) {
  if (vec) {
    *reinterpret_cast<float4*>(a + j) = va;
    *reinterpret_cast<float4*>(b + j) = vb;
  } else {
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      if (j + l < d) {
        a[j + l] = lane(va, l);
        b[j + l] = lane(vb, l);
      }
    }
  }
}

}  // namespace pfp
