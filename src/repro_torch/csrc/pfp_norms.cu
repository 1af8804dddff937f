// Delta-method PFP normalisation kernels for Hopper: RMSNorm and LayerNorm
// over the last axis, with an optional moment-matched activation epilogue.
//
// Replaces repro/kernels/pfp_norms.py: pfp_rmsnorm_pallas (_rmsnorm_kernel)
// and pfp_layernorm_pallas (_layernorm_kernel), both through _norm_call.
//
//   RMSNorm:   scale = gain / sqrt(sum_j srm_j / d + eps)
//              mean' = mu * scale,            var' = var * scale^2
//   LayerNorm: mu_tok = sum_j mu_j / d
//              spread = sum_j (var_j + (mu_j - mu_tok)^2) / d
//              scale = gain / sqrt(spread + eps)
//              mean' = (mu - mu_tok) * scale + bias,  var' = var * scale^2
//
// then, with an activation, (mean', var') -> (mean, srm) by the moment
// functions of pfp_moments.cuh. The input's second moment is a variance or
// a second raw moment (REP), the missing one formed in registers.
//
// What bounds it on the H100: bytes. Each element is read once (mu and the
// second moment) and written once (two outputs), for a handful of flops
// (dozens with a Gauss-Hermite epilogue); the reductions are per row. At a
// decode step (4 rows) the launch and one row's chain of dependent steps
// are the time: load, fold, barrier, normalise, store.
// Design: one block a row, the row in registers (pfp_norm.cuh norm_row):
// each thread loads its slice of the row once, as float4 where aligned,
// the statistics come from those registers by shuffle trees and one
// exchange through shared memory a reduction (one barrier for RMSNorm, two
// for LayerNorm), and each thread normalises and stores its slice. The
// block's threads and each thread's groups (the plan) come from the row
// width alone (kernels/pfp_norms.py norm_plan), so that a row's bits
// depend on d only; pfp_norm.cuh states the bit rules. Rows and d of any
// size a plan covers are masked here; nothing is padded.
//
// LayerNorm's spread: the TPU kernel uses the moment form
// sum(var + mu^2)/d - mu_tok^2 (pfp_norms.py:69), which zero padding needed
// and which cancels when |mu_tok| is large. Nothing is padded here and the
// row is at hand, so the spread is summed in the centred form of the
// eager pfp_layers.pfp_layernorm, after a first reduction for mu_tok, from
// the same registers. (A single reduction of per-thread (count, mean, M2,
// sum of var) merged by Chan's formula would save one barrier, for a
// division and several products more a merge, and another rounding than
// the centred sum's; the two-reduction form keeps the eager layer's
// arithmetic.)
#include "pfp_norm.cuh"

namespace {

using pfp::kLayer;
using pfp::kRepSrm;
using pfp::kRepVar;
using pfp::kRms;
constexpr int kNoAct = -1;

// The outputs of one group: (mean, var), or (mean, srm) through ACT.
template <int ACT>
struct NormStore {
  float* mu;
  float* sec;
  int d;
  bool vec;

  __device__ __forceinline__ void operator()(int j, const float4& mean,
                                             const float4& var) const {
    if constexpr (ACT == kNoAct) {
      pfp::store_group(mu, sec, j, d, vec, mean, var);
    } else {
      float4 a, b;
#pragma unroll
      for (int l = 0; l < 4; ++l)
        pfp::activation_moments<ACT>(pfp::lane(mean, l), pfp::lane(var, l),
                                     &pfp::lane(a, l), &pfp::lane(b, l));
      pfp::store_group(mu, sec, j, d, vec, a, b);
    }
  }
};

template <int NORM, int REP, int ACT, int G>
__global__ void __launch_bounds__(pfp::norm_max_threads(G))
pfp_norm_kernel(const float* __restrict__ mu, const float* __restrict__ sec,
                const float* __restrict__ gain,
                const float* __restrict__ bias,
                float* __restrict__ mu_out, float* __restrict__ sec_out,
                int d, float eps, int vec) {
  __shared__ float part[2 * pfp::kNormMaxWarps];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  pfp::norm_row<NORM, REP, G>(mu + base, sec + base, gain, bias, d, eps,
                              vec != 0, part,
                              NormStore<ACT>{mu_out + base, sec_out + base,
                                             d, vec != 0});
}

struct Args {
  const float *mu, *sec, *gain, *bias;
  float *mu_out, *sec_out;
  int rows, d;
  float eps;
  int vec;
};

template <int NORM, int REP, int ACT>
int launch(const Args& a, int threads, int groups, cudaStream_t stream) {
#define PFP_NORM_CASE(G, T)                                             \
  if (groups == G) {                                                    \
    pfp_norm_kernel<NORM, REP, ACT, G><<<a.rows, threads, 0, stream>>>( \
        a.mu, a.sec, a.gain, a.bias, a.mu_out, a.sec_out, a.d, a.eps,   \
        a.vec);                                                         \
    return pfp::launch_status();                                        \
  }
  PFP_NORM_GROUPS(PFP_NORM_CASE)
#undef PFP_NORM_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // not instantiated
}

template <int NORM, int REP>
int launch_act(int act, const Args& a, int threads, int groups,
               cudaStream_t s) {
  switch (act) {
    case kNoAct:
      return launch<NORM, REP, kNoAct>(a, threads, groups, s);
    case pfp::kRelu:
      return launch<NORM, REP, pfp::kRelu>(a, threads, groups, s);
    case pfp::kGelu:
      return launch<NORM, REP, pfp::kGelu>(a, threads, groups, s);
    case pfp::kSilu:
      return launch<NORM, REP, pfp::kSilu>(a, threads, groups, s);
    case pfp::kTanh:
      return launch<NORM, REP, pfp::kTanh>(a, threads, groups, s);
    case pfp::kSigmoid:
      return launch<NORM, REP, pfp::kSigmoid>(a, threads, groups, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int NORM>
int launch_rep(int rep, int act, const Args& a, int threads, int groups,
               cudaStream_t s) {
  if (rep == kRepVar)
    return launch_act<NORM, kRepVar>(act, a, threads, groups, s);
  if (rep == kRepSrm)
    return launch_act<NORM, kRepSrm>(act, a, threads, groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace

// norm: 0 rms, 1 layer (bias read only then); rep: 0 the second moment is a
// variance, 1 a second raw moment; act: -1 none (outputs mean, var), else
// an activation kind of pfp_moments.cuh (outputs mean, srm); (threads,
// groups): the plan, a block of `threads` a row, `groups` float4 groups a
// thread (one of PFP_NORM_GROUPS, covering d). mu, sec and the outputs
// are (rows, d) fp32 row-major; gain and bias (d,).
PFP_EXPORT int pfp_norm_launch(int norm, int rep, int act, int threads,
                               int groups, const void* mu, const void* sec,
                               const void* gain, const void* bias,
                               void* mu_out, void* sec_out, int rows, int d,
                               float eps, void* stream) {
  if (rows < 1 || d < 1 || !pfp::norm_plan_ok(threads, groups, d))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(mu),
               static_cast<const float*>(sec),
               static_cast<const float*>(gain),
               static_cast<const float*>(bias),
               static_cast<float*>(mu_out),
               static_cast<float*>(sec_out),
               rows,
               d,
               eps,
               d % 4 == 0 && aligned16(mu) && aligned16(sec) &&
                   aligned16(gain) && aligned16(bias) && aligned16(mu_out) &&
                   aligned16(sec_out)};
  auto s = static_cast<cudaStream_t>(stream);
  if (norm == kRms) return launch_rep<kRms>(rep, act, a, threads, groups, s);
  if (norm == kLayer)
    return launch_rep<kLayer>(rep, act, a, threads, groups, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
