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
// (dozens with a Gauss-Hermite epilogue); the reductions are per row.
// Design: one block of 256 threads per row. A pass over the row sums what
// the normaliser needs (warp shuffles, then one value per warp in shared
// memory); a last pass reads the row again (from L1/L2: a 4096-wide row is
// 32 KB) and writes the outputs, with neighbouring threads on neighbouring
// addresses throughout. Rows and d of any size are masked here; nothing is
// padded.
//
// LayerNorm's spread: the TPU kernel uses the moment form
// sum(var + mu^2)/d - mu_tok^2 (pfp_norms.py:69), which zero padding needed
// and which cancels when |mu_tok| is large. Nothing is padded here and the
// row is at hand, so the spread is summed in the centred form of the
// eager pfp_layers.pfp_layernorm, after a first pass for mu_tok.
//
// The row statistics and the per-element normalisation live in
// pfp_norm.cuh, shared with the fused unit (pfp_fused.cu).
#include "pfp_norm.cuh"

namespace {

using pfp::kLayer;
using pfp::kRepSrm;
using pfp::kRepVar;
using pfp::kRms;
constexpr int kThreads = pfp::kNormThreads;
constexpr int kNoAct = -1;

template <int NORM, int REP, int ACT>
__global__ void __launch_bounds__(kThreads)
pfp_norm_kernel(const float* __restrict__ mu, const float* __restrict__ sec,
                const float* __restrict__ gain,
                const float* __restrict__ bias,
                float* __restrict__ mu_out, float* __restrict__ sec_out,
                int d, float eps) {
  __shared__ float s_part[pfp::kNormWarps];
  const long long base = static_cast<long long>(blockIdx.x) * d;
  const float* m = mu + base;
  const float* s = sec + base;
  float mu_tok, norm;
  pfp::block_row_stats<NORM, REP>(m, s, d, eps, s_part, &mu_tok, &norm);

  for (int j = threadIdx.x; j < d; j += kThreads) {
    float mean, var;
    pfp::normalise<NORM, REP>(m[j], s[j], gain[j], bias[j], mu_tok, norm,
                              &mean, &var);
    if constexpr (ACT != kNoAct) {
      pfp::activation_moments<ACT>(mean, var, &mu_out[base + j],
                                   &sec_out[base + j]);
    } else {
      mu_out[base + j] = mean;
      sec_out[base + j] = var;
    }
  }
}

template <int NORM, int REP, int ACT>
void launch(const float* mu, const float* sec, const float* gain,
            const float* bias, float* mu_out, float* sec_out, int rows,
            int d, float eps, cudaStream_t stream) {
  pfp_norm_kernel<NORM, REP, ACT><<<rows, kThreads, 0, stream>>>(
      mu, sec, gain, bias, mu_out, sec_out, d, eps);
}

template <int NORM, int REP>
int launch_act(int act, const float* mu, const float* sec, const float* gain,
               const float* bias, float* mu_out, float* sec_out, int rows,
               int d, float eps, cudaStream_t s) {
  switch (act) {
    case kNoAct:
      launch<NORM, REP, kNoAct>(mu, sec, gain, bias, mu_out, sec_out, rows,
                                d, eps, s);
      break;
    case pfp::kRelu:
      launch<NORM, REP, pfp::kRelu>(mu, sec, gain, bias, mu_out, sec_out,
                                    rows, d, eps, s);
      break;
    case pfp::kGelu:
      launch<NORM, REP, pfp::kGelu>(mu, sec, gain, bias, mu_out, sec_out,
                                    rows, d, eps, s);
      break;
    case pfp::kSilu:
      launch<NORM, REP, pfp::kSilu>(mu, sec, gain, bias, mu_out, sec_out,
                                    rows, d, eps, s);
      break;
    case pfp::kTanh:
      launch<NORM, REP, pfp::kTanh>(mu, sec, gain, bias, mu_out, sec_out,
                                    rows, d, eps, s);
      break;
    case pfp::kSigmoid:
      launch<NORM, REP, pfp::kSigmoid>(mu, sec, gain, bias, mu_out, sec_out,
                                       rows, d, eps, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return pfp::launch_status();
}

template <int NORM>
int launch_rep(int rep, int act, const float* mu, const float* sec,
               const float* gain, const float* bias, float* mu_out,
               float* sec_out, int rows, int d, float eps, cudaStream_t s) {
  if (rep == kRepVar)
    return launch_act<NORM, kRepVar>(act, mu, sec, gain, bias, mu_out,
                                     sec_out, rows, d, eps, s);
  if (rep == kRepSrm)
    return launch_act<NORM, kRepSrm>(act, mu, sec, gain, bias, mu_out,
                                     sec_out, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// norm: 0 rms, 1 layer (bias read only then); rep: 0 the second moment is a
// variance, 1 a second raw moment; act: -1 none (outputs mean, var), else
// an activation kind of pfp_moments.cuh (outputs mean, srm). mu, sec and
// the outputs are (rows, d) fp32 row-major; gain and bias (d,).
PFP_EXPORT int pfp_norm_launch(int norm, int rep, int act, const void* mu,
                               const void* sec, const void* gain,
                               const void* bias, void* mu_out, void* sec_out,
                               int rows, int d, float eps, void* stream) {
  if (rows < 1 || d < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* pm = static_cast<const float*>(mu);
  const auto* ps = static_cast<const float*>(sec);
  const auto* pg = static_cast<const float*>(gain);
  const auto* pb = static_cast<const float*>(bias);
  auto* om = static_cast<float*>(mu_out);
  auto* os = static_cast<float*>(sec_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (norm == kRms)
    return launch_rep<kRms>(rep, act, pm, ps, pg, pb, om, os, rows, d, eps,
                            s);
  if (norm == kLayer)
    return launch_rep<kLayer>(rep, act, pm, ps, pg, pb, om, os, rows, d, eps,
                              s);
  return static_cast<int>(cudaErrorInvalidValue);
}
