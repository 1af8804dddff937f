// The fused PFP unit for Hopper: a delta-method norm (RMSNorm or
// LayerNorm, VAR or SRM input), VAR -> SRM, the Eq. 12 joint dense and a
// moment-matched activation in one kernel:
// (M,K) norm input x (K,N) weight -> mean (M,N), srm (M,N).
//
// Replaces repro/kernels/pfp_fused.py: pfp_norm_dense_act_pallas
// (_norm_dense_act_kernel).
//
// It computes what the unfused kernel chain computes (pfp_norms.cu, torch's
// to_srm, pfp_dense.cu mode 0, pfp_activations.cu), bit for bit, with every
// (block_m, block_n) tile:
//  * Norm prologue. Each block forms the statistics of its block_m rows
//    with pfp_norm.cuh: the norm kernel's strided 256-thread sums and its
//    block_sum tree, each row by one warp (warp_block_sum), 8 rows at once.
//  * K loop. pfp_dense.cu's mode-0 sums: kBK = 16 rows of K a tile in
//    shared memory, k in sequence, the mean in one accumulator and the
//    variance in one accumulator fed by two fmaf (+ srm_x srm_w, then
//    - mu_x^2 mu_w^2). The x tile is normalised while it is staged:
//    (h_mu, h_var) by pfp_norm.cuh's normalise, as the norm kernel forms
//    them, then h_srm = h_var + h_mu^2 rounded as torch's two-op to_srm
//    rounds it. The intrinsics keep nvcc from contracting that product and
//    sum into one fma, which would round once and part the bits. Each
//    output's sum runs over k in one order whatever the tile, so every
//    tile gives the same bits.
//    Unlike the dense kernel, the squares mu_x^2 and mu_w^2 are formed
//    once as a tile is staged (the same rounded products the dense kernel
//    forms in its inner loop), and a thread's rows and columns are groups
//    of up to 4 neighbours read by one shared load: the inner loop is
//    then 3 TM TN fmaf and 3 (TM / RV + TN / CV) loads a k (6 at 4 x 4),
//    where the dense kernel's adds TM + TN multiplies and 2 (TM + TN)
//    loads (16).
//  * Epilogue. pfp::activation_moments on the fp32 (mean, var) of the
//    sums, staged through shared memory unchanged: the code the activation
//    kernel runs on the dense's output. The kind is a run-time argument
//    (pfp::activation_moments_of), so the file has 24 instantiations
//    (2 norms x 2 reps x 6 tiles), not 120.
// IEEE fp32 on the SIMT cores throughout: no TF32, no tensor cores (Eq. 12
// is a small difference of two large sums).
//
// What bounds it on the H100: at prefill (granite's gate projection,
// M 2048, K 4096, N 14336) the fp32 FMA rate: three products of M N K
// terms, 7.2e11 operations, against 0.5 GB moved. At a decode step (M 4)
// the weight stream: the (K, N) mean and SRM, 470 MB, read once per
// block_m rows. What fusing saves is the norm's and the dense's outputs
// round trips through device memory and two launches; the dense's work
// stays, and sets the pace. The row statistics are formed again by every
// block of a block row (N / block_n times), from L2.
// Design: 16 x 16 threads, each holding block_m / 16 rows and block_n / 16
// columns of the output tile; ragged M, N and K are masked (masked entries
// are exact zeros, as in the dense kernel), nothing is padded.
#include "pfp_norm.cuh"

namespace {

using pfp::kLayer;
using pfp::kRepSrm;
using pfp::kRepVar;
using pfp::kRms;
constexpr int kThreads = pfp::kNormThreads;  // 16 x 16
constexpr int kSide = 16;
constexpr int kBK = 16;
// One vector of W neighbouring floats from shared memory (16-, 8- or
// 4-byte aligned).
template <int W>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
  if constexpr (W == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  } else if constexpr (W == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    out[0] = *p;
  }
}

template <int NORM, int REP, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
pfp_norm_dense_act_kernel(int act, const float* __restrict__ mu,
                          const float* __restrict__ sec,
                          const float* __restrict__ gain,
                          const float* __restrict__ bias,
                          const float* __restrict__ mu_w,
                          const float* __restrict__ srm_w,
                          float* __restrict__ mu_out,
                          float* __restrict__ srm_out, int M, int N, int K,
                          float eps) {
  constexpr int BM = kSide * TM;
  constexpr int BN = kSide * TN;
  // A thread's TM rows come in groups of RV neighbours, group g at rows
  // g * 16 RV + ty RV + [0, RV); its TN columns likewise in groups of CV.
  // So one shared-memory load reads a group, and the 16 threads of a row
  // of the thread grid read 16 neighbouring groups.
  constexpr int RV = TM < 4 ? TM : 4;
  constexpr int CV = TN < 4 ? TN : 4;
  // x tiles are stored k-major, rows padded to XP floats: 16-byte aligned,
  // and the transposing stores spread over the banks.
  constexpr int XP = BM + 4;
  constexpr int kX = kBK * XP, kW = kBK * BN;
  // One buffer holds the K loop's tiles (x: mean, mean^2, srm; w: mean,
  // mean^2, srm), then the epilogue's staged group of rows x columns.
  constexpr int kLoopFloats = 3 * kX + 3 * kW;
  constexpr int kEpiR = kSide * RV, kEpiC = kSide * CV;
  constexpr int kEpiFloats = 2 * kEpiR * kEpiC;
  __shared__ float s_tok[BM];
  __shared__ float s_norm[BM];
  __shared__ __align__(16)
      float s_buf[kLoopFloats > kEpiFloats ? kLoopFloats : kEpiFloats];
  auto s_xa = reinterpret_cast<float (*)[XP]>(s_buf);
  auto s_xa2 = reinterpret_cast<float (*)[XP]>(s_buf + kX);
  auto s_xb = reinterpret_cast<float (*)[XP]>(s_buf + 2 * kX);
  auto s_wa = reinterpret_cast<float (*)[BN]>(s_buf + 3 * kX);
  auto s_wa2 = reinterpret_cast<float (*)[BN]>(s_buf + 3 * kX + kW);
  auto s_wb = reinterpret_cast<float (*)[BN]>(s_buf + 3 * kX + 2 * kW);

  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int lane = threadIdx.x % 32;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;

  // Norm prologue: warp w forms the statistics of rows w, w + 8, ...
  for (int r = threadIdx.x / 32; r < BM; r += pfp::kNormWarps) {
    const long long m = m0 + r;
    float tok = 0.0f, norm = 0.0f;
    if (m < M)
      pfp::warp_row_stats<NORM, REP>(mu + m * K, sec + m * K, K, eps, lane,
                                     &tok, &norm);
    if (lane == 0) {
      s_tok[r] = tok;
      s_norm[r] = norm;
    }
  }
  __syncthreads();

  float acc_mu[TM][TN], acc_v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_mu[i][j] = 0.0f;
      acc_v[i][j] = 0.0f;
    }
  }

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
      const int r = e / kBK, c = e % kBK;
      const long long m = m0 + r;
      const int k = k0 + c;
      float h_mu = 0.0f, h_mu2 = 0.0f, h_srm = 0.0f;
      if (m < M && k < K) {
        const long long off = m * K + k;
        float h_var;
        pfp::normalise<NORM, REP>(mu[off], sec[off], gain[k], bias[k],
                                  s_tok[r], s_norm[r], &h_mu, &h_var);
        h_mu2 = __fmul_rn(h_mu, h_mu);
        h_srm = __fadd_rn(h_var, h_mu2);
      }
      s_xa[c][r] = h_mu;
      s_xa2[c][r] = h_mu2;
      s_xb[c][r] = h_srm;
    }
    for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < N;
      const long long off = static_cast<long long>(k) * N + n;
      const float w = ok ? mu_w[off] : 0.0f;
      s_wa[r][c] = w;
      s_wa2[r][c] = __fmul_rn(w, w);
      s_wb[r][c] = ok ? srm_w[off] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], a2[TM], b[TM], w[TN], w2[TN], v[TN];
#pragma unroll
      for (int g = 0; g < TM / RV; ++g) {
        const int row = g * kSide * RV + ty * RV;
        load_vec<RV>(&s_xa[kk][row], &a[g * RV]);
        load_vec<RV>(&s_xa2[kk][row], &a2[g * RV]);
        load_vec<RV>(&s_xb[kk][row], &b[g * RV]);
      }
#pragma unroll
      for (int g = 0; g < TN / CV; ++g) {
        const int col = g * kSide * CV + tx * CV;
        load_vec<CV>(&s_wa[kk][col], &w[g * CV]);
        load_vec<CV>(&s_wa2[kk][col], &w2[g * CV]);
        load_vec<CV>(&s_wb[kk][col], &v[g * CV]);
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_mu[i][j] = fmaf(a[i], w[j], acc_mu[i][j]);
          acc_v[i][j] = fmaf(b[i], v[j], acc_v[i][j]);     // + srm_x srm_w
          acc_v[i][j] = fmaf(-a2[i], w2[j], acc_v[i][j]);  // - mu_x^2 mu_w^2
        }
      }
    }
    __syncthreads();
  }

  // Epilogue, one group of rows x one group of columns a pass: every
  // thread stages its accumulators of the pass in shared memory, then the
  // block walks the staged kEpiR x kEpiC outputs with neighbouring threads
  // on neighbouring columns, so the stores coalesce and the activation's
  // code appears once a pass, not once per accumulator: the Gauss-Hermite
  // kinds are long, and TM x TN copies of them would dominate the build.
  auto s_mu = reinterpret_cast<float (*)[kEpiC]>(s_buf);
  auto s_var = reinterpret_cast<float (*)[kEpiC]>(s_buf + kEpiR * kEpiC);
#pragma unroll
  for (int gi = 0; gi < TM / RV; ++gi) {
#pragma unroll
    for (int gj = 0; gj < TN / CV; ++gj) {
#pragma unroll
      for (int ii = 0; ii < RV; ++ii) {
#pragma unroll
        for (int jj = 0; jj < CV; ++jj) {
          const int i = gi * RV + ii, j = gj * CV + jj;
          s_mu[ty * RV + ii][tx * CV + jj] = acc_mu[i][j];
          s_var[ty * RV + ii][tx * CV + jj] = acc_v[i][j];
        }
      }
      __syncthreads();
#pragma unroll 1
      for (int e = threadIdx.x; e < kEpiR * kEpiC; e += kThreads) {
        const int r = e / kEpiC, c = e % kEpiC;
        const long long m = m0 + gi * kEpiR + r;
        const int n = n0 + gj * kEpiC + c;
        if (m < M && n < N) {
          const long long off = m * N + n;
          pfp::activation_moments_of(act, s_mu[r][c], s_var[r][c],
                                     &mu_out[off], &srm_out[off]);
        }
      }
      __syncthreads();
    }
  }
}

struct Problem {
  int act;
  const float *mu, *sec, *gain, *bias, *mu_w, *srm_w;
  float *mu_out, *srm_out;
  int M, N, K;
  float eps;
};

template <int NORM, int REP, int TM, int TN>
void launch(const Problem& p, cudaStream_t stream) {
  constexpr int BM = kSide * TM, BN = kSide * TN;
  const dim3 grid(static_cast<unsigned>((p.M + BM - 1) / BM),
                  static_cast<unsigned>((p.N + BN - 1) / BN));
  pfp_norm_dense_act_kernel<NORM, REP, TM, TN>
      <<<grid, kThreads, 0, stream>>>(p.act, p.mu, p.sec, p.gain, p.bias,
                                      p.mu_w, p.srm_w, p.mu_out, p.srm_out,
                                      p.M, p.N, p.K, p.eps);
}

// The tiles of kernels/pfp_fused.py TILES.
template <int NORM, int REP>
int launch_tile(int block_m, int block_n, const Problem& p, cudaStream_t s) {
  if (block_m == 16 && block_n == 64)
    launch<NORM, REP, 1, 4>(p, s);
  else if (block_m == 16 && block_n == 128)
    launch<NORM, REP, 1, 8>(p, s);
  else if (block_m == 32 && block_n == 64)
    launch<NORM, REP, 2, 4>(p, s);
  else if (block_m == 64 && block_n == 64)
    launch<NORM, REP, 4, 4>(p, s);
  else if (block_m == 64 && block_n == 128)
    launch<NORM, REP, 4, 8>(p, s);
  else if (block_m == 128 && block_n == 64)
    launch<NORM, REP, 8, 4>(p, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return pfp::launch_status();
}

template <int NORM>
int launch_rep(int rep, int block_m, int block_n, const Problem& p,
               cudaStream_t s) {
  if (rep == kRepVar)
    return launch_tile<NORM, kRepVar>(block_m, block_n, p, s);
  if (rep == kRepSrm)
    return launch_tile<NORM, kRepSrm>(block_m, block_n, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// norm: 0 rms, 1 layer (bias read only then); rep: 0 the input's second
// moment is a variance, 1 a second raw moment; act: an activation kind of
// pfp_moments.cuh; (block_m, block_n): one of the instantiated tiles. mu,
// sec (m, k); gain, bias (k,); mu_w, srm_w (k, n); the outputs (m, n) mean
// and srm. All fp32, row-major, contiguous, on the device of `stream`.
// Requires m, n, k >= 1.
PFP_EXPORT int pfp_norm_dense_act_launch(
    int norm, int rep, int act, int block_m, int block_n, const void* mu,
    const void* sec, const void* gain, const void* bias, const void* mu_w,
    const void* srm_w, void* mu_out, void* srm_out, int m, int n, int k,
    float eps, void* stream) {
  if (m < 1 || n < 1 || k < 1 || act < pfp::kRelu || act > pfp::kSigmoid)
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{act,
                  static_cast<const float*>(mu),
                  static_cast<const float*>(sec),
                  static_cast<const float*>(gain),
                  static_cast<const float*>(bias),
                  static_cast<const float*>(mu_w),
                  static_cast<const float*>(srm_w),
                  static_cast<float*>(mu_out),
                  static_cast<float*>(srm_out),
                  m, n, k, eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (norm == kRms) return launch_rep<kRms>(rep, block_m, block_n, p, s);
  if (norm == kLayer) return launch_rep<kLayer>(rep, block_m, block_n, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
