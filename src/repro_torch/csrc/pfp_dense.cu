// Joint PFP dense kernels for Hopper: Eq. 12 (SRM), Eq. 13 (first layer)
// and Eq. 7 (var formulation), (M,K) x (K,N) -> mean (M,N), variance (M,N),
// and the same for E independent problems (E,M,K) x (E,K,N) -> (E,M,N).
//
// Replaces repro/kernels/pfp_dense.py: pfp_dense_pallas (_dense_kernel,
// _first_layer_kernel) and pfp_dense_var_pallas (_var_formulation_kernel);
// and repro/kernels/pfp_moe.py: pfp_dense_batched_pallas (_bdense_kernel,
// _bfirst_layer_kernel) and pfp_dense_batched_var_pallas
// (_bvar_formulation_kernel), the MoE expert MLP.
//
// What bounds it on the H100: on the paper's models K <= 784 and N <= 120,
// so each output element costs 2-4 products of K terms and the operands
// are a few MB at most. At batch <= 100 the grid has only a handful of
// blocks and the kernel is bound by latency (one block walks all of K);
// at batch 1024 the conv layers (M = 784 * B) are bound by the fp32 FMA
// rate of the SIMT cores, since the operands stay in L2.
//
// Design:
//  * Joint operator, as on the TPU: one block loads each (BM x BK) tile of
//    the two x operands and each (BK x BN) tile of the two w operands into
//    shared memory once, and all products of the formulation consume them.
//  * The TPU carries the K sum in VMEM across sequential grid steps. Blocks
//    on Hopper run in no order, so the K loop lives inside the block; K is
//    small on this path, so no cross-block reduction is needed.
//  * Eq. 12 is a small difference of two large sums when srm ~= mu^2. The
//    TPU kernel keeps the two sums apart and subtracts once after the K loop
//    (pfp_dense.py:77); in fp32 that leaves an error of a few ulps of the
//    large sums, measured on the H100 at 5x that of cuBLAS's fp32 product.
//    Here both products of each term go into one accumulator by two fmaf
//    (srm_x*srm_w, then -mu_x^2*mu_w^2), so the accumulator stays at the
//    size of the variance and so does its rounding error. IEEE fp32 only:
//    no TF32, no tensor cores.
//  * N is small and varies per layer (6..120), so the tile width BN is
//    chosen from N to waste few threads, and the rows per thread (TM) drop
//    from 4 to 1 when the grid would otherwise leave the SMs idle.
//  * Ragged edges are masked here (zero-filled tiles contribute exact zeros
//    to every accumulator), so the wrapper neither pads nor slices.
//  * Batched experts: the expert axis is blockIdx.z and each block offsets
//    its operands by its expert's strides (in 64 bits: the recurrent lift
//    puts thousands of problems on that axis). The TPU kernel's block_e
//    groups experts per grid step to amortise step overhead; here blocks
//    of all experts run at once, so there is nothing to group. The offsets
//    are a template flag (BATCHED), taken only when E > 1: held in
//    registers they cost the TM = 4 tile a block per SM, so the single
//    dense compiles without them. The flag moves only the operands' base,
//    never the order of a sum, so an expert's slice comes out bit for bit
//    as the single dense gives it, and a row's result depends neither on
//    M nor on the other rows (TM and the grid change which thread holds an
//    output, never the order of its sum).
//  * At the MoE shapes (deepseek-moe-16b: E 64, K 2048 / 1408, N 1408 /
//    2048) the work is the fp32 FMA rate at prefill (M = capacity 240) and
//    the weight stream at decode (M = 6: every expert's mu and srm, 1.48 GB
//    a product, read once per M tile).
#include "pfp_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;
constexpr long long kFillBlocks = 2 * 132;  // two blocks per H100 SM

enum Mode { kSrm = 0, kFirstLayer = 1, kVar = 2 };

// xa, xb: mu_x and srm_x (kSrm), x and unused (kFirstLayer), mu_x and var_x
// (kVar); wa, wb: mu_w and srm_w (kSrm), mu_w and var_w (kFirstLayer, kVar).
template <int MODE, int BN, int TN, int TM, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
pfp_dense_kernel(const float* __restrict__ xa, const float* __restrict__ xb,
                 const float* __restrict__ wa, const float* __restrict__ wb,
                 float* __restrict__ mu_out, float* __restrict__ var_out,
                 int M, int N, int K, long long x_stride, long long w_stride) {
  constexpr int TX = BN / TN;
  constexpr int TY = kThreads / TX;
  constexpr int BM = TY * TM;
  constexpr bool kTwoX = MODE != kFirstLayer;
  // x tiles are stored k-major; the +1 keeps the transposing stores from
  // landing in one bank.
  __shared__ float s_xa[kBK][BM + 1];
  __shared__ float s_xb[kTwoX ? kBK : 1][kTwoX ? BM + 1 : 1];
  __shared__ float s_wa[kBK][BN];
  __shared__ float s_wb[kBK][BN];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const int n0 = blockIdx.y * BN;
  if constexpr (BATCHED) {
    const long long expert = blockIdx.z;
    xa += expert * x_stride;
    xb += expert * x_stride;
    wa += expert * w_stride;
    wb += expert * w_stride;
    mu_out += expert * M * N;
    var_out += expert * M * N;
  }

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
      const bool ok = m < M && k < K;
      const long long off = m * K + k;
      s_xa[c][r] = ok ? xa[off] : 0.0f;
      if constexpr (kTwoX) s_xb[c][r] = ok ? xb[off] : 0.0f;
    }
    for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
      const int r = e / BN, c = e % BN;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < K && n < N;
      const long long off = static_cast<long long>(k) * N + n;
      s_wa[r][c] = ok ? wa[off] : 0.0f;
      s_wb[r][c] = ok ? wb[off] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[TM], a2[TM], b[TM], w[TN], w2[TN], v[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = s_xa[kk][ty + i * TY];
        a2[i] = a[i] * a[i];
        if constexpr (kTwoX) {
          b[i] = s_xb[kk][ty + i * TY];
        } else {
          b[i] = 0.0f;
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        w[j] = s_wa[kk][tx + j * TX];
        w2[j] = w[j] * w[j];
        v[j] = s_wb[kk][tx + j * TX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          acc_mu[i][j] = fmaf(a[i], w[j], acc_mu[i][j]);
          if constexpr (MODE == kSrm) {
            acc_v[i][j] = fmaf(b[i], v[j], acc_v[i][j]);     // + srm_x srm_w
            acc_v[i][j] = fmaf(-a2[i], w2[j], acc_v[i][j]);  // - mu_x^2 mu_w^2
          } else if constexpr (MODE == kFirstLayer) {
            acc_v[i][j] = fmaf(a2[i], v[j], acc_v[i][j]);    // x^2 . var_w
          } else {
            acc_v[i][j] = fmaf(b[i], w2[j], acc_v[i][j]);    // var_x . mu_w^2
            acc_v[i][j] = fmaf(a2[i], v[j], acc_v[i][j]);    // mu_x^2 . var_w
            acc_v[i][j] = fmaf(b[i], v[j], acc_v[i][j]);     // var_x . var_w
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + i * TY;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (n >= N) continue;
      const long long off = m * N + n;
      mu_out[off] = acc_mu[i][j];
      var_out[off] = acc_v[i][j];
    }
  }
}

// The problem: E independent (M,K) x (K,N) denses, expert e's operands at
// e * x_stride / e * w_stride floats, its outputs at e * M * N.
struct Problem {
  const float *xa, *xb, *wa, *wb;
  float *mu, *var;
  int E, M, N, K;
  long long x_stride, w_stride;
};

template <int MODE, int BN, int TN, int TM>
void launch(const Problem& p, cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / TN)) * TM;
  const dim3 grid(static_cast<unsigned>((p.M + BM - 1) / BM),
                  static_cast<unsigned>((p.N + BN - 1) / BN),
                  static_cast<unsigned>(p.E));
  if (p.E > 1)
    pfp_dense_kernel<MODE, BN, TN, TM, true><<<grid, kThreads, 0, stream>>>(
        p.xa, p.xb, p.wa, p.wb, p.mu, p.var, p.M, p.N, p.K, p.x_stride,
        p.w_stride);
  else
    pfp_dense_kernel<MODE, BN, TN, TM, false><<<grid, kThreads, 0, stream>>>(
        p.xa, p.xb, p.wa, p.wb, p.mu, p.var, p.M, p.N, p.K, 0, 0);
}

template <int MODE, int BN, int TN>
void launch_rows(const Problem& p, cudaStream_t stream) {
  constexpr int BM4 = (kThreads / (BN / TN)) * 4;
  const long long blocks4 = static_cast<long long>((p.M + BM4 - 1) / BM4) *
                            ((p.N + BN - 1) / BN) * p.E;
  if (blocks4 >= kFillBlocks)
    launch<MODE, BN, TN, 4>(p, stream);
  else
    launch<MODE, BN, TN, 1>(p, stream);
}

template <int MODE>
void launch_mode(const Problem& p, cudaStream_t stream) {
  if (p.N <= 8)
    launch_rows<MODE, 8, 1>(p, stream);
  else if (p.N <= 16)
    launch_rows<MODE, 16, 1>(p, stream);
  else if (p.N <= 32)
    launch_rows<MODE, 32, 2>(p, stream);
  else
    launch_rows<MODE, 64, 4>(p, stream);
}

int launch_problem(int mode, const Problem& p, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSrm:
      launch_mode<kSrm>(p, s);
      break;
    case kFirstLayer:
      launch_mode<kFirstLayer>(p, s);
      break;
    case kVar:
      launch_mode<kVar>(p, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return pfp::launch_status();
}

}  // namespace

// The batched form, rows 12-13 of the TPU kernels: e independent problems,
// expert i's x operands at i * x_stride floats and its w operands at
// i * w_stride (fp32, each slice row-major and contiguous); the outputs are
// contiguous (e, m, n). Modes as below. Requires 1 <= e <= 65535 (the grid's
// z extent), m, n >= 1 and k >= 0.
PFP_EXPORT int pfp_dense_batched_launch(int mode, const void* xa,
                                        const void* xb, const void* wa,
                                        const void* wb, void* mu, void* var,
                                        int e, int m, int n, int k,
                                        long long x_stride,
                                        long long w_stride, void* stream) {
  if (e < 1 || e > 65535 || m < 1 || n < 1 || k < 0 || x_stride < 0 ||
      w_stride < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{static_cast<const float*>(xa), static_cast<const float*>(xb),
                  static_cast<const float*>(wa), static_cast<const float*>(wb),
                  static_cast<float*>(mu), static_cast<float*>(var),
                  e, m, n, k, x_stride, w_stride};
  return launch_problem(mode, p, stream);
}

// mode: 0 = Eq. 12 (mu_x, srm_x, mu_w, srm_w), 1 = Eq. 13 (x, unused, mu_w,
// var_w), 2 = Eq. 7 (mu_x, var_x, mu_w, var_w). All fp32, row-major,
// contiguous, on the device of `stream`. Requires M, N >= 1 and K >= 0.
PFP_EXPORT int pfp_dense_launch(int mode, const void* xa, const void* xb,
                                const void* wa, const void* wb, void* mu,
                                void* var, int m, int n, int k,
                                void* stream) {
  return pfp_dense_batched_launch(mode, xa, xb, wa, wb, mu, var, 1, m, n, k,
                                  0, 0, stream);
}

PFP_EXPORT const char* pfp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
