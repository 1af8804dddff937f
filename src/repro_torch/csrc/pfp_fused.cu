// The fused PFP unit for Hopper: a delta-method norm (RMSNorm or
// LayerNorm, VAR or SRM input), VAR -> SRM, the Eq. 12 joint dense and a
// moment-matched activation: (M,K) norm input x (K,N) weight -> mean (M,N),
// srm (M,N).
//
// Replaces repro/kernels/pfp_fused.py: pfp_norm_dense_act_pallas
// (_norm_dense_act_kernel).
//
// It computes what the unfused kernel chain computes (pfp_norms.cu, torch's
// to_srm, pfp_dense.cu mode 0, pfp_activations.cu), bit for bit, at every
// tile, wherever the chain's dense does not split K (kernels/pfp_dense.py
// split_k is 1: N > 128 with K <= 4096, every N < 64, every K <= 64), in
// two launches where the chain takes five:
//  * The norm pass (pfp_norm_srm_kernel): the norm kernel's own row pass
//    (pfp_norm.cuh norm_row: one block a row on the norm kernel's plan,
//    the row in registers), then h_srm = h_var + h_mu^2 rounded as torch's two-op
//    to_srm rounds it (the intrinsics keep nvcc from contracting the
//    product and sum into one fma); (h_mu, h_srm) to a workspace, read
//    once and written once.
//  * The dense and the activation: the dense kernel's own ring
//    (pfp_dense_ring.cuh dense_ring) on one of its instantiated plans
//    (PFP_FUSED_TILES, a subset of pfp_dense.cu's PFP_DENSE_TILES) with
//    split 1, so its fmaf sequence, k order and sums are the dense
//    kernel's; then ActEpilogue: once the ring is drained, the block
//    stages its (mean, var) sums in the ring's memory and walks them with
//    neighbouring threads on neighbouring columns, calling
//    pfp::activation_moments on each, the code the activation kernel runs
//    on the dense's output. The dense's outputs never reach device
//    memory.
// Why the norm is a pass and not a stage of the ring (tools/
// ab_kernel_times.py on an H100 80GB HBM3 at 700 W; PERF.md): a first
// build normalised each landed x tile as the wide tile copies it k-major
// and as a decode tile reads it, after a pass that formed the row
// statistics. That put a chain of dependent loads and products before
// every tile's products: granite's gate (2048, 4096, 14336) took 19.77 ms
// against the chain's 17.56 (the dense alone 17.16), a 4-slot decode step
// (4, 4096, 14336) 0.339 ms against 0.190. Forming each block's row
// statistics inside it would instead read its rows again for each of the
// N / block_n blocks of a block row (7.5 GB of L2 reads at the gate and
// 128-row tiles), with the SM otherwise idle. The pass reads and writes
// 4 M K floats once (134 MB at the gate).
// IEEE fp32 on the SIMT cores throughout: no TF32, no tensor cores (Eq. 12
// is a small difference of two large sums).
//
// What bounds it on the H100: at prefill (granite's gate projection, M
// 2048, K 4096, N 14336) the fp32 FMA rate of the dense: three products of
// M N K terms, 7.2e11 operations; at a decode step (M 4) the weight
// stream, the (K, N) mean and SRM, 470 MB. What fusing saves is the
// dense's outputs' round trip through device memory, the torch to_srm ops
// and three launches.
#include "pfp_dense_ring.cuh"
#include "pfp_norm.cuh"

namespace {

using namespace pfp::ring;
using pfp::kLayer;
using pfp::kRepSrm;
using pfp::kRepVar;
using pfp::kRms;

// The dense plans (BN, TN, TM, stages) the fused unit is instantiated on:
// the wide tiles and the interleaved ring tiles of the large regime, and
// the TM 1 tiles of the decode regime (kernels/pfp_dense.py _LARGE,
// _DECODE). kernels/pfp_fused.py's PLANS is this list;
// tests/test_torch_fused.py holds the two equal and every entry one of
// PFP_DENSE_TILES.
#define PFP_FUSED_TILES(X) \
  X(128, 8, 8, 2)          \
  X(128, 8, 4, 2)          \
  X(64, 4, 4, 4)           \
  X(64, 4, 1, 4)           \
  X(128, 4, 1, 4)          \
  X(64, 1, 1, 4)

// The norm pass's outputs of one group: (h_mu, h_srm), h_srm rounded as
// torch's to_srm rounds h_var + h_mu^2 (two ops: the intrinsics keep nvcc
// from contracting them into one fma).
struct SrmStore {
  float* h_mu;
  float* h_srm;
  int d;
  bool vec;

  __device__ __forceinline__ void operator()(int j, const float4& mean,
                                             const float4& var) const {
    float4 srm;
#pragma unroll
    for (int l = 0; l < 4; ++l)
      pfp::lane(srm, l) = __fadd_rn(pfp::lane(var, l),
                                    __fmul_rn(pfp::lane(mean, l),
                                              pfp::lane(mean, l)));
    pfp::store_group(h_mu, h_srm, j, d, vec, mean, srm);
  }
};

// The norm pass: row m of (mu, sec) normalised, (h_mu, h_srm) to row m of
// h_mu and h_srm, by one block a row on the norm kernel's plan, as the
// norm kernel forms (h_mu, h_var) (pfp_norm.cuh norm_row) and torch's
// to_srm the SRM.
template <int NORM, int REP, int G>
__global__ void __launch_bounds__(pfp::norm_max_threads(G))
pfp_norm_srm_kernel(const float* __restrict__ mu,
                    const float* __restrict__ sec,
                    const float* __restrict__ gain,
                    const float* __restrict__ bias,
                    float* __restrict__ h_mu, float* __restrict__ h_srm,
                    int K, float eps, int vec) {
  __shared__ float part[2 * pfp::kNormMaxWarps];
  const long long base = static_cast<long long>(blockIdx.x) * K;
  pfp::norm_row<NORM, REP, G>(mu + base, sec + base, gain, bias, K, eps,
                              vec != 0, part,
                              SrmStore{h_mu + base, h_srm + base, K,
                                       vec != 0});
}

// The activation on the block's (mean, var) sums: (mean, srm) out.
struct ActEpilogue {
  static constexpr bool kAccumulates = false;  // a split runs as a cluster
  int act;
  float* mu;
  float* srm;

  template <class R, int TM, int TN>
  __device__ __forceinline__ void store(float* smem,
                                        const float (&acc_mu)[TM][TN],
                                        const float (&acc_v)[TM][TN], int M,
                                        int N, long long m0, int n0) const {
    constexpr int BM = R::BM, BN = R::TX * TN;
    static_assert(2 * BM * BN <= R::kFloats, "the staged sums fit the ring");
    float* s_mu = smem;
    float* s_var = smem + BM * BN;
    const int tx = threadIdx.x % R::TX, ty = threadIdx.x / R::TX;
    pfp::cp_async_wait<0>();
    __syncthreads();  // every thread is done with the ring
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int off = R::row(ty, i) * BN + R::col(tx, j);
        s_mu[off] = acc_mu[i][j];
        s_var[off] = acc_v[i][j];
      }
    }
    __syncthreads();
    switch (act) {
      case pfp::kRelu:
        return apply<pfp::kRelu, BM, BN>(s_mu, s_var, M, N, m0, n0);
      case pfp::kGelu:
        return apply<pfp::kGelu, BM, BN>(s_mu, s_var, M, N, m0, n0);
      case pfp::kSilu:
        return apply<pfp::kSilu, BM, BN>(s_mu, s_var, M, N, m0, n0);
      case pfp::kTanh:
        return apply<pfp::kTanh, BM, BN>(s_mu, s_var, M, N, m0, n0);
      default:
        return apply<pfp::kSigmoid, BM, BN>(s_mu, s_var, M, N, m0, n0);
    }
  }

  // The staged BM x BN sums through activation kind KIND, 4 outputs a
  // thread in flight: the moment functions are chains of dependent
  // special-function calls, and one wide block is all its SM holds.
  template <int KIND, int BM, int BN>
  __device__ __forceinline__ void apply(const float* s_mu,
                                        const float* s_var, int M, int N,
                                        long long m0, int n0) const {
#pragma unroll 4
    for (int e = threadIdx.x; e < BM * BN; e += kThreads) {
      const long long m = m0 + e / BN;
      const int n = n0 + e % BN;
      if (m < M && n < N)
        pfp::activation_moments<KIND>(s_mu[e], s_var[e], &mu[m * N + n],
                                      &srm[m * N + n]);
    }
  }
};

// The dense ring (Eq. 12) on the norm pass's (h_mu, h_srm), the
// activation on its sums.
template <int BN, int TN, int TM, int STAGES>
__global__ void __launch_bounds__(kThreads)
pfp_norm_dense_act_kernel(int act, const float* __restrict__ h_mu,
                          const float* __restrict__ h_srm,
                          const float* __restrict__ mu_w,
                          const float* __restrict__ srm_w,
                          float* __restrict__ mu_out,
                          float* __restrict__ srm_out, int M, int N, int K,
                          int split, int chunk, int vec_x, int vec_w) {
  extern __shared__ __align__(16) float smem[];
  dense_ring<kSrm, BN, TN, TM, STAGES, false>(
      smem, h_mu, h_srm, mu_w, srm_w, nullptr, M, N, K, 0, 0, split, chunk,
      0, vec_x, vec_w, ActEpilogue{act, mu_out, srm_out});
}

struct Problem {
  int act;
  int norm_threads, norm_groups;  // the norm kernel's plan at K
  const float *mu, *sec, *gain, *bias;
  float* h;  // (2, M, K): h_mu, then h_srm
  const float *mu_w, *srm_w;
  float *mu_out, *srm_out;
  int M, N, K, split;  // split: the chain's dense's (split_k)
  float eps;
};

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <int NORM, int REP, int BN, int TN, int TM, int STAGES>
int launch(const Problem& p, cudaStream_t stream) {
  using R = Ring<kSrm, BN, TN, TM, STAGES>;
  constexpr int kBytes = R::kFloats * 4;
  const long long m_tiles = (p.M + R::BM - 1) / R::BM;
  if (m_tiles * p.split > 0x7fffffffLL || (p.N + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pfp_norm_dense_act_kernel<BN, TN, TM, STAGES>;
  static bool raised[pfp::kMaxDevices] = {};
  cudaError_t err = pfp::allow_smem(kernel, kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* h_mu = p.h;
  float* h_srm = p.h + static_cast<long long>(p.M) * p.K;
  const int vec_norm = p.K % 4 == 0 && aligned16(p.mu) && aligned16(p.sec) &&
                       aligned16(p.gain) && aligned16(p.bias) &&
                       aligned16(p.h);
  err = cudaErrorInvalidValue;  // a plan PFP_NORM_GROUPS does not list
#define PFP_NORM_CASE(G, T)                                                \
  if (p.norm_groups == G) {                                                \
    pfp_norm_srm_kernel<NORM, REP, G><<<p.M, p.norm_threads, 0, stream>>>( \
        p.mu, p.sec, p.gain, p.bias, h_mu, h_srm, p.K, p.eps, vec_norm);   \
    err = cudaGetLastError();                                              \
  }
  PFP_NORM_GROUPS(PFP_NORM_CASE)
#undef PFP_NORM_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  // The dense kernel's ranges: K / split in whole kBK.
  const int chunk = ((p.K + p.split - 1) / p.split + kBK - 1) / kBK * kBK;
  const int vec_x = p.K % 4 == 0 && aligned16(p.h);
  const int vec_w = p.N % 4 == 0 && aligned16(p.mu_w) && aligned16(p.srm_w);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m_tiles * p.split),
                     static_cast<unsigned>((p.N + BN - 1) / BN));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p.act, h_mu, h_srm, p.mu_w, p.srm_w,
                           p.mu_out, p.srm_out, p.M, p.N, p.K, p.split,
                           chunk, vec_x, vec_w);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch never ran
    return static_cast<int>(err);
  }
  return pfp::launch_status();
}

template <int NORM, int REP>
int launch_plan(int bn, int tn, int tm, int stages, const Problem& p,
                cudaStream_t s) {
#define PFP_FUSED_CASE(BN, TN, TM, ST)                          \
  if (bn == BN && tn == TN && tm == TM && stages == ST)         \
    return launch<NORM, REP, BN, TN, TM, ST>(p, s);
  PFP_FUSED_TILES(PFP_FUSED_CASE)
#undef PFP_FUSED_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // not instantiated
}

template <int NORM>
int launch_rep(int rep, int bn, int tn, int tm, int stages, const Problem& p,
               cudaStream_t s) {
  if (rep == kRepVar)
    return launch_plan<NORM, kRepVar>(bn, tn, tm, stages, p, s);
  if (rep == kRepSrm)
    return launch_plan<NORM, kRepSrm>(bn, tn, tm, stages, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// norm: 0 rms, 1 layer (bias read only then); rep: 0 the input's second
// moment is a variance, 1 a second raw moment; act: an activation kind of
// pfp_moments.cuh; (bn, tn, tm, stages): one of PFP_FUSED_TILES;
// (norm_threads, norm_groups): the norm kernel's plan at k
// (kernels/pfp_norms.py norm_plan), one of PFP_NORM_GROUPS; split: the
// unfused dense's split of K (kernels/pfp_dense.py split_k), 1..8, run as
// a cluster so the sums are the dense kernel's. mu, sec
// (m, k); gain, bias (k,); h (2, m, k), a workspace the norm pass writes;
// mu_w, srm_w (k, n); the outputs (m, n) mean and srm. All fp32,
// row-major, contiguous, on the device of `stream`. Requires m, n, k >= 1.
// Launches the norm pass, then the ring.
PFP_EXPORT int pfp_norm_dense_act_launch(
    int norm, int rep, int act, int bn, int tn, int tm, int stages,
    int norm_threads, int norm_groups, const void* mu, const void* sec,
    const void* gain, const void* bias, void* h, const void* mu_w,
    const void* srm_w, void* mu_out, void* srm_out, int m, int n, int k,
    int split, float eps, void* stream) {
  if (m < 1 || n < 1 || k < 1 || act < pfp::kRelu || act > pfp::kSigmoid ||
      split < 1 || split > kMaxSplit ||
      !pfp::norm_plan_ok(norm_threads, norm_groups, k))
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{act,
                  norm_threads,
                  norm_groups,
                  static_cast<const float*>(mu),
                  static_cast<const float*>(sec),
                  static_cast<const float*>(gain),
                  static_cast<const float*>(bias),
                  static_cast<float*>(h),
                  static_cast<const float*>(mu_w),
                  static_cast<const float*>(srm_w),
                  static_cast<float*>(mu_out),
                  static_cast<float*>(srm_out),
                  m, n, k, split, eps};
  auto s = static_cast<cudaStream_t>(stream);
  if (norm == kRms) return launch_rep<kRms>(rep, bn, tn, tm, stages, p, s);
  if (norm == kLayer)
    return launch_rep<kLayer>(rep, bn, tn, tm, stages, p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
