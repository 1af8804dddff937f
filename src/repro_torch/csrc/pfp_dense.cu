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
// What bounds it on the H100, by regime:
//  * Large (N > 128 and M > 16: LM prefill and forward, MoE prefill): the
//    fp32 FMA rate of the SIMT cores, once the operand reads from shared
//    memory keep up with the FFMAs.
//  * Narrow (N <= 128: the paper's MLP and LeNet-5): latency. At batch
//    <= 100 a whole layer is a few blocks, and one block walking K = 784
//    in synchronous tiles took 0.09 ms for 0.01 ms of bytes.
//  * Decode (M <= 16, N > 128): the weight stream, every weight's mean
//    and SRM read once.
//
// Design:
//  * Joint operator, as on the TPU: a block stages each (BM x BK) tile of
//    the two x operands and each (BK x BN) tile of the two w operands in
//    shared memory once, and all products of the formulation consume them.
//  * The TPU carries the K sum in VMEM across sequential grid steps. Blocks
//    on Hopper run in no order, so the K loop lives inside the block, or
//    inside the CTAs of one cluster (split-K below). Ragged edges are
//    masked here (zero-filled tiles add exact zeros to every accumulator),
//    so the wrapper neither pads nor slices.
//  * The plan (split, BN, TN, TM, stages) is chosen in Python
//    (kernels/pfp_dense.py dense_plan) and checked here against the list
//    of instantiated tiles; a plan not in PFP_DENSE_TILES is refused.
//  * Eq. 12 is a small difference of two large sums when srm ~= mu^2. The
//    TPU kernel keeps the two sums apart and subtracts once after the K loop
//    (pfp_dense.py:77); in fp32 that leaves an error of a few ulps of the
//    large sums, measured on the H100 at 5x that of cuBLAS's fp32 product.
//    Here both products of each term go into one accumulator by two fmaf
//    (srm_x*srm_w, then -mu_x^2*mu_w^2), so the accumulator stays at the
//    size of the variance and so does its rounding error. IEEE fp32 only:
//    no TF32, no tensor cores.
//  * One order of summation: every output sums its K terms in order, one
//    fmaf chain (one per cluster rank, added in rank order, when K is
//    split), zero-filled past the range's end, whatever the tile, TM, the
//    stage count or the grid. The split depends on (K, N, mode) only, so a
//    row's result does too: not on M, E or the other rows.
//  * One loop for every regime: a ring of `stages` tiles filled by cp.async
//    (16-byte copies where the row stride and the base allow it, 4-byte
//    ones otherwise; zero-filled past the edges), so a block keeps
//    stages - 1 tiles in flight while it computes one. x is staged
//    m-major, since cp.async cannot transpose.
//  * Large regime (wide tiles, TN 8): 128 columns by 128 or 64 rows, each
//    thread 8 or 4 rows by 8 columns in groups of 4 neighbours, so every
//    operand read from shared memory is a float4. Once a tile lands the
//    block copies its x k-major and stages mu_x^2 and mu_w^2 (__fmul_rn:
//    the plain products' rounding), so each k of the 8 x 8 tile is 12
//    LDS.128 and 192 FFMAs (Eq. 12), no FMUL; the synchronous 4 x 4 tile
//    it replaces spent 16 scalar loads and 8 FMULs on 48. 128 accumulators
//    hold a thread at up to 255 registers, one block an SM, so barriers
//    stall the whole SM: tiles of 32 k on a ring of 2 halve them against
//    16 k. Bits do not move with the tile, so the tile is chosen from the
//    block count (kernels/pfp_dense.py); where 128 x 128 leaves the card
//    idle (a prefill chunk of 128 rows) the interleaved ring tiles take
//    over.
//  * Narrow and decode regimes (TN <= 4): columns interleaved across the
//    threads. At decode the tile has TM = 1 and as few thread rows as
//    cover M, since each staged weight is read from shared memory once per
//    thread row.
//  * Cluster split-K (narrow regime only, split = 2..8, a function of K
//    and N): the `split` CTAs of a thread-block cluster each sum one
//    contiguous, 16-aligned K range of the same output tile with the
//    single accumulator above; ranks 1.. leave their partial (mu, var)
//    tiles in shared memory and rank 0 adds them in rank order over
//    distributed shared memory. One launch, no workspace, no atomics,
//    deterministic. Every CTA waits at the last cluster barrier, so no
//    shared memory is freed while rank 0 reads it.
//  * Batched experts: the expert axis is blockIdx.z and each block offsets
//    its operands by its expert's strides (in 64 bits: the recurrent lift
//    puts thousands of problems on that axis). Blocks of all experts run
//    at once, so the TPU kernel's block_e grouping has no use here. The
//    offsets are a template flag (BATCHED), taken only when E > 1 or a row
//    count is given, so the single dense compiles without them. The flag
//    moves only the operands' base, never the order of a sum, so an
//    expert's slice comes out bit for bit as the single dense gives it.
//    With `rows` (kept rows per expert, a prefix of the capacity), a block
//    whose first row is past its expert's count writes zeros and reads no
//    weights: those rows are zero in the input, and zero rows give +0.
#include <cooperative_groups.h>

#include "pfp_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 16;      // K of a staged tile: interleaved tiles
constexpr int kWideBK = 32;  // and wide tiles
constexpr int kMaxSplit = 8;  // the portable cluster size

// The instantiated plans (BN, TN, TM, stages). kernels/pfp_dense.py's
// TILES is this list; tests/test_torch_dense_plan.py holds the two equal.
#define PFP_DENSE_TILES(X) \
  X(128, 8, 8, 2)          \
  X(128, 8, 4, 2)          \
  X(8, 1, 1, 4)            \
  X(8, 1, 4, 4)            \
  X(16, 1, 1, 4)           \
  X(16, 1, 4, 4)           \
  X(32, 2, 1, 4)           \
  X(32, 2, 4, 4)           \
  X(64, 4, 1, 4)           \
  X(64, 4, 4, 4)           \
  X(128, 4, 1, 4)          \
  X(128, 4, 4, 4)          \
  X(64, 1, 1, 4)

enum Mode { kSrm = 0, kFirstLayer = 1, kVar = 2 };

// One k term of the formulation for a thread's TM x TN outputs: a[i], b[i]
// are its rows' x operands and a2[i] = a[i] * a[i]; w[j], v[j] its
// columns' w operands and w2[j] = w[j] * w[j]. Every tile runs exactly
// this sequence of fmaf.
template <int MODE, int TM, int TN>
__device__ __forceinline__ void fma_step(const float (&a)[TM],
                                         const float (&a2)[TM],
                                         const float (&b)[TM],
                                         const float (&w)[TN],
                                         const float (&w2)[TN],
                                         const float (&v)[TN],
                                         float (&acc_mu)[TM][TN],
                                         float (&acc_v)[TM][TN]) {
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

// A tile's shape and its layout in dynamic shared memory, in floats: per
// stage the x operands (BM rows of kXPitch, m-major: 16-byte aligned, and
// thread rows land on different banks) then the two w tiles (BK x BN).
// After the K loop the same memory holds a split rank's partial sums.
// Thread (tx, ty) owns rows row(ty, i) and columns col(tx, j): interleaved
// (i * TY + ty, j * TX + tx), or in a wide tile groups of 4 neighbours
// ((j / 4) * 4 * TX + 4 * tx + j % 4, rows alike), each read as one
// float4. After the ring a wide tile keeps its current tile's x k-major
// (BK rows of kXTRow per operand), mu_x^2 k-major and mu_w^2.
template <int MODE, int BN, int TN, int TM, int STAGES>
struct Ring {
  static constexpr int TX = BN / TN;
  static constexpr int TY = kThreads / TX;
  static constexpr int BM = TY * TM;
  static constexpr bool kWide = TN == 8;
  static constexpr int kGroup = kWide ? 4 : 1;
  static constexpr int BK = kWide ? kWideBK : kBK;
  static constexpr int kXPitch = BK + 4;
  static constexpr int kNX = MODE == kFirstLayer ? 1 : 2;
  static constexpr int kX = BM * kXPitch;
  static constexpr int kW = BK * BN;
  static constexpr int kStage = kNX * kX + 2 * kW;
  static constexpr int kXTRow = BM + 4;  // 16-byte rows, banks staggered
  static constexpr int kXT = BK * kXTRow;
  static constexpr int kTile = kWide ? (kNX + 1) * kXT + kW : 0;
  // Wide tiles never split K, so they keep no partials.
  static constexpr int kPartial = kWide ? 0 : 2 * TM * TN * kThreads;
  static constexpr int kFloats =
      STAGES * kStage > kPartial ? STAGES * kStage + kTile : kPartial;
  static constexpr int kBytes = kFloats * 4;
  static_assert(TM % kGroup == 0 && TN % kGroup == 0, "groups of four");

  __device__ __forceinline__ static int row(int ty, int i) {
    return (i / kGroup) * kGroup * TY + kGroup * ty + i % kGroup;
  }
  __device__ __forceinline__ static int col(int tx, int j) {
    return (j / kGroup) * kGroup * TX + kGroup * tx + j % kGroup;
  }
};

template <class R, int TM, int TN>
__device__ __forceinline__ void store_tile(float* mu_out, float* var_out,
                                           const float (&acc_mu)[TM][TN],
                                           const float (&acc_v)[TM][TN],
                                           int M, int N, long long m0,
                                           int n0) {
  const int tx = threadIdx.x % R::TX, ty = threadIdx.x / R::TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + R::row(ty, i);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + R::col(tx, j);
      if (n >= N) continue;
      const long long off = m * N + n;
      mu_out[off] = acc_mu[i][j];
      var_out[off] = acc_v[i][j];
    }
  }
}

// Offsets a block's operands to its expert (blockIdx.z). Returns false,
// after writing zeros to the block's outputs, when the block's first row
// is past the expert's row count.
template <class R, int TM, int TN>
__device__ __forceinline__ bool enter_expert(
    const float* __restrict__& xa, const float* __restrict__& xb,
    const float* __restrict__& wa, const float* __restrict__& wb,
    float* __restrict__& mu_out, float* __restrict__& var_out,
    const int* __restrict__ rows, int M, int N,
    long long m0, int n0, long long x_stride, long long w_stride) {
  const long long expert = blockIdx.z;
  xa += expert * x_stride;
  xb += expert * x_stride;
  wa += expert * w_stride;
  wb += expert * w_stride;
  mu_out += expert * M * N;
  var_out += expert * M * N;
  if (rows == nullptr || m0 < rows[expert]) return true;
  const float zero[TM][TN] = {};
  store_tile<R>(mu_out, var_out, zero, zero, M, N, m0, n0);
  return false;
}

// ---------------------------------------------------------------------------
// The cp.async ring, and cluster split-K
// ---------------------------------------------------------------------------
using pfp::cp_async16;
using pfp::cp_async4;
using pfp::cp_async_commit;
using pfp::cp_async_wait;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One landed tile through a wide tile's thread. First the block copies x
// (m-major in the ring) k-major into s_xt and stages the squares mu_x^2
// and mu_w^2 once, rounded as the plain products are; then each k takes
// one float4 per 4 rows or columns of each operand and no FMUL.
template <int MODE, class R, int TM, int TN>
__device__ __forceinline__ void wide_tile(const float* s_xa,
                                          const float* s_xb,
                                          const float* s_wa,
                                          const float* s_wb, float* s_xt,
                                          int tx, int ty,
                                          float (&acc_mu)[TM][TN],
                                          float (&acc_v)[TM][TN]) {
  constexpr int BM = R::BM, BN = R::TX * TN, XT = R::kXTRow;
  constexpr bool kTwoX = MODE != kFirstLayer;
  float* xt_a = s_xt;
  float* xt_b = s_xt + R::kXT;
  float* xt_a2 = s_xt + R::kNX * R::kXT;
  float* w2_t = xt_a2 + R::kXT;
  // Neighbouring threads take neighbouring rows: both the ring's reads and
  // these stores are free of bank conflicts.
#pragma unroll
  for (int e = threadIdx.x; e < BM * R::BK / 4; e += kThreads) {
    const int r = e % BM, c = e / BM * 4;
    const float4 a4 = ld4(s_xa + r * R::kXPitch + c);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float4 b4 =
        kTwoX ? ld4(s_xb + r * R::kXPitch + c) : make_float4(0, 0, 0, 0);
    const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      xt_a[(c + q) * XT + r] = a[q];
      xt_a2[(c + q) * XT + r] = __fmul_rn(a[q], a[q]);
      if constexpr (kTwoX) xt_b[(c + q) * XT + r] = b[q];
    }
  }
  if constexpr (kTwoX) {  // Eq. 13 takes no mu_w^2
#pragma unroll
    for (int e = threadIdx.x * 4; e < R::kW; e += kThreads * 4) {
      const float4 w4 = ld4(s_wa + e);
      *reinterpret_cast<float4*>(w2_t + e) =
          make_float4(__fmul_rn(w4.x, w4.x), __fmul_rn(w4.y, w4.y),
                      __fmul_rn(w4.z, w4.z), __fmul_rn(w4.w, w4.w));
    }
  }
  __syncthreads();
  // Unrolled 16 k at a time: fully unrolled, Eq. 7's body of 32 x 256
  // FFMAs ran at under half speed.
#pragma unroll 16
  for (int k = 0; k < R::BK; ++k) {
    float a[TM], a2[TM], b[TM], w[TN], w2[TN], v[TN];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const int off = k * XT + R::row(ty, i);
      const float4 a4 = ld4(xt_a + off);
      const float4 q4 = ld4(xt_a2 + off);
      const float4 b4 =
          kTwoX ? ld4(xt_b + off) : make_float4(0, 0, 0, 0);
      a[i] = a4.x, a[i + 1] = a4.y, a[i + 2] = a4.z, a[i + 3] = a4.w;
      a2[i] = q4.x, a2[i + 1] = q4.y, a2[i + 2] = q4.z, a2[i + 3] = q4.w;
      b[i] = b4.x, b[i + 1] = b4.y, b[i + 2] = b4.z, b[i + 3] = b4.w;
    }
#pragma unroll
    for (int j = 0; j < TN; j += 4) {
      const int off = k * BN + R::col(tx, j);
      const float4 w4 = ld4(s_wa + off);
      const float4 v4 = ld4(s_wb + off);
      const float4 q4 =
          kTwoX ? ld4(w2_t + off) : make_float4(0, 0, 0, 0);
      w[j] = w4.x, w[j + 1] = w4.y, w[j + 2] = w4.z, w[j + 3] = w4.w;
      v[j] = v4.x, v[j + 1] = v4.y, v[j + 2] = v4.z, v[j + 3] = v4.w;
      w2[j] = q4.x, w2[j + 1] = q4.y, w2[j + 2] = q4.z, w2[j + 3] = q4.w;
    }
    fma_step<MODE, TM, TN>(a, a2, b, w, w2, v, acc_mu, acc_v);
  }
}

// One landed tile through an interleaved tile's thread (narrow and
// decode regimes): 4 consecutive k of each of its rows, one float4 each.
template <int MODE, class R, int TM, int TN>
__device__ __forceinline__ void interleaved_tile(const float* s_xa,
                                                 const float* s_xb,
                                                 const float* s_wa,
                                                 const float* s_wb, int tx,
                                                 int ty,
                                                 float (&acc_mu)[TM][TN],
                                                 float (&acc_v)[TM][TN]) {
  constexpr int TX = R::TX, TY = R::TY, BN = R::TX * TN;
  constexpr bool kTwoX = MODE != kFirstLayer;
#pragma unroll
  for (int k4 = 0; k4 < kBK; k4 += 4) {
    float4 xa4[TM], xb4[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int off = (ty + i * TY) * R::kXPitch + k4;
      xa4[i] = *reinterpret_cast<const float4*>(s_xa + off);
      if constexpr (kTwoX) {
        xb4[i] = *reinterpret_cast<const float4*>(s_xb + off);
      } else {
        xb4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float a[TM], a2[TM], b[TM], w[TN], w2[TN], v[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        a[i] = q == 0 ? xa4[i].x : q == 1 ? xa4[i].y
             : q == 2 ? xa4[i].z : xa4[i].w;
        a2[i] = a[i] * a[i];
        b[i] = q == 0 ? xb4[i].x : q == 1 ? xb4[i].y
             : q == 2 ? xb4[i].z : xb4[i].w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        w[j] = s_wa[(k4 + q) * BN + tx + j * TX];
        w2[j] = w[j] * w[j];
        v[j] = s_wb[(k4 + q) * BN + tx + j * TX];
      }
      fma_step<MODE, TM, TN>(a, a2, b, w, w2, v, acc_mu, acc_v);
    }
  }
}

// xa, xb: mu_x and srm_x (kSrm), x and unused (kFirstLayer), mu_x and var_x
// (kVar); wa, wb: mu_w and srm_w (kSrm), mu_w and var_w (kFirstLayer, kVar).
// `split` CTAs (a cluster along x) share an output tile, rank r summing K
// range [r * chunk, (r + 1) * chunk); vec_x and vec_w allow 16-byte copies
// of the x and w rows.
template <int MODE, int BN, int TN, int TM, int STAGES, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
pfp_dense_ring_kernel(const float* __restrict__ xa,
                      const float* __restrict__ xb,
                      const float* __restrict__ wa,
                      const float* __restrict__ wb,
                      float* __restrict__ mu_out, float* __restrict__ var_out,
                      const int* __restrict__ rows, int M, int N, int K,
                      long long x_stride, long long w_stride, int split,
                      int chunk, int vec_x, int vec_w) {
  using R = Ring<MODE, BN, TN, TM, STAGES>;
  constexpr int TX = R::TX, BM = R::BM;
  constexpr bool kTwoX = MODE != kFirstLayer;
  extern __shared__ __align__(16) float smem[];

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const int rank =
      split > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long m0 = static_cast<long long>(blockIdx.x / split) * BM;
  const int n0 = blockIdx.y * BN;
  if constexpr (BATCHED) {
    // Every rank of a cluster has the same m0 and expert, so a cluster
    // leaves whole or not at all.
    if (!enter_expert<R, TM, TN>(xa, xb, wa, wb, mu_out, var_out, rows, M, N,
                                 m0, n0, x_stride, w_stride))
      return;
  }
  const int k_begin = min(K, rank * chunk);
  const int k_end = min(K, k_begin + chunk);
  constexpr int BK = R::BK, kXPitch = R::kXPitch;
  const int tiles = (k_end - k_begin + BK - 1) / BK;

  auto load = [&](int stage, int k0) {
    float* s_xa = smem + stage * R::kStage;
    float* s_xb = s_xa + R::kX;
    float* s_wa = s_xa + R::kNX * R::kX;
    float* s_wb = s_wa + R::kW;
    if (vec_x) {  // K % 4 == 0 and k_end too: a chunk is in or out whole
#pragma unroll
      for (int e = threadIdx.x; e < BM * BK / 4; e += kThreads) {
        const int r = e / (BK / 4), c = e % (BK / 4) * 4;
        const long long m = m0 + r;
        const bool ok = m < M && k0 + c < k_end;
        const long long off = ok ? m * K + k0 + c : 0;
        cp_async16(s_xa + r * kXPitch + c, xa + off, ok);
        if constexpr (kTwoX) cp_async16(s_xb + r * kXPitch + c, xb + off, ok);
      }
    } else {
#pragma unroll
      for (int e = threadIdx.x; e < BM * BK; e += kThreads) {
        const int r = e / BK, c = e % BK;
        const long long m = m0 + r;
        const bool ok = m < M && k0 + c < k_end;
        const long long off = ok ? m * K + k0 + c : 0;
        cp_async4(s_xa + r * kXPitch + c, xa + off, ok);
        if constexpr (kTwoX) cp_async4(s_xb + r * kXPitch + c, xb + off, ok);
      }
    }
    if (vec_w) {  // N % 4 == 0
#pragma unroll
      for (int e = threadIdx.x; e < BK * BN / 4; e += kThreads) {
        const int r = e / (BN / 4), c = e % (BN / 4) * 4;
        const bool ok = k0 + r < k_end && n0 + c < N;
        const long long off =
            ok ? static_cast<long long>(k0 + r) * N + n0 + c : 0;
        cp_async16(s_wa + r * BN + c, wa + off, ok);
        cp_async16(s_wb + r * BN + c, wb + off, ok);
      }
    } else {
#pragma unroll
      for (int e = threadIdx.x; e < BK * BN; e += kThreads) {
        const int r = e / BN, c = e % BN;
        const bool ok = k0 + r < k_end && n0 + c < N;
        const long long off =
            ok ? static_cast<long long>(k0 + r) * N + n0 + c : 0;
        cp_async4(s_wa + r * BN + c, wa + off, ok);
        cp_async4(s_wb + r * BN + c, wb + off, ok);
      }
    }
  };

  float acc_mu[TM][TN], acc_v[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      acc_mu[i][j] = 0.0f;
      acc_v[i][j] = 0.0f;
    }
  }

#pragma unroll 1
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < tiles) load(s, k_begin + s * BK);
    cp_async_commit();
  }
  for (int t = 0; t < tiles; ++t) {
    // Tile t has landed, this thread's part and (after the barrier) every
    // thread's; every thread is done with stage t - 1, which is refilled.
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = t + STAGES - 1;
    if (next < tiles) load(next % STAGES, k_begin + next * BK);
    cp_async_commit();

    const float* s_xa = smem + (t % STAGES) * R::kStage;
    const float* s_xb = s_xa + R::kX;
    const float* s_wa = s_xa + R::kNX * R::kX;
    const float* s_wb = s_wa + R::kW;
    if constexpr (R::kWide) {
      wide_tile<MODE, R>(s_xa, s_xb, s_wa, s_wb, smem + STAGES * R::kStage,
                         tx, ty, acc_mu, acc_v);
    } else {
      interleaved_tile<MODE, R>(s_xa, s_xb, s_wa, s_wb, tx, ty, acc_mu,
                                acc_v);
    }
  }

  if constexpr (!R::kWide) {
    if (split > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cp_async_wait<0>();
      __syncthreads();  // the ring is drained: it now holds the partials
      float* part = smem;
      constexpr int kOuts = TM * TN;
      if (rank != 0) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            part[(i * TN + j) * kThreads + threadIdx.x] = acc_mu[i][j];
            part[(kOuts + i * TN + j) * kThreads + threadIdx.x] = acc_v[i][j];
          }
        }
      }
      cluster.sync();
      if (rank == 0) {
        for (int r = 1; r < split; ++r) {  // rank order: deterministic
          const float* theirs = cluster.map_shared_rank(part, r);
#pragma unroll
          for (int i = 0; i < TM; ++i) {
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              acc_mu[i][j] += theirs[(i * TN + j) * kThreads + threadIdx.x];
              acc_v[i][j] +=
                  theirs[(kOuts + i * TN + j) * kThreads + threadIdx.x];
            }
          }
        }
      }
      cluster.sync();  // no rank leaves while rank 0 reads its shared memory
      if (rank != 0) return;
    }
  }
  store_tile<R>(mu_out, var_out, acc_mu, acc_v, M, N, m0, n0);
}

// The problem: E independent (M,K) x (K,N) denses, expert e's operands at
// e * x_stride / e * w_stride floats, its outputs at e * M * N; rows: null,
// or E kept-row counts (only read when batched).
struct Problem {
  const float *xa, *xb, *wa, *wb;
  float *mu, *var;
  const int* rows;
  int E, M, N, K;
  long long x_stride, w_stride;
};

bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <int MODE, int BN, int TN, int TM, int STAGES, bool BATCHED>
int launch_tile(const Problem& p, int split, cudaStream_t stream) {
  using R = Ring<MODE, BN, TN, TM, STAGES>;
  const long long m_tiles = (p.M + R::BM - 1) / R::BM;
  if (m_tiles * split > 0x7fffffffLL || (p.N + BN - 1) / BN > 65535 ||
      (R::kWide && split != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pfp_dense_ring_kernel<MODE, BN, TN, TM, STAGES, BATCHED>;
  static bool raised[pfp::kMaxDevices] = {};
  cudaError_t err = pfp::allow_smem(kernel, R::kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Each rank's range: K / split rounded up to whole tiles of this ring.
  const int chunk = ((p.K + split - 1) / split + R::BK - 1) / R::BK * R::BK;
  const int vec_x = p.K % 4 == 0 && p.x_stride % 4 == 0 &&
                    aligned16(p.xa) && aligned16(p.xb);
  const int vec_w = p.N % 4 == 0 && p.w_stride % 4 == 0 &&
                    aligned16(p.wa) && aligned16(p.wb);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m_tiles * split),
                     static_cast<unsigned>((p.N + BN - 1) / BN),
                     static_cast<unsigned>(p.E));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = R::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = split > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p.xa, p.xb, p.wa, p.wb, p.mu, p.var,
                           p.rows, p.M, p.N, p.K, p.x_stride, p.w_stride,
                           split, chunk, vec_x, vec_w);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch never ran
    return static_cast<int>(err);
  }
  return pfp::launch_status();
}

struct Plan {
  int split, bn, tn, tm, stages;
};

template <int MODE, bool BATCHED>
int launch_plan(const Problem& p, const Plan& plan, cudaStream_t stream) {
#define PFP_DENSE_CASE(BN, TN, TM, ST)                                  \
  if (plan.bn == BN && plan.tn == TN && plan.tm == TM && plan.stages == ST) \
    return launch_tile<MODE, BN, TN, TM, ST, BATCHED>(p, plan.split, stream);
  PFP_DENSE_TILES(PFP_DENSE_CASE)
#undef PFP_DENSE_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // not instantiated
}

template <int MODE>
int launch_mode(const Problem& p, const Plan& plan, cudaStream_t stream) {
  if (p.E > 1 || p.rows != nullptr)
    return launch_plan<MODE, true>(p, plan, stream);
  return launch_plan<MODE, false>(p, plan, stream);
}

}  // namespace

// The batched form, rows 12-13 of the TPU kernels: e independent problems,
// expert i's x operands at i * x_stride floats and its w operands at
// i * w_stride (fp32, each slice row-major and contiguous); the outputs are
// contiguous (e, m, n). rows: null, or e int32 kept-row counts on the
// device (expert i's rows from rows[i] on are zero in x, and come out as
// zeros). Modes as below. The plan (split, bn, tn, tm, stages) must be one
// of PFP_DENSE_TILES with 1 <= split <= 8 (1 for the wide tiles, tn 8);
// anything else returns cudaErrorInvalidValue. Requires 1 <= e <= 65535
// (the grid's z extent), m, n >= 1 and k >= 0.
PFP_EXPORT int pfp_dense_batched_launch(
    int mode, const void* xa, const void* xb, const void* wa, const void* wb,
    void* mu, void* var, const void* rows, int e, int m, int n, int k,
    long long x_stride, long long w_stride, int split, int bn, int tn, int tm,
    int stages, void* stream) {
  if (e < 1 || e > 65535 || m < 1 || n < 1 || k < 0 || x_stride < 0 ||
      w_stride < 0 || split < 1 || split > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{static_cast<const float*>(xa), static_cast<const float*>(xb),
                  static_cast<const float*>(wa), static_cast<const float*>(wb),
                  static_cast<float*>(mu), static_cast<float*>(var),
                  static_cast<const int*>(rows), e, m, n, k, x_stride,
                  w_stride};
  const Plan plan{split, bn, tn, tm, stages};
  auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kSrm:
      return launch_mode<kSrm>(p, plan, s);
    case kFirstLayer:
      return launch_mode<kFirstLayer>(p, plan, s);
    case kVar:
      return launch_mode<kVar>(p, plan, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// mode: 0 = Eq. 12 (mu_x, srm_x, mu_w, srm_w), 1 = Eq. 13 (x, unused, mu_w,
// var_w), 2 = Eq. 7 (mu_x, var_x, mu_w, var_w). All fp32, row-major,
// contiguous, on the device of `stream`. Requires M, N >= 1 and K >= 0;
// the plan as for pfp_dense_batched_launch.
PFP_EXPORT int pfp_dense_launch(int mode, const void* xa, const void* xb,
                                const void* wa, const void* wb, void* mu,
                                void* var, int m, int n, int k, int split,
                                int bn, int tn, int tm, int stages,
                                void* stream) {
  return pfp_dense_batched_launch(mode, xa, xb, wa, wb, mu, var, nullptr, 1,
                                  m, n, k, 0, 0, split, bn, tn, tm, stages,
                                  stream);
}

PFP_EXPORT const char* pfp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
