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
//  * Cluster split-K (split = 2..8, a function of K and N): the `split`
//    CTAs of a thread-block cluster each sum one contiguous K range of
//    the same output tile, a whole number of 16-k tiles whatever the
//    tile, with the single accumulator above; ranks 1.. leave their
//    partial (mu, var) tiles in shared memory and rank 0 adds them in
//    rank order over distributed shared memory. One launch, no workspace,
//    no atomics, deterministic. Every CTA waits at the last cluster
//    barrier, so no shared memory is freed while rank 0 reads it. The
//    narrow regime splits for latency. Every regime splits K past 4096
//    (N > 128) for accuracy: the variance's terms share a sign, so one
//    chain's error grows as u sqrt(K) sum|terms| (at K 14336 as large
//    as TF32 inputs give); 4 or 8 chains of at most 2048 err about S
//    times less. The large regime walks the ranges in one CTA instead
//    (`serial`): each summed from zero, added into the outputs in range
//    order, the same additions as rank 0's. Its tiles hold an SM alone,
//    and clusters of 8 of them left a GPC's odd SMs idle: K 14336 at M
//    2048 ran 14% slower as a cluster (PERF.md, row 1 at long K).
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
#include "pfp_dense_ring.cuh"

namespace {

using namespace pfp::ring;

// The instantiated plans (BN, TN, TM, stages). kernels/pfp_dense.py's
// TILES is this list; tests/test_torch_dense_plan.py holds the two equal.
// pfp_fused.cu instantiates the fused unit on some of them
// (PFP_FUSED_TILES).
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

// The ring's body (pfp_dense_ring.cuh), its sums stored as they are.
template <int MODE, int BN, int TN, int TM, int STAGES, bool BATCHED>
__global__ void __launch_bounds__(kThreads)
pfp_dense_ring_kernel(const float* __restrict__ xa,
                      const float* __restrict__ xb,
                      const float* __restrict__ wa,
                      const float* __restrict__ wb,
                      float* __restrict__ mu_out, float* __restrict__ var_out,
                      const int* __restrict__ rows, int M, int N, int K,
                      long long x_stride, long long w_stride, int split,
                      int chunk, int serial, int vec_x, int vec_w) {
  extern __shared__ __align__(16) float smem[];
  dense_ring<MODE, BN, TN, TM, STAGES, BATCHED>(
      smem, xa, xb, wa, wb, rows, M, N, K, x_stride, w_stride, split, chunk,
      serial, vec_x, vec_w, StoreEpilogue{mu_out, var_out});
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
int launch_tile(const Problem& p, int split, int serial,
                cudaStream_t stream) {
  using R = Ring<MODE, BN, TN, TM, STAGES>;
  const long long m_tiles = (p.M + R::BM - 1) / R::BM;
  const int ranks = serial ? 1 : split;  // CTAs an output tile
  if (m_tiles * ranks > 0x7fffffffLL || (p.N + BN - 1) / BN > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pfp_dense_ring_kernel<MODE, BN, TN, TM, STAGES, BATCHED>;
  static bool raised[pfp::kMaxDevices] = {};
  constexpr int kBytes = R::kFloats * 4;
  cudaError_t err = pfp::allow_smem(kernel, kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Each rank's range: K / split rounded up to whole kBK, whatever the
  // tile (a wide tile's last one in a range may be half zero-filled).
  const int chunk = ((p.K + split - 1) / split + kBK - 1) / kBK * kBK;
  const int vec_x = p.K % 4 == 0 && p.x_stride % 4 == 0 &&
                    aligned16(p.xa) && aligned16(p.xb);
  const int vec_w = p.N % 4 == 0 && p.w_stride % 4 == 0 &&
                    aligned16(p.wa) && aligned16(p.wb);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m_tiles * ranks),
                     static_cast<unsigned>((p.N + BN - 1) / BN),
                     static_cast<unsigned>(p.E));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ranks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ranks > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, p.xa, p.xb, p.wa, p.wb, p.mu, p.var,
                           p.rows, p.M, p.N, p.K, p.x_stride, p.w_stride,
                           split, chunk, serial, vec_x, vec_w);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch never ran
    return static_cast<int>(err);
  }
  return pfp::launch_status();
}

struct Plan {
  int split, bn, tn, tm, stages, serial;
};

template <int MODE, bool BATCHED>
int launch_plan(const Problem& p, const Plan& plan, cudaStream_t stream) {
#define PFP_DENSE_CASE(BN, TN, TM, ST)                                  \
  if (plan.bn == BN && plan.tn == TN && plan.tm == TM && plan.stages == ST) \
    return launch_tile<MODE, BN, TN, TM, ST, BATCHED>(p, plan.split,       \
                                                      plan.serial, stream);
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
// of PFP_DENSE_TILES with 1 <= split <= 8; anything else returns
// cudaErrorInvalidValue. serial: 0, a cluster of `split` CTAs an output
// tile; 1, one CTA walking the split's K ranges in order (the same sums).
// Requires 1 <= e <= 65535 (the grid's z extent), m, n >= 1 and k >= 0.
PFP_EXPORT int pfp_dense_batched_launch(
    int mode, const void* xa, const void* xb, const void* wa, const void* wb,
    void* mu, void* var, const void* rows, int e, int m, int n, int k,
    long long x_stride, long long w_stride, int split, int bn, int tn, int tm,
    int stages, int serial, void* stream) {
  if (e < 1 || e > 65535 || m < 1 || n < 1 || k < 0 || x_stride < 0 ||
      w_stride < 0 || split < 1 || split > kMaxSplit || serial < 0 ||
      serial > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Problem p{static_cast<const float*>(xa), static_cast<const float*>(xb),
                  static_cast<const float*>(wa), static_cast<const float*>(wb),
                  static_cast<float*>(mu), static_cast<float*>(var),
                  static_cast<const int*>(rows), e, m, n, k, x_stride,
                  w_stride};
  const Plan plan{split, bn, tn, tm, stages, serial};
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
// the plan and serial as for pfp_dense_batched_launch.
PFP_EXPORT int pfp_dense_launch(int mode, const void* xa, const void* xb,
                                const void* wa, const void* wb, void* mu,
                                void* var, int m, int n, int k, int split,
                                int bn, int tn, int tm, int stages,
                                int serial, void* stream) {
  return pfp_dense_batched_launch(mode, xa, xb, wa, wb, mu, var, nullptr, 1,
                                  m, n, k, 0, 0, split, bn, tn, tm, stages,
                                  serial, stream);
}

PFP_EXPORT const char* pfp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
