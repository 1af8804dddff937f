// Flash-style mean-field PFP attention for Hopper: one online-softmax sweep
// over the keys gives both outputs,
//
//     out_mu  = softmax(q k^T * scale) @ mu_v
//     out_var = softmax(q k^T * scale)^2 @ var_v
//
// Three kernels, on two tile bodies (attend_tile, and score / accumulate in
// the cache kernel):
//
//  * pfp_attention_kernel, without a KV cache: q (B, H, Tq, D) against
//    k / mu_v / var_v (B, Hkv, Tk, D), causality right-aligned by index
//    (query row t sits at position t + Tk - Tq). Replaces
//    repro/kernels/pfp_attention.py: pfp_attention_pallas (_attn_kernel).
//  * pfp_attention_kv_kernel<PAGED = false>, the KV cache: q (B, H, Tq, D)
//    against a cache (B, Hkv, S, D) with per-batch int32 q_start and
//    kv_len on the device: query row t of batch b sits at absolute
//    position q_start[b] + t, key j is real iff j < kv_len[b], and an
//    optional window keeps keys j > position - window. Replaces
//    pfp_attention_cache_pallas (_cache_attn_kernel).
//  * pfp_attention_kv_kernel<PAGED = true>, the paged cache: the same, with
//    key j of batch b at pool row (page_table[b, j / ps], kv head, j % ps)
//    of a pool (NP, Hkv, ps, D). Replaces pfp_attention_paged_pallas
//    (_paged_attn_kernel).
//
// As in the TPU kernels: query head h reads KV head h / (H / Hkv) (kv-major
// grouping, K/V never repeated); masked scores are NEG_INF and p is zeroed
// after the exp; the mean accumulator is rescaled by alpha and the variance
// accumulator by alpha^2 (p^2 shares the running max and normaliser), and
// the end divides by l and l^2 with l clamped at 1e-18, so a query row with
// no valid key comes out 0 rather than NaN. fp32 throughout: IEEE products,
// accurate expf, no tensor cores and no TF32.
//
// What bounds them on the H100:
//  * without a cache, at the granite-8b prefill shape (B 4, H 32, T 512,
//    D 128, causal): fp32 operations, ~13 GFLOP, 0.19 ms at the 67 TFLOP/s
//    SIMT peak, against 0.05 ms for its 134 MB of operands;
//  * the cache kernels at decode (Tq = 1): bytes. Each step reads the
//    valid K, mu_v and var_v rows once, 3 * B * Hkv * kv_len * D * 4 bytes
//    (50 MB at B 4, Hkv 8, kv_len 1024, D 128: 15 us at 3.35 TB/s), and does
//    ~6 operations per byte read. At prefill (Tq = 512) operations again.
//
// Design of the kernel without a cache: a block of 8 warps owns BQ = 64
// query rows and walks the key tiles itself, so nothing crosses blocks (the
// TPU carries m, l and both accumulators across sequential K grid steps
// instead). Per tile of 32 keys the block stages K, mu_v and var_v in shared
// memory. Each warp owns 8 query rows, and lane l scores key l against them
// (float4 reads along D from rows padded to D + 4 floats, which keeps the 32
// lanes on distinct banks). The row max and sum are warp shuffles; p goes to
// shared memory, and for P.V lane l owns output columns l, l + 32, ... of
// the warp's rows, so the V reads are conflict-free and p is a broadcast.
// Tiles that hold no valid key for any row of the block are skipped: they
// would add exact zeros, so skipping them changes no bit.
//
// The cache kernels (pfp_attention_kv_kernel) pack the G = H / Hkv query
// heads of one KV head and the Tq query rows into a block's rows,
// position-major (block row r is query row r / G of head kvh * G + r % G),
// so each K / V tile is read once per KV head, not once per query head: a
// block of BQ = 8 rows at decode (G * Tq <= 8: 4 real rows for granite-8b,
// 1 for deepseek-moe-16b), of 64 rows otherwise. What they guarantee: a
// query row's two outputs are a function of its query, the K, mu_v and var_v
// rows of its valid keys, its position, kv_len, the window and the scale
// only; not of Tq, B, the other rows or slots, the page size or order, the
// block size or how many blocks share its keys. The arithmetic that makes it
// so:
//  * Segments: the keys are cut at fixed absolute positions into segments of
//    kSegment keys. Within a segment a fresh online softmax runs over its
//    32-key tiles in key order: each score one fmaf chain over d; the tile's
//    max; p; the warp's xor-tree sum of p (lane l holds key k0 + l); then
//    P.mu_v and P^2.var_v as one fmaf chain over the keys in order, after
//    the accumulators are rescaled by alpha and alpha^2. Every rounding is
//    spelled out (__fmul_rn, __fmaf_rn, __fsub_rn), so nvcc contracts
//    nothing differently in one instantiation than in another.
//  * Across segments: one left fold in segment order (fold_ml, fold_acc). An
//    empty segment, or a tile with no valid key for a row, is an exact no-op
//    for that row, so a block skips every tile that holds no valid key for
//    any of its rows.
//  * The end: divide by l and l^2, l clamped at 1e-18, so a row without a
//    valid key comes out 0 rather than NaN.
// A block that walks all of a row's segments and folds as it goes thus gives
// the bits of blocks that compute segments apart and fold their partials in
// segment order afterwards; the fold is never applied to a range of
// segments out of order (fp addition does not associate).
//
// What the decode design does about the bound (bytes, at 32 or 64 (slot, KV
// head) pairs, too few for 132 SMs if each walked its keys alone):
//  * Split keys: the `cluster` blocks of a thread-block cluster share one
//    (slot, KV head, row tile); in round k rank r takes segment
//    first + k * cluster + r. Each rank leaves its segment's partial (m, l
//    and both accumulators of every row) in shared memory, and rank 0 folds
//    the partials over distributed shared memory in rank order, which is
//    segment order; the next round starts once rank 0 has read them. One
//    launch, no workspace, no atomics, any kv_len the cache holds. The
//    cluster size comes from kernels/pfp_attention.py attention_plan, from
//    shapes and the cache's capacity only (kv_len stays on the device): the
//    largest that keeps the blocks in one wave. A rank with no segment in
//    a round only waits at the cluster barriers; a block whose keys are
//    all past kv_len writes zeros and leaves. With cluster 1 a block walks
//    all its tiles in one ring and folds each segment into its running
//    state as it ends.
//  * One barrier a tile: the warp that scores a row also accumulates it
//    (KvTile), so only the ring's barrier joins the warps. A decode block
//    has 1 (deepseek-moe-16b) to 4 (granite-8b) real rows; its other warps
//    only copy. Spreading P.V over all 8 warps took a second barrier a
//    tile and measured 7% slower at decode (PERF.md).
//  * Copies in flight: K, mu_v and var_v come through a cp.async ring of
//    kStages tiles (zero-filled past the block's last valid key); the block
//    computes one tile while the next lands. A page holds whole key rows, so
//    paged and contiguous differ only in a key row's address.
// The prefill block (64 rows) runs the same tile arithmetic, so a row's bits
// do not depend on which block size computed it.
//
// Rows and keys past the ends are masked here; nothing is padded. q_start
// and kv_len stay on the device (no host sync), so a step can be captured
// in a CUDA graph. Shared memory is above the 48 KB default at D = 128, so
// each launcher raises the block's dynamic shared-memory limit once per
// instantiation and device, on its first call (before any capture).
#include <cooperative_groups.h>

#include "pfp_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 32;  // keys per tile: one per lane
constexpr float kNegInf = -1e30f;  // core/masking.py NEG_INF
constexpr float kMinL = 1e-18f;

template <int D, int BQ>
struct Tile {
  static constexpr int kRowsPerWarp = BQ / kWarps;
  static constexpr int kColsPerLane = D >= 32 ? D / 32 : 1;
  static constexpr int kLd = D + 4;  // padded row of the Q and K tiles
  static constexpr int kFloats = BQ * kLd + kBK * kLd + 2 * kBK * D + BQ * kBK;
  static constexpr int kBytes = kFloats * 4;
  static_assert(BQ % kWarps == 0, "BQ must be a multiple of the warp count");
  static_assert(D % 4 == 0, "D must be a multiple of 4");
  static_assert(D < 32 || D % 32 == 0, "D >= 32 must be a multiple of 32");
};

// The block's shared tiles: Q (BQ x kLd), K (kBK x kLd), mu_v and var_v
// (kBK x D), P (BQ x kBK).
template <int D, int BQ>
struct Smem {
  float *q, *k, *vm, *vv, *p;
  __device__ explicit Smem(float* base) {
    using T = Tile<D, BQ>;
    q = base;
    k = q + BQ * T::kLd;
    vm = k + kBK * T::kLd;
    vv = vm + kBK * D;
    p = vv + kBK * D;
  }
};

// One warp's running softmax state and accumulators for its rows, on this
// lane's output columns.
template <int D, int BQ>
struct Rows {
  static constexpr int RW = Tile<D, BQ>::kRowsPerWarp;
  static constexpr int CPL = Tile<D, BQ>::kColsPerLane;
  float m[RW], l[RW], mu[RW][CPL], var[RW][CPL];

  __device__ __forceinline__ Rows() {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      m[i] = kNegInf;
      l[i] = 0.0f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        mu[i][c] = 0.0f;
        var[i][c] = 0.0f;
      }
    }
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One staged tile of kBK keys against the warp's rows row0 .. row0 + RW - 1
// (_score_tile, then _accumulate). valid(i) says whether key k0 + lane is
// a valid key of the warp's row i.
template <int D, int BQ, typename Valid>
__device__ __forceinline__ void attend_tile(const Smem<D, BQ>& sm, int row0,
                                            int lane, float scale,
                                            const Valid& valid,
                                            Rows<D, BQ>& st) {
  constexpr int RW = Rows<D, BQ>::RW;
  constexpr int CPL = Rows<D, BQ>::CPL;
  constexpr int LD = Tile<D, BQ>::kLd;

  // Scores of key k0 + lane against the warp's RW query rows.
  float s[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) s[i] = 0.0f;
#pragma unroll 4
  for (int d4 = 0; d4 < D / 4; ++d4) {
    const float4 kv =
        *reinterpret_cast<const float4*>(sm.k + lane * LD + 4 * d4);
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float4 qv =
          *reinterpret_cast<const float4*>(sm.q + (row0 + i) * LD + 4 * d4);
      s[i] = fmaf(qv.x, kv.x, s[i]);
      s[i] = fmaf(qv.y, kv.y, s[i]);
      s[i] = fmaf(qv.z, kv.z, s[i]);
      s[i] = fmaf(qv.w, kv.w, s[i]);
    }
  }

  // Joint online softmax: one row per i, one key per lane.
  float alpha[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const bool ok = valid(i);
    const float sc = ok ? s[i] * scale : kNegInf;
    const float m_next = fmaxf(st.m[i], warp_max(sc));
    alpha[i] = expf(st.m[i] - m_next);
    const float p = ok ? expf(sc - m_next) : 0.0f;
    st.l[i] = st.l[i] * alpha[i] + warp_sum(p);
    st.m[i] = m_next;
    sm.p[(row0 + i) * kBK + lane] = p;
  }
  __syncwarp();

  // mu = mu * alpha + P . mu_v;  var = var * alpha^2 + P^2 . var_v, on the
  // warp's rows and this lane's columns.
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float a2 = alpha[i] * alpha[i];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      st.mu[i][c] *= alpha[i];
      st.var[i][c] *= a2;
    }
  }
  if (D >= 32 || lane < D) {
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vmj[CPL], vvj[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        vmj[c] = sm.vm[j * D + lane + 32 * c];
        vvj[c] = sm.vv[j * D + lane + 32 * c];
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float p = sm.p[(row0 + i) * kBK + j];
        const float p2 = p * p;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          st.mu[i][c] = fmaf(p, vmj[c], st.mu[i][c]);
          st.var[i][c] = fmaf(p2, vvj[c], st.var[i][c]);
        }
      }
    }
  }
}

// _finalize for the warp's row i, written at `out_row` (floats): a row with
// a valid key has l >= 1; a row without one has l == 0 and zero
// accumulators, and the clamp keeps l^2 finite.
template <int D, int BQ>
__device__ __forceinline__ void write_row(const Rows<D, BQ>& st, int i,
                                          int lane, long long out_row,
                                          float* __restrict__ om,
                                          float* __restrict__ ov) {
  if (D < 32 && lane >= D) return;
  const float l = fmaxf(st.l[i], kMinL);
  const float l2 = l * l;
#pragma unroll
  for (int c = 0; c < Rows<D, BQ>::CPL; ++c) {
    om[out_row + lane + 32 * c] = st.mu[i][c] / l;
    ov[out_row + lane + 32 * c] = st.var[i][c] / l2;
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
pfp_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ vm,
                     const float* __restrict__ vv, float* __restrict__ om,
                     float* __restrict__ ov, int H, int Hkv, int Tq, int Tk,
                     float scale, int causal) {
  constexpr int RW = Tile<D, BQ>::kRowsPerWarp;
  constexpr int LD = Tile<D, BQ>::kLd;
  extern __shared__ float4 smem4[];
  const Smem<D, BQ> sm(reinterpret_cast<float*>(smem4));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const long long kvh = static_cast<long long>(b) * Hkv + h / (H / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int qoff = Tk - Tq;  // right-aligned causality
  const float* qb = q + static_cast<long long>(bh) * Tq * D;
  const float* kb = k + kvh * Tk * D;
  const float* vmb = vm + kvh * Tk * D;
  const float* vvb = vv + kvh * Tk * D;

  for (int e = threadIdx.x; e < BQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    sm.q[r * LD + c] = q0 + r < Tq
                           ? qb[static_cast<long long>(q0 + r) * D + c]
                           : 0.0f;
  }

  Rows<D, BQ> st;
  int num_tiles = (Tk + kBK - 1) / kBK;
  if (causal) {
    const int last_key = min(Tk - 1, q0 + BQ - 1 + qoff);
    num_tiles = last_key < 0 ? 0 : last_key / kBK + 1;
  }
  const int row0 = warp * RW;

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K / V are no longer read
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < Tk;
      const long long off = static_cast<long long>(k0 + r) * D + c;
      sm.k[r * LD + c] = ok ? kb[off] : 0.0f;
      sm.vm[r * D + c] = ok ? vmb[off] : 0.0f;
      sm.vv[r * D + c] = ok ? vvb[off] : 0.0f;
    }
    __syncthreads();
    const int key = k0 + lane;
    attend_tile(sm, row0, lane, scale, [&](int i) {
      return key < Tk && (!causal || q0 + row0 + i + qoff >= key);
    }, st);
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = q0 + row0 + i;
    if (row < Tq)
      write_row(st, i, lane, (static_cast<long long>(bh) * Tq + row) * D, om,
                ov);
  }
}

// ---------------------------------------------------------------------------
// The KV-cache kernels: keys in fixed segments, one left fold
// ---------------------------------------------------------------------------
constexpr int kSegment = 128;   // keys per segment: attention_plan's SEGMENT
constexpr int kStages = 2;      // tiles in the cp.async ring
constexpr int kMaxCluster = 8;  // the portable cluster size

// The instantiated block sizes (rows): kernels/pfp_attention.py BLOCK_ROWS.
#define PFP_ATTENTION_BLOCKS(X) X(8) X(64)

using pfp::cp_async16;
using pfp::cp_async_commit;
using pfp::cp_async_wait;

// The fold of a segment's partial (m_b, l_b, acc_b) into a running state
// (m, l, acc) of one row: m' = max(m, m_b), alpha = exp(m - m'),
// beta = exp(m_b - m'), l' = l alpha + l_b beta; each accumulator
// acc' = acc alpha + acc_b beta (mean) or acc alpha^2 + acc_b beta^2
// (variance), by fold_acc with the coefficients fold_ml returns. An empty
// partial (m_b = NEG_INF, l_b = 0, acc_b = 0) leaves the state as it is.
struct FoldCoef {
  float a, b, a2, b2;
};

__device__ __forceinline__ FoldCoef fold_ml(float& m, float& l, float m_b,
                                            float l_b) {
  const float m_new = fmaxf(m, m_b);
  FoldCoef f;
  f.a = expf(__fsub_rn(m, m_new));
  f.b = expf(__fsub_rn(m_b, m_new));
  f.a2 = __fmul_rn(f.a, f.a);
  f.b2 = __fmul_rn(f.b, f.b);
  l = __fmaf_rn(l_b, f.b, __fmul_rn(l, f.a));
  m = m_new;
  return f;
}

__device__ __forceinline__ float fold_acc(float acc, float acc_b, float a,
                                          float b) {
  return __fmaf_rn(acc_b, b, __fmul_rn(acc, a));
}

// A cache block of BQ rows (8 at decode, 64 otherwise). Warp w owns rows
// srow = w * kRW .. (kRW = BQ / 8): it scores them (lane l on key k0 + l)
// and accumulates them (lane l on columns l, l + 32, ... of both tensors),
// so p, alpha and the fold coefficients never leave the warp, and one
// barrier a tile (the ring's) is the only one. A warp with no real row
// only helps copy the tiles. A thread's accumulator a = (i * kCPL + c) * 2
// + t is row srow + i, column lane + 32 c, tensor t (0 mean, 1 variance).
// Shared memory, in floats: Q (BQ x D); the ring of kStages tiles, each K
// (kBK x kLd) then mu_v and var_v (kBK x D); p (BQ x kBK); the running
// accumulators where they are many ([a][thread]). A segment's partial for
// the cluster exchange (kAcc x kThreads accumulators, then m and l per
// row) lies over the ring, which is idle between rounds.
template <int D, int BQ>
struct KvTile {
  static constexpr int kRW = BQ / kWarps;
  static constexpr int kCPL = D >= 32 ? D / 32 : 1;
  static constexpr int kAcc = kRW * kCPL * 2;
  static constexpr int kLd = D + 4;
  static constexpr int kStage = kBK * kLd + 2 * kBK * D;
  static constexpr int kPartM = kAcc * kThreads;  // offsets in a partial
  static constexpr int kPartL = kPartM + BQ;
  static constexpr int kRingFloats = kStages * kStage > kPartL + BQ
                                         ? kStages * kStage
                                         : kPartL + BQ;
  static constexpr int kQ = 0;
  static constexpr int kRing = kQ + BQ * D;
  static constexpr int kP = kRing + kRingFloats;
  static constexpr bool kRunShared = kAcc > 16;  // else 64 more registers
  static constexpr int kRun = kP + BQ * kBK;
  static constexpr int kFloats = kRun + (kRunShared ? kAcc * kThreads : 0);
  static constexpr int kBytes = kFloats * 4;
  static_assert(BQ % kWarps == 0, "BQ must be a multiple of the warp count");
  static_assert(D % 4 == 0 && (D < 32 || D % 32 == 0), "bad head_dim");
  static_assert(kBytes <= 227 * 1024, "shared memory of a block");
};

// S: the cache length (contiguous) or the page size (paged). P: the page
// table's width, NP: the pool's page count (paged only). blockIdx.x is
// row tile * cluster + rank, blockIdx.y is b * Hkv + kvh.
template <int D, int BQ, bool PAGED>
__global__ void __launch_bounds__(kThreads)
pfp_attention_kv_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ vm,
                        const float* __restrict__ vv,
                        const int* __restrict__ page_table,
                        const int* __restrict__ q_start,
                        const int* __restrict__ kv_len,
                        float* __restrict__ om, float* __restrict__ ov, int H,
                        int Hkv, int Tq, int S, int P, int NP, float scale,
                        int causal, int window, int cluster) {
  using L = KvTile<D, BQ>;
  constexpr int D4 = D / 4;
  constexpr int RW = L::kRW;
  constexpr int CPL = L::kCPL;
  constexpr int NA = L::kAcc;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_q = smem + L::kQ;
  float* ring = smem + L::kRing;
  float* s_p = smem + L::kP;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rank = static_cast<int>(blockIdx.x % cluster);
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int G = H / Hkv;
  const int rows = G * Tq;
  const int r0 = static_cast<int>(blockIdx.x / cluster) * BQ;
  const int nrows = min(BQ, rows - r0);
  const int qs = q_start[b];
  const int cap = PAGED ? P * S : S;
  const int klim = min(max(kv_len[b], 0), cap);

  // Keys any row of the block can see: causality bounds them by the
  // block's last query position, the window by its first.
  const int last = r0 + nrows - 1;
  const int hi = causal ? min(klim, qs + last / G + 1) : klim;
  const int lo = window > 0 ? max(0, qs + r0 / G - window + 1) : 0;
  const int seg_first = lo / kSegment;
  const int nsegs = hi > lo ? (hi + kSegment - 1) / kSegment - seg_first : 0;
  const int rounds = (nsegs + cluster - 1) / cluster;

  for (int e = tid; e < BQ * D4; e += kThreads) {
    const int r = e / D4, c = e % D4, R = r0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < nrows) {
      const long long row =
          (static_cast<long long>(b) * H + kvh * G + R % G) * Tq + R / G;
      v = reinterpret_cast<const float4*>(q + row * D)[c];
    }
    reinterpret_cast<float4*>(s_q + r * D)[c] = v;
  }
  // (the first tile's barrier publishes Q)

  // The warp's rows: positions, the segment's (m, l) and the running
  // (m, l) (alike in every lane), the last tile's alpha; the segment's
  // accumulators and the running ones (run(a)).
  const int srow = warp * RW;
  const bool scoring = srow < nrows;
  int pos[RW];
  float m[RW], l[RW], run_m[RW], run_l[RW], alpha[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    pos[i] = qs + (r0 + srow + i) / G;
    m[i] = run_m[i] = kNegInf;
    l[i] = run_l[i] = 0.0f;
  }
  float acc[NA], run_regs[L::kRunShared ? 1 : NA];
  auto run = [&](int a) -> float& {
    if constexpr (L::kRunShared)
      return smem[L::kRun + a * kThreads + tid];
    else
      return run_regs[a];
  };
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    acc[a] = 0.0f;
    run(a) = 0.0f;
  }

  // Stage tile t (keys t * kBK ..) into ring stage st; keys from hi on are
  // zero-filled (they are valid for no row of the block).
  auto load_tile = [&](int t, int st) {
    float* sk = ring + st * L::kStage;
    float* svm = sk + kBK * L::kLd;
    float* svv = svm + kBK * D;
    const int k0 = t * kBK;
    for (int e = tid; e < kBK * D4; e += kThreads) {
      const int r = e / D4, c = e % D4, j = k0 + r;
      const bool ok = j < hi;
      long long row = 0;
      if (ok) {
        if constexpr (PAGED) {
          int page = page_table[static_cast<long long>(b) * P + j / S];
          if (page < 0 || page >= NP) page = 0;  // outside the pool: trash
          row = (static_cast<long long>(page) * Hkv + kvh) * S + j % S;
        } else {
          row = (static_cast<long long>(b) * Hkv + kvh) * S + j;
        }
      }
      const long long off = row * D + 4 * c;
      cp_async16(sk + r * L::kLd + 4 * c, k + off, ok);
      cp_async16(svm + r * D + 4 * c, vm + off, ok);
      cp_async16(svv + r * D + 4 * c, vv + off, ok);
    }
  };

  // Scores of tile t against the warp's rows and the online softmax step:
  // p to shared memory, alpha kept.
  auto score = [&](const float* sk, int t) {
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      const float4 kv =
          *reinterpret_cast<const float4*>(sk + lane * L::kLd + 4 * d4);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(s_q + (srow + i) * D + 4 * d4);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }
    const int key = t * kBK + lane;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const bool ok = srow + i < nrows && key < klim &&
                      (!causal || pos[i] >= key) &&
                      (window <= 0 || key > pos[i] - window);
      const float sc = ok ? __fmul_rn(s[i], scale) : kNegInf;
      const float m_next = fmaxf(m[i], warp_max(sc));
      alpha[i] = expf(__fsub_rn(m[i], m_next));
      const float p = ok ? expf(__fsub_rn(sc, m_next)) : 0.0f;
      l[i] = __fmaf_rn(l[i], alpha[i], warp_sum(p));
      m[i] = m_next;
      s_p[(srow + i) * kBK + lane] = p;
    }
  };

  // P.V of the staged tile: rescale by alpha (mean) and alpha^2
  // (variance), then one fmaf per key in key order on each accumulator.
  auto accumulate = [&](const float* sk) {
    const float* svm = sk + kBK * L::kLd;
    const float* svv = svm + kBK * D;
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float a2 = __fmul_rn(alpha[i], alpha[i]);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc[(i * CPL + c) * 2] = __fmul_rn(acc[(i * CPL + c) * 2], alpha[i]);
        acc[(i * CPL + c) * 2 + 1] =
            __fmul_rn(acc[(i * CPL + c) * 2 + 1], a2);
      }
    }
    if (D < 32 && lane >= D) return;
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vmj[CPL], vvj[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        vmj[c] = svm[j * D + lane + 32 * c];
        vvj[c] = svv[j * D + lane + 32 * c];
      }
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float p = s_p[(srow + i) * kBK + j];
        const float p2 = __fmul_rn(p, p);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int a = (i * CPL + c) * 2;
          acc[a] = __fmaf_rn(p, vmj[c], acc[a]);
          acc[a + 1] = __fmaf_rn(p2, vvj[c], acc[a + 1]);
        }
      }
    }
  };

  // Fold one segment's partial into the running state, row by row: its
  // (m, l) from mb(i), lb(i), its accumulators from xb(a).
  auto fold = [&](auto mb, auto lb, auto xb) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const FoldCoef f = fold_ml(run_m[i], run_l[i], mb(i), lb(i));
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int a = (i * CPL + c) * 2;
        run(a) = fold_acc(run(a), xb(a), f.a, f.b);
        run(a + 1) = fold_acc(run(a + 1), xb(a + 1), f.a2, f.b2);
      }
    }
  };
  auto restart = [&] {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      m[i] = kNegInf;
      l[i] = 0.0f;
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) acc[a] = 0.0f;
  };

  // Tiles ta .. tb - 1 through the ring. With `fold`, each segment is
  // folded into the running state as it ends (cluster 1); otherwise the
  // tiles are one segment of a round.
  auto run_tiles = [&](int ta, int tb, bool fold_segments) {
    const int n = tb - ta;
#pragma unroll 1
    for (int st = 0; st < kStages - 1; ++st) {
      if (st < n) load_tile(ta + st, st);
      cp_async_commit();
    }
#pragma unroll 1
    for (int f = 0; f < n; ++f) {
      // Tile f has landed (this thread's part, then every thread's); stage
      // f - 1 and the last tile's p are no longer read.
      cp_async_wait<kStages - 2>();
      __syncthreads();
      const int nxt = f + kStages - 1;
      if (nxt < n) load_tile(ta + nxt, nxt % kStages);
      cp_async_commit();
      if (!scoring) continue;
      const float* sk = ring + (f % kStages) * L::kStage;
      const int t = ta + f;
      score(sk, t);
      __syncwarp();
      accumulate(sk);
      if (fold_segments &&
          (f + 1 == n || ((t + 1) * kBK) % kSegment == 0)) {
        fold([&](int i) { return m[i]; }, [&](int i) { return l[i]; },
             [&](int a) { return acc[a]; });
        restart();
      }
    }
    cp_async_wait<0>();
  };

  if (cluster == 1) {
    if (nsegs > 0) run_tiles(lo / kBK, (hi + kBK - 1) / kBK, true);
  } else {
    cg::cluster_group cl = cg::this_cluster();
    float* part = ring;
#pragma unroll 1
    for (int k = 0; k < rounds; ++k) {
      const int active = min(cluster, nsegs - k * cluster);
      if (rank < active) {
        const int s0 = (seg_first + k * cluster + rank) * kSegment;
        run_tiles(max(lo, s0) / kBK,
                  (min(hi, s0 + kSegment) + kBK - 1) / kBK, false);
      }
      __syncthreads();  // the ring is drained and read: it takes the partial
      if (rank < active && scoring) {
#pragma unroll
        for (int a = 0; a < NA; ++a) part[a * kThreads + tid] = acc[a];
        if (lane == 0) {
#pragma unroll
          for (int i = 0; i < RW; ++i) {
            part[L::kPartM + srow + i] = m[i];
            part[L::kPartL + srow + i] = l[i];
          }
        }
      }
      cl.sync();
      if (rank == 0 && scoring) {
        for (int r = 0; r < active; ++r) {  // rank order: segment order
          const float* theirs = cl.map_shared_rank(part, r);
          fold([&](int i) { return theirs[L::kPartM + srow + i]; },
               [&](int i) { return theirs[L::kPartL + srow + i]; },
               [&](int a) { return theirs[a * kThreads + tid]; });
        }
      }
      cl.sync();  // rank 0 has read every partial: the rings may refill
      restart();
    }
    if (rank != 0) return;
  }

  if (!scoring || (D < 32 && lane >= D)) return;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = srow + i;
    if (r >= nrows) break;
    const int R = r0 + r;
    const long long out =
        ((static_cast<long long>(b) * H + kvh * G + R % G) * Tq + R / G) * D;
    const float lr = fmaxf(run_l[i], kMinL);
    const float lr2 = __fmul_rn(lr, lr);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      const int a = (i * CPL + c) * 2;
      om[out + lane + 32 * c] = __fdiv_rn(run(a), lr);
      ov[out + lane + 32 * c] = __fdiv_rn(run(a + 1), lr2);
    }
  }
}

template <int D, int BQ>
int launch(const float* q, const float* k, const float* vm, const float* vv,
           float* om, float* ov, int B, int H, int Hkv, int Tq, int Tk,
           float scale, int causal, cudaStream_t stream) {
  constexpr int kBytes = Tile<D, BQ>::kBytes;
  static bool raised[pfp::kMaxDevices] = {};
  const cudaError_t err =
      pfp::allow_smem(pfp_attention_kernel<D, BQ>, kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((Tq + BQ - 1) / BQ),
                  static_cast<unsigned>(B * H));
  pfp_attention_kernel<D, BQ><<<grid, kThreads, kBytes, stream>>>(
      q, k, vm, vv, om, ov, H, Hkv, Tq, Tk, scale, causal);
  return pfp::launch_status();
}

struct KvArgs {
  const float *q, *k, *vm, *vv;
  const int *page_table, *q_start, *kv_len;
  float *om, *ov;
  int B, H, Hkv, Tq, S, P, NP;
  float scale;
  int causal, window, cluster;
};

// The instantiation, allowed its shared memory on the current device.
template <int D, int BQ, bool PAGED>
cudaError_t kv_kernel_ready() {
  static bool raised[pfp::kMaxDevices] = {};
  return pfp::allow_smem(pfp_attention_kv_kernel<D, BQ, PAGED>,
                         KvTile<D, BQ>::kBytes, raised);
}

template <int D, int BQ, bool PAGED>
int launch_kv(const KvArgs& a, cudaStream_t stream) {
  using L = KvTile<D, BQ>;
  const long long rows = static_cast<long long>(a.H / a.Hkv) * a.Tq;
  const long long tiles = (rows + BQ - 1) / BQ;
  if (tiles * a.cluster > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = pfp_attention_kv_kernel<D, BQ, PAGED>;
  cudaError_t err = kv_kernel_ready<D, BQ, PAGED>();
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles * a.cluster),
                     static_cast<unsigned>(a.B * a.Hkv));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, a.q, a.k, a.vm, a.vv, a.page_table,
                           a.q_start, a.kv_len, a.om, a.ov, a.H, a.Hkv, a.Tq,
                           a.S, a.P, a.NP, a.scale, a.causal, a.window,
                           a.cluster);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch never ran
    return static_cast<int>(err);
  }
  return pfp::launch_status();
}

template <int D, bool PAGED>
int launch_kv_block(const KvArgs& a, int block_rows, cudaStream_t stream) {
#define PFP_ATTENTION_CASE(BQ) \
  if (block_rows == BQ) return launch_kv<D, BQ, PAGED>(a, stream);
  PFP_ATTENTION_BLOCKS(PFP_ATTENTION_CASE)
#undef PFP_ATTENTION_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // not instantiated
}

// A block's shared memory in bytes and the blocks an SM of the current
// device holds at that size.
template <int D, int BQ, bool PAGED>
int kv_block(int* bytes, int* per_sm) {
  *bytes = KvTile<D, BQ>::kBytes;
  cudaError_t err = kv_kernel_ready<D, BQ, PAGED>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, pfp_attention_kv_kernel<D, BQ, PAGED>, kThreads, *bytes);
  return static_cast<int>(err);
}

template <int D, bool PAGED>
int kv_block_rows(int block_rows, int* bytes, int* per_sm) {
#define PFP_ATTENTION_CASE(BQ) \
  if (block_rows == BQ) return kv_block<D, BQ, PAGED>(bytes, per_sm);
  PFP_ATTENTION_BLOCKS(PFP_ATTENTION_CASE)
#undef PFP_ATTENTION_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // not instantiated
}

}  // namespace

// q (B, H, Tq, D); k, v_mu, v_var (B, Hkv, Tk, D); outputs (B, H, Tq, D).
// head_dim D in {16, 128} (the reduced test config, granite-8b; other
// widths are instantiated with the models that need them); H % Hkv == 0;
// B * H <= 65535.
PFP_EXPORT int pfp_attention_launch(const void* q, const void* k,
                                    const void* v_mu, const void* v_var,
                                    void* out_mu, void* out_var, int B, int H,
                                    int Hkv, int Tq, int Tk, int D,
                                    float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Tq < 1 || Tk < 1 ||
      static_cast<long long>(B) * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* pq = static_cast<const float*>(q);
  const auto* pk = static_cast<const float*>(k);
  const auto* pvm = static_cast<const float*>(v_mu);
  const auto* pvv = static_cast<const float*>(v_var);
  auto* om = static_cast<float*>(out_mu);
  auto* ov = static_cast<float*>(out_var);
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16, 64>(pq, pk, pvm, pvv, om, ov, B, H, Hkv, Tq, Tk,
                            scale, causal, s);
    case 128:
      return launch<128, 64>(pq, pk, pvm, pvv, om, ov, B, H, Hkv, Tq, Tk,
                             scale, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The KV-cache kernels. q (B, H, Tq, D); paged = 0: k, v_mu, v_var
// (B, Hkv, S, D) and page_table unused; paged = 1: k, v_mu, v_var
// (NP, Hkv, S, D) pools of pages of S rows, page_table (B, P) int32.
// q_start, kv_len (B,) int32; window <= 0 means none. Outputs (B, H, Tq, D).
// All pointers 16-byte aligned. head_dim D in {16, 128}; H % Hkv == 0;
// B * Hkv <= 65535. A table entry outside [0, NP) reads the trash page 0.
// The plan (kernels/pfp_attention.py attention_plan): block_rows, one of
// PFP_ATTENTION_BLOCKS; cluster, 1 .. 8 blocks sharing a row tile's keys.
// Any other plan is refused.
PFP_EXPORT int pfp_attention_kv_launch(
    int paged, const void* q, const void* k, const void* v_mu,
    const void* v_var, const void* page_table, const void* q_start,
    const void* kv_len, void* out_mu, void* out_var, int B, int H, int Hkv,
    int Tq, int S, int P, int NP, int D, float scale, int causal, int window,
    int block_rows, int cluster, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Tq < 1 || S < 1 ||
      static_cast<long long>(B) * Hkv > 65535 ||
      static_cast<long long>(H / Hkv) * Tq > 0x7fffffffLL ||
      (paged && (P < 1 || NP < 1)) || cluster < 1 || cluster > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  const KvArgs a{static_cast<const float*>(q),
                 static_cast<const float*>(k),
                 static_cast<const float*>(v_mu),
                 static_cast<const float*>(v_var),
                 static_cast<const int*>(page_table),
                 static_cast<const int*>(q_start),
                 static_cast<const int*>(kv_len),
                 static_cast<float*>(out_mu),
                 static_cast<float*>(out_var),
                 B, H, Hkv, Tq, S, P, NP, scale, causal, window, cluster};
  auto s = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (paged ? 1 : 0)) {
    case 16 * 2:
      return launch_kv_block<16, false>(a, block_rows, s);
    case 16 * 2 + 1:
      return launch_kv_block<16, true>(a, block_rows, s);
    case 128 * 2:
      return launch_kv_block<128, false>(a, block_rows, s);
    case 128 * 2 + 1:
      return launch_kv_block<128, true>(a, block_rows, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The cache kernel's block of block_rows rows at head_dim D: its shared
// memory in bytes and the blocks an SM of the current device holds
// (kernels/pfp_attention.py kv_block_bytes and blocks_per_sm model them).
PFP_EXPORT int pfp_attention_kv_block(int paged, int D, int block_rows,
                                      int* smem_bytes, int* blocks_per_sm) {
  switch (D * 2 + (paged ? 1 : 0)) {
    case 16 * 2:
      return kv_block_rows<16, false>(block_rows, smem_bytes, blocks_per_sm);
    case 16 * 2 + 1:
      return kv_block_rows<16, true>(block_rows, smem_bytes, blocks_per_sm);
    case 128 * 2:
      return kv_block_rows<128, false>(block_rows, smem_bytes, blocks_per_sm);
    case 128 * 2 + 1:
      return kv_block_rows<128, true>(block_rows, smem_bytes, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
