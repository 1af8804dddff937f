// Flash-style mean-field PFP attention for Hopper: one online-softmax sweep
// over the keys gives both outputs,
//
//     out_mu  = softmax(q k^T * scale) @ mu_v
//     out_var = softmax(q k^T * scale)^2 @ var_v
//
// Three kernels:
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
// no tensor cores and no TF32; the cache kernels take accurate expf, the
// kernel without a cache exp2f of scores in base 2.
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
// Design of the kernel without a cache (Flash, below): a block owns 128
// rows of one KV head's query heads and walks the key tiles itself, so
// nothing crosses blocks (the TPU carries m, l and both accumulators across
// sequential K grid steps instead). To keep the SIMT cores' FMAs fed from
// shared memory, both products are register-blocked as the dense wide tile
// is: each thread computes 4 rows x 4 keys of S and 8 rows x D / 16
// columns of each output, reading float4s only. K, mu_v and var_v arrive
// through a cp.async ring. Tiles that hold no
// valid key for any row of the block are skipped: they would add exact
// zeros. No bit contract ties this kernel to the cache kernels; it is
// deterministic (no atomics; every sum in a fixed order).
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

using pfp::cp_async16;
using pfp::cp_async_commit;
using pfp::cp_async_wait;

// ---------------------------------------------------------------------------
// The kernel without a cache (row 9): register-blocked products on a ring
// ---------------------------------------------------------------------------
// A block owns kRows = 128 rows of one (batch, KV head): the G query heads
// of the KV head packed position-major (block row R is query row R / G of
// head kvh * G + R % G), so each K / V tile is staged once for G heads and
// a block's rows span 128 / G positions, which keeps the causal diagonal's
// masked work to a fraction of a tile. Both products are register-blocked,
// each with its own map of the 256 threads, and exchange p and alpha
// through shared memory: on the H100 a shared-memory load costs a
// wavefront per 32 values a warp reads (broadcast or not), against 4 FFMA
// issues a cycle an SM, so a thread must do 4 FMAs per value it loads.
//  * S = Q K^T: thread (sx, sy) of 8 x 32 takes rows 4 sy .. 4 sy + 3 and
//    keys sx, sx + 8, sx + 16, sx + 24 of the 32-key tile: 8 values a d
//    for 16 FMAs. The online softmax of a row runs in its 8 lanes (xor
//    shuffles over 1, 2, 4); m and l stay in those lanes' registers; p
//    and p^2 go to P and P^2 as one float4 of 4 rows a key, alpha to
//    s_alpha.
//  * P.mu_v and P^2.var_v: thread (vx, vy) of 16 x 16 takes rows 4 vy ..
//    and 64 + 4 vy .. and columns 4 vx + 64 g .. (column vx at D 16): per
//    key 8 values of p, 8 of p^2 and D / 8 of V for D / 2 FMAs, 4 a value
//    at D 128, and no other arithmetic.
// K, mu_v and var_v come through a 2-deep cp.async ring (zero-filled past
// the block's last key), Q with the first tile; two block barriers a tile
// (the ring's, and S before P.V). Causal blocks start heaviest first (the
// row tile is gridDim.y - 1 - blockIdx.y and y varies slowest), so the
// last wave is the lightest.
template <int D>
struct Flash {
  static constexpr int kRows = 128;  // kernels/pfp_attention.py FLASH_ROWS
  static constexpr int kDepth = 2;   // tiles in the ring
  static constexpr int SX = 8, SY = kThreads / SX;  // the S map
  static constexpr int VX = 16, VY = kThreads / VX;  // the P.V map
  static constexpr int SR = kRows / SY, SK = kBK / SX;  // 4 rows x 4 keys
  static constexpr int VR = kRows / VY;  // 8 rows
  static constexpr int CT = D / VX;      // columns a thread
  static constexpr int VEC = CT >= 4 ? 4 : 1;  // neighbouring columns
  static constexpr int kLd = D + 4;     // Q and K rows: banks staggered
  static constexpr int kPLd = kRows + 4;  // P and P^2 rows, one a key
  static constexpr int kStage = kBK * kLd + 2 * kBK * D;
  static constexpr int kP = kRows * kLd;
  static constexpr int kP2 = kP + kBK * kPLd;
  static constexpr int kAlpha = kP2 + kBK * kPLd;
  static constexpr int kRing = kAlpha + kRows;
  static constexpr int kFloats = kRing + kDepth * kStage;
  static constexpr int kBytes = kFloats * 4;
  static_assert(SR == 4 && SK == 4 && VR == 8, "the thread patches");
  static_assert(D % 16 == 0 && CT % VEC == 0, "head_dim");
  static_assert(kBytes <= 227 * 1024, "shared memory of a block");

  // P.V thread row i (of VR) and column c (of CT).
  __device__ __forceinline__ static int vrow(int vy, int i) {
    return (i / 4) * (kRows / 2) + 4 * vy + i % 4;
  }
  __device__ __forceinline__ static int vcol(int vx, int c) {
    return (c / VEC) * VX * VEC + vx * VEC + c % VEC;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
pfp_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ vm,
                     const float* __restrict__ vv, float* __restrict__ om,
                     float* __restrict__ ov, int H, int Hkv, int Tq, int Tk,
                     float scale, int causal) {
  using F = Flash<D>;
  constexpr int D4 = D / 4, SR = F::SR, SK = F::SK, VR = F::VR, CT = F::CT;
  constexpr int LD = F::kLd, PLD = F::kPLd;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_q = smem;
  float* s_p = smem + F::kP;
  float* s_p2 = smem + F::kP2;
  float* s_alpha = smem + F::kAlpha;
  float* ring = smem + F::kRing;

  const int tid = threadIdx.x;
  const int sx = tid % F::SX, sy = tid / F::SX;
  const int vx = tid % F::VX, vy = tid / F::VX;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int rows = G * Tq;
  const int tile = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int r0 = tile * F::kRows;
  const int nrows = min(F::kRows, rows - r0);
  const int qoff = Tk - Tq;  // right-aligned causality
  // Scores and their running max in base 2 (times log2 e), so that exp2f
  // of a difference is expf of the natural one.
  const float scale2 = scale * 1.44269504088896341f;
  // Keys any row of the block can see.
  const int hi = causal ? max(0, min(Tk, (r0 + nrows - 1) / G + qoff + 1))
                        : Tk;
  const int tiles = (hi + kBK - 1) / kBK;
  const long long kv0 = (static_cast<long long>(b) * Hkv + kvh) * Tk * D;
  // The last position among the P.V map's rows of this warp (a bound: the
  // warp's last row below the block's end).
  const int last_pos =
      (r0 + min(nrows - 1, F::vrow(2 * (tid / 32) + 1, VR - 1))) / G + qoff;

  // Q, zero past the rows, with the first tile's group.
  for (int e = tid; e < F::kRows * D4; e += kThreads) {
    const int r = e / D4, c = e % D4, R = r0 + r;
    const bool ok = r < nrows;
    const long long row =
        ok ? (static_cast<long long>(b) * H + kvh * G + R % G) * Tq + R / G
           : 0;
    cp_async16(s_q + r * LD + 4 * c, q + row * D + 4 * c, ok);
  }
  auto load = [&](int t, int st) {
    float* sk = ring + st * F::kStage;
    float* svm = sk + kBK * LD;
    float* svv = svm + kBK * D;
    for (int e = tid; e < kBK * D4; e += kThreads) {
      const int r = e / D4, c = e % D4, j = t * kBK + r;
      const bool ok = j < hi;
      const long long off = ok ? kv0 + static_cast<long long>(j) * D + 4 * c
                               : 0;
      cp_async16(sk + r * LD + 4 * c, k + off, ok);
      cp_async16(svm + r * D + 4 * c, vm + off, ok);
      cp_async16(svv + r * D + 4 * c, vv + off, ok);
    }
  };

  // The S map's rows: live (below the block's rows), position among the
  // keys, running max and normaliser (alike in the row's 8 lanes).
  bool live[SR];
  int pos[SR];
  float m[SR], l[SR];
#pragma unroll
  for (int i = 0; i < SR; ++i) {
    const int r = SR * sy + i;
    live[i] = r < nrows;
    pos[i] = (r0 + r) / G + qoff;
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  // The P.V map's sums.
  float mu[VR][CT], var[VR][CT];
#pragma unroll
  for (int i = 0; i < VR; ++i) {
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      mu[i][c] = 0.0f;
      var[i][c] = 0.0f;
    }
  }

  if (tiles > 0) load(0, 0);
  cp_async_commit();
#pragma unroll 1
  for (int t = 0; t < tiles; ++t) {
    // Tile t has landed (and Q); every thread is done with tile t - 1's
    // stage, P and alpha.
    cp_async_wait<0>();
    __syncthreads();
    if (t + 1 < tiles) load(t + 1, (t + 1) % F::kDepth);
    cp_async_commit();
    const float* sk = ring + (t % F::kDepth) * F::kStage;
    const float* svm = sk + kBK * LD;
    const float* svv = svm + kBK * D;

    // S: one fmaf chain over d for each of the thread's rows and keys.
    float s[SR][SK];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
#pragma unroll
      for (int jj = 0; jj < SK; ++jj) s[i][jj] = 0.0f;
    }
#pragma unroll 4
    for (int d4 = 0; d4 < D4; ++d4) {
      float4 kv[SK];
#pragma unroll
      for (int jj = 0; jj < SK; ++jj)
        kv[jj] = *reinterpret_cast<const float4*>(
            sk + (sx + F::SX * jj) * LD + 4 * d4);
#pragma unroll
      for (int i = 0; i < SR; ++i) {
        const float4 qv = *reinterpret_cast<const float4*>(
            s_q + (SR * sy + i) * LD + 4 * d4);
#pragma unroll
        for (int jj = 0; jj < SK; ++jj) {
          s[i][jj] = fmaf(qv.x, kv[jj].x, s[i][jj]);
          s[i][jj] = fmaf(qv.y, kv[jj].y, s[i][jj]);
          s[i][jj] = fmaf(qv.z, kv[jj].z, s[i][jj]);
          s[i][jj] = fmaf(qv.w, kv[jj].w, s[i][jj]);
        }
      }
    }

    // The online softmax of each row over its 8 lanes; p to P, alpha to
    // s_alpha.
    float p[SR][SK];
#pragma unroll
    for (int i = 0; i < SR; ++i) {
      float sc[SK], mx = kNegInf;
      bool ok[SK];
#pragma unroll
      for (int jj = 0; jj < SK; ++jj) {
        const int key = t * kBK + sx + F::SX * jj;
        ok[jj] = live[i] && key < Tk && (!causal || key <= pos[i]);
        sc[jj] = ok[jj] ? s[i][jj] * scale2 : kNegInf;
        mx = fmaxf(mx, sc[jj]);
      }
#pragma unroll
      for (int off = 1; off < F::SX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_next = fmaxf(m[i], mx);
      const float alpha = exp2f(m[i] - m_next);
      float sum = 0.0f;
#pragma unroll
      for (int jj = 0; jj < SK; ++jj) {
        p[i][jj] = ok[jj] ? exp2f(sc[jj] - m_next) : 0.0f;
        sum += p[i][jj];
      }
#pragma unroll
      for (int off = 1; off < F::SX; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_next;
      if (sx == 0) s_alpha[SR * sy + i] = alpha;
    }
#pragma unroll
    for (int jj = 0; jj < SK; ++jj) {
      const int off = (sx + F::SX * jj) * PLD + SR * sy;
      *reinterpret_cast<float4*>(s_p + off) =
          make_float4(p[0][jj], p[1][jj], p[2][jj], p[3][jj]);
      *reinterpret_cast<float4*>(s_p2 + off) =
          make_float4(p[0][jj] * p[0][jj], p[1][jj] * p[1][jj],
                      p[2][jj] * p[2][jj], p[3][jj] * p[3][jj]);
    }
    __syncthreads();

    // mu = mu alpha + P . mu_v; var = var alpha^2 + P^2 . var_v, keys in
    // order.
    float al[VR];
#pragma unroll
    for (int h = 0; h < VR; h += 4) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(s_alpha + F::vrow(vy, h));
      al[h] = a4.x, al[h + 1] = a4.y, al[h + 2] = a4.z, al[h + 3] = a4.w;
    }
    // Once the rows' maxima settle, alpha is 1 (and x * 1 is x): the warp
    // skips the rescale.
    bool moved = false;
#pragma unroll
    for (int i = 0; i < VR; ++i) moved |= al[i] != 1.0f;
    if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
      for (int i = 0; i < VR; ++i) {
        const float a2 = al[i] * al[i];
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          mu[i][c] *= al[i];
          var[i][c] *= a2;
        }
      }
    }
    // Keys past the last one any of the warp's rows sees have p = 0 for
    // all of them (the causal diagonal, the end of the keys): the warp
    // stops there.
    const int jend = min(kBK, min(Tk, causal ? last_pos + 1 : Tk) - t * kBK);
#pragma unroll 2
    for (int j = 0; j < jend; ++j) {
      float pj[VR], p2j[VR];
#pragma unroll
      for (int h = 0; h < VR; h += 4) {
        const int off = j * PLD + F::vrow(vy, h);
        const float4 p4 = *reinterpret_cast<const float4*>(s_p + off);
        const float4 q4 = *reinterpret_cast<const float4*>(s_p2 + off);
        pj[h] = p4.x, pj[h + 1] = p4.y, pj[h + 2] = p4.z, pj[h + 3] = p4.w;
        p2j[h] = q4.x, p2j[h + 1] = q4.y, p2j[h + 2] = q4.z,
        p2j[h + 3] = q4.w;
      }
      float vmj[CT], vvj[CT];
#pragma unroll
      for (int c = 0; c < CT; c += F::VEC) {
        const int col = F::vcol(vx, c);
        if constexpr (F::VEC == 4) {
          const float4 a4 =
              *reinterpret_cast<const float4*>(svm + j * D + col);
          const float4 b4 =
              *reinterpret_cast<const float4*>(svv + j * D + col);
          vmj[c] = a4.x, vmj[c + 1] = a4.y, vmj[c + 2] = a4.z,
          vmj[c + 3] = a4.w;
          vvj[c] = b4.x, vvj[c + 1] = b4.y, vvj[c + 2] = b4.z,
          vvj[c + 3] = b4.w;
        } else {
          vmj[c] = svm[j * D + col];
          vvj[c] = svv[j * D + col];
        }
      }
#pragma unroll
      for (int i = 0; i < VR; ++i) {
#pragma unroll
        for (int c = 0; c < CT; ++c) {
          mu[i][c] = fmaf(pj[i], vmj[c], mu[i][c]);
          var[i][c] = fmaf(p2j[i], vvj[c], var[i][c]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Scale by 1 / l and 1 / l^2, l clamped at 1e-18: a row with a valid
  // key has l >= 1; a row without one has l == 0, zero sums and zero
  // outputs. l goes from the S map to the P.V map through s_alpha. The
  // outputs leave as float4s of whole 16-byte groups.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < SR; ++i)
    if (sx == 0) s_alpha[SR * sy + i] = l[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < VR; ++i) {
    const int r = F::vrow(vy, i);
    if (r >= nrows) continue;
    const int R = r0 + r;
    const long long out =
        ((static_cast<long long>(b) * H + kvh * G + R % G) * Tq + R / G) * D;
    const float lr = fmaxf(s_alpha[r], kMinL);
    const float inv = 1.0f / lr, inv2 = 1.0f / (lr * lr);
#pragma unroll
    for (int c = 0; c < CT; c += F::VEC) {
      const int col = F::vcol(vx, c);
      if constexpr (F::VEC == 4) {
        *reinterpret_cast<float4*>(om + out + col) =
            make_float4(mu[i][c] * inv, mu[i][c + 1] * inv,
                        mu[i][c + 2] * inv, mu[i][c + 3] * inv);
        *reinterpret_cast<float4*>(ov + out + col) =
            make_float4(var[i][c] * inv2, var[i][c + 1] * inv2,
                        var[i][c + 2] * inv2, var[i][c + 3] * inv2);
      } else {
        om[out + col] = mu[i][c] * inv;
        ov[out + col] = var[i][c] * inv2;
      }
    }
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

template <int D>
int launch(const float* q, const float* k, const float* vm, const float* vv,
           float* om, float* ov, int B, int H, int Hkv, int Tq, int Tk,
           float scale, int causal, cudaStream_t stream) {
  using F = Flash<D>;
  const long long tiles = (static_cast<long long>(H / Hkv) * Tq + F::kRows - 1) /
                          F::kRows;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  static bool raised[pfp::kMaxDevices] = {};
  const cudaError_t err =
      pfp::allow_smem(pfp_attention_kernel<D>, F::kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * Hkv),
                  static_cast<unsigned>(tiles));
  pfp_attention_kernel<D><<<grid, kThreads, F::kBytes, stream>>>(
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
// head_dim D in {16, 64, 128} (the reduced test config, musicgen-medium,
// granite-8b; kernels/pfp_attention.py HEAD_DIMS); H % Hkv == 0;
// B * Hkv <= 2^31 - 1; (H / Hkv) * Tq / 64 row tiles <= 65535. All
// pointers 16-byte aligned.
PFP_EXPORT int pfp_attention_launch(const void* q, const void* k,
                                    const void* v_mu, const void* v_var,
                                    void* out_mu, void* out_var, int B, int H,
                                    int Hkv, int Tq, int Tk, int D,
                                    float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Tq < 1 || Tk < 1 ||
      static_cast<long long>(B) * Hkv > 0x7fffffffLL)
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
      return launch<16>(pq, pk, pvm, pvv, om, ov, B, H, Hkv, Tq, Tk, scale,
                        causal, s);
    case 64:
      return launch<64>(pq, pk, pvm, pvv, om, ov, B, H, Hkv, Tq, Tk, scale,
                        causal, s);
    case 128:
      return launch<128>(pq, pk, pvm, pvv, om, ov, B, H, Hkv, Tq, Tk, scale,
                         causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The KV-cache kernels. q (B, H, Tq, D); paged = 0: k, v_mu, v_var
// (B, Hkv, S, D) and page_table unused; paged = 1: k, v_mu, v_var
// (NP, Hkv, S, D) pools of pages of S rows, page_table (B, P) int32.
// q_start, kv_len (B,) int32; window <= 0 means none. Outputs (B, H, Tq, D).
// All pointers 16-byte aligned. head_dim D in {16, 64, 128}; H % Hkv == 0;
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
    case 64 * 2:
      return launch_kv_block<64, false>(a, block_rows, s);
    case 64 * 2 + 1:
      return launch_kv_block<64, true>(a, block_rows, s);
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
    case 64 * 2:
      return kv_block_rows<64, false>(block_rows, smem_bytes, blocks_per_sm);
    case 64 * 2 + 1:
      return kv_block_rows<64, true>(block_rows, smem_bytes, blocks_per_sm);
    case 128 * 2:
      return kv_block_rows<128, false>(block_rows, smem_bytes, blocks_per_sm);
    case 128 * 2 + 1:
      return kv_block_rows<128, true>(block_rows, smem_bytes, blocks_per_sm);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
