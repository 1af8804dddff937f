// The joint PFP dense's cp.async ring, shared by the dense kernels
// (pfp_dense.cu) and the fused norm -> dense -> activation unit
// (pfp_fused.cu), so that both sum every output with the same fmaf
// sequence in the same k order and the fused unit equals the unfused chain
// bit for bit by construction.
//
// dense_ring() is the whole body of a block: the `load` of a tile into the
// ring, the ring itself, wide_tile / interleaved_tile on each landed tile,
// cluster split-K (every tile, in ranges of whole kBK = 16 k), and the
// epilogue, a policy that says what becomes of
// the sums: StoreEpilogue (the dense kernels) writes (mean, var);
// pfp_fused.cu's ActEpilogue runs the activation's moment functions on
// them. The design and what bounds each regime are set out in
// pfp_dense.cu.
#pragma once

#include <cooperative_groups.h>

#include "pfp_common.cuh"

namespace pfp {
namespace ring {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kBK = 16;      // K of a staged tile: interleaved tiles
constexpr int kWideBK = 32;  // and wide tiles
constexpr int kMaxSplit = 8;  // the portable cluster size

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
  // A split rank's partial (mean, var) sums, once the ring is drained.
  static constexpr int kPartial = 2 * TM * TN * kThreads;
  static constexpr int kFloats = STAGES * kStage + kTile > kPartial
                                     ? STAGES * kStage + kTile
                                     : kPartial;
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

// The dense kernels' epilogue: (mean, var) to (mu, var), expert e's at
// offset e * M * N.
struct StoreEpilogue {
  static constexpr bool kAccumulates = true;
  float* mu;
  float* var;
  __device__ __forceinline__ void offset(long long off) {
    mu += off;
    var += off;
  }
  template <class R, int TM, int TN>
  __device__ __forceinline__ void store(float*, const float (&acc_mu)[TM][TN],
                                        const float (&acc_v)[TM][TN], int M,
                                        int N, long long m0, int n0) const {
    store_tile<R>(mu, var, acc_mu, acc_v, M, N, m0, n0);
  }
  // One K range's sums into the outputs, which hold the running total of
  // the ranges before it (`add`), else are written. Each output is read
  // and written by the thread that owns it, in program order.
  template <class R, int TM, int TN>
  __device__ __forceinline__ void accumulate(const float (&acc_mu)[TM][TN],
                                             const float (&acc_v)[TM][TN],
                                             int M, int N, long long m0,
                                             int n0, bool add) const {
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
        mu[off] = add ? mu[off] + acc_mu[i][j] : acc_mu[i][j];
        var[off] = add ? var[off] + acc_v[i][j] : acc_v[i][j];
      }
    }
  }
};

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

// A block's whole dense. xa, xb: mu_x and srm_x (kSrm), x and unused
// (kFirstLayer), mu_x and var_x (kVar); wa, wb: mu_w and srm_w (kSrm),
// mu_w and var_w (kFirstLayer, kVar). `split` CTAs (a cluster along x)
// share an output tile, rank r summing K range [r * chunk, (r + 1) *
// chunk), chunk a multiple of kBK whatever the tile, so the ranges and
// hence the sums do not depend on it. With `serial` (and an epilogue that
// accumulates) one CTA walks all `split` ranges in order instead, each
// range summed from zero as a rank sums it and added into the running
// total in rank order: the same additions, so the same bits, with no
// cluster (the large regime, whose one-block-an-SM tiles pack a GPC
// badly in clusters). vec_x and vec_w allow 16-byte copies of the x and
// w rows. smem holds Ring::kFloats floats.
template <int MODE, int BN, int TN, int TM, int STAGES, bool BATCHED,
          class Epilogue>
__device__ __forceinline__ void dense_ring(
    float* smem, const float* __restrict__ xa, const float* __restrict__ xb,
    const float* __restrict__ wa, const float* __restrict__ wb,
    const int* __restrict__ rows, int M, int N, int K, long long x_stride,
    long long w_stride, int split, int chunk, int serial, int vec_x,
    int vec_w, Epilogue epi) {
  using R = Ring<MODE, BN, TN, TM, STAGES>;
  constexpr int TX = R::TX, BM = R::BM;
  constexpr bool kTwoX = MODE != kFirstLayer;

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const bool walk = Epilogue::kAccumulates && serial && split > 1;
  const int ranks = walk ? 1 : split;  // CTAs an output tile
  const int rank =
      ranks > 1 ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const long long m0 = static_cast<long long>(blockIdx.x / ranks) * BM;
  const int n0 = blockIdx.y * BN;
  if constexpr (BATCHED) {
    // Offsets a block's operands to its expert (blockIdx.z). A block whose
    // first row is past the expert's row count writes zeros and leaves.
    // Every rank of a cluster has the same m0 and expert, so a cluster
    // leaves whole or not at all.
    const long long expert = blockIdx.z;
    xa += expert * x_stride;
    xb += expert * x_stride;
    wa += expert * w_stride;
    wb += expert * w_stride;
    epi.offset(expert * M * N);
    if (rows != nullptr && m0 >= rows[expert]) {
      const float zero[TM][TN] = {};
      epi.template store<R>(smem, zero, zero, M, N, m0, n0);
      return;
    }
  }
  // The K ranges this CTA sums: its rank's, or (walk) all of them in
  // order, each range's sums added into the epilogue's running total.
  const int r_first = walk ? 0 : rank, r_last = walk ? split : rank + 1;
  int k_begin = 0, k_end = 0;
  constexpr int BK = R::BK, kXPitch = R::kXPitch;

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
#pragma unroll 1
  for (int r = r_first; r < r_last; ++r) {
    k_begin = min(K, r * chunk);
    k_end = min(K, k_begin + chunk);
    const int tiles = (k_end - k_begin + BK - 1) / BK;
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
    if (walk) {
      if constexpr (Epilogue::kAccumulates) {
        cp_async_wait<0>();
        __syncthreads();  // every thread is done with the ring: refill it
        epi.template accumulate<R>(acc_mu, acc_v, M, N, m0, n0, r > 0);
      }
    }
  }  // the K ranges
  if (walk) return;

  if (ranks > 1) {
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
  epi.template store<R>(smem, acc_mu, acc_v, M, N, m0, n0);
}

}  // namespace ring
}  // namespace pfp
