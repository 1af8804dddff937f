// Flash-style mean-field PFP attention for Hopper: one online-softmax sweep
// over the keys gives both outputs,
//
//     out_mu  = softmax(q k^T * scale) @ mu_v
//     out_var = softmax(q k^T * scale)^2 @ var_v
//
// Three kernels share one tile body (attend_tile below):
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
// Design: a block of 8 warps owns BQ query rows and walks the key tiles
// itself, so nothing crosses blocks (the TPU carries m, l and both
// accumulators across sequential K grid steps instead). Per tile of 32 keys
// the block stages K, mu_v and var_v in shared memory. Each warp owns
// BQ / 8 query rows, and lane l scores key l against them (float4 reads
// along D from rows padded to D + 4 floats, which keeps the 32 lanes on
// distinct banks). The row max and sum are warp shuffles; p goes to shared
// memory, and for P.V lane l owns output columns l, l + 32, ... of the
// warp's rows, so the V reads are conflict-free and p is a broadcast. Tiles
// that hold no valid key for any row of the block (past kv_len, above the
// block's last causal row, below its first window row) are skipped: they
// would add exact zeros, so skipping them changes no bit.
//
// The cache kernels pack the G = H / Hkv query heads of one KV head and the
// Tq query rows into the block's rows, position-major (block row r is query
// row r / G of head kvh * G + r % G), so each K / V tile is read once per
// KV head, not once per query head. At decode (Tq = 1, G = 4) the block has
// BQ = 8 rows of which 4 are real; at prefill BQ = 64. The grid is
// (row tiles, B * Hkv): at decode 32 blocks on 132 SMs (splitting the keys
// across blocks, flash-decoding, is later work). The contiguous and the
// paged kernel are one template that differs only in a key row's address,
// with the same tile order and accumulation order, so on the same cache
// contents paged and contiguous attention agree bit for bit.
//
// Rows and keys past the ends are masked here; nothing is padded. q_start
// and kv_len stay on the device (no host sync), so a step can be captured
// in a CUDA graph. Shared memory is above the 48 KB default at D = 128, so
// each launcher raises the block's dynamic shared-memory limit once per
// instantiation and device, on its first call (before any capture).
#include "pfp_common.cuh"

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

// S: the cache length (contiguous) or the page size (paged). P: the page
// table's width, NP: the pool's page count (paged only).
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
                        int causal, int window) {
  constexpr int RW = Tile<D, BQ>::kRowsPerWarp;
  constexpr int LD = Tile<D, BQ>::kLd;
  constexpr int D4 = D / 4;
  extern __shared__ float4 smem4[];
  const Smem<D, BQ> sm(reinterpret_cast<float*>(smem4));

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int b = blockIdx.y / Hkv, kvh = blockIdx.y % Hkv;
  const int G = H / Hkv;
  const int rows = G * Tq;
  const int r0 = blockIdx.x * BQ;
  const int qs = q_start[b];
  const int cap = PAGED ? P * S : S;
  const int klim = min(max(kv_len[b], 0), cap);

  // Block row r is query row (r0 + r) / G of head kvh * G + (r0 + r) % G.
  for (int e = threadIdx.x; e < BQ * D4; e += kThreads) {
    const int r = e / D4, c = e % D4, R = r0 + r;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (R < rows) {
      const long long row =
          (static_cast<long long>(b) * H + kvh * G + R % G) * Tq + R / G;
      v = reinterpret_cast<const float4*>(q + row * D)[c];
    }
    reinterpret_cast<float4*>(sm.q + r * LD)[c] = v;
  }

  Rows<D, BQ> st;
  const int row0 = warp * RW;
  int pos[RW];  // absolute position of each of the warp's rows
#pragma unroll
  for (int i = 0; i < RW; ++i) pos[i] = qs + (r0 + row0 + i) / G;

  // Keys any row of the block can see: causality bounds them by the
  // block's last query position, the window by its first.
  const int last = min(r0 + BQ, rows) - 1;
  const int hi = causal ? min(klim, qs + last / G + 1) : klim;
  const int lo = window > 0 ? max(0, qs + r0 / G - window + 1) : 0;
  const int t_begin = lo / kBK;
  const int t_end = hi > lo ? (hi + kBK - 1) / kBK : t_begin;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K / V are no longer read
    for (int e = threadIdx.x; e < kBK * D4; e += kThreads) {
      const int r = e / D4, c = e % D4, j = k0 + r;
      float4 kx = make_float4(0.0f, 0.0f, 0.0f, 0.0f), mx = kx, vx = kx;
      if (j < hi) {
        long long row;
        if constexpr (PAGED) {
          int page = page_table[static_cast<long long>(b) * P + j / S];
          if (page < 0 || page >= NP) page = 0;  // outside the pool: trash
          row = (static_cast<long long>(page) * Hkv + kvh) * S + j % S;
        } else {
          row = (static_cast<long long>(b) * Hkv + kvh) * S + j;
        }
        kx = reinterpret_cast<const float4*>(k + row * D)[c];
        mx = reinterpret_cast<const float4*>(vm + row * D)[c];
        vx = reinterpret_cast<const float4*>(vv + row * D)[c];
      }
      reinterpret_cast<float4*>(sm.k + r * LD)[c] = kx;
      reinterpret_cast<float4*>(sm.vm + r * D)[c] = mx;
      reinterpret_cast<float4*>(sm.vv + r * D)[c] = vx;
    }
    __syncthreads();
    const int key = k0 + lane;
    attend_tile(sm, row0, lane, scale, [&](int i) {
      return key < klim && (!causal || pos[i] >= key) &&
             (window <= 0 || key > pos[i] - window);
    }, st);
  }

#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int R = r0 + row0 + i;
    if (R < rows) {
      const long long row =
          (static_cast<long long>(b) * H + kvh * G + R % G) * Tq + R / G;
      write_row(st, i, lane, row * D, om, ov);
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
  int causal, window;
};

template <int D, int BQ, bool PAGED>
int launch_kv(const KvArgs& a, cudaStream_t stream) {
  constexpr int kBytes = Tile<D, BQ>::kBytes;
  static bool raised[pfp::kMaxDevices] = {};
  const cudaError_t err = pfp::allow_smem(
      pfp_attention_kv_kernel<D, BQ, PAGED>, kBytes, raised);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(a.H / a.Hkv) * a.Tq;
  const dim3 grid(static_cast<unsigned>((rows + BQ - 1) / BQ),
                  static_cast<unsigned>(a.B * a.Hkv));
  pfp_attention_kv_kernel<D, BQ, PAGED><<<grid, kThreads, kBytes, stream>>>(
      a.q, a.k, a.vm, a.vv, a.page_table, a.q_start, a.kv_len, a.om, a.ov,
      a.H, a.Hkv, a.Tq, a.S, a.P, a.NP, a.scale, a.causal, a.window);
  return pfp::launch_status();
}

// Decode packs G * Tq <= 8 rows (G = 4, Tq = 1 for granite-8b) into a
// block of 8 rows, one per warp; longer query blocks take 64.
template <int D, bool PAGED>
int launch_kv_rows(const KvArgs& a, cudaStream_t stream) {
  if (static_cast<long long>(a.H / a.Hkv) * a.Tq <= 8)
    return launch_kv<D, 8, PAGED>(a, stream);
  return launch_kv<D, 64, PAGED>(a, stream);
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
PFP_EXPORT int pfp_attention_kv_launch(
    int paged, const void* q, const void* k, const void* v_mu,
    const void* v_var, const void* page_table, const void* q_start,
    const void* kv_len, void* out_mu, void* out_var, int B, int H, int Hkv,
    int Tq, int S, int P, int NP, int D, float scale, int causal, int window,
    void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Tq < 1 || S < 1 ||
      static_cast<long long>(B) * Hkv > 65535 ||
      static_cast<long long>(H / Hkv) * Tq > 0x7fffffffLL ||
      (paged && (P < 1 || NP < 1)))
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
                 B, H, Hkv, Tq, S, P, NP, scale, causal, window};
  auto s = static_cast<cudaStream_t>(stream);
  switch (D * 2 + (paged ? 1 : 0)) {
    case 16 * 2:
      return launch_kv_rows<16, false>(a, s);
    case 16 * 2 + 1:
      return launch_kv_rows<16, true>(a, s);
    case 128 * 2:
      return launch_kv_rows<128, false>(a, s);
    case 128 * 2 + 1:
      return launch_kv_rows<128, true>(a, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
