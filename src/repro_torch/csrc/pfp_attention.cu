// Flash-style mean-field PFP attention for Hopper: one online-softmax sweep
// over the keys gives both outputs,
//
//     out_mu  = softmax(q k^T * scale) @ mu_v
//     out_var = softmax(q k^T * scale)^2 @ var_v
//
// q (B, H, Tq, D), k / mu_v / var_v (B, Hkv, Tk, D), H a multiple of Hkv,
// fp32, row-major, contiguous.
//
// Replaces repro/kernels/pfp_attention.py: pfp_attention_pallas
// (_attn_kernel with the shared _score_tile, _accumulate, _finalize). As
// there: query head h reads KV head h / (H / Hkv) (kv-major grouping, K/V
// never repeated); causality is right-aligned by index (query row t sits
// at position t + Tk - Tq); masked scores are NEG_INF and p is zeroed after
// the exp; the mean accumulator is rescaled by alpha and the variance
// accumulator by alpha^2 (p^2 shares the running max and normaliser), and
// the end divides by l and l^2 with l clamped at 1e-18, so a query row with
// no valid key (Tq > Tk, causal) comes out 0 rather than NaN.
//
// What bounds it on the H100: fp32 operations. At the granite-8b shape
// (B 4, H 32, T 512, D 128, causal) the three products take ~13 GFLOP, which
// is 0.19 ms at the 67 TFLOP/s fp32 SIMT peak, against 0.05 ms for its
// 134 MB of operands. No tensor cores and no TF32: IEEE fp32 products,
// accurate expf.
//
// Design: one block of 8 warps per (b * H + h, tile of BQ query rows). The
// Q tile is staged in shared memory once; per tile of 32 keys the block
// stages K, mu_v and var_v. Each warp owns BQ/8 query rows, and lane l
// scores key l against them (float4 reads along D from rows padded to
// D + 4 floats, which keeps the 32 lanes on distinct banks). The row max and
// sum are warp shuffles; p goes to shared memory, and for P.V lane l owns
// output columns l, l + 32, ... of the warp's rows, so the V reads are
// conflict-free and p is a broadcast. With causality, key tiles wholly
// above the last query row of the block are skipped: they would add exact
// zeros. Rows and keys past Tq / Tk are masked here; nothing is padded.
// Shared memory is above the 48 KB default at D = 128, so the launcher
// raises the block's dynamic shared-memory limit once per instantiation
// and device.
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

template <int D, int BQ>
__global__ void __launch_bounds__(kThreads)
pfp_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ vm,
                     const float* __restrict__ vv, float* __restrict__ om,
                     float* __restrict__ ov, int H, int Hkv, int Tq, int Tk,
                     float scale, int causal) {
  using T = Tile<D, BQ>;
  constexpr int RW = T::kRowsPerWarp;
  constexpr int CPL = T::kColsPerLane;
  constexpr int LD = T::kLd;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + BQ * LD;
  float* sVm = sK + kBK * LD;
  float* sVv = sVm + kBK * D;
  float* sP = sVv + kBK * D;

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
    sQ[r * LD + c] = q0 + r < Tq ? qb[static_cast<long long>(q0 + r) * D + c]
                                 : 0.0f;
  }

  float m_run[RW], l_run[RW], acc_mu[RW][CPL], acc_var[RW][CPL];
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      acc_mu[i][c] = 0.0f;
      acc_var[i][c] = 0.0f;
    }
  }

  int num_tiles = (Tk + kBK - 1) / kBK;
  if (causal) {
    const int last_key = min(Tk - 1, q0 + BQ - 1 + qoff);
    num_tiles = last_key < 0 ? 0 : last_key / kBK + 1;
  }
  const int row0 = warp * RW;
  const bool lane_has_col = D >= 32 || lane < D;

  for (int t = 0; t < num_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K / V are no longer read
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool ok = k0 + r < Tk;
      const long long off = static_cast<long long>(k0 + r) * D + c;
      sK[r * LD + c] = ok ? kb[off] : 0.0f;
      sVm[r * D + c] = ok ? vmb[off] : 0.0f;
      sVv[r * D + c] = ok ? vvb[off] : 0.0f;
    }
    __syncthreads();

    // Scores of key k0 + lane against the warp's RW query rows.
    float s[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) s[i] = 0.0f;
#pragma unroll 4
    for (int d4 = 0; d4 < D / 4; ++d4) {
      const float4 kv = *reinterpret_cast<const float4*>(sK + lane * LD + 4 * d4);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(sQ + (row0 + i) * LD + 4 * d4);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    // Joint online softmax (_accumulate): one row per i, one key per lane.
    const int key = k0 + lane;
    float alpha[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int q_idx = q0 + row0 + i + qoff;
      const bool valid = key < Tk && (!causal || q_idx >= key);
      const float sc = valid ? s[i] * scale : kNegInf;
      const float m_next = fmaxf(m_run[i], warp_max(sc));
      alpha[i] = expf(m_run[i] - m_next);
      const float p = valid ? expf(sc - m_next) : 0.0f;
      l_run[i] = l_run[i] * alpha[i] + warp_sum(p);
      m_run[i] = m_next;
      sP[(row0 + i) * kBK + lane] = p;
    }
    __syncwarp();

    // acc_mu = acc_mu * alpha + P . mu_v;  acc_var = acc_var * alpha^2 +
    // P^2 . var_v, on the warp's rows and this lane's columns.
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float a2 = alpha[i] * alpha[i];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        acc_mu[i][c] *= alpha[i];
        acc_var[i][c] *= a2;
      }
    }
    if (lane_has_col) {
#pragma unroll 4
      for (int j = 0; j < kBK; ++j) {
        float vmj[CPL], vvj[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          vmj[c] = sVm[j * D + lane + 32 * c];
          vvj[c] = sVv[j * D + lane + 32 * c];
        }
#pragma unroll
        for (int i = 0; i < RW; ++i) {
          const float p = sP[(row0 + i) * kBK + j];
          const float p2 = p * p;
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            acc_mu[i][c] = fmaf(p, vmj[c], acc_mu[i][c]);
            acc_var[i][c] = fmaf(p2, vvj[c], acc_var[i][c]);
          }
        }
      }
    }
  }

  // _finalize: a row with a valid key has l >= 1; a row without one has
  // l == 0 and zero accumulators, and the clamp keeps l^2 finite.
  if (!lane_has_col) return;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int row = q0 + row0 + i;
    if (row >= Tq) continue;
    const float l = fmaxf(l_run[i], kMinL);
    const float l2 = l * l;
    const long long off = (static_cast<long long>(bh) * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      om[off + lane + 32 * c] = acc_mu[i][c] / l;
      ov[off + lane + 32 * c] = acc_var[i][c] / l2;
    }
  }
}

template <int D, int BQ>
int launch(const float* q, const float* k, const float* vm, const float* vv,
           float* om, float* ov, int B, int H, int Hkv, int Tq, int Tk,
           float scale, int causal, cudaStream_t stream) {
  using T = Tile<D, BQ>;
  // The limit is per device: raise it once on each card this runs on.
  constexpr int kMaxDevices = 64;
  static bool smem_raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !smem_raised[dev]) {
    err = cudaFuncSetAttribute(pfp_attention_kernel<D, BQ>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               T::kBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) smem_raised[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((Tq + BQ - 1) / BQ),
                  static_cast<unsigned>(B * H));
  pfp_attention_kernel<D, BQ><<<grid, kThreads, T::kBytes, stream>>>(
      q, k, vm, vv, om, ov, H, Hkv, Tq, Tk, scale, causal);
  return pfp::launch_status();
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
